"""k4 stride-2 convolutions and crop helpers, channels last, 2D or 3D.

Counterpart of ``transfer_em_tpu/ops/convs.py``.  The JAX package computes
these convs with XLA outside any Pallas kernel, so the port leaves them to
``torch.nn.functional`` (cuDNN on the card).  Activations stay channels-last
(NHWC / NDHWC) and kernels in the JAX layout (HWIO / DHWIO), so both
packages take the same tensors at their public functions:

* ``conv_nd``: VALID or SAME (XLA's split, at any stride) strided conv;
  the kernel's (k.., Cin, Cout) -> (Cout, Cin, k..) is ``permute(n + 1,
  n, 0, .., n - 1)`` for n spatial axes.
* ``conv_transpose_nd``: TF-SAME transposed conv at any k and s; the
  generator's k4 stride-2 one (reference
  Keras ``Conv2DTranspose`` / ``Conv3DTranspose``, convs.py:84-132) ==
  ``F.conv_transpose{2,3}d(stride=2, padding=1)`` with the (k.., Cin, Cout)
  kernel as (Cin, Cout, k..) and NO spatial flip (the JAX version flips
  because it writes the transposed conv as a forward conv on the dilated
  input; ``conv_transpose{2,3}d`` is the adjoint itself).  Pinned against
  the JAX function in tests/test_torch_ops.py (3D) and
  tests/test_torch_2d_models.py (2D).  ``phase_decompose=True`` computes it
  as the JAX package's subpixel formulation (convs.py:135-189): one k3
  VALID conv over x padded by 1, with 2^n * Cout output channels
  (:func:`phase_kernel`), then interleaved (:func:`interleave_phases`).

An NDHWC (NHWC) tensor permuted to NCDHW (NCHW) is a channels_last view,
which cuDNN takes without a copy.  On the CPU the permuted kernel is made
contiguous: there PyTorch's ``slow_conv2d``, which it picks for some shapes
(a 2D batch of one), refuses a strided weight gradient.
"""

from __future__ import annotations

import itertools
from typing import Optional, Sequence, Tuple, Union

import torch
import torch.nn.functional as F

_CONV = {2: F.conv2d, 3: F.conv3d}
_CONV_T = {2: F.conv_transpose2d, 3: F.conv_transpose3d}


def _spatial_rank(x: torch.Tensor, kernel: torch.Tensor) -> int:
    """n for an (B, *n spatial, C) input and a (*n spatial, Cin, Cout)
    kernel, n in {2, 3}; raises on anything else."""
    n = x.dim() - 2
    if n not in _CONV or kernel.dim() != x.dim():
        raise ValueError(
            f"expected NHWC x HWIO (2D) or NDHWC x DHWIO (3D); got x "
            f"{tuple(x.shape)}, kernel {tuple(kernel.shape)}")
    return n


def _to_channels_first(x: torch.Tensor) -> torch.Tensor:
    n = x.dim() - 2
    return x.permute(0, n + 1, *range(1, n + 1))


def _weight(w: torch.Tensor) -> torch.Tensor:
    return w.contiguous() if w.device.type == "cpu" else w


def _to_channels_last(y: torch.Tensor) -> torch.Tensor:
    n = y.dim() - 2
    return y.permute(0, *range(2, n + 2), 1).contiguous()


def same_padding(n: int, k: int, s: int) -> Tuple[int, int]:
    """XLA's SAME split of one axis of extent ``n`` for a k-tap stride-s
    conv: ceil(n / s) outputs, ``total = max((ceil(n / s) - 1) * s + k - n,
    0)`` zeros, ``total // 2`` before and the rest after (more after when
    ``total`` is odd)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def conv_nd(x: torch.Tensor, kernel: torch.Tensor, *, stride: int = 1,
            padding: str = "VALID") -> torch.Tensor:
    """(B, *S, Cin) * (*k, Cin, Cout) -> (B, *S', Cout), 2D or 3D, in x's
    dtype (the kernel is cast to it).  ``padding="SAME"`` pads as XLA does
    (:func:`same_padding`, split unevenly where the total is odd): torch's
    ``padding="same"`` at stride 1, at a larger stride an explicit pad and
    a VALID conv (torch refuses "same" there)."""
    n = _spatial_rank(x, kernel)
    if padding not in ("VALID", "SAME"):
        raise ValueError(f"padding must be VALID or SAME, got {padding!r}")
    w = _weight(kernel.to(x.dtype).permute(n + 1, n, *range(n)))
    pad = "valid"
    if padding == "SAME" and stride == 1:
        pad = "same"
    elif padding == "SAME":
        pads = ()
        for ax in reversed(range(n)):
            pads += same_padding(x.shape[1 + ax], kernel.shape[ax], stride)
        x = F.pad(x, (0, 0) + pads)
    y = _CONV[n](_to_channels_first(x), w, stride=stride, padding=pad)
    return _to_channels_last(y)


def same_transpose_padding(k: int, s: int) -> Tuple[int, int]:
    """Equivalent forward-conv padding for TF's SAME transposed conv.

    TF SAME transpose (out = in * s) is the input-gradient of a SAME forward
    strided conv; its forward-dilated equivalent pads (k-1-p_lo, k-1-p_hi)
    where p_total = max(k - s, 0), p_lo = p_total//2, p_hi = p_total - p_lo.
    torch's ``conv_transpose`` takes ``padding = k - 1 - pad`` for a
    symmetric pad (k=4, s=2: (2, 2), so 1).
    """
    p_total = max(k - s, 0)
    p_lo = p_total // 2
    p_hi = p_total - p_lo
    return (k - 1 - p_lo, k - 1 - p_hi)


def conv_transpose_nd(x: torch.Tensor, kernel: torch.Tensor, *,
                      stride: int = 2,
                      phase_decompose: Optional[bool] = None) -> torch.Tensor:
    """TF-exact stride-s SAME transposed conv, 2D or 3D: (B, *n, Cin) *
    (k.., Cin, Cout) -> (B, *n', Cout), n' = (n - 1) * s + k - max(k - s,
    0): n * s where k >= s, (n - 1) * s + k below (k1 s2: 2n - 1), as the
    JAX package's input-dilated conv gives.  The generator's k4 s2 is
    ``conv_transpose`` with padding 1; any other (k, s) is ``conv_transpose``
    unpadded, cropped by :func:`same_transpose_padding`'s split of
    max(k - s, 0) (the low side ``p_lo``, the high side the rest).
    ``phase_decompose`` (default off, as in the JAX package; k4 s2 only):
    one stride-1 k3 conv with 2^n * Cout outputs, then interleaved; the
    same function, summed in another order."""
    n = _spatial_rank(x, kernel)
    k = kernel.shape[0]
    if phase_decompose:
        if stride != 2 or k != 4:
            raise ValueError("phase_decompose supports stride=2, k=4 only")
        return _conv_transpose_phase(x, kernel)
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    w = _weight(kernel.to(x.dtype).permute(n, n + 1, *range(n)))
    xc = _to_channels_first(x)
    if stride == 2 and k == 4:  # the generator's up convs
        pad, _ = same_transpose_padding(k, stride)  # symmetric: (2, 2)
        return _to_channels_last(_CONV_T[n](xc, w, stride=stride,
                                            padding=k - 1 - pad))
    p_total = max(k - stride, 0)
    lo, hi = p_total // 2, p_total - p_total // 2
    y = _CONV_T[n](xc, w, stride=stride)  # (n - 1) * s + k an axis
    y = y[(slice(None), slice(None))
          + tuple(slice(lo, y.shape[2 + ax] - hi) for ax in range(n))]
    return _to_channels_last(y)


# Per axis, the TF SAME stride-2 k4 transposed conv is
#   y[2m] = x[m-1] w[3] + x[m] w[1],   y[2m+1] = x[m] w[2] + x[m+1] w[0],
# i.e. over x padded by 1, the even phase takes window offsets {0: w[3],
# 1: w[1]} and the odd phase {1: w[2], 2: w[0]} of a k3 window
# (transfer_em_tpu/ops/convs.py:135-189).
_TAPMAP = ({0: 3, 1: 1}, {1: 2, 2: 0})


def phase_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """(4,)*n + (Cin, Cout) -> the phase conv's (3,)*n + (Cin, 2^n * Cout)
    kernel, phase p (the per-axis phase bits, first axis most significant)
    in output channels [p * Cout, (p + 1) * Cout).  Each tap is written
    once into zeros, so the values (int8 codes too) carry over exactly."""
    n = kernel.dim() - 2
    cin, cout = kernel.shape[-2], kernel.shape[-1]
    k3 = kernel.new_zeros((3,) * n + (cin, cout * 2 ** n))
    for pidx, phases in enumerate(itertools.product((0, 1), repeat=n)):
        for offs in itertools.product(*[_TAPMAP[p] for p in phases]):
            taps = tuple(_TAPMAP[p][o] for p, o in zip(phases, offs))
            k3[offs + (slice(None), slice(pidx * cout, (pidx + 1) * cout))] \
                = kernel[taps]
    return k3


def interleave_phases(y: torch.Tensor, p: int = 2) -> torch.Tensor:
    """A phase conv's (B, *S, p^n * Cout) -> (B, *pS, Cout): output p * m
    + r of each axis from phase r (the phases' channel blocks ordered with
    the first axis most significant)."""
    n = y.dim() - 2
    bsz, sp, cout = y.shape[0], tuple(y.shape[1:-1]), y.shape[-1] // p ** n
    y = y.reshape((bsz,) + sp + (p,) * n + (cout,))
    perm = [0]
    for i in range(n):
        perm += [1 + i, 1 + n + i]  # (m, phase) per axis
    y = y.permute(perm + [1 + 2 * n])
    return y.reshape((bsz,) + tuple(p * s for s in sp) + (cout,))


def _conv_transpose_phase(x: torch.Tensor, kernel: torch.Tensor
                          ) -> torch.Tensor:
    y = conv_nd(zero_pad(x, 1), phase_kernel(kernel))
    return interleave_phases(y).contiguous()


def center_crop(x: torch.Tensor,
                crop: Union[int, Sequence[Sequence[int]]]) -> torch.Tensor:
    """Crop every spatial axis by ``crop`` per face, or by (lo, hi) pairs
    per axis (Keras Cropping2D / Cropping3D)."""
    ndim = x.dim() - 2
    if isinstance(crop, int):
        crop = [(crop, crop)] * ndim
    slices = [slice(None)]
    for ax, (lo, hi) in enumerate(crop):
        slices.append(slice(lo, x.shape[1 + ax] - hi))
    slices.append(slice(None))
    return x[tuple(slices)]


def zero_pad(x: torch.Tensor, pad: int) -> torch.Tensor:
    """Zero-pad every spatial axis by ``pad`` per face (Keras
    ZeroPadding2D / ZeroPadding3D), channels last."""
    return F.pad(x, (0, 0) + (pad, pad) * (x.dim() - 2))


def asymmetric_center_crop(x: torch.Tensor, target) -> torch.Tensor:
    """Crop each spatial axis down to ``target`` (int or per-axis tuple); an
    odd leftover voxel goes to the HIGH side (reference generator.py:74-86)."""
    ndim = x.dim() - 2
    if isinstance(target, int):
        target = (target,) * ndim
    crops = []
    for ax in range(ndim):
        total = x.shape[1 + ax] - target[ax]
        lo = total // 2
        crops.append((lo, total - lo))
    return center_crop(x, crops)


def crop_to_match(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Center-crop x's spatial axes to ref's spatial shape."""
    return asymmetric_center_crop(x, tuple(ref.shape[1:-1]))
