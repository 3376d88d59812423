"""k4 stride-2 convolutions and crop helpers, channels last, 2D or 3D.

Counterpart of ``transfer_em_tpu/ops/convs.py``.  The JAX package computes
these convs with XLA outside any Pallas kernel.  The port leaves the 1x1
convs and every 2D conv to ``torch.nn.functional`` (cuDNN on the card).
The 3D k4 stride-2 convs, down and transposed, run in float32 inference on
hand-written kernels: the down convs on the down4 kernel
(``ops/cuda_down.py``, :func:`down_route`), the transposed convs as the
phase conv on conv3 (``ops/cuda_conv.py``, :func:`phase_route`);
everywhere else on cuDNN.  Activations
stay channels-last (NHWC / NDHWC) and kernels in the JAX layout (HWIO /
DHWIO), so both packages take the same tensors at their public functions:

* ``conv_nd``: VALID or SAME (XLA's split, at any stride) strided conv;
  the kernel's (k.., Cin, Cout) -> (Cout, Cin, k..) is ``permute(n + 1,
  n, 0, .., n - 1)`` for n spatial axes.  ``leaky`` applies LeakyReLU
  after it (in the down4 kernel's epilogue on its route).  A 3D k4
  stride-2 VALID conv that :func:`down_route` takes runs on the down4
  kernel (``ops/cuda_down.py``), which reads x in place at stride 2.
  ``conv_nd.k4_calls`` and ``.cudnn_calls`` count the k4 stride-2 VALID
  convs by form (``ops/counts.py`` ``down_k4`` / ``down_cudnn``).
* ``conv_transpose_nd``: TF-SAME transposed conv at any k and s; the
  generator's k4 stride-2 one (reference
  Keras ``Conv2DTranspose`` / ``Conv3DTranspose``, convs.py:84-132) ==
  ``F.conv_transpose{2,3}d(stride=2, padding=1)`` with the (k.., Cin, Cout)
  kernel as (Cin, Cout, k..) and NO spatial flip (the JAX version flips
  because it writes the transposed conv as a forward conv on the dilated
  input; ``conv_transpose{2,3}d`` is the adjoint itself).  Pinned against
  the JAX function in tests/test_torch_ops.py (3D) and
  tests/test_torch_2d_models.py (2D).  The phase form computes the same
  function as the JAX package's subpixel formulation (convs.py:135-189):
  one k3 VALID conv over x padded by 1, with 2^n * Cout output channels
  (:func:`phase_kernel`), then interleaved (:func:`interleave_phases`).
  ``phase_decompose`` picks the form; its default picks it from the call
  (:func:`phase_route`).  ``conv_transpose_nd.phase_calls`` and
  ``.cudnn_calls`` count the two forms (``ops/counts.py``
  ``transpose_phase`` / ``transpose_cudnn``).

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

from .cuda_conv import conv3, storage_cached
from .cuda_down import down4
from .cuda_kernels import leaky_relu

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
            padding: str = "VALID", leaky: Optional[float] = None
            ) -> torch.Tensor:
    """(B, *S, Cin) * (*k, Cin, Cout) -> (B, *S', Cout), 2D or 3D, in x's
    dtype (the kernel is cast to it).  ``padding="SAME"`` pads as XLA does
    (:func:`same_padding`, split unevenly where the total is odd): torch's
    ``padding="same"`` at stride 1, at a larger stride an explicit pad and
    a VALID conv (torch refuses "same" there).  ``leaky`` applies
    LeakyReLU(negative_slope=leaky) to the result.  A call that
    :func:`down_route` takes runs on the down4 kernel, the LeakyReLU in its
    epilogue; every other call on ``F.conv{2,3}d``, then the leaky_relu
    kernel."""
    n = _spatial_rank(x, kernel)
    if padding not in ("VALID", "SAME"):
        raise ValueError(f"padding must be VALID or SAME, got {padding!r}")
    if down_route(x, kernel, stride, padding):
        conv_nd.k4_calls += 1
        return down4(x, kernel, leaky)
    if _is_down(kernel, stride, padding):
        conv_nd.cudnn_calls += 1
    w = _weight(kernel.to(x.dtype).permute(n + 1, n, *range(n)))
    pad = "valid"
    if padding == "SAME" and stride == 1:
        pad = "same"
    elif padding == "SAME":
        pads = ()
        for ax in reversed(range(n)):
            pads += same_padding(x.shape[1 + ax], kernel.shape[ax], stride)
        x = F.pad(x, (0, 0) + pads)
    y = _to_channels_last(_CONV[n](_to_channels_first(x), w, stride=stride,
                                   padding=pad))
    return y if leaky is None else leaky_relu(y, leaky)


conv_nd.k4_calls = 0     # k4 stride-2 VALID convs on the down4 kernel
conv_nd.cudnn_calls = 0  # k4 stride-2 VALID convs on F.conv{2,3}d


def _is_down(kernel: torch.Tensor, stride: int, padding: str) -> bool:
    """A k4 stride-2 VALID conv: the U-Net's down convs."""
    n = kernel.dim() - 2
    return (tuple(kernel.shape[:n]) == (4,) * n and stride == 2
            and padding == "VALID")


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


# The phase route takes a transposed conv whose Cin * Cout is below this.
# Float32 with TF32 off on an H100 80GB HBM3 (700 W), B=16: at the wf=1
# generator's up1.up (256 -> 128, 13^3 in) the phase conv takes 7.12 ms and
# cuDNN 5.01, at its up0.up (128 -> 64, 22^3 in) 6.56 against 10.79.  With
# 13^3 in, the phase conv wins up to 128 -> 96 (12,288) and loses from
# 192 -> 96 (18,432) on, at B=4, 16 and 128 alike; with 22^3 in, and in the
# slab's B=1 planes, it wins at every width up to 256 -> 128 (PERF.md §6).
PHASE_CIN_COUT_LIMIT = 16384


def _records_grad(x: torch.Tensor, kernel: torch.Tensor) -> bool:
    """Whether a forward on x and kernel records an autograd graph."""
    return torch.is_grad_enabled() and (x.requires_grad
                                        or kernel.requires_grad)


def _func_wrapped(t: torch.Tensor) -> bool:
    """t is wrapped by a ``torch.func`` transform (the train step's vmap
    over stacked networks, ``ensemble_apps``): the wrapper does not show
    whether the tensor under it requires grad, and has no storage."""
    return torch._C._functorch.is_functorch_wrapped_tensor(t)


def phase_route(x: torch.Tensor, kernel: torch.Tensor, stride: int) -> bool:
    """The default of ``conv_transpose_nd(phase_decompose=None)``: the phase
    conv on conv3 for a 3D k4 stride-2 float32 call that records no
    gradient (inference: every inference mode runs under
    ``inference_mode``), with Cin * Cout below :data:`PHASE_CIN_COUT_LIMIT`;
    cuDNN's transposed conv for the rest.

    * float32 with TF32 off: cuDNN's transposed conv runs on the CUDA cores,
      conv3's phase conv on the tensor cores as 3xTF32, at float32's
      accuracy, so the phase form's 27/8 times the MACs (19 of its 27 taps
      a phase are zero) take less time: at the wf=8 generator's up convs
      (B=128) 1.2 and 1.4 ms against cuDNN's 3.3 and 9.4 on an H100.  At
      wide channels and small extents cuDNN's engine catches up
      (:data:`PHASE_CIN_COUT_LIMIT`).
    * bfloat16: cuDNN's transposed conv already runs on the tensor cores.
      The phase form beats it at some shapes and loses at others (at
      wf=8 B=128 0.51 against 0.29 ms at up1.up, 0.83 against 2.29 at
      up0.up; chip_smoke.py phase 12); bf16 stays on cuDNN.
    * 2D: conv3 is 3D only.
    * A forward that records a gradient, or may (an operand wrapped by a
      ``torch.func`` transform): the phase form's backward would be cuDNN's
      k3 backward on 27/8 times the work."""
    return (x.dim() == 5 and kernel.shape[0] == 4 and stride == 2
            and x.dtype == torch.float32
            and kernel.shape[-2] * kernel.shape[-1] < PHASE_CIN_COUT_LIMIT
            and not _records_grad(x, kernel)
            and not (_func_wrapped(x) or _func_wrapped(kernel)))


# The down route takes a k4 stride-2 conv whose output has at least this
# many voxels on every axis: every down conv of the generator at its tile
# and in slabs, and the discriminator's first.  Float32 with TF32 off on an
# H100 80GB HBM3 (700 W), the down4 kernel against cuDNN: the wf=8
# generator's down convs at B=128 2.16 and 0.46 ms against 11.36 and 1.74,
# wf=1's (B=16) 4.23 and 1.53 against 17.58 and 6.08.  With 6^3 out (the
# discriminator's down2) it wins too (0.17 against 0.31 ms at wf=8, B=128),
# but at wf=1's 256 -> 256 its 3xTF32 sums of 16,384 terms are 1.2e-4 of
# the largest value from float64, over conv3's float32 tolerance, so that
# extent stays on cuDNN (PERF.md §6, §7).
DOWN_MIN_OUT = 15


def down_route(x: torch.Tensor, kernel: torch.Tensor, stride: int,
               padding: str) -> bool:
    """Whether ``conv_nd`` runs the call on the down4 kernel
    (``ops/cuda_down.py``): a 3D k4 stride-2 VALID float32 call that
    records no gradient (inference: every inference mode runs under
    ``inference_mode``), with at least :data:`DOWN_MIN_OUT` output voxels
    an axis (every down conv of the generator at its 74^3 tile and in
    slabs, the discriminator's first); ``F.conv{2,3}d`` for the rest.

    * float32 with TF32 off: cuDNN's k4 stride-2 conv runs on the CUDA
      cores (3.6 TFLOP/s at 8 channels, 19 at 64-256), the down4 kernel on
      the tensor cores as 3xTF32, at float32's accuracy.
    * bfloat16: cuDNN's conv already runs on the tensor cores.
    * 2D: the kernel is 3D only.  SAME: the U-Net's down convs are VALID.
    * A forward that records a gradient, or may (an operand wrapped by a
      ``torch.func`` transform): the kernel has no backward, and training
      keeps cuDNN's forward and backward together."""
    return (x.dim() == 5 and _is_down(kernel, stride, padding)
            and x.dtype == torch.float32
            and min(x.shape[1:4]) // 2 - 1 >= DOWN_MIN_OUT
            and not _records_grad(x, kernel)
            and not (_func_wrapped(x) or _func_wrapped(kernel)))


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
    ``phase_decompose`` (k4 s2 only): True computes it as the phase conv,
    one stride-1 k3 conv with 2^n * Cout outputs (on conv3 in 3D), then
    interleaved, the same function summed in another order; False as
    cuDNN's transposed conv; None (default) picks by :func:`phase_route`."""
    n = _spatial_rank(x, kernel)
    k = kernel.shape[0]
    if phase_decompose is None:
        phase_decompose = phase_route(x, kernel, stride)
    if phase_decompose:
        if stride != 2 or k != 4:
            raise ValueError("phase_decompose supports stride=2, k=4 only")
        conv_transpose_nd.phase_calls += 1
        return _conv_transpose_phase(x, kernel)
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    conv_transpose_nd.cudnn_calls += 1
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


conv_transpose_nd.phase_calls = 0  # the phase conv (conv3 in 3D)
conv_transpose_nd.cudnn_calls = 0  # cuDNN's conv_transpose{2,3}d


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


def _derived_kernel(kernel: torch.Tensor, name: str, build
                    ) -> torch.Tensor:
    """build(kernel) (the phase conv's kernel) for a forward that records
    no gradient, cached per parameter under ``name``
    (``cuda_conv.storage_cached``): repeated forwards reuse it, and so
    conv3's tensor-core pack of it, cached on its own storage; an in-place
    update of the parameter (``p.add_`` under ``no_grad``) rebuilds both.
    It is built outside inference mode, so that it has a version counter
    and its pack is cached too."""
    def make():
        with torch.inference_mode(False), torch.no_grad():
            return build(kernel.detach())

    return storage_cached(kernel, name, (), make)


def _conv_transpose_phase(x: torch.Tensor, kernel: torch.Tensor
                          ) -> torch.Tensor:
    k3 = (phase_kernel(kernel) if _records_grad(x, kernel)
          else _derived_kernel(kernel, "_phase_kernels", phase_kernel))
    xp = zero_pad(x, 1)
    y = conv3(xp, k3) if x.dim() == 5 else conv_nd(xp, k3)
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
