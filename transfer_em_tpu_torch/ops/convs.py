"""Convolutions and crop helpers, channels last, 2D or 3D; the one place
that picks the kernel each float conv runs on.

Counterpart of ``transfer_em_tpu/ops/convs.py``.  Activations stay
channels-last (NHWC / NDHWC) and kernels in the JAX layout (HWIO / DHWIO),
so both packages take the same tensors at their public functions.

**The routes.**  :func:`conv_form` reads each call (its rank, kernel,
stride, padding, dtype, whether it records a gradient) and names the form
that runs it; :func:`conv_nd` and :func:`conv_transpose_nd` run that form.
The int8 convs (``ops/quant.py``) are a model's configuration, not a
route: ``models/blocks.py`` takes them by its ``int8_conv`` flag.

================  ===================================================
form              takes
================  ===================================================
``"conv3"``       a 3D 3x3x3 stride-1 conv, VALID or SAME (zero-padded
                  by 1 a face first), float32 or bfloat16, with or
                  without a gradient: the conv3 kernels
                  (``ops/cuda_conv.py``), the LeakyReLU in their epilogue
``"down4"``       a 3D k4 stride-2 VALID conv in float32 inference with
                  at least :data:`DOWN_MIN_OUT` outputs an axis: the down4
                  kernel (``ops/cuda_down.py``), the LeakyReLU in its
                  epilogue
``"phase"``       a 3D k4 stride-2 transposed conv in float32 inference
                  with Cin * Cout under :data:`PHASE_CIN_COUT_LIMIT`: the
                  phase conv, one k3 conv on conv3 (:func:`phase_kernel`,
                  :func:`interleave_phases`)
``"cudnn"``       every other conv: ``torch.nn.functional`` (cuDNN on the
                  card; :func:`conv_cudnn`), then the leaky_relu kernel
                  (``ops/cuda_kernels.py``)
================  ===================================================

"Float32 inference" is a 3D float32 call that records no gradient (every
inference mode runs under ``inference_mode``) and whose operands no
``torch.func`` transform wraps (the train step's vmap over stacked
networks, ``ensemble_apps``, hides whether they require grad):

* float32 with TF32 off: cuDNN's k4 stride-2 and transposed convs run on
  the CUDA cores (3.6 TFLOP/s at 8 channels, 19 at 64-256), the down4 and
  conv3 kernels on the tensor cores as 3xTF32, at float32's accuracy.  The
  phase form's 27/8 times the MACs (19 of its 27 taps a phase are zero)
  still take less time: at the wf=8 generator's up convs (B=128) 1.2 and
  1.4 ms against cuDNN's 3.3 and 9.4 on an H100.
* bfloat16: cuDNN's convs already run on the tensor cores.  The phase form
  beats cuDNN's transposed conv at some shapes and loses at others (at wf=8
  B=128 0.51 against 0.29 ms at up1.up, 0.83 against 2.29 at up0.up;
  chip_smoke.py phase 12).
* 2D: the kernels are 3D only, as the JAX package gates its Pallas conv on
  ``ndim == 3``.
* A forward that records a gradient: down4 has no backward, the phase
  form's backward would be cuDNN's k3 backward on 27/8 times the work, and
  training keeps cuDNN's forward and backward together.  conv3 carries its
  own autograd Function (``ops/cuda_conv.py``), so it trains.

The forms' counts (``ops/counts.py``): ``down_k4`` and ``down_cudnn`` count
the k4 stride-2 VALID convs by form, ``transpose_phase`` and
``transpose_cudnn`` the transposed convs.

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
  tests/test_torch_2d_models.py (2D).  The phase form computes the same
  function as the JAX package's subpixel formulation (convs.py:135-189):
  one k3 VALID conv over x padded by 1, with 2^n * Cout output channels
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

from .. import telemetry
from ..kernels import DTYPE_CODES
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


# The phase form takes a transposed conv whose Cin * Cout is below this.
# Float32 with TF32 off on an H100 80GB HBM3 (700 W), B=16: at the wf=1
# generator's up1.up (256 -> 128, 13^3 in) the phase conv takes 7.12 ms and
# cuDNN 5.01, at its up0.up (128 -> 64, 22^3 in) 6.56 against 10.79.  With
# 13^3 in, the phase conv wins up to 128 -> 96 (12,288) and loses from
# 192 -> 96 (18,432) on, at B=4, 16 and 128 alike; with 22^3 in, and in the
# slab's B=1 planes, it wins at every width up to 256 -> 128 (PERF.md §6).
PHASE_CIN_COUT_LIMIT = 16384

# The down4 form takes a k4 stride-2 conv whose output has at least this
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


def _records_grad(x: torch.Tensor, kernel: torch.Tensor) -> bool:
    """Whether a forward on x and kernel records an autograd graph."""
    return torch.is_grad_enabled() and (x.requires_grad
                                        or kernel.requires_grad)


def _func_wrapped(t: torch.Tensor) -> bool:
    """t is wrapped by a ``torch.func`` transform: the wrapper does not
    show whether the tensor under it requires grad, and has no storage."""
    return torch._C._functorch.is_functorch_wrapped_tensor(t)


def _f32_inference(x: torch.Tensor, kernel: torch.Tensor) -> bool:
    """A 3D float32 call that records no gradient and whose operands no
    ``torch.func`` transform wraps (module docstring)."""
    return (x.dim() == 5 and x.dtype == torch.float32
            and not _records_grad(x, kernel)
            and not (_func_wrapped(x) or _func_wrapped(kernel)))


def _is_down(kernel: torch.Tensor, stride: int, padding: str) -> bool:
    """A k4 stride-2 VALID conv: the U-Net's down convs."""
    n = kernel.dim() - 2
    return (tuple(kernel.shape[:n]) == (4,) * n and stride == 2
            and padding == "VALID")


def conv_form(x: torch.Tensor, kernel: torch.Tensor, stride: int = 1,
              padding: str = "VALID", transpose: bool = False) -> str:
    """The form that runs a conv of x by kernel: ``"conv3"``, ``"down4"``,
    ``"phase"`` or ``"cudnn"`` (the module docstring's table).
    ``transpose``: the TF-SAME transposed conv of :func:`conv_transpose_nd`
    (``padding`` unread)."""
    n = x.dim() - 2
    if transpose:
        return ("phase" if tuple(kernel.shape[:n]) == (4,) * n
                and stride == 2
                and kernel.shape[-2] * kernel.shape[-1] < PHASE_CIN_COUT_LIMIT
                and _f32_inference(x, kernel) else "cudnn")
    if (n == 3 and tuple(kernel.shape[:3]) == (3, 3, 3) and stride == 1
            and x.dtype in DTYPE_CODES):
        return "conv3"
    if (_is_down(kernel, stride, padding) and _f32_inference(x, kernel)
            and min(x.shape[1:4]) // 2 - 1 >= DOWN_MIN_OUT):
        return "down4"
    return "cudnn"


def conv_nd(x: torch.Tensor, kernel: torch.Tensor, *, stride: int = 1,
            padding: str = "VALID", leaky: Optional[float] = None
            ) -> torch.Tensor:
    """(B, *S, Cin) * (*k, Cin, Cout) -> (B, *S', Cout), 2D or 3D, in x's
    dtype, on the form :func:`conv_form` picks.  ``padding="SAME"`` pads as
    XLA does (:func:`same_padding`, split unevenly where the total is
    odd).  ``leaky`` applies LeakyReLU(negative_slope=leaky) to the result,
    in the conv3 and down4 kernels' epilogue.  conv3 takes the kernel as
    it is, a float32 parameter under a bfloat16 x too (its packs are
    cached per parameter; a per-call cast is not); the other forms cast it
    to x's dtype."""
    _spatial_rank(x, kernel)
    if padding not in ("VALID", "SAME"):
        raise ValueError(f"padding must be VALID or SAME, got {padding!r}")
    form = conv_form(x, kernel, stride, padding)
    if form == "conv3":
        return conv3(zero_pad(x, 1) if padding == "SAME" else x, kernel,
                     leaky)
    if form == "down4":
        telemetry.count("down_k4")
        return down4(x, kernel, leaky)
    if _is_down(kernel, stride, padding):
        telemetry.count("down_cudnn")
    return conv_cudnn(x, kernel, stride=stride, padding=padding, leaky=leaky)


def conv_cudnn(x: torch.Tensor, kernel: torch.Tensor, *, stride: int = 1,
               padding: str = "VALID", leaky: Optional[float] = None
               ) -> torch.Tensor:
    """:func:`conv_nd` on ``F.conv{2,3}d`` whatever the call (cuDNN on the
    card), the kernel cast to x's dtype, then the leaky_relu kernel: the
    form that :func:`conv_nd` falls back to, and the one the warp's box
    filters (``ops/warp.py``) take by name.  At stride 1 SAME is torch's
    ``padding="same"``; at a larger stride an explicit pad and a VALID
    conv (torch refuses "same" there)."""
    n = _spatial_rank(x, kernel)
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
    ``phase_decompose`` (k4 s2 only): True computes it as the phase conv,
    one stride-1 k3 conv with 2^n * Cout outputs (through :func:`conv_nd`:
    conv3 in 3D), then interleaved, the same function summed in another
    order; False as cuDNN's transposed conv; None (default) as
    :func:`conv_form` picks."""
    n = _spatial_rank(x, kernel)
    k = kernel.shape[0]
    if phase_decompose is None:
        phase_decompose = conv_form(x, kernel, stride,
                                    transpose=True) == "phase"
    if phase_decompose:
        if stride != 2 or k != 4:
            raise ValueError("phase_decompose supports stride=2, k=4 only")
        telemetry.count("transpose_phase")
        return _conv_transpose_phase(x, kernel)
    if stride < 1:
        raise ValueError(f"stride must be >= 1, got {stride}")
    telemetry.count("transpose_cudnn")
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
    """The phase form.  For a forward that records no gradient the phase
    kernel is cached per parameter (``cuda_conv.storage_cached``):
    repeated forwards reuse it, and so conv3's pack of it, cached on its
    own storage; an in-place update of the parameter (``p.add_`` under
    ``no_grad``) rebuilds both.  It is built outside inference mode, so
    that it has a version counter and its pack is cached too."""
    def make():
        with torch.inference_mode(False), torch.no_grad():
            return phase_kernel(kernel.detach())

    k3 = (phase_kernel(kernel) if _records_grad(x, kernel)
          else storage_cached(kernel, "_phase_kernels", (), make))
    y = conv_nd(zero_pad(x, 1), k3)
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
