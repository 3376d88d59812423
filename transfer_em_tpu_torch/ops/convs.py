"""k4 stride-2 convolutions and crop helpers, channels last, 2D or 3D.

Counterpart of ``transfer_em_tpu/ops/convs.py``.  The JAX package computes
these convs with XLA outside any Pallas kernel, so the port leaves them to
``torch.nn.functional`` (cuDNN on the card).  Activations stay channels-last
(NHWC / NDHWC) and kernels in the JAX layout (HWIO / DHWIO), so both
packages take the same tensors at their public functions:

* ``conv_nd``: VALID (or SAME) strided conv; the kernel's (k.., Cin, Cout)
  -> (Cout, Cin, k..) is ``permute(n + 1, n, 0, .., n - 1)`` for n spatial
  axes.
* ``conv_transpose_nd``: TF-SAME k4 stride-2 transposed conv (reference
  Keras ``Conv2DTranspose`` / ``Conv3DTranspose``, convs.py:84-132) ==
  ``F.conv_transpose{2,3}d(stride=2, padding=1)`` with the (k.., Cin, Cout)
  kernel as (Cin, Cout, k..) and NO spatial flip (the JAX version flips
  because it writes the transposed conv as a forward conv on the dilated
  input; ``conv_transpose{2,3}d`` is the adjoint itself).  Pinned against
  the JAX function in tests/test_torch_ops.py (3D) and
  tests/test_torch_2d_models.py (2D).

An NDHWC (NHWC) tensor permuted to NCDHW (NCHW) is a channels_last view,
which cuDNN takes without a copy.  On the CPU the permuted kernel is made
contiguous: there PyTorch's ``slow_conv2d``, which it picks for some shapes
(a 2D batch of one), refuses a strided weight gradient.
"""

from __future__ import annotations

from typing import Sequence, Union

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


def conv_nd(x: torch.Tensor, kernel: torch.Tensor, *, stride: int = 1,
            padding: str = "VALID") -> torch.Tensor:
    """(B, *S, Cin) * (*k, Cin, Cout) -> (B, *S', Cout), 2D or 3D, in x's
    dtype (the kernel is cast to it)."""
    n = _spatial_rank(x, kernel)
    pad = {"VALID": "valid", "SAME": "same"}[padding]
    if pad == "same" and stride != 1:
        raise ValueError("SAME padding is supported at stride 1 only")
    w = _weight(kernel.to(x.dtype).permute(n + 1, n, *range(n)))
    y = _CONV[n](_to_channels_first(x), w, stride=stride, padding=pad)
    return _to_channels_last(y)


def conv_transpose_nd(x: torch.Tensor, kernel: torch.Tensor, *,
                      stride: int = 2) -> torch.Tensor:
    """TF-exact stride-2 SAME transposed conv, 2D or 3D: (B, *n, Cin) *
    (4.., Cin, Cout) -> (B, *2n, Cout)."""
    n = _spatial_rank(x, kernel)
    if stride != 2 or kernel.shape[0] != 4:
        raise ValueError("conv_transpose_nd supports k=4, stride=2 (the "
                         "generator's up convs)")
    w = _weight(kernel.to(x.dtype).permute(n, n + 1, *range(n)))
    y = _CONV_T[n](_to_channels_first(x), w, stride=2, padding=1)
    return _to_channels_last(y)


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
