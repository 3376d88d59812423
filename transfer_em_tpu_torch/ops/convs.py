"""k4 stride-2 convolutions and crop helpers, channels last.

Counterpart of ``transfer_em_tpu/ops/convs.py``.  The JAX package computes
these convs with XLA outside any Pallas kernel, so the port leaves them to
``torch.nn.functional`` (cuDNN on the card).  Activations stay channels-last
(NDHWC) and kernels in the JAX layout (DHWIO), so both packages take the
same tensors at their public functions:

* ``conv_nd``: VALID (or SAME) strided conv; DHWIO -> OIDHW is
  ``permute(4, 3, 0, 1, 2)``.
* ``conv_transpose_nd``: TF-SAME k4 stride-2 transposed conv (reference
  Keras ``Conv3DTranspose``, convs.py:84-132) ==
  ``F.conv_transpose3d(stride=2, padding=1)`` with the (k,k,k,Cin,Cout)
  kernel as ``permute(3, 4, 0, 1, 2)`` and NO spatial flip (the JAX version
  flips because it writes the transposed conv as a forward conv on the
  dilated input; ``conv_transpose3d`` is the adjoint itself).  Pinned against
  the JAX function in tests/test_torch_ops.py.

An NDHWC tensor permuted to NCDHW is a channels_last_3d view, which cuDNN
takes without a copy.
"""

from __future__ import annotations

from typing import Sequence, Union

import torch
import torch.nn.functional as F

_TO_NCDHW = (0, 4, 1, 2, 3)
_TO_NDHWC = (0, 2, 3, 4, 1)


def _check_3d(x: torch.Tensor, kernel: torch.Tensor) -> None:
    if x.dim() != 5 or kernel.dim() != 5:
        raise ValueError(
            f"this slice of the port is 3D (NDHWC x DHWIO); got x "
            f"{tuple(x.shape)}, kernel {tuple(kernel.shape)}")


def conv_nd(x: torch.Tensor, kernel: torch.Tensor, *, stride: int = 1,
            padding: str = "VALID") -> torch.Tensor:
    """(B, D, H, W, Cin) * (k, k, k, Cin, Cout) -> (B, D', H', W', Cout),
    in x's dtype (the kernel is cast to it)."""
    _check_3d(x, kernel)
    pad = {"VALID": "valid", "SAME": "same"}[padding]
    if pad == "same" and stride != 1:
        raise ValueError("SAME padding is supported at stride 1 only")
    w = kernel.to(x.dtype).permute(4, 3, 0, 1, 2)
    y = F.conv3d(x.permute(_TO_NCDHW), w, stride=stride, padding=pad)
    return y.permute(_TO_NDHWC).contiguous()


def conv_transpose_nd(x: torch.Tensor, kernel: torch.Tensor, *,
                      stride: int = 2) -> torch.Tensor:
    """TF-exact stride-2 SAME transposed conv: (B, n, n, n, Cin) *
    (4, 4, 4, Cin, Cout) -> (B, 2n, 2n, 2n, Cout)."""
    _check_3d(x, kernel)
    if stride != 2 or kernel.shape[0] != 4:
        raise ValueError("conv_transpose_nd supports k=4, stride=2 (the "
                         "generator's up convs)")
    w = kernel.to(x.dtype).permute(3, 4, 0, 1, 2)
    y = F.conv_transpose3d(x.permute(_TO_NCDHW), w, stride=2, padding=1)
    return y.permute(_TO_NDHWC).contiguous()


def center_crop(x: torch.Tensor,
                crop: Union[int, Sequence[Sequence[int]]]) -> torch.Tensor:
    """Crop every spatial axis by ``crop`` per face, or by (lo, hi) pairs
    per axis (Keras Cropping3D)."""
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
    ZeroPadding3D), channels last."""
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
