"""Synthetic-domain warping: box blur + dilated random holes (counterpart of
transfer_em_tpu/ops/warp.py, reference transfer_em/debug.py:7-63
``warp_tensor``).

From a scaled [-1, 1] element of the target domain it makes an artificial
source domain:

1. a 3^n box blur (SAME), n = 3 spatial axes, or 2 for a 2D image;
2. holes: voxels drawn with probability HOLE_RATE = 4/128**2, the mask
   dilated by an all-ones 4^n SAME conv;
3. the holes filled with the mean of the BLURRED element.

The two convs are small depthwise convs that the JAX package leaves to
XLA, so they stay on ``F.conv3d`` / ``F.conv2d`` through
``ops/convs.conv_cudnn``, whatever form ``conv_nd`` would pick.  The even
4^n SAME kernel pads (1, 2) on every axis, as XLA does
(tests/test_torch_warp_augment.py pins it against the JAX function in 3D,
tests/test_torch_2d_train.py in 2D).

The hole mask is the only randomness: ``torch.rand`` from a
``torch.Generator`` on the element's device, seeded with an integer
``key``, so a warp is a pure function of (key, element) on one device (a
CUDA generator draws other bits than a CPU one, and neither draws JAX's).
"""

from __future__ import annotations

import torch

from ..rng import derive_seed
from .convs import conv_cudnn

HOLE_RATE = 4.0 / (128 * 128)


def _box_filter(k: int, normalize: bool, device,
                ndim: int = 3) -> torch.Tensor:
    w = torch.ones((k,) * ndim + (1, 1), dtype=torch.float32, device=device)
    return w / k ** ndim if normalize else w


def hole_mask(shape, key: int, device) -> torch.Tensor:
    """float32 0/1 mask of ``shape``: each voxel 1 with probability
    HOLE_RATE, drawn from a generator on ``device`` seeded with ``key``."""
    g = torch.Generator(device=device).manual_seed(int(key))
    u = torch.rand(tuple(shape), generator=g, device=device)
    return (u < HOLE_RATE).to(torch.float32)


def warp_with_mask(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """The deterministic part of the warp on a batch (B, *S, 1), 2D or 3D,
    given its hole masks (same shape, 0/1): blur, dilate the holes, fill
    them with each element's blurred mean."""
    n = x.dim() - 2
    xb = conv_cudnn(x, _box_filter(3, True, x.device, n), padding="SAME")
    holes = conv_cudnn(mask, _box_filter(4, False, x.device, n),
                       padding="SAME")
    mean = xb.mean(dim=tuple(range(1, x.dim())), keepdim=True)
    return torch.where(holes > 0, mean, xb)


def warp(x: torch.Tensor, key: int) -> torch.Tensor:
    """Warp one element, (D, H, W, 1) or (H, W, 1); ``key`` (an int) seeds
    the holes."""
    return warp_with_mask(x[None], hole_mask(x.shape, key, x.device)[None])[0]


def batch_warp(x: torch.Tensor, key: int) -> torch.Tensor:
    """Warp a batch (B, *S, 1); element i's holes are seeded with
    ``derive_seed(key, i)``."""
    masks = torch.stack([hole_mask(x.shape[1:], derive_seed(key, i), x.device)
                         for i in range(x.shape[0])])
    return warp_with_mask(x, masks)


def make_warp_map(seed: int = 0):
    """A per-element warp map for the dataset pipelines' ``custom_map``:
    ``f(element, key) -> warped``, where ``key`` is the integer the pipeline
    passes (a pure function of its seed and the element's id) or any stream
    index; the holes are seeded with ``derive_seed(seed, key)``."""

    def _map(el: torch.Tensor, key: int) -> torch.Tensor:
        return warp(el, derive_seed(seed, key))

    return _map
