"""Intensity scaling and population standardization (counterpart of
transfer_em_tpu/ops/normalize.py, reference transfer_em/datasets/
datasets.py:123-202).

The data pipelines' functions, in plain torch on the batch's device:

* ``scale_tensor``: uint8 -> float32 in [-1, 1] (x / 127.5 - 1), with a
  trailing channel axis;
* ``unscale_to_uint8``: its inverse, rounding half to even and clipping;
* ``standardize_population`` / ``unstandardize_population``: (x - mean) / std
  and back;
* ``get_meanstd``: the reference's MEAN OF MEANS and MEAN OF VARIANCES over
  the dataset's elements (datasets.py:173-190), deliberately not the pooled
  variance.

The pipelines scale first and standardize after the custom map, in two
roundings; the folded affine ``preprocess_u8`` of the tile step rounds once
and is not used there.

The tile step's uint8 edges run on the hand-written kernels of
``ops/cuda_kernels.py`` (plain PyTorch on the CPU):

* ``preprocess_u8``: uint8 -> float32 scale + standardize, one affine pass
  (normalize.py:78-91), with a trailing channel axis;
* ``postprocess_to_u8``: unstandardize, rescale, round half to even, clip
  (normalize.py:94-102), here with the tile step's tpad trim folded in and
  the channel axis dropped.
"""

from __future__ import annotations

import math
from typing import Iterable, Tuple

import torch

from .cuda_kernels import postprocess_u8 as postprocess_to_u8
from .cuda_kernels import preprocess_u8

MeanStd = Tuple[float, float]


def scale_tensor(x: torch.Tensor) -> torch.Tensor:
    """uint8 volume -> float32 in [-1, 1] with a trailing channel axis
    (reference datasets.py:193-202)."""
    return (x.to(torch.float32) / 127.5 - 1.0).unsqueeze(-1)


def unscale_to_uint8(x: torch.Tensor) -> torch.Tensor:
    """[-1, 1] float -> uint8, rounded half to even (reference utils.py:
    109-118)."""
    return torch.round((x + 1.0) * 127.5).clamp(0, 255).to(torch.uint8)


def standardize_population(x: torch.Tensor, meanstd: MeanStd) -> torch.Tensor:
    mean, std = meanstd
    return (x - mean) / std


def unstandardize_population(x: torch.Tensor,
                             meanstd: MeanStd) -> torch.Tensor:
    mean, std = meanstd
    return x * std + mean


def get_meanstd(elements: Iterable[torch.Tensor]) -> MeanStd:
    """Population statistics over (already scaled) elements: the mean of
    the per-element float32 means and sqrt of the mean of the per-element
    variances.  The per-element statistics stay on the elements' device and
    are read once, at the end."""
    means, variances = [], []
    for el in elements:
        el = torch.as_tensor(el).to(torch.float32)
        variances.append(torch.var(el, correction=0))
        means.append(torch.mean(el))
    if not means:
        raise ValueError("empty dataset: cannot compute mean/std")
    m = torch.stack(means).to("cpu", torch.float64)
    v = torch.stack(variances).to("cpu", torch.float64)
    return float(m.mean()), math.sqrt(float(v.mean()))


__all__ = ["scale_tensor", "unscale_to_uint8", "standardize_population",
           "unstandardize_population", "get_meanstd", "preprocess_u8",
           "postprocess_to_u8"]
