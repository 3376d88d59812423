"""Random augmentation: axis transpose, flips, intensity jitter (counterpart
of transfer_em_tpu/ops/augment.py, reference datasets/datasets.py:123-155
``augment``):

* a permutation of the spatial axes, by index into the
  ``itertools.permutations`` table (the channel axis stays last);
* each spatial axis flipped independently with p = 0.5;
* the jitter x * U(1, 1.05) + U(-0.05, 0.05).

The few parameters of an element are drawn on the host by
``np.random.default_rng(key)`` and applied on the element's device, so an
augmentation is a pure function of (key, element) and costs the device no
read-back.
"""

from __future__ import annotations

import itertools
from typing import Tuple

import numpy as np
import torch

from ..rng import derive_seed

AugmentParams = Tuple[int, Tuple[bool, ...], float, float]


def _perm_table(ndim: int) -> Tuple[Tuple[int, ...], ...]:
    return tuple(itertools.permutations(range(ndim)))


def augment_params(key: int, ndim: int) -> AugmentParams:
    """(permutation index, flips per spatial axis, mean shift, variance
    scale) drawn from ``np.random.default_rng(key)``."""
    rng = np.random.default_rng(int(key))
    idx = int(rng.integers(0, len(_perm_table(ndim))))
    flips = tuple(bool(f) for f in rng.random(ndim) < 0.5)
    mean_adj = float(rng.uniform(-0.05, 0.05))
    var_adj = float(rng.uniform(1.0, 1.05))
    return idx, flips, mean_adj, var_adj


def apply_augment(x: torch.Tensor, params: AugmentParams) -> torch.Tensor:
    """One element (*spatial, C): transpose by the table's entry, then flip
    the chosen axes of the transposed element, then the jitter."""
    idx, flips, mean_adj, var_adj = params
    ndim = x.dim() - 1
    x = x.permute(_perm_table(ndim)[idx] + (ndim,))
    dims = [d for d in range(ndim) if flips[d]]
    if dims:
        x = torch.flip(x, dims)
    return x * var_adj + mean_adj


def augment(x: torch.Tensor, key: int) -> torch.Tensor:
    """Augment one element (*spatial, C) with parameters drawn from
    ``key``."""
    return apply_augment(x, augment_params(key, x.dim() - 1))


def batch_augment(x: torch.Tensor, key: int) -> torch.Tensor:
    """Augment a batch (B, *spatial, C); element i draws from
    ``derive_seed(key, i)``."""
    return torch.stack([augment(x[i], derive_seed(key, i))
                        for i in range(x.shape[0])])
