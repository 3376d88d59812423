"""Plain versions of the training data pipeline's host draws and device
transforms (janelia-flyem/transfer_em datasets/datasets.py: scale to
[-1, 1], population standardisation by the mean of the elements' means and
the mean of their variances, the random axis transpose, flips and intensity
jitter), with the seeding rule of the system's pipeline written out again:

* ``derive_seed(*words)``: numpy ``SeedSequence(words)``'s first 64-bit
  word, top bit cleared;
* an epoch ``e`` of a shuffled in-memory dataset of ``n`` elements visits
  ``default_rng(derive_seed(seed, 911, e, 0)).permutation(n)`` in batches
  of ``B`` (the remainder dropped);
* batch ``b`` of epoch ``e`` augments its ``i``-th element with
  ``default_rng(derive_seed(derive_seed(seed, 911, e, 1000 + b), i))``:
  a permutation index into ``itertools.permutations(range(3))``, three
  flips (< 0.5), a shift U(-0.05, 0.05) and a scale U(1, 1.05).

Batches are (B, 1, D, H, W) float32 here (NCDHW).
"""

from __future__ import annotations

import itertools
import math
from typing import List, Sequence, Tuple

import numpy as np
import torch

EPOCHS = 911
PERMS = tuple(itertools.permutations(range(3)))


def derive_seed(*words: int) -> int:
    state = np.random.SeedSequence([int(w) for w in words]).generate_state(
        1, np.uint64)
    return int(state[0]) & (2 ** 63 - 1)


def scale(x_u8: torch.Tensor) -> torch.Tensor:
    return x_u8.to(torch.float32) / 127.5 - 1.0


def meanstd(elements_u8: Sequence[torch.Tensor]) -> Tuple[float, float]:
    """Mean of the scaled elements' means and the square root of the mean
    of their (population) variances, each element's in float32."""
    means, variances = [], []
    for el in elements_u8:
        x = scale(el)
        means.append(float(x.mean()))
        variances.append(float(x.var(correction=0)))
    return (float(np.mean(np.asarray(means, np.float64))),
            math.sqrt(float(np.mean(np.asarray(variances, np.float64)))))


def augment_params(key: int):
    rng = np.random.default_rng(int(key))
    idx = int(rng.integers(0, len(PERMS)))
    flips = tuple(bool(f) for f in rng.random(3) < 0.5)
    shift = float(rng.uniform(-0.05, 0.05))
    gain = float(rng.uniform(1.0, 1.05))
    return idx, flips, shift, gain


def augment(x: torch.Tensor, key: int) -> torch.Tensor:
    """One element (D, H, W): the axes permuted, then the chosen axes of the
    permuted element flipped, then x * gain + shift."""
    idx, flips, shift, gain = augment_params(key)
    x = x.permute(PERMS[idx])
    dims = [d for d in range(3) if flips[d]]
    if dims:
        x = torch.flip(x, dims)
    return x * gain + shift


def batch_order(n: int, batch: int, seed: int, epoch: int,
                shuffle: bool) -> List[np.ndarray]:
    order = (np.random.default_rng(derive_seed(seed, EPOCHS, epoch, 0))
             .permutation(n) if shuffle else np.arange(n))
    return [order[s:s + batch] for s in range(0, n - batch + 1, batch)]


def make_batch(elements_u8: Sequence[torch.Tensor], ms: Tuple[float, float],
               seed: int, epoch: int, b: int, idx) -> torch.Tensor:
    """Batch ``b`` of epoch ``epoch``: the elements ``idx`` scaled,
    standardised and augmented, (B, 1, D, H, W)."""
    key = derive_seed(seed, EPOCHS, epoch, 1000 + b)
    mean, std = ms
    out = []
    for i, j in enumerate(idx):
        x = (scale(elements_u8[int(j)]) - mean) / std
        out.append(augment(x, derive_seed(key, i)))
    return torch.stack(out).unsqueeze(1)


def batches(elements_u8: Sequence[torch.Tensor], batch: int, seed: int,
            shuffle: bool, count: int) -> List[torch.Tensor]:
    """The first ``count`` batches of the dataset, epoch after epoch."""
    ms = meanstd(elements_u8)
    out, epoch = [], 0
    while len(out) < count:
        for b, idx in enumerate(batch_order(len(elements_u8), batch, seed,
                                            epoch, shuffle)):
            if len(out) == count:
                break
            out.append(make_batch(elements_u8, ms, seed, epoch, b, idx))
        epoch += 1
    return out
