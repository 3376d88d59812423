"""Seeded inputs that the benchmark makes and hands to both the system and
the reference: EM-like uint8 volumes, tile crops and normalisation
constants."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.pipeline import derive_seed


def synth_volume(extent: int, seed: int) -> np.ndarray:
    """Smooth EM-like uint8 texture (8^3 box-filtered noise), zyx, made on
    the host (the streaming recipe's volume)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(extent + 8,) * 3).astype(np.float32)
    c = np.cumsum(np.cumsum(np.cumsum(v, 0), 1), 2)
    s = (c[8:, 8:, 8:] - c[:-8, 8:, 8:] - c[8:, :-8, 8:] - c[8:, 8:, :-8]
         + c[:-8, :-8, 8:] + c[:-8, 8:, :-8] + c[8:, :-8, :-8]
         - c[:-8, :-8, :-8])
    s = (s - s.min()) / max(float(np.ptp(s)), 1e-6)
    return (s * 255).astype(np.uint8)


def device_volume(extent: int, seed: int, device) -> torch.Tensor:
    """The same kind of texture made on ``device`` in a few calls (noise
    from a generator there, an 8^3 mean filter, stretched to [0, 255])."""
    g = torch.Generator(device=device).manual_seed(int(seed))
    v = torch.randn((1, 1) + (extent + 7,) * 3, generator=g, device=device)
    s = F.avg_pool3d(v, 8, stride=1)[0, 0]
    lo, hi = s.min(), s.max()
    return ((s - lo) / (hi - lo).clamp_min(1e-6) * 255).to(torch.uint8)


def crops(vol: np.ndarray, n: int, side: int, seed: int) -> List[np.ndarray]:
    """``n`` cubes of ``side`` at corners drawn from ``seed``."""
    rng = np.random.default_rng(seed)
    corners = rng.integers(0, np.asarray(vol.shape) - side + 1, size=(n, 3))
    return [np.ascontiguousarray(vol[z:z + side, y:y + side, x:x + side])
            for z, y, x in corners]


def meanstd(seed: int, word: int) -> Tuple[float, float]:
    """A domain's (mean, std) for the tile step, from the seed."""
    rng = np.random.default_rng(derive_seed(seed, 7, word))
    return float(rng.uniform(-0.1, 0.1)), float(rng.uniform(0.3, 0.6))
