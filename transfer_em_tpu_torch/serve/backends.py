"""Volume read backends for the serving layer.

Own copy of ``transfer_em_tpu/serve/backends.py`` minus tensorstore (a later
slice).  ``read(start_xyz, size_xyz)`` returns uint8 C-order zyx bytes ==
F-order xyz, the reference data service's contract (cloudrun_functions/
transferem.py:146-180); out-of-bounds reads zero-fill.
"""

from __future__ import annotations

import functools
from typing import Dict

import numpy as np

from ..native import gather_box


class VolumeBackend:
    """read(start_xyz, size_xyz) -> uint8 zyx C-order array."""

    def read(self, start, size) -> np.ndarray:
        raise NotImplementedError


class NumpyVolume(VolumeBackend):
    """Backend over a zyx uint8 array (or .npy path); OOB reads zero-fill."""

    def __init__(self, vol_or_path):
        if isinstance(vol_or_path, str):
            vol_or_path = np.load(vol_or_path)
        # uint8 only: a cast here would wrap mod 256 or truncate floats and
        # serve garbled voxels with no error.
        if np.asarray(vol_or_path).dtype != np.uint8:
            raise ValueError(
                f"NumpyVolume requires uint8 (got "
                f"{np.asarray(vol_or_path).dtype}); the serving byte "
                "contract is uint8-only")
        self.vol = np.ascontiguousarray(vol_or_path, np.uint8)

    def read(self, start, size) -> np.ndarray:
        return gather_box(self.vol, start, size)


_REGISTRY: Dict[str, VolumeBackend] = {}


def register_volume(location: str, backend: VolumeBackend) -> None:
    """Expose a backend under a location string (tests, local serving)."""
    _REGISTRY[location] = backend


@functools.lru_cache(maxsize=16)
def _open_npy(location: str) -> VolumeBackend:
    return NumpyVolume(location)


def open_volume(location: str) -> VolumeBackend:
    """Resolve a location: a registered backend, else a ``.npy`` path
    (cached).  Other locations (ng-precomputed via tensorstore) belong to a
    later slice of the port."""
    if location in _REGISTRY:
        return _REGISTRY[location]
    if location.endswith(".npy"):
        return _open_npy(location)
    raise NotImplementedError(
        f"location {location!r}: this slice serves registered volumes and "
        ".npy files; tensorstore volumes come with a later slice")
