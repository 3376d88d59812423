"""Volume read backends for the serving layer.

Own copy of ``transfer_em_tpu/serve/backends.py``.  ``read(start_xyz,
size_xyz)`` returns uint8 C-order zyx bytes == F-order xyz, the reference
data service's contract (cloudrun_functions/transferem.py:146-180);
out-of-bounds reads zero-fill.  Loads no torch: the data service forks
worker processes from a process that imports this module.
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


class TensorstoreVolume(VolumeBackend):
    """neuroglancer-precomputed backend (reference cloudrun_functions/
    transferem.py:131-180): ``location`` is 'bucket/path' (GCS) or
    'file://...'.  Out-of-domain reads zero-fill through
    ``data.sources.read_ts_box_zyx`` (tensorstore itself raises OutOfRange;
    tiled requests read halos past the volume's faces)."""

    def __init__(self, location: str, scale_index: int = 0):
        from ..data.sources import open_tensorstore
        self.ds = open_tensorstore(location, scale_index)
        # uint8 only, as NumpyVolume: another dtype assigned into the
        # zero-filled uint8 buffer would truncate mod 256.
        if np.dtype(self.ds.dtype.numpy_dtype) != np.uint8:
            raise ValueError(
                f"volume at {location!r} has dtype {self.ds.dtype}, but the "
                "serving byte contract is uint8-only")
        self._lo = np.asarray(self.ds.domain.inclusive_min[:3], np.int64)
        self._hi = np.asarray(self.ds.domain.exclusive_max[:3], np.int64)

    def read(self, start, size) -> np.ndarray:
        from ..data.sources import read_ts_box_zyx
        return read_ts_box_zyx(self.ds, start, size, self._lo, self._hi)


_REGISTRY: Dict[str, VolumeBackend] = {}


def register_volume(location: str, backend: VolumeBackend) -> None:
    """Expose a backend under a location string (tests, local serving)."""
    _REGISTRY[location] = backend


@functools.lru_cache(maxsize=16)
def _open_uncached(location: str, scale_index: int) -> VolumeBackend:
    if location.endswith(".npy"):
        return NumpyVolume(location)
    return TensorstoreVolume(location, scale_index)


def open_volume(location: str, scale_index: int = 0) -> VolumeBackend:
    """Resolve a location: a registered backend first, else a backend
    cached by (location, scale_index), so a fleet of chunk requests against
    one volume opens it (tensorstore's metadata read) once: ``.npy`` ->
    NumpyVolume, anything else -> TensorstoreVolume."""
    if location in _REGISTRY:
        return _REGISTRY[location]
    return _open_uncached(location, scale_index)
