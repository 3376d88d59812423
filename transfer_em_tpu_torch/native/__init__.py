"""Native (C++) host runtime: tile scatter/gather via ctypes.

Own copy of ``transfer_em_tpu/native`` (scatter.cpp is the same source).
Builds ``scatter.cpp`` with g++ on first use into the port's build directory
``transfer_em_tpu_torch/_build/`` (gitignored), never beside the JAX copy;
falls back to numpy loops when no compiler is available.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
import warnings
from typing import Optional, Sequence, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "scatter.cpp")
_BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")
_LIB_PATH = os.path.join(_BUILD_DIR, "libtemnative.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _build() -> Optional[ctypes.CDLL]:
    global _build_failed
    os.makedirs(_BUILD_DIR, exist_ok=True)
    tmp = f"{_LIB_PATH}.{os.getpid()}.tmp"
    try:
        subprocess.check_call(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17",
             "-o", tmp, _SRC, "-lpthread"],
            stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
        os.replace(tmp, _LIB_PATH)
    except (OSError, subprocess.CalledProcessError):
        _build_failed = True
        return None
    return _load_lib()


def _load_lib() -> Optional[ctypes.CDLL]:
    global _build_failed
    try:
        lib = ctypes.CDLL(_LIB_PATH)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i64 = ctypes.c_int64
        i64p = ctypes.POINTER(i64)
        for fn in (lib.tem_scatter_blocks, lib.tem_gather_blocks):
            fn.argtypes = [u8p, i64, i64, i64, u8p, i64, i64, i64p, i64]
            fn.restype = None
        return lib
    except (OSError, AttributeError) as e:
        _build_failed = True
        warnings.warn(f"libtemnative.so present but unloadable "
                      f"({type(e).__name__}: {e}); using the numpy "
                      "fallback", RuntimeWarning, stacklevel=2)
        return None


def _get_lib() -> Optional[ctypes.CDLL]:
    global _lib
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is None and not _build_failed:
            if (os.path.exists(_LIB_PATH)
                    and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(_SRC)):
                _lib = _load_lib()
            else:
                _lib = _build()
    return _lib


def native_available() -> bool:
    """Whether the compiled scatter/gather library loads (else the numpy
    loops serve)."""
    return _get_lib() is not None


def _u8p(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def scatter_blocks(out_zyx: np.ndarray, tiles: np.ndarray,
                   indices: Sequence[Tuple[int, int, int]], tile_size: int,
                   num_threads: int = 4) -> None:
    """Scatter cubic uint8 tiles into a zyx buffer at xyz offsets (clipped
    on both faces), like the reference's slice assignment (utils.py:121-125).
    """
    if out_zyx.dtype != np.uint8 or not out_zyx.flags.c_contiguous:
        raise ValueError("out_zyx must be C-contiguous uint8")
    tiles = np.ascontiguousarray(tiles, np.uint8)
    n = len(indices)
    if tiles.shape[0] != n:
        raise ValueError(f"{tiles.shape[0]} tiles for {n} indices")
    t = tile_size
    lib = _get_lib()
    if lib is not None and tiles.ndim == 4 and tiles.shape[1:] == (t, t, t):
        idx = np.ascontiguousarray(np.asarray(indices, np.int64))
        lib.tem_scatter_blocks(
            _u8p(out_zyx), *map(ctypes.c_int64, out_zyx.shape),
            _u8p(tiles), ctypes.c_int64(n), ctypes.c_int64(t),
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(num_threads))
        return
    Z, Y, X = out_zyx.shape
    for i, (ox, oy, oz) in enumerate(indices):
        z0, z1 = max(0, -oz), min(t, Z - oz)
        y0, y1 = max(0, -oy), min(t, Y - oy)
        x0, x1 = max(0, -ox), min(t, X - ox)
        if z0 >= z1 or y0 >= y1 or x0 >= x1:
            continue
        out_zyx[oz + z0:oz + z1, oy + y0:oy + y1,
                ox + x0:ox + x1] = tiles[i][z0:z1, y0:y1, x0:x1]


def gather_blocks(vol_zyx: np.ndarray,
                  corners: Sequence[Tuple[int, int, int]], tile_size: int,
                  num_threads: int = 4) -> np.ndarray:
    """Extract cubic uint8 tiles at xyz corners (zero-filled out of bounds)."""
    vol_zyx = np.ascontiguousarray(vol_zyx, np.uint8)
    n = len(corners)
    t = tile_size
    tiles = np.zeros((n, t, t, t), np.uint8)
    lib = _get_lib()
    if lib is not None:
        cor = np.ascontiguousarray(np.asarray(corners, np.int64))
        lib.tem_gather_blocks(
            _u8p(vol_zyx), *map(ctypes.c_int64, vol_zyx.shape),
            _u8p(tiles), ctypes.c_int64(n), ctypes.c_int64(t),
            cor.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            ctypes.c_int64(num_threads))
        return tiles
    Z, Y, X = vol_zyx.shape
    for i, (cx, cy, cz) in enumerate(corners):
        z0, z1 = max(0, -cz), min(t, Z - cz)
        y0, y1 = max(0, -cy), min(t, Y - cy)
        x0, x1 = max(0, -cx), min(t, X - cx)
        if z0 >= z1 or y0 >= y1 or x0 >= x1:
            continue
        tiles[i][z0:z1, y0:y1, x0:x1] = vol_zyx[cz + z0:cz + z1,
                                                cy + y0:cy + y1,
                                                cx + x0:cx + x1]
    return tiles


def gather_box(vol_zyx: np.ndarray, corner_xyz: Sequence[int],
               size_xyz: Sequence[int]) -> np.ndarray:
    """Copy an xyz box out of a host zyx volume, zero-filled out of bounds."""
    Z, Y, X = vol_zyx.shape
    cx, cy, cz = (int(v) for v in corner_xyz)
    sx, sy, sz = (int(v) for v in size_xyz)
    out = np.zeros((sz, sy, sx), np.uint8)
    z0, z1 = max(0, -cz), min(sz, Z - cz)
    y0, y1 = max(0, -cy), min(sy, Y - cy)
    x0, x1 = max(0, -cx), min(sx, X - cx)
    if z0 < z1 and y0 < y1 and x0 < x1:
        out[z0:z1, y0:y1, x0:x1] = vol_zyx[cz + z0:cz + z1,
                                           cy + y0:cy + y1,
                                           cx + x0:cx + x1]
    return out

