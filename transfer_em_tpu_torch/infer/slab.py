"""Slab inference: whole z-slab forwards instead of 74^3 tiles.

Counterpart of ``transfer_em_tpu/infer/slab.py``.  The generator is fully
convolutional, so a whole (74, Y, X) z-slab runs as one forward: a 360^3
request is 9 forwards of (1, 74, 394, 394) instead of 1000 tile forwards,
and each output voxel costs about a quarter of the tile grid's conv work
(74 * 394^2 inputs per 40 * 360^2 outputs, against 74^3 per 36^3).

VALID-conv arithmetic per axis (``shapes.is_valid_dimsize``): the z input
extent stays 74 (40 out); y and x take the smallest valid extent covering
the request and its halo.  Out-of-bounds halos read zeros, as on the tile
paths.  The slabs sit at another stride-2 pooling phase than the trimmed
tile grid (40-deep output slabs against 36-wide tiles), so slab output can
differ from the tile modes'; it equals one whole-volume generator pass at
the same alignment.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.normalize import postprocess_to_u8, preprocess_u8
from ..shapes import generator_shapes, is_valid_dimsize
from .device_stitch import count_pageable, to_result, volume_on
from .tiling import (_DEVICE_LOCK, check_3d_generator, check_generator,
                     meanstd_tuple)


def _next_valid(n: int) -> int:
    d = n
    while not is_valid_dimsize(d):
        d += 1
    return d


def slab_predict(vol_zyx, gen: nn.Module,
                 start: Sequence[int], size: Sequence[int],
                 meanstd_x, meanstd_y, z_in: int = 74,
                 as_numpy: bool = True, device="cuda"):
    """Predict an xyz ``start``/``size`` region of a zyx uint8 volume, one
    generator forward per ``z_in``-deep input slab.

    ``vol_zyx``: numpy array or tensor; a uint8 tensor already on ``device``
    is used in place.  ``z_in``: a valid dimsize (74 -> 40 out).
    ``as_numpy=False`` returns the uint8 tensor on the device.  Returns the
    zyx uint8 block of ``size``.
    """
    if not is_valid_dimsize(z_in):
        raise ValueError(f"z_in={z_in} is not a valid dimsize")
    dev = resolve_device(device)
    check_3d_generator(gen)
    check_generator(gen, dev)
    shp = generator_shapes(z_in)
    z_out, buffer = shp.out, shp.buffer

    sx, sy, sz = size
    x0, y0, z0 = start
    y_in = _next_valid(sy + 2 * buffer)
    x_in = _next_valid(sx + 2 * buffer)
    y_out, x_out = y_in - 2 * buffer, x_in - 2 * buffer  # >= sy, sx
    nz = -(-sz // z_out)

    count_pageable(vol_zyx, dev, as_numpy)
    vol = volume_on(vol_zyx, dev)
    Z, Y, X = vol.shape
    # Pad so that every slab read is in range (zeros outside the volume).
    z_lo, y_lo, x_lo = z0 - buffer, y0 - buffer, x0 - buffer
    z_hi = z_lo + nz * z_out + 2 * buffer
    lo = (max(0, -z_lo), max(0, -y_lo), max(0, -x_lo))
    hi = (max(0, z_hi - Z), max(0, y_lo + y_in - Y), max(0, x_lo + x_in - X))
    if any(lo) or any(hi):
        vol = F.pad(vol, (lo[2], hi[2], lo[1], hi[1], lo[0], hi[0]))
    z_lo, y_lo, x_lo = z_lo + lo[0], y_lo + lo[1], x_lo + lo[2]

    out = torch.empty((nz * z_out, y_out, x_out), dtype=torch.uint8,
                      device=dev)
    ms_x, ms_y = meanstd_tuple(meanstd_x), meanstd_tuple(meanstd_y)
    with _DEVICE_LOCK, torch.inference_mode():
        for i in range(nz):
            zs = z_lo + i * z_out
            slab = vol[zs:zs + z_in, y_lo:y_lo + y_in, x_lo:x_lo + x_in]
            y = gen(preprocess_u8(slab[None].contiguous(), ms_x))
            out[i * z_out:(i + 1) * z_out] = postprocess_to_u8(y, ms_y)[0]
    return to_result(out[:sz, :sy, :sx], as_numpy)
