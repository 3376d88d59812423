"""Plain tiled prediction of a region of a uint8 volume, as janelia-flyem/
transfer_em's utils.py plans and stitches it (utils.py:68-125):

* the tile's output side is trimmed to a multiple of 6 (40 -> 36), the
  trim folded into the halo (17 -> 19) and cut from each face of the
  generator's output (2 voxels);
* tiles start at the region's corner less the halo and step by the output
  side, x outermost; a read outside the volume gives zeros;
* each tile is scaled to [-1, 1], standardised with (mean, std) of the x
  domain, run through the generator, then un-standardised with the y
  domain's, mapped back to [0, 255], rounded half to even and clipped;
* the outputs are stitched into the region, cut to its size.

Tensors are on the caller's device; the volume is zyx, corners xyz.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from . import models as M


OUT, HALO, BATCH = 40, 17, 128  # the generator's output side and halo


def batch_for(wf: int) -> int:
    """Tiles a batch of :func:`predict_region` at width factor ``wf``:
    :data:`BATCH` at wf=8, scaled with the widths (16 at wf=1), so that a
    batch's activations take the same memory at every width."""
    return max(1, BATCH * wf // 8)


def tile_plan(start: Sequence[int], size: Sequence[int]):
    """(output side, halo, trim, corners xyz, padded size zyx)."""
    outdimsize, buffer, tpad = OUT, HALO, 0
    if outdimsize // 6:
        diff = outdimsize % 6
        outdimsize -= diff
        tpad = diff // 2
        buffer += tpad
    corners = [(x - buffer, y - buffer, z - buffer)
               for x in range(start[0], start[0] + size[0], outdimsize)
               for y in range(start[1], start[1] + size[1], outdimsize)
               for z in range(start[2], start[2] + size[2], outdimsize)]
    padded = [s + (outdimsize - s % outdimsize) % outdimsize for s in size]
    return outdimsize, buffer, tpad, corners, (padded[2], padded[1],
                                               padded[0])


def predict_region(vol_zyx: torch.Tensor, params, start, size,
                   meanstd_x: Tuple[float, float],
                   meanstd_y: Tuple[float, float],
                   quant=None, batch: int = BATCH) -> torch.Tensor:
    """The stitched zyx uint8 prediction of the xyz region ``start`` +
    ``size`` of ``vol_zyx`` (a uint8 tensor), ``batch`` tiles at a time."""
    od, buf, tpad, corners, padded = tile_plan(start, size)
    s = od + 2 * buf
    cz = np.asarray(corners, np.int64)[:, ::-1]  # zyx
    lo = int(max(0, -cz.min()))
    hi = int(max(0, (cz + s - np.asarray(vol_zyx.shape)).max()))
    vol = F.pad(vol_zyx, (lo, hi) * 3) if lo or hi else vol_zyx
    cz = cz + lo
    (mx, sx), (my, sy) = meanstd_x, meanstd_y
    out = torch.zeros(padded, dtype=torch.uint8, device=vol_zyx.device)
    nz, ny = padded[0] // od, padded[1] // od
    with torch.no_grad():
        for b in range(0, len(cz), batch):
            cs = cz[b:b + batch]
            tiles = torch.stack([vol[z:z + s, y:y + s, x:x + s]
                                 for z, y, x in cs])
            xin = ((tiles.to(torch.float32) / 127.5 - 1.0) - mx) / sx
            yout = M.generator(params, xin.unsqueeze(1), quant=quant)[:, 0]
            if tpad:
                yout = yout[:, tpad:-tpad, tpad:-tpad, tpad:-tpad]
            u8 = torch.clamp(torch.round((yout * sy + my + 1.0) * 127.5),
                             0, 255).to(torch.uint8)
            for t, tile in enumerate(u8):
                i = b + t
                gz, gy, gx = i % nz, i // nz % ny, i // (nz * ny)
                out[gz * od:(gz + 1) * od, gy * od:(gy + 1) * od,
                    gx * od:(gx + 1) * od] = tile
    return out[:size[2], :size[1], :size[0]]


def level_gaps(got: np.ndarray, want: np.ndarray, side: int) -> dict:
    """The numbers by which two zyx uint8 predictions of one region are
    compared: ``off_share``, the share of voxels whose level differs;
    ``far_share``, the share two or more levels off; ``tile_shift``, the
    largest mean signed gap in levels, by magnitude, over the output tiles
    (blocks of ``side`` voxels an axis from the region's corner, as
    :func:`tile_plan` lays them); ``max_gap``, the widest gap."""
    d = got.astype(np.int16) - want.astype(np.int16)
    a = np.abs(d)
    sums = d
    count = np.ones((1, 1, 1), np.int64)
    for ax, n in enumerate(d.shape):
        edges = np.arange(0, n, side)
        sums = np.add.reduceat(sums, edges, axis=ax, dtype=np.int64)
        shape = [1, 1, 1]
        shape[ax] = len(edges)
        count = count * np.diff(np.append(edges, n)).reshape(shape)
    return {"off_share": float(np.count_nonzero(a)) / a.size,
            "far_share": float(np.count_nonzero(a >= 2)) / a.size,
            "tile_shift": float(np.abs(sums / count).max()),
            "max_gap": int(a.max())}
