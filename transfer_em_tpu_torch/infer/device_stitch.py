"""Device-resident tiled inference: gather -> predict -> stitch on the card.

Counterpart of ``transfer_em_tpu/infer/device_stitch.py``.  The uint8
source volume lives on the device; per tile batch the card

  1. gathers the (padded) input tiles out of the volume,
  2. runs preprocess + generator + postprocess (the tile step's kernels),
  3. writes the uint8 results into the output volume,

so the host never touches a voxel between upload and download.  The JAX
package runs this as one ``lax.scan`` of ``dynamic_slice`` /
``dynamic_update_slice``; here the tile corners lie on a regular grid of
step ``outdimsize`` (``plan_tiles``), so ``unfold`` gives a strided view of
every tile with no copy, and one advanced index per batch gathers a
contiguous ``(B, s, s, s)`` batch; one ``index_put`` per batch stitches.
The index tensors are built once, on the device: the batch loop launches
no per-tile work and never waits for the card.

With ``mesh=`` the tile batches are dealt out over the mesh's 'data' axis:
each device runs its share of the batches on a replica of the generator,
and each batch's result is written into the one output on the caller's
device.  The JAX package, one program a device, stitches a partial output
a device and combines them by ``pmax``; one process driving every device
needs no partials (tiles are disjoint, and a padding tile repeats the last
one, so its duplicate write carries the same voxels).

Out-of-bounds halos read zeros, as ``gather_blocks`` gives the host path:
the volume is zero-padded by exactly enough for every tile slice to lie in
range (a torch slice past the end would come back short, and one with a
negative start would wrap), and the range is checked before any launch.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.normalize import postprocess_to_u8, preprocess_u8
from ..parallel.mesh import replicas
from ..telemetry import span
from .tiling import (_DEVICE_LOCK, TilePlan, check_3d_generator,
                     check_generator, data_sharding, meanstd_tuple,
                     plan_tiles, tile_batch)


def volume_on(vol_zyx, dev: torch.device) -> torch.Tensor:
    """The uint8 zyx volume on ``dev``: a uint8 tensor already there is used
    in place (upload once, predict many); anything else is copied."""
    if isinstance(vol_zyx, torch.Tensor):
        return vol_zyx.to(dev, torch.uint8)
    return torch.from_numpy(np.ascontiguousarray(vol_zyx, np.uint8)).to(dev)


def to_result(out: torch.Tensor, as_numpy: bool):
    """The exact-size result: a numpy array, or the tensor on its device.
    The copy to the host waits for the card first (``volume.wait``), so
    ``volume.download`` times the copy itself: the D2H, page faults and
    ``.numpy()``."""
    out = out.contiguous()
    if not as_numpy:
        return out
    with span("volume.wait"):
        if out.is_cuda:
            torch.cuda.current_stream(out.device).synchronize()
    with span("volume.download"):
        return out.cpu().numpy()


def device_predict_tiled(
        vol_zyx, gen: nn.Module,
        start: Sequence[int], size: Sequence[int],
        outdimsize: int, buffer: int,
        meanstd_x, meanstd_y,
        batch_size: int = 8,
        as_numpy: bool = True,
        mesh=None,
        prepadded: bool = False,
        device="cuda"):
    """Tiled inference over a device-resident uint8 zyx volume.

    Semantics match ``infer.tiling.predict_tiled`` over an in-memory source
    (out-of-bounds halos read zeros); the result is the stitched zyx uint8
    block of ``size`` (xyz).  ``vol_zyx`` is a numpy array or a tensor; a
    uint8 tensor already on ``device`` is used in place.  ``as_numpy=False``
    returns the uint8 tensor on the device.  ``prepadded``: the caller
    guarantees every tile read lies inside ``vol_zyx`` (infer/stream.py
    fetches haloed blocks), so no padding copy is made.  Batches run at
    ``tiling.tile_batch``'s shape, as ``predict_tiled``'s do.  ``mesh``:
    optional mesh with a 'data' axis; each of its devices runs
    ``batch_size``-tile batches (the batch count rounds up to the axis
    size), and the result lands on ``device``.
    """
    dev = resolve_device(device)
    devices = (data_sharding(mesh, "device_predict_tiled")
               if mesh is not None else None)
    check_3d_generator(gen)
    check_generator(gen, dev)
    plan = plan_tiles(start, size, outdimsize, buffer)
    out = stitch_plan(vol_zyx, gen, plan,
                      tile_batch(plan.num_tiles, batch_size),
                      meanstd_x, meanstd_y, prepadded, dev, devices)
    return to_result(out, as_numpy)


def stitch_plan(vol_zyx, gen: nn.Module, plan: TilePlan, batch: int,
                meanstd_x, meanstd_y, prepadded: bool,
                dev: torch.device,
                devices: Optional[Sequence[torch.device]] = None
                ) -> torch.Tensor:
    """Every tile of ``plan`` gathered from ``vol_zyx``, predicted ``batch``
    tiles a step and stitched on ``dev``: the zyx uint8 tensor of the
    request.  infer/stream.py runs each chunk through this at its whole
    request's batch, so the chunking changes no voxel.  ``devices``: deal
    the batches out over these (contiguous runs of equal length, the last
    padded by repeats of the last tile), each on its replica of ``gen``;
    every batch's result is stitched into the one output on ``dev``."""
    sx, sy, sz = plan.size
    if plan.num_tiles == 0:  # zero-extent request
        return torch.zeros((sz, sy, sx), dtype=torch.uint8, device=dev)

    with span("volume.upload"):
        vol = volume_on(vol_zyx, dev)
    with span("volume.prepare"):
        shards, cells, out, out_tiles, per = _prepare(
            vol, gen, plan, batch, prepadded, dev, devices)
    ms_x, ms_y = meanstd_tuple(meanstd_x), meanstd_tuple(meanstd_y)
    with _DEVICE_LOCK, torch.inference_mode(), span("volume.tiles", dev):
        # step k of every device before step k + 1 of any, so the devices
        # run together; device j takes batches [j per, (j + 1) per) and
        # its results land in the one output on dev
        for k in range(per):
            for j, (g, (gz, gy, gx), windows) in enumerate(shards):
                i = (j * per + k) * batch
                y = g(preprocess_u8(windows[gz[i:i + batch], gy[i:i + batch],
                                            gx[i:i + batch]], ms_x))
                out_tiles[cells[0][i:i + batch], cells[1][i:i + batch],
                          cells[2][i:i + batch]] = postprocess_to_u8(
                              y, ms_y, plan.tpad).to(dev)
    return out[:sz, :sy, :sx]


def _prepare(vol, gen, plan: TilePlan, batch: int, prepadded: bool,
             dev: torch.device, devices):
    """The padding, the tiles' grid cells, the output and the unfolded
    input windows of every device (``stitch_plan``); the batches a device
    runs."""
    s, od = plan.insize, plan.outdimsize
    T = plan.num_tiles
    corners = np.asarray(plan.corners, np.int64)[:, ::-1]  # (T, 3) zyx
    if prepadded:
        pad = 0
    else:
        # Pad by the corners' real overhang, rounded up to a multiple of
        # insize as in the JAX package; interior requests pad 0 and copy
        # nothing.
        need = int(max(0, -corners.min(),
                       (corners + s - np.asarray(vol.shape)).max()))
        pad = -(-need // s) * s
    if pad:
        vol = F.pad(vol, (pad,) * 6)
    corners = corners + pad
    if corners.min() < 0 or (corners + s > np.asarray(vol.shape)).any():
        raise ValueError(
            f"tile reads reach outside the {tuple(vol.shape)} volume"
            + (" (prepadded=True, but the block does not cover every tile's"
               " halo)" if prepadded else ""))

    # plan_tiles walks x outermost and z innermost, so tile t sits at grid
    # cell (t // (nz ny), t // nz % ny, t % nz) of both the input windows
    # (step od from the first corner) and the output.  Padding tiles
    # repeat the last tile, whose duplicate writes carry the same voxels.
    # The cells are computed on the device: no copy, no wait.
    devices = list(devices) if devices is not None else [dev]
    n = len(devices)
    nb = -(-T // batch)
    per = -(-nb // n)  # batches a device: the count rounds up to n
    pz, py, px = plan.padded_size
    nz, ny = pz // od, py // od
    first = corners[0]
    t = torch.arange(n * per * batch, device=dev).clamp_(max=T - 1)
    cells = (t % nz, t // nz % ny, t // (nz * ny))
    out = torch.zeros(plan.padded_size, dtype=torch.uint8, device=dev)
    out_tiles = out.view(pz // od, od, py // od, od, px // od,
                         od).permute(0, 2, 4, 1, 3, 5)
    shards = []
    for d, g in zip(devices, replicas(gen, devices)):
        shards.append((
            g, tuple(c.to(d) for c in cells),
            vol.to(d)[first[0]:, first[1]:, first[2]:]
            .unfold(0, s, od).unfold(1, s, od).unfold(2, s, od)))
    return shards, cells, out, out_tiles, per
