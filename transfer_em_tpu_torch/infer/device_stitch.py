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

The batches walk the tiles z outermost, so each batch reads a contiguous
range of the volume's z planes and completes a contiguous range of the
output's.  On one device the host copies move in those z slabs
(``slab_schedule``, ``_SlabCopies``): a host source's planes land on the
device just before the first batch that reads them, and a numpy result's
planes leave as soon as the batch that completes them has run.  On a card
they go through a few reused pinned slots on two side streams, ordered
against the batch loop by events, so the copies run while later batches
compute; on the CPU the same slabs are plain copies.

With ``mesh=`` the tile batches are dealt out over the mesh's 'data' axis:
each device runs its share of the batches on a replica of the generator,
and each batch's result is written into the one output on the caller's
device.  The JAX package, one program a device, stitches a partial output
a device and combines them by ``pmax``; one process driving every device
needs no partials (tiles are disjoint, and a padding tile repeats the last
one, so its duplicate write carries the same voxels).  Every device reads
the whole volume, so the meshed call copies it whole (pageable memory).

Out-of-bounds halos read zeros, as ``gather_blocks`` gives the host path:
the volume is zero-padded by exactly enough for every tile slice to lie in
range (a torch slice past the end would come back short, and one with a
negative start would wrap), and the range is checked before any launch.
"""

from __future__ import annotations

import threading
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..device import resolve_device
from ..ops.normalize import postprocess_to_u8, preprocess_u8
from ..parallel.mesh import replicas
from ..telemetry import count, span
from .tiling import (_DEVICE_LOCK, TilePlan, check_3d_generator,
                     check_generator, data_sharding, meanstd_tuple,
                     plan_tiles, tile_batch)

# A pinned staging slot holds 8 MiB, or one plane where a plane is larger;
# each direction takes SLOTS of them in turn.
SLOT_BYTES = 8 << 20
SLOTS = 4


def _in_place(vol_zyx, dev: torch.device) -> bool:
    """A tensor that needs no upload from the host: one on a card, or any
    tensor when the device is the host."""
    return isinstance(vol_zyx, torch.Tensor) and (
        vol_zyx.device.type != "cpu" or dev.type == "cpu")


def volume_on(vol_zyx, dev: torch.device) -> torch.Tensor:
    """The uint8 zyx volume on ``dev``: a uint8 tensor already there is used
    in place (upload once, predict many); anything else is copied."""
    if isinstance(vol_zyx, torch.Tensor):
        return vol_zyx.to(dev, torch.uint8)
    return torch.from_numpy(np.ascontiguousarray(vol_zyx, np.uint8)).to(dev)


def count_pageable(vol_zyx, dev: torch.device, as_numpy: bool) -> None:
    """Count a call (``volume_pageable``) that copies between the host and
    the device without the staged slabs: a meshed device-mode call or a
    slab-mode call with a host source or a numpy result."""
    if as_numpy or not _in_place(vol_zyx, dev):
        count("volume_pageable")


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
    uint8 tensor already on ``device`` is used in place, and a host source
    is uploaded in z slabs as the batches reach them.  ``as_numpy=False``
    returns the uint8 tensor on the device; a numpy result is a fresh array,
    downloaded in z slabs as the batches complete them.  ``prepadded``:
    the caller guarantees every tile read lies inside ``vol_zyx``
    (infer/stream.py fetches haloed blocks), so no padding is made.
    Batches run at ``tiling.tile_batch``'s shape, as ``predict_tiled``'s
    do.  ``mesh``: optional mesh with a 'data' axis; each of its devices
    runs ``batch_size``-tile batches (the batch count rounds up to the axis
    size), and the result lands on ``device``.

    Counts (``telemetry``): ``volume_slabs_in`` and ``volume_slabs_out``,
    the slabs uploaded and downloaded; ``volume_pageable``, a meshed call
    that copies its volume or result whole.
    """
    dev = resolve_device(device)
    devices = (data_sharding(mesh, "device_predict_tiled")
               if mesh is not None else None)
    check_3d_generator(gen)
    check_generator(gen, dev)
    plan = plan_tiles(start, size, outdimsize, buffer)
    batch = tile_batch(plan.num_tiles, batch_size)
    if devices is not None or plan.num_tiles == 0:
        if devices is not None:
            count_pageable(vol_zyx, dev, as_numpy)
        out = stitch_plan(vol_zyx, gen, plan, batch, meanstd_x, meanstd_y,
                          prepadded, dev, devices)
        return to_result(out, as_numpy)
    staging = _staging(dev)
    with staging.lock:
        copies = _SlabCopies(vol_zyx, plan, batch, prepadded, dev, as_numpy,
                             staging)
        out = stitch_plan(vol_zyx, gen, plan, batch, meanstd_x, meanstd_y,
                          prepadded, dev, copies=copies)
        return copies.result(out)


def stitch_plan(vol_zyx, gen: nn.Module, plan: TilePlan, batch: int,
                meanstd_x, meanstd_y, prepadded: bool,
                dev: torch.device,
                devices: Optional[Sequence[torch.device]] = None,
                copies: Optional["_SlabCopies"] = None) -> torch.Tensor:
    """Every tile of ``plan`` gathered from ``vol_zyx``, predicted ``batch``
    tiles a step and stitched on ``dev``: the zyx uint8 tensor of the
    request.  infer/stream.py runs each chunk through this at its whole
    request's batch, so the chunking changes no voxel.  ``devices``: deal
    the batches out over these (contiguous runs of equal length, the last
    padded by repeats of the last tile), each on its replica of ``gen``;
    every batch's result is stitched into the one output on ``dev``.
    ``copies`` (one device): the call's slab copies, which hold the device
    volume and move the slabs around each batch."""
    sx, sy, sz = plan.size
    if plan.num_tiles == 0:  # zero-extent request
        return torch.zeros((sz, sy, sx), dtype=torch.uint8, device=dev)

    if copies is None:
        with span("volume.upload"):
            vol = volume_on(vol_zyx, dev)
        pad = padding(plan, vol.shape, prepadded)
        if pad:
            vol = F.pad(vol, (pad,) * 6)
    else:
        vol, pad = copies.volume, copies.pad
        copies.upload(0)
    with span("volume.prepare"):
        shards, cells, out, out_tiles, per = _prepare(
            vol, gen, plan, batch, pad, prepadded, dev, devices)
    ms_x, ms_y = meanstd_tuple(meanstd_x), meanstd_tuple(meanstd_y)
    with _DEVICE_LOCK, torch.inference_mode(), span("volume.tiles", dev):
        # step k of every device before step k + 1 of any, so the devices
        # run together; device j takes batches [j per, (j + 1) per) and its
        # results land in the one output on dev
        for k in range(per):
            if copies is not None:
                copies.upload(k)
            for j, (g, (gz, gy, gx), windows) in enumerate(shards):
                i = (j * per + k) * batch
                y = g(preprocess_u8(windows[gz[i:i + batch], gy[i:i + batch],
                                            gx[i:i + batch]], ms_x))
                out_tiles[cells[0][i:i + batch], cells[1][i:i + batch],
                          cells[2][i:i + batch]] = postprocess_to_u8(
                              y, ms_y, plan.tpad).to(dev)
            if copies is not None:
                copies.finished(k, out)
    return out[:sz, :sy, :sx]


def padding(plan: TilePlan, shape: Sequence[int], prepadded: bool) -> int:
    """The zero padding a face that puts every tile read of ``plan`` inside
    a zyx volume of ``shape``: the corners' real overhang, rounded up to a
    multiple of insize as in the JAX package (interior requests pad 0 and
    copy nothing); 0 for a ``prepadded`` block."""
    if prepadded:
        return 0
    first, last = _extreme_corners(plan)
    need = int(max(0, -first.min(),
                   (last + plan.insize - np.asarray(shape)).max()))
    return -(-need // plan.insize) * plan.insize


def _extreme_corners(plan: TilePlan):
    """The least and the greatest zyx tile corner: ``plan_tiles`` walks
    every axis upward, so they are its first and last corners."""
    return (np.asarray(plan.corners[0][::-1], np.int64),
            np.asarray(plan.corners[-1][::-1], np.int64))


def slab_schedule(plan: TilePlan, batch: int, depth: int
                  ) -> List[Tuple[Tuple[int, int], Tuple[int, int]]]:
    """The z slabs of a one-device call of ``plan`` at ``batch`` tiles a
    step, its tiles walked z outermost, over a source ``depth`` planes
    deep: for each batch k, ``((z0, z1), (o0, o1))``.  ``[z0, z1)`` are
    the source planes that batch k reads and no earlier batch read (inside
    ``[0, depth)``: reads outside it are the padding's zeros); ``[o0, o1)``
    are the planes of the result whose last writer is batch k.  Either may
    be empty (z0 == z1)."""
    T = plan.num_tiles
    if T == 0:
        return []
    od, s = plan.outdimsize, plan.insize
    _, py, px = plan.padded_size
    row = (py // od) * (px // od)  # tiles in one z row of the grid
    z_first = plan.corners[0][2]
    staged = min(max(z_first, 0), depth)
    done = 0
    slabs = []
    for k in range(-(-T // batch)):
        last = min((k + 1) * batch, T) - 1  # padding tiles repeat it
        hi = min(max(z_first + last // row * od + s, staged), depth)
        complete = min((last + 1) // row * od, plan.size[2])
        slabs.append(((staged, hi), (done, complete)))
        staged, done = hi, complete
    return slabs


class _Staging:
    """The staging of one device, reused by every call on it, one call at
    a time (``lock``): ``2 * SLOTS`` host slots, uploads through the first
    ``SLOTS`` and downloads through the rest, each of ``SLOT_BYTES`` or
    one plane where a plane is larger.  On a card the slots are pinned and
    two side streams copy them, each upload slot remembering the event of
    its last upload; on the CPU they are plain tensors."""

    def __init__(self, dev: torch.device):
        self.lock = threading.Lock()
        self.cuda = dev.type == "cuda"
        if self.cuda:
            self.h2d = torch.cuda.Stream(dev)
            self.d2h = torch.cuda.Stream(dev)
        self.slots: List[torch.Tensor] = []
        self.uploaded: List[Optional[torch.cuda.Event]] = [None] * SLOTS
        self.turn = 0  # the next upload slot

    def fit(self, plane_bytes: int) -> int:
        """Slots of at least one plane (allocated on the first call, and
        anew only for a larger plane); returns the slot size."""
        nbytes = max(SLOT_BYTES, plane_bytes)
        if not self.slots or self.slots[0].numel() < nbytes:
            if self.cuda:  # the old slots' copies must land first
                for e in self.uploaded:
                    if e is not None:
                        e.synchronize()
                self.d2h.synchronize()
            self.slots = [torch.empty(nbytes, dtype=torch.uint8,
                                      pin_memory=self.cuda)
                          for _ in range(2 * SLOTS)]
            self.uploaded = [None] * SLOTS
        return self.slots[0].numel()

    def upload(self, src: torch.Tensor, dst: torch.Tensor,
               compute) -> None:
        """The host planes ``src`` into the device planes ``dst``, a few
        planes a slot; on a card the compute stream waits for the last
        one."""
        plane = src[0].numel()
        n = max(1, self.fit(plane) // plane)
        for a in range(0, len(src), n):
            b = min(a + n, len(src))
            i, self.turn = self.turn, (self.turn + 1) % SLOTS
            if self.uploaded[i] is not None:  # its last upload has landed
                self.uploaded[i].synchronize()
            slot = self.slots[i][:(b - a) * plane].view(src[a:b].shape)
            slot.copy_(src[a:b])
            if not self.cuda:
                dst[a:b].copy_(slot)
                continue
            with torch.cuda.stream(self.h2d):
                dst[a:b].copy_(slot, non_blocking=True)
                landed = torch.cuda.Event()
                landed.record(self.h2d)
            self.uploaded[i] = landed
        if self.cuda:
            compute.wait_event(landed)


_STAGING: Dict[torch.device, _Staging] = {}
_STAGING_LOCK = threading.Lock()


def _staging(dev: torch.device) -> _Staging:
    with _STAGING_LOCK:
        if dev not in _STAGING:
            _STAGING[dev] = _Staging(dev)
        return _STAGING[dev]


def pinned_staging_bytes() -> int:
    """Pinned host bytes that device mode holds for its staged copies, over
    every card."""
    with _STAGING_LOCK:
        return sum(t.numel() for s in _STAGING.values() if s.cuda
                   for t in s.slots)


class _SlabCopies:
    """One device-mode call's host copies, slab by slab
    (``slab_schedule``), through its device's ``_Staging``.

    Upload, for a host source: ``upload(k)`` moves the planes batch k reads
    first into the device volume (zeroed where it pads the source), and on
    a card the compute stream waits for them.  A tensor on the device is
    used in place.  Download, for a numpy result: ``finished(k, out)``,
    after batch k, queues the result planes batch k completed, and on a
    card starts their copies into the download slots once the batch has
    run, as many as slots are free; ``result`` takes them into a fresh
    array in order, starting the queued ones as slots come free."""

    def __init__(self, vol_zyx, plan: TilePlan, batch: int, prepadded: bool,
                 dev: torch.device, as_numpy: bool, staging: _Staging):
        self.staging = staging
        self.compute = (torch.cuda.current_stream(dev) if staging.cuda
                        else None)
        self.slabs = slab_schedule(plan, batch, vol_zyx.shape[0])
        self.pad = p = padding(plan, vol_zyx.shape, prepadded)
        self.src = None
        if _in_place(vol_zyx, dev):
            vol = vol_zyx.to(dev, torch.uint8)
            self.volume = F.pad(vol, (p,) * 6) if p else vol
        else:
            self.src = (vol_zyx.to(torch.uint8)
                        if isinstance(vol_zyx, torch.Tensor) else
                        torch.from_numpy(np.ascontiguousarray(vol_zyx,
                                                              np.uint8)))
            shape = tuple(n + 2 * p for n in self.src.shape)
            make = torch.zeros if p else torch.empty
            if staging.cuda:  # from the upload stream's memory
                with torch.cuda.stream(staging.h2d):
                    self.volume = make(shape, dtype=torch.uint8, device=dev)
                self.volume.record_stream(self.compute)
                # the zeros land before any read, staged slabs or none
                self.compute.wait_stream(staging.h2d)
            else:
                self.volume = make(shape, dtype=torch.uint8)
        self.staged = 0  # batches whose slabs are on the device
        sx, sy, sz = plan.size
        self.array = np.empty((sz, sy, sx), np.uint8) if as_numpy else None
        self.out = None  # the padded device output, once a batch ran
        self.queued = deque()  # (o0, o1, event): planes not yet copied out
        self.moving = deque()  # (o0, o1, slot, event): planes in a slot
        self.issued = 0  # download pieces started, for the slots' turns

    def upload(self, k: int) -> None:
        """The slabs of batches up to ``k`` not yet on the device."""
        while self.staged <= k:
            z0, z1 = self.slabs[self.staged][0]
            self.staged += 1
            if self.src is None or z1 == z0:
                continue
            count("volume_slabs_in")
            with span("volume.upload"):
                p = self.pad
                Y, X = self.src.shape[1:]
                self.staging.upload(
                    self.src[z0:z1],
                    self.volume[z0 + p:z1 + p, p:p + Y, p:p + X],
                    self.compute)

    def finished(self, k: int, out: torch.Tensor) -> None:
        """Queue the result planes batch ``k`` (just enqueued) completes."""
        o0, o1 = self.slabs[k][1]
        if self.array is None or o1 == o0:
            return
        count("volume_slabs_out")
        ran = None
        if self.staging.cuda:
            ran = torch.cuda.Event()
            ran.record(self.compute)
            if self.out is None:
                out.record_stream(self.staging.d2h)
        self.out = out
        plane = out[0].numel()
        n = max(1, self.staging.fit(plane) // plane)
        for a in range(o0, o1, n):
            self.queued.append((a, min(a + n, o1), ran))
        self._start()

    def _start(self) -> None:
        """Copy queued planes into the download slots that are free."""
        st, out = self.staging, self.out
        while self.queued and len(self.moving) < SLOTS:
            a, b, ran = self.queued.popleft()
            slot = st.slots[SLOTS + self.issued % SLOTS]
            self.issued += 1
            host = slot[:(b - a) * out[0].numel()].view(out[a:b].shape)
            landed = None
            if st.cuda:
                st.d2h.wait_event(ran)
                with torch.cuda.stream(st.d2h):
                    host.copy_(out[a:b], non_blocking=True)
                    landed = torch.cuda.Event()
                    landed.record(st.d2h)
            else:
                host.copy_(out[a:b])
            self.moving.append((a, b, host, landed))

    def result(self, out: torch.Tensor):
        """The call's result: the device tensor, or each downloaded slab
        copied into the fresh array as it lands."""
        if self.array is None:
            return out.contiguous()
        array = torch.from_numpy(self.array)
        sy, sx = self.array.shape[1:]
        while self.moving:
            a, b, host, landed = self.moving.popleft()
            with span("volume.wait"):
                if landed is not None:
                    landed.synchronize()
            with span("volume.download"):
                array[a:b].copy_(host[:, :sy, :sx])
            self._start()
        return self.array


def _prepare(vol, gen, plan: TilePlan, batch: int, pad: int,
             prepadded: bool, dev: torch.device, devices):
    """The tiles' grid cells, the output and the unfolded input windows of
    every device (``stitch_plan``) over ``vol``, padded by ``pad`` a face;
    the batches a device runs."""
    s, od = plan.insize, plan.outdimsize
    T = plan.num_tiles
    first, last = (c + pad for c in _extreme_corners(plan))
    if first.min() < 0 or (last + s > np.asarray(vol.shape)).any():
        raise ValueError(
            f"tile reads reach outside the {tuple(vol.shape)} volume"
            + (" (prepadded=True, but the block does not cover every tile's"
               " halo)" if prepadded else ""))

    # The batches walk the grid z outermost and x innermost, so tile t sits
    # at grid cell (t // (ny nx), t // nx % ny, t % nx) of both the input
    # windows (step od from the first corner) and the output, and a batch
    # spans a contiguous range of z rows (``slab_schedule``).  Padding
    # tiles repeat the last tile, whose duplicate writes carry the same
    # voxels.  The cells are computed on the device: no copy, no wait.
    devices = list(devices) if devices is not None else [dev]
    n = len(devices)
    nb = -(-T // batch)
    per = -(-nb // n)  # batches a device: the count rounds up to n
    pz, py, px = plan.padded_size
    ny, nx = py // od, px // od
    t = torch.arange(n * per * batch, device=dev).clamp_(max=T - 1)
    cells = (t // (ny * nx), t // nx % ny, t % nx)
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
