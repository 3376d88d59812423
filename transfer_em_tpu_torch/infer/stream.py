"""Streaming chunked inference for volumes larger than the card.

Counterpart of ``transfer_em_tpu/infer/stream.py``.  The device modes
(infer/device_stitch.py, infer/slab.py) hold the whole uint8 source on the
card; this module runs any request as a pipeline of chunks that fit:

1. The padded output grid is split into equal chunks of whole output tiles
   (x innermost), each sized so that its haloed uint8 input block fits
   ``max_block_bytes`` (``plan_chunks``).
2. Every block is fetched with its halo (zeros outside the source), so the
   chunk runs the device path's gather -> predict -> stitch with no padding
   (``device_stitch.stitch_plan``) and its voxels equal the whole-volume
   device path's bit for bit.
3. Fetch, upload, compute and download overlap, with at most two blocks
   and two results in flight:
     host thread : fetch of block k+1 into one of two pinned buffers
     H2D stream  : non-blocking upload of block k+1 (an event marks it)
     compute     : chunk k, after waiting on its upload's event
     D2H stream  : non-blocking download of result k-1 into one of two
                   pinned buffers (an event marks it); the host writes it
                   into ``out`` once that event has completed.
   A block uploaded on the H2D stream and a result read on the D2H stream
   are marked with ``record_stream``, so the caching allocator does not
   hand their memory out again before the other stream is done with it.

On the CPU (``device="cpu"``) the same loop runs without streams.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..device import resolve_device
from ..native import gather_box
from ..shapes import tile_plan_outdimsize
from .device_stitch import stitch_plan
from .tiling import (check_3d_generator, check_generator, data_sharding,
                     plan_tiles, tile_batch)


@dataclasses.dataclass(frozen=True)
class ChunkPlan:
    """Static description of one streaming run."""

    start: Tuple[int, int, int]      # requested xyz start
    size: Tuple[int, int, int]       # requested xyz size
    outdimsize: int                  # effective output tile (multiple of 6)
    buffer: int                      # effective halo (incl. folded tpad)
    chunk: Tuple[int, int, int]      # xyz chunk extent (output voxels)
    grid: Tuple[int, int, int]       # xyz chunk counts
    block: Tuple[int, int, int]      # xyz fetched block extent (chunk + 2b)

    @property
    def num_chunks(self) -> int:
        return int(np.prod(self.grid))

    def chunk_xyz(self, k: int) -> Tuple[int, int, int]:
        """Grid coordinates of flat chunk index k (x innermost)."""
        gx, gy, _gz = self.grid
        return (k % gx, (k // gx) % gy, k // (gx * gy))


def plan_chunks(start: Sequence[int], size: Sequence[int], outdimsize: int,
                buffer: int, max_block_bytes: int) -> ChunkPlan:
    """Split an xyz request into equal chunks of whole output tiles.

    Chunks keep x (the fastest-varying axis of the zyx output, hence fetch
    locality) as large as fits, then y, then z; every chunk's haloed uint8
    input block is at most ``max_block_bytes``.
    """
    od, b, _tpad = tile_plan_outdimsize(outdimsize, buffer)
    padded = [-(-s // od) * od for s in size]  # per-axis multiple of od

    min_block = (od + 2 * b) ** 3
    if min_block > max_block_bytes:
        raise ValueError(
            f"max_block_bytes={max_block_bytes} cannot hold even one "
            f"{od + 2*b}^3 input tile ({min_block} bytes)")

    def largest_fit(axis_padded: int, others: Tuple[int, ...]) -> int:
        """Largest multiple of od <= axis_padded whose block fits."""
        other_bytes = int(np.prod([o + 2 * b for o in others]))
        c = (max_block_bytes // other_bytes - 2 * b) // od * od
        return max(od, min(axis_padded, c))

    cx = largest_fit(padded[0], (od, od))
    cy = largest_fit(padded[1], (cx, od))
    cz = largest_fit(padded[2], (cx, cy))
    chunk = (cx, cy, cz)
    grid = tuple(-(-p // c) for p, c in zip(padded, chunk))
    block = tuple(c + 2 * b for c in chunk)
    return ChunkPlan(start=tuple(start), size=tuple(size), outdimsize=od,
                     buffer=b, chunk=chunk, grid=grid, block=block)


class _Transfers:
    """Uploads and downloads of the pipeline: on a CUDA device through two
    pinned buffers each and side streams with events; on the CPU plain
    tensors and arrays."""

    def __init__(self, dev: torch.device, block_zyx, chunk_zyx):
        self.cuda = dev.type == "cuda"
        self.dev = dev
        if not self.cuda:
            return
        self.compute = torch.cuda.current_stream(dev)
        self.h2d, self.d2h = torch.cuda.Stream(dev), torch.cuda.Stream(dev)
        self.blocks = [torch.empty(block_zyx, dtype=torch.uint8,
                                   pin_memory=True) for _ in range(2)]
        self.results = [torch.empty(chunk_zyx, dtype=torch.uint8,
                                    pin_memory=True) for _ in range(2)]
        self.uploaded = [None, None]  # event: the slot's upload has landed

    def stage(self, k: int, block: np.ndarray):
        """Fetch thread: block k into its pinned slot, once the slot's
        previous upload has landed."""
        if not self.cuda:
            return torch.from_numpy(block)
        slot = k % 2
        if self.uploaded[slot] is not None:
            self.uploaded[slot].synchronize()
        self.blocks[slot].numpy()[...] = block
        return slot

    def upload(self, staged) -> torch.Tensor:
        """Block on the device, ordered before the compute stream's next
        work."""
        if not self.cuda:
            return staged
        with torch.cuda.stream(self.h2d):
            block = self.blocks[staged].to(self.dev, non_blocking=True)
            landed = torch.cuda.Event()
            landed.record(self.h2d)
        self.uploaded[staged] = landed
        self.compute.wait_event(landed)
        block.record_stream(self.compute)
        return block

    def download(self, k: int, result: torch.Tensor):
        """Start result k's copy to the host after the compute stream's
        work so far."""
        if not self.cuda:
            return result.numpy(), None
        computed = torch.cuda.Event()
        computed.record(self.compute)
        self.d2h.wait_event(computed)
        host = self.results[k % 2]
        with torch.cuda.stream(self.d2h):
            host.copy_(result, non_blocking=True)
            landed = torch.cuda.Event()
            landed.record(self.d2h)
        result.record_stream(self.d2h)
        return host.numpy(), landed


def chunk_batch_tiles(plan: ChunkPlan, chunk_tiles: int,
                      dev: torch.device) -> int:
    """The tile count a chunk's batch is fitted to (``tile_batch``): the
    chunk's own on CUDA, the whole request's on the CPU (see
    ``predict_streaming``'s ``batch_size``)."""
    if dev.type == "cuda":
        return chunk_tiles
    return int(np.prod([-(-s // plan.outdimsize) for s in plan.size]))


def predict_streaming(
        fetch_box: Callable[[Tuple[int, int, int], Tuple[int, int, int]],
                            np.ndarray],
        gen: nn.Module,
        start: Sequence[int], size: Sequence[int],
        outdimsize: int, buffer: int,
        meanstd_x, meanstd_y,
        batch_size: int = 128,
        max_block_bytes: int = 1 << 30,
        mesh=None,
        out: Optional[np.ndarray] = None,
        device="cuda",
) -> np.ndarray:
    """Tiled inference over a source of any size via chunk streaming.

    Args:
      fetch_box: (corner_xyz, size_xyz) -> zyx uint8 block, zero-filled
        outside the source (``gather_box`` for host arrays).
      gen: the generator module, on ``device``.
      start, size: xyz request, like predict_tiled.
      batch_size: tiles per forward.  On CUDA each chunk runs at
        ``tile_batch(tiles in the chunk, batch_size)``, as the JAX package
        runs ``min(batch_size, tiles in the chunk)``: no chunk pads up to a
        batch larger than itself.  On the CPU every chunk runs at the whole
        request's ``tile_batch``, because there a conv's sums depend on the
        batch and the voxels must equal device mode's bit for bit.  On the
        H100 device mode gives the same bits at batches 8-128 under
        ``cudnn.deterministic`` (chip_smoke.py's volume phase holds the
        stream at 40-tile chunks bit-equal to device mode at 128).
      max_block_bytes: device budget for one haloed input block.  At most
        two blocks and two result chunks are on the device at once, so
        peak memory is about 2 * max_block_bytes + 2 * chunk bytes + the
        model's activations.
      mesh: optional mesh with a 'data' axis: each chunk's tile batches are
        dealt out over its devices, as ``device_predict_tiled(mesh=)``
        deals a request's (``batch_size`` tiles a device and a step).
      out: optional preallocated zyx uint8 output of ``size`` (e.g. a
        np.memmap for outputs larger than host RAM).
      device: "cuda" (default) or "cpu"; CUDA absent raises.
    Returns:
      zyx uint8 array of ``size`` (``out`` if given).
    """
    dev = resolve_device(device)
    devices = (data_sharding(mesh, "predict_streaming")
               if mesh is not None else None)
    check_3d_generator(gen)
    check_generator(gen, dev)
    plan = plan_chunks(start, size, outdimsize, buffer, max_block_bytes)
    b = plan.buffer
    cx, cy, cz = plan.chunk
    sx, sy, sz = plan.size

    if out is None:
        out = np.zeros((sz, sy, sx), np.uint8)
    elif out.shape != (sz, sy, sx):
        raise ValueError(f"out shape {out.shape} != request {(sz, sy, sx)}")
    elif out.dtype != np.uint8 or not out.flags.c_contiguous:
        raise ValueError("out must be C-contiguous uint8")

    n = plan.num_chunks
    if n == 0:  # zero-extent request: nothing to fetch or compute
        return out
    # Chunk-local coordinates: the block holds the halo, so each chunk's
    # tiles start at (b, b, b) and cover the whole chunk.
    chunk_tiles = plan_tiles((b, b, b), plan.chunk, outdimsize, buffer)
    batch = tile_batch(chunk_batch_tiles(plan, chunk_tiles.num_tiles, dev),
                       batch_size)
    io = _Transfers(dev, plan.block[::-1], plan.chunk[::-1])

    def fetch(k: int):
        i, j, l = plan.chunk_xyz(k)
        corner = (plan.start[0] + i * cx - b, plan.start[1] + j * cy - b,
                  plan.start[2] + l * cz - b)
        return io.stage(k, np.ascontiguousarray(
            fetch_box(corner, plan.block), np.uint8))

    def compute(block: torch.Tensor) -> torch.Tensor:
        return stitch_plan(block, gen, chunk_tiles, batch, meanstd_x,
                           meanstd_y, prepadded=True, dev=dev,
                           devices=devices)

    def write(k: int, chunk_zyx: np.ndarray, landed):
        if landed is not None:
            landed.synchronize()
        i, j, l = plan.chunk_xyz(k)
        ox, oy, oz = i * cx, j * cy, l * cz
        vz, vy, vx = min(cz, sz - oz), min(cy, sy - oy), min(cx, sx - ox)
        out[oz:oz + vz, oy:oy + vy, ox:ox + vx] = chunk_zyx[:vz, :vy, :vx]

    pending = []
    with ThreadPoolExecutor(max_workers=1) as ex:
        block = io.upload(fetch(0))
        for k in range(n):
            fut = ex.submit(fetch, k + 1) if k + 1 < n else None
            pending.append((k, *io.download(k, compute(block))))
            if fut is not None:
                block = io.upload(fut.result())  # overlaps chunk k
            if len(pending) > 1:
                write(*pending.pop(0))
        for p in pending:
            write(*p)
    return out


def predict_volume_streaming(vol_zyx: np.ndarray, gen: nn.Module,
                             start, size, meanstd_x, meanstd_y, *,
                             outdimsize: int = 40, buffer: int = 17,
                             batch_size: int = 128,
                             max_block_bytes: int = 1 << 30,
                             mesh=None, out: Optional[np.ndarray] = None,
                             device="cuda") -> np.ndarray:
    """predict_streaming over a host-resident (possibly memory-mapped) zyx
    uint8 volume."""
    def fetch_box(corner, bsize):
        return gather_box(vol_zyx, corner, bsize)

    return predict_streaming(fetch_box, gen, start, size, outdimsize, buffer,
                             meanstd_x, meanstd_y, batch_size=batch_size,
                             max_block_bytes=max_block_bytes, mesh=mesh,
                             out=out, device=device)
