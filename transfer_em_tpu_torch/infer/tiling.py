"""Tiled large-volume inference with VALID-conv overlap stitching.

Counterpart of ``transfer_em_tpu/infer/tiling.py`` (reference
transfer_em/utils.py:41-130 ``predict_ng_cube``): the same tile plan (output
tile trimmed to a multiple of 6, 40 -> 36, the trim ``tpad=2`` folded into
the halo, 17 -> 19; utils.py:70-75), tiles batched uint8 in / uint8 out,
and a host memcpy scatter (native/).

The fused tile step runs on the GPU: uint8 -> preprocess kernel ->
UNetGenerator (conv3 + LeakyReLU kernels, cuDNN k4 convs) -> postprocess
kernel, which reads the tpad-trimmed window in place -> uint8.  Device work
comes from one thread at a time: every step holds ``_DEVICE_LOCK`` (on the
batched path only the batcher's worker runs steps, so it is uncontended).

With ``mesh=`` (a ``parallel.make_mesh`` mesh with a 'data' axis) every tile
batch is split over the data axis's devices, one generator replica each:
the multi-card path for sources streamed from the host or remote storage.
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import math
import threading
import time
from collections import deque
from typing import Callable, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ..data.sources import (CloudRunFetcher, _parallel_fetch,
                            open_tensorstore, read_ts_box_zyx)
from ..device import resolve_device
from ..native import scatter_blocks
from ..ops.normalize import postprocess_to_u8, preprocess_u8
from ..parallel.mesh import replicas
from ..shapes import tile_plan_outdimsize
from ..telemetry import span

_DEVICE_LOCK = threading.Lock()
FETCH_THREADS = 8  # predict_tiled default: tile fetches in flight 2x this


class InferenceCancelled(RuntimeError):
    """Raised by predict_tiled when its ``should_cancel`` callback fires
    (client disconnect / request timeout in the serving layer)."""


@dataclasses.dataclass(frozen=True)
class TilePlan:
    """Static description of one tiled-inference run."""

    start: Tuple[int, int, int]        # requested xyz start
    size: Tuple[int, int, int]         # requested xyz size
    outdimsize: int                    # effective output tile (multiple of 6)
    buffer: int                        # effective halo (incl. folded tpad)
    tpad: int                          # extra trim per face on model output
    corners: Tuple[Tuple[int, int, int], ...]   # fetch corners (xyz, -buffer)
    indices: Tuple[Tuple[int, int, int], ...]   # output offsets (xyz)
    padded_size: Tuple[int, int, int]  # zyx padded output-buffer shape

    @property
    def insize(self) -> int:
        return self.outdimsize + 2 * self.buffer

    @property
    def num_tiles(self) -> int:
        return len(self.corners)


def plan_tiles(start: Sequence[int], size: Sequence[int], outdimsize: int,
               buffer: int) -> TilePlan:
    """Chunk an xyz request into overlapping tiles (reference utils.py:68-104)."""
    outdimsize, buffer, tpad = tile_plan_outdimsize(outdimsize, buffer)
    corners: List[Tuple[int, int, int]] = []
    indices: List[Tuple[int, int, int]] = []
    for x in range(start[0], start[0] + size[0], outdimsize):
        for y in range(start[1], start[1] + size[1], outdimsize):
            for z in range(start[2], start[2] + size[2], outdimsize):
                corners.append((x - buffer, y - buffer, z - buffer))
                indices.append((x - start[0], y - start[1], z - start[2]))
    padded = []
    for s in size:
        extra = (outdimsize - s % outdimsize) % outdimsize
        padded.append(s + extra)
    padded_zyx = (padded[2], padded[1], padded[0])
    return TilePlan(start=tuple(start), size=tuple(size),
                    outdimsize=outdimsize, buffer=buffer, tpad=tpad,
                    corners=tuple(corners), indices=tuple(indices),
                    padded_size=padded_zyx)


def check_generator(gen: nn.Module, dev: torch.device) -> None:
    """Raise unless ``gen``'s parameters live on ``dev``."""
    on = next(gen.parameters()).device
    if on != dev:
        raise ValueError(f"generator lives on {on}, the prediction was "
                         f"asked for {dev}")


def check_3d_generator(gen: Optional[nn.Module]) -> None:
    """Raise ValueError for a 2D generator: the tile-grid entry points
    (predict_tiled, device_predict_tiled, slab_predict, predict_streaming,
    ModelService) plan zyx cubes, as the JAX package's ``plan_tiles`` does,
    and refuse one here rather than deep inside a conv."""
    if gen is not None and not getattr(gen, "is3d", True):
        raise ValueError("tiled volume inference is 3D (zyx cubes); this is "
                         "a 2D generator: run 2D images through "
                         "make_tile_step or EM2EM.predict")


def meanstd_tuple(meanstd):
    """A (mean, std) pair of Python floats, or None; accepts any 2-sequence
    (an ndarray included)."""
    return tuple(float(v) for v in meanstd) if meanstd is not None else None


def data_sharding(mesh, who: str = "tiled inference") -> List[torch.device]:
    """The devices of ``mesh``'s 'data' axis, one per shard of a tile batch
    (the JAX package's NamedSharding over 'data'; positions along the other
    axes would repeat the same work).  Inference runs in one process, so
    every one of them must be this process's."""
    if "data" not in mesh.shape:
        raise ValueError(
            f"{who} needs a mesh with a 'data' axis (got axes "
            f"{tuple(mesh.shape)}); for spatially-sharded inference use "
            "parallel.halo_predict")
    if mesh.spans_processes:
        raise ValueError(f"{who} runs in one process; this mesh spans "
                         "several (use a mesh of this process's devices)")
    return mesh.axis_devices("data")


def make_tile_step(gen: nn.Module, meanstd_x, meanstd_y, tpad: int,
                   device="cuda", sharding: Optional[Sequence] = None
                   ) -> Callable[[np.ndarray], np.ndarray]:
    """Fused step: (B, s, s, s) uint8 numpy -> (B, o, o, o) uint8 numpy on
    ``device`` (where ``gen`` must already live); for a 2D generator
    (B, s, s) -> (B, o, o), as the JAX package's step takes either rank.
    ``o`` is the generator's output side less ``2 * tpad``.  ``sharding``:
    devices (``data_sharding(mesh)``) to split every batch over, in equal
    parts, each on a replica of ``gen``; B must divide by their count.
    A step's spans (``telemetry``): ``tile_step.h2d`` and
    ``tile_step.forward`` for each part, then ``tile_step.d2h``."""
    dev = resolve_device(device)
    check_generator(gen, dev)
    ms_x, ms_y = meanstd_tuple(meanstd_x), meanstd_tuple(meanstd_y)
    tpad = int(tpad)
    devices = list(sharding) if sharding is not None else [dev]

    def step(tiles_u8: np.ndarray) -> np.ndarray:
        arr = np.ascontiguousarray(tiles_u8, np.uint8)
        if len(arr) % len(devices):
            raise ValueError(f"batch {len(arr)} does not split over "
                             f"{len(devices)} devices")
        gens = replicas(gen, devices)  # refreshed if gen's weights changed
        with _DEVICE_LOCK, torch.inference_mode():
            # every part is launched before any is read back, so the
            # devices run together
            outs = []
            for d, g, part in zip(devices, gens,
                                  np.split(arr, len(devices))):
                with span("tile_step.h2d"):
                    x = torch.from_numpy(part).to(d)
                with span("tile_step.forward", d):
                    outs.append(postprocess_to_u8(g(preprocess_u8(x, ms_x)),
                                                  ms_y, tpad))
            with span("tile_step.d2h"):
                return np.concatenate([o.cpu().numpy() for o in outs])

    return step


def scatter_tiles(out_zyx: np.ndarray, tiles_u8: np.ndarray,
                  indices: Sequence[Tuple[int, int, int]], outdimsize: int):
    """Write predicted tiles (zyx each) into the zyx output buffer at xyz
    indices (reference utils.py:121-125), with the native memcpy scatter."""
    scatter_blocks(out_zyx, tiles_u8, indices, outdimsize)


def default_batch_size(gen: nn.Module, ceiling: int = 128,
                       floor: int = 8) -> int:
    """Width-aware device batch: ``ceiling`` * 32 / widest conv output,
    rounded down to a multiple of 8, within [``floor``, ``ceiling``] (wf=8
    -> 128, wf=4 -> 64, wf=1 -> 16 at the defaults), the JAX package's
    rule (tiling.py:150-174); a generator without conv kernels gets
    ``ceiling``.

    128 at wf=8 holds on the H100: device mode over a 360^3 request (1000
    tiles, f32) ran 127.9-134.1 / 131.4-134.7 / 133.0-134.5 Mvox/s at
    B = 64 / 128 / 256 in three calls of chip_smoke.py (``volume``; NVIDIA
    H100 80GB HBM3, 700 W), with peak memory 2.1 / 4.2 / 8.2 GB: no batch
    is faster by more than the spread between calls, and 256 takes twice
    the memory.  16 at wf=1 holds too: bf16 device mode over a 180^3
    request (125 tiles) ran 28.91-28.99 / 30.59-30.66 / 31.18-31.25
    Mvox/s at B = 8 / 16 / 32 in two calls of chip_smoke.py (``wide``;
    the same card), with peak memory 1.05 / 2.01 / 3.95 GB: B=32 gains 2%
    for twice the memory.  wf = 2 and 4 are not measured on the card."""
    widest = max((int(p.shape[-1]) for p in gen.parameters()
                  if p.dim() >= 4), default=0)
    if widest <= 0:
        return ceiling
    return max(floor, min(ceiling, (ceiling * 32 // widest) // 8 * 8))


def tile_batch(n_tiles: int, batch_size: int, multiple: int = 1) -> int:
    """Tiles per device step for a request of ``n_tiles``: small requests
    must not pay full-batch padding, so ``batch_size`` is clamped to the
    tile count rounded up to a multiple of 8 (as in the JAX package).  The
    tile-grid modes (tiles, device, stream) run at this shape, so they
    agree bit for bit: a conv's summation order may depend on the batch
    (on the CPU it does; the stream fits each chunk's batch to the chunk on
    CUDA only, infer/stream.py).  ``multiple``: a batch split over that
    many devices is rounded up to a multiple of it, before and after the
    clamp, as the JAX package rounds to its mesh's data axis."""
    batch_size = -(-batch_size // multiple) * multiple
    ladder = n_tiles if n_tiles <= 8 else -(-n_tiles // 8) * 8
    clamped = -(-min(batch_size, ladder) // multiple) * multiple
    return max(1, clamped)


def _check_batcher(batcher, plan: TilePlan, gen, meanstd_x, meanstd_y,
                   dev: torch.device) -> None:
    """Reject a shared batcher built for another plan, normalization, model
    or device: its baked-in step would serve the wrong voxels silently."""
    for attr, planned in (("insize", plan.insize),
                          ("outdimsize", plan.outdimsize),
                          ("buffer", plan.buffer)):
        built = getattr(batcher, attr, None)
        if built is not None and built != planned:
            raise ValueError(
                f"batcher was built for {attr}={built}, this request plans "
                f"{planned} — outdimsize/buffer mismatch")
    for attr, asked in (("meanstd_x", meanstd_x), ("meanstd_y", meanstd_y)):
        built = getattr(batcher, attr, None)
        if built is None or asked is None:
            continue
        asked_t = tuple(float(v) for v in asked)
        if any(not math.isclose(b, a, rel_tol=1e-9, abs_tol=1e-12)
               for b, a in zip(built, asked_t)):
            raise ValueError(
                f"batcher was built for {attr}={built}, this request passes "
                f"{asked_t}; build a batcher for this model/meanstd")
    built_model = getattr(batcher, "model", None)
    if built_model is not None and gen is not None and built_model is not gen:
        raise ValueError("batcher was built over a different generator than "
                         "this request's; build a batcher for this model")
    built_dev = getattr(batcher, "device", None)
    if built_dev is not None and built_dev != dev:
        raise ValueError(f"batcher runs on {built_dev}, this request asked "
                         f"for {dev}")


def predict_tiled(
        fetch_tile: Callable[[Tuple[int, int, int], int], np.ndarray],
        gen: Optional[nn.Module],
        start: Sequence[int], size: Sequence[int],
        outdimsize: int, buffer: int,
        meanstd_x, meanstd_y,
        batch_size: int = 8,
        batcher=None,
        out: Optional[np.ndarray] = None,
        should_cancel: Optional[Callable[[], bool]] = None,
        device="cuda",
        mesh=None,
        sharding=None,
        fetch_input: bool = False,
        fetch_threads: int = FETCH_THREADS,
):
    """Full tiled inference: fetch -> batched fused step -> stitch -> crop.

    Args:
      fetch_tile: (corner_xyz, insize) -> uint8 zyx cube (the data source).
      gen: the generator module, on ``device`` (unused for compute when a
        ``batcher`` is given, which carries its own step).
      batch_size: tiles per device step.  Batches are zero-padded to
        ``batch_size``, clamped to the request's tile count rounded up to a
        multiple of 8 (as in the JAX package), so few batch shapes run.
      batcher: optional ``infer.batcher.TileBatcher`` shared with other
        concurrent requests against the same model (bit-identical results).
      out: optional preallocated zyx uint8 output of ``size``.
      should_cancel: polled per fetched tile, before each device dispatch,
        and every 0.2 s while awaiting batcher futures; when it returns True
        the run raises ``InferenceCancelled``.
      device: "cuda" (default) or "cpu"; CUDA absent raises.
      mesh: optional mesh with a 'data' axis: each tile batch is split over
        its devices (``batch_size`` is rounded up to a multiple of the
        axis size, before and after the clamp).  ``sharding`` takes the
        devices (``data_sharding(mesh)``) instead.  Unused with a batcher,
        which carries its own.
      fetch_input: also stitch the input voxels under each output tile.
      fetch_threads: ``fetch_tile`` calls run on this many threads, twice
        as many tiles in flight (the JAX package's default, 8).
    Returns:
      the zyx uint8 prediction of ``size`` (``out`` if given); with
      ``fetch_input``, the pair (input, prediction).
    """
    if mesh is not None:
        if sharding is not None:
            raise ValueError("pass either mesh= or sharding=, not both")
        sharding = data_sharding(mesh)
    dev = resolve_device(device)
    check_3d_generator(gen)
    plan = plan_tiles(start, size, outdimsize, buffer)
    batch_size = tile_batch(plan.num_tiles, batch_size,
                            len(sharding) if sharding is not None else 1)
    if out is not None:
        want = (size[2], size[1], size[0])  # zyx
        if tuple(out.shape) != want:
            raise ValueError(f"out shape {out.shape} != request zyx {want}")
        if out.dtype != np.uint8 or not out.flags.c_contiguous:
            raise ValueError("out must be C-contiguous uint8")
    if batcher is not None:
        _check_batcher(batcher, plan, gen, meanstd_x, meanstd_y, dev)
        return _predict_tiled_batched(batcher, fetch_tile, plan, out=out,
                                      should_cancel=should_cancel,
                                      fetch_input=fetch_input,
                                      fetch_threads=fetch_threads)
    step = make_tile_step(gen, meanstd_x, meanstd_y, plan.tpad, dev,
                          sharding)

    user_out = out is not None
    if out is None:
        out = np.zeros(plan.padded_size, np.uint8)
    in_out = np.zeros(plan.padded_size, np.uint8) if fetch_input else None
    lo, hi = plan.buffer, plan.buffer + plan.outdimsize
    fetched = _parallel_fetch(iter(plan.corners),
                              lambda c: fetch_tile(c, plan.insize),
                              fetch_threads)
    batch_tiles: List[np.ndarray] = []
    batch_idx: List[Tuple[int, int, int]] = []

    def flush():
        if not batch_tiles:
            return
        if should_cancel is not None and should_cancel():
            raise InferenceCancelled("tiled inference cancelled")
        k = len(batch_tiles)
        arr = np.zeros((batch_size,) + batch_tiles[0].shape, np.uint8)
        arr[:k] = batch_tiles
        scatter_tiles(out, step(arr)[:k], batch_idx, plan.outdimsize)
        if fetch_input:
            scatter_tiles(in_out, arr[:k, lo:hi, lo:hi, lo:hi], batch_idx,
                          plan.outdimsize)
        batch_tiles.clear()
        batch_idx.clear()

    for tile, idx in zip(fetched, plan.indices):
        if should_cancel is not None and should_cancel():
            raise InferenceCancelled("tiled inference cancelled")
        batch_tiles.append(np.asarray(tile, np.uint8))
        batch_idx.append(idx)
        if len(batch_tiles) == batch_size:
            flush()
    flush()
    return _result(out, in_out, plan, user_out)


def _result(out, in_out, plan: TilePlan, user_out: bool):
    """The request's crop of the stitched output (a caller's ``out`` is
    already exact), and of the stitched input where it was fetched."""
    sx, sy, sz = plan.size
    res = out if user_out else out[:sz, :sy, :sx]
    if in_out is not None:
        return in_out[:sz, :sy, :sx], res
    return res


def _predict_tiled_batched(batcher, fetch_tile, plan: TilePlan,
                           out: Optional[np.ndarray] = None,
                           should_cancel: Optional[Callable[[], bool]]
                           = None, fetch_input: bool = False,
                           fetch_threads: int = FETCH_THREADS):
    """predict_tiled's loop when a shared TileBatcher owns the device:
    submit tiles as they are fetched, scatter as futures resolve.  In-flight
    tiles are capped at 4 batches' worth to bound host RAM."""
    user_out = out is not None
    if out is None:
        out = np.zeros(plan.padded_size, np.uint8)
    in_out = np.zeros(plan.padded_size, np.uint8) if fetch_input else None
    lo, hi = plan.buffer, plan.buffer + plan.outdimsize
    pending: deque = deque()

    def drain(n):
        for _ in range(n):
            fut, idx, tin = pending.popleft()
            # Bounded wait (600 s >> any batch); poll should_cancel every
            # 0.2 s so a hangup or deadline unblocks this thread mid-batch.
            if should_cancel is None:
                pred = fut.result(timeout=600)
            else:
                t0 = time.monotonic()
                while True:
                    try:
                        pred = fut.result(timeout=0.2)
                        break
                    except cf.TimeoutError:
                        if should_cancel():
                            raise InferenceCancelled(
                                "tiled inference cancelled")
                        if time.monotonic() - t0 > 600:
                            raise
            scatter_tiles(out, pred[None], [idx], plan.outdimsize)
            if tin is not None:
                scatter_tiles(in_out, tin[None], [idx], plan.outdimsize)

    fetched = _parallel_fetch(iter(plan.corners),
                              lambda c: fetch_tile(c, plan.insize),
                              fetch_threads)
    cap = 4 * batcher.max_batch
    for tile, idx in zip(fetched, plan.indices):
        if should_cancel is not None and should_cancel():
            raise InferenceCancelled("tiled inference cancelled")
        t = np.asarray(tile, np.uint8)
        # a copy: a view would keep the whole insize^3 tile in `pending`
        tin = t[lo:hi, lo:hi, lo:hi].copy() if fetch_input else None
        try:
            fut = batcher.submit(t)
        except RuntimeError:
            # Batcher closed under us (model eviction or shutdown): run this
            # tile synchronously on our own thread and keep going.
            fut = cf.Future()
            fut.set_result(batcher.run_direct(t))
        pending.append((fut, idx, tin))
        if len(pending) > cap:
            drain(len(pending) - cap)
    drain(len(pending))
    return _result(out, in_out, plan, user_out)


def predict_ng_cube(location: str, start, size, model, meanstd_x, meanstd_y,
                    cloudrun: Optional[str] = None, fetch_input: bool = False,
                    outdimsize: Optional[int] = None,
                    buffer: Optional[int] = None, batch_size: int = 8,
                    mesh=None, batcher=None,
                    out: Optional[np.ndarray] = None, device="cuda"):
    """Tiled inference of an xyz ``start``/``size`` region of a
    neuroglancer-precomputed volume (reference utils.py:41; the JAX
    package's ``predict_ng_cube``).

    ``model``: an ``EM2EM`` (its generator G, ``outdimsize`` and
    ``buffer``), or a generator module with explicit ``outdimsize`` and
    ``buffer``.  ``location``: 'bucket/path' (GCS) or 'file://...'.
    ``cloudrun=None`` reads through tensorstore, zero-filled outside the
    volume's domain; otherwise through the data service at that URL
    (``POST /volume``).  ``fetch_input``, ``batch_size``, ``batcher``,
    ``out``, ``device`` and ``mesh`` as in ``predict_tiled``."""
    dev = resolve_device(device)
    if hasattr(model, "outdimsize"):
        outdimsize = model.outdimsize if outdimsize is None else outdimsize
        buffer = model.buffer if buffer is None else buffer
        gen = model.state.gg
    else:
        gen = model
        if outdimsize is None or buffer is None:
            raise ValueError("a generator module needs explicit outdimsize "
                             "and buffer")

    if cloudrun is None:
        ds = open_tensorstore(location)
        dom_lo = np.asarray(ds.domain.inclusive_min[:3], np.int64)
        dom_hi = np.asarray(ds.domain.exclusive_max[:3], np.int64)

        def fetch_tile(corner, insize):
            return read_ts_box_zyx(ds, corner, (insize,) * 3, dom_lo, dom_hi)
    else:
        fetcher = CloudRunFetcher(cloudrun, location)

        def fetch_tile(corner, insize):
            return fetcher.fetch(corner, insize)

    return predict_tiled(fetch_tile, gen, start, size, outdimsize, buffer,
                         meanstd_x, meanstd_y, batch_size=batch_size,
                         batcher=batcher, out=out, device=dev, mesh=mesh,
                         fetch_input=fetch_input)
