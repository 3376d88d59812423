"""Cross-request tile batching: coalesce concurrent serving requests into
shared device batches.

Counterpart of ``transfer_em_tpu/infer/batcher.py``; ``TileBatcher`` is
framework-free and copied (its ``params`` became ``model`` and it records
its ``device``).  The reference's production pattern is many concurrent
64-aligned chunk requests against one cached model (model_cloudrun/
transferem.py:66-73); one 64^3 chunk is only 8 tiles, so the batcher's one
device-owning worker thread gathers tiles from all concurrent requests into
shared batches (up to ``max_batch``, lingering ``linger_ms`` for
stragglers), pads them to a multiple-of-8 bucket ladder, runs the fused
uint8 -> uint8 tile step, and resolves each tile's Future.  Results are
bit-identical to unbatched serving (the step is per-tile independent and the
bucket ladder bounds the batch shapes).
"""

from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import queue
import threading
import time
from typing import Callable, Optional

import numpy as np

from ..telemetry import current, span

_CLOSE = object()
BUCKET = 8  # default bucket granule and smallest bucket, as in the JAX package


@dataclasses.dataclass
class _Item:
    tile: np.ndarray
    future: cf.Future
    submitted: float  # time.monotonic() at submit
    request: Optional[int]  # the submitting request's id, if recorded


class TileBatcher:
    """Coalesces uint8 tiles submitted from many threads into shared device
    batches executed by one worker thread.

    Args:
      step: ``(B, insize, insize, insize) uint8 -> (B, out, out, out) uint8``
        on numpy arrays (``infer.tiling.make_tile_step``).
      insize: expected tile side, or None to accept any.
      max_batch: device batch ceiling.
      linger_ms: after the first tile of a batch arrives, wait at most this
        long for more before dispatching.
      min_bucket / bucket_granule / multiple: batches are zero-padded to
        ``max(min_bucket, round_up(k, bucket_granule))`` (clamped to
        ``max_batch``) rounded up to a multiple of ``multiple`` (the mesh's
        data-axis size when the step splits batches over it), so pad waste
        stays under ``bucket_granule`` slots per batch and few batch shapes
        ever run (the JAX package's rule, batcher.py:61-75, 178-181).
      outdimsize / buffer / meanstd_x / meanstd_y / model / device: what the
        step bakes in, when known; ``predict_tiled`` rejects a request whose
        plan, normalization, model or device differ.
    """

    def __init__(self, step: Callable, *, insize: Optional[int] = None,
                 max_batch: int = 128, linger_ms: float = 5.0,
                 min_bucket: int = BUCKET, bucket_granule: int = BUCKET,
                 multiple: int = 1,
                 outdimsize: Optional[int] = None,
                 buffer: Optional[int] = None,
                 meanstd_x=None, meanstd_y=None, model=None, device=None):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1 (got {max_batch})")
        self._step = step
        self.insize = insize
        self.outdimsize = outdimsize
        self.buffer = buffer
        self.meanstd_x = (tuple(float(v) for v in meanstd_x)
                          if meanstd_x is not None else None)
        self.meanstd_y = (tuple(float(v) for v in meanstd_y)
                          if meanstd_y is not None else None)
        self.model = model
        self.device = device
        self.max_batch = int(max_batch)
        self._min_bucket = max(1, int(min_bucket))
        self._granule = max(1, int(bucket_granule))
        self._multiple = max(1, int(multiple))
        self._linger = float(linger_ms) / 1000.0
        self._q: queue.Queue = queue.Queue()
        self._lock = threading.Lock()
        self._closed = False
        self._stats = {"batches": 0, "tiles": 0, "padded": 0, "largest": 0,
                       "errors": 0, "queue_wait_s": 0.0,
                       "queue_wait_max_s": 0.0, "linger_s": 0.0}
        self._thread = threading.Thread(target=self._worker, daemon=True,
                                        name="TileBatcher")
        self._thread.start()

    # -- client side -------------------------------------------------------

    def submit(self, tile_u8: np.ndarray) -> cf.Future:
        """Queue one uint8 tile; the Future resolves to its predicted
        (trimmed, uint8, zyx) output tile.  Raises RuntimeError once the
        batcher is closed (callers fall back to :meth:`run_direct`)."""
        tile = np.asarray(tile_u8, np.uint8)
        if self.insize is not None and tile.shape != (self.insize,) * 3:
            raise ValueError(
                f"tile shape {tile.shape} != expected "
                f"{(self.insize,) * 3} — this batcher was built for a "
                "different tile plan (outdimsize/buffer)")
        fut: cf.Future = cf.Future()
        rec = current()
        item = _Item(tile, fut, time.monotonic(),
                     rec["request"] if rec is not None else None)
        # The closed-check and the put share close()'s lock, so no tile can
        # land behind the sentinel (a tile behind a dead worker would hang).
        with self._lock:
            if self._closed:
                raise RuntimeError("TileBatcher is closed")
            self._q.put(item)
        return fut

    def run_direct(self, tile_u8: np.ndarray) -> np.ndarray:
        """Run ONE tile synchronously on the caller's thread (works after
        close(); same bucket shapes as the worker)."""
        tile = np.asarray(tile_u8, np.uint8)
        arr = np.zeros((self._bucket(1),) + tile.shape, np.uint8)
        arr[0] = tile
        return np.asarray(self._step(arr))[0]

    def stats(self) -> dict:
        """Counters: batches run, tiles served, zero-pad slots, largest
        batch, errors, occupancy = tiles / (tiles + padded), and seconds:
        ``queue_wait_s`` (each tile's wait from submit until its batch is
        dispatched, summed), ``queue_wait_max_s`` (the longest) and
        ``linger_s`` (the worker's waits for a batch to fill, summed)."""
        with self._lock:
            s = dict(self._stats)
        total = s["tiles"] + s["padded"]
        s["occupancy"] = (s["tiles"] / total) if total else 1.0
        return s

    def close(self, wait: bool = True):
        """Stop the worker.  Idempotent; pending tiles still resolve, later
        submits raise.  ``wait=False`` lets the daemon worker drain in the
        background (the model-cache eviction path)."""
        with self._lock:
            if not self._closed:
                self._closed = True
                self._q.put(_CLOSE)
        if wait:  # outside the lock: the worker needs it for its stats
            self._thread.join(timeout=30)

    # -- worker side -------------------------------------------------------

    def _bucket(self, k: int) -> int:
        b = max(self._min_bucket, -(-k // self._granule) * self._granule)
        b = min(max(b, k), max(self.max_batch, k))
        return -(-b // self._multiple) * self._multiple

    def _gather(self, first: _Item):
        """First tile in hand: wait up to linger for more, then take
        whatever else is already queued, up to max_batch."""
        batch = [first]
        deadline = time.monotonic() + self._linger
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            try:
                if remaining > 0:
                    item = self._q.get(timeout=remaining)
                else:
                    item = self._q.get_nowait()
            except queue.Empty:
                break
            if item is _CLOSE:
                self._q.put(_CLOSE)  # re-deliver to the outer loop
                break
            batch.append(item)
        return batch

    def _run(self, batch):
        groups: dict = {}
        for item in batch:
            groups.setdefault(item.tile.shape, []).append(item)
        for shape, grp in groups.items():
            # Claim each future first: a cancelled one drops out here and
            # set_result below cannot raise InvalidStateError.
            grp = [it for it in grp
                   if it.future.set_running_or_notify_cancel()]
            if not grp:
                continue
            k = len(grp)
            now = time.monotonic()
            waits = [now - it.submitted for it in grp]
            with self._lock:
                self._stats["queue_wait_s"] += sum(waits)
                self._stats["queue_wait_max_s"] = max(
                    self._stats["queue_wait_max_s"], max(waits))
            try:
                bucket = self._bucket(k)
                arr = np.zeros((bucket,) + shape, np.uint8)
                for i, item in enumerate(grp):
                    arr[i] = item.tile
                with span("batcher.step", self.device,
                          request=grp[0].request):
                    pred = np.asarray(self._step(arr))
            except BaseException as e:  # noqa: BLE001 — must not hang callers
                for item in grp:
                    item.future.set_exception(e)
                with self._lock:
                    self._stats["errors"] += 1
                continue
            for i, item in enumerate(grp):
                item.future.set_result(pred[i])
            with self._lock:
                self._stats["batches"] += 1
                self._stats["tiles"] += k
                self._stats["padded"] += bucket - k
                self._stats["largest"] = max(self._stats["largest"], k)

    def _worker(self):
        while True:
            item = self._q.get()
            if item is _CLOSE:
                return
            t0 = time.monotonic()
            with span("batcher.linger", request=item.request):
                batch = self._gather(item)
            with self._lock:
                self._stats["linger_s"] += time.monotonic() - t0
            try:
                self._run(batch)
            except BaseException as e:  # noqa: BLE001 — worker must survive
                for it in batch:
                    if not it.future.done():
                        try:
                            it.future.set_exception(e)
                        except cf.InvalidStateError:
                            pass
                with self._lock:
                    self._stats["errors"] += 1


def make_tile_batcher(gen, meanstd_x, meanstd_y, outdimsize: int,
                      buffer: int, *, device="cuda",
                      max_batch: Optional[int] = None,
                      linger_ms: float = 5.0, mesh=None,
                      sharding=None, min_bucket: int = BUCKET,
                      bucket_granule: int = BUCKET) -> TileBatcher:
    """Build a TileBatcher around one model's fused tile step on ``device``.

    Takes the (outdimsize, buffer) the model's meta.json records and applies
    the multiple-of-6 trim / tpad fold exactly as ``plan_tiles`` does, so
    the batcher serves any ``predict_tiled`` request for this model.
    ``max_batch=None``: the width-aware default (128 at wf=8).  ``mesh``:
    split every batch over the mesh's 'data' axis, one generator replica a
    device (bucket sizes round up to the axis size); ``sharding`` takes the
    devices (``tiling.data_sharding(mesh)``) instead.  ``min_bucket`` /
    ``bucket_granule``: :class:`TileBatcher`'s.
    """
    from ..device import resolve_device
    from ..shapes import tile_plan_outdimsize
    from .tiling import data_sharding, default_batch_size, make_tile_step

    if mesh is not None:
        if sharding is not None:
            raise ValueError("pass either mesh= or sharding=, not both")
        sharding = data_sharding(mesh)
    dev = resolve_device(device)
    if max_batch is None:
        max_batch = default_batch_size(gen)
    eff_out, eff_buf, tpad = tile_plan_outdimsize(outdimsize, buffer)
    step = make_tile_step(gen, meanstd_x, meanstd_y, tpad, dev, sharding)
    return TileBatcher(step, insize=eff_out + 2 * eff_buf,
                       max_batch=max_batch, linger_ms=linger_ms,
                       min_bucket=min_bucket, bucket_granule=bucket_granule,
                       multiple=len(sharding) if sharding is not None else 1,
                       outdimsize=eff_out, buffer=eff_buf,
                       meanstd_x=meanstd_x, meanstd_y=meanstd_y,
                       model=gen, device=dev)
