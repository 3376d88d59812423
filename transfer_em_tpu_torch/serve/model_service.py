"""Model-serving service: POST / runs the generator on a 64-aligned chunk.

Counterpart of ``transfer_em_tpu/serve/model_service.py`` (reference
model_cloudrun/transferem.py): request {location, start, glbstart, size,
model_name, dest} -> validate 64-alignment (:66-73), load/cache the model
(:85-116), read the chunk + halo (:118-135), batched tiled inference on the
GPU, write the result as 64^3 gzip neuroglancer blocks named
"x0-x1_y0-y1_z0-z1" under dest (:158-189).

Model roots and destinations are local directories or ``gs://bucket/
prefix`` (google-cloud-storage, imported only there).  Device work comes
from one thread at a time: the shared TileBatcher's worker (cross_batch, the
default), or the tile step's device lock on the unbatched path.
"""

from __future__ import annotations

import gzip
import json
import os
import re
import selectors
import shutil
import socket
import tempfile
import threading
import time
import traceback
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional

import numpy as np

from ..device import resolve_device
from ..infer.export import load_generator
from ..infer.tiling import (InferenceCancelled, check_3d_generator,
                            data_sharding, predict_tiled)
from ..telemetry import current, span, totals
from .backends import open_volume

BLOCK = 64
_NAME_RE = re.compile(r"[A-Za-z0-9._-]+")
# the layers whose span totals GET /stats reports under "stages"
STAGES = ("serve.", "batcher.", "tile_step.")


def _sock_eof(sock) -> bool:
    """True when the peer has closed (or the socket is dead): a non-blocking
    peek, polled as predict_tiled's should_cancel hook.  selectors rather
    than select.select, which fails for fd >= 1024."""
    try:
        sel = selectors.DefaultSelector()
        try:
            sel.register(sock, selectors.EVENT_READ)
            if not sel.select(timeout=0):
                return False
        finally:
            sel.close()
        return sock.recv(1, socket.MSG_PEEK) == b""
    except (OSError, ValueError, KeyError):
        return True


class _Limiter:
    """Bounded request admission: at most ``limit`` chunk requests compute
    at once; the rest get an immediate 503 + Retry-After (the reference
    deployment's Cloud Run concurrency, cloudrun_functions/README.md:60-66).
    """

    def __init__(self, limit: int):
        self.limit = int(limit)
        self._sem = threading.BoundedSemaphore(self.limit)
        self._lock = threading.Lock()
        self.admitted = 0
        self.rejected = 0

    def try_acquire(self) -> bool:
        ok = self._sem.acquire(blocking=False)
        with self._lock:
            if ok:
                self.admitted += 1
            else:
                self.rejected += 1
        return ok

    def release(self):
        self._sem.release()

    def stats(self):
        with self._lock:
            return {"limit": self.limit, "admitted": self.admitted,
                    "rejected": self.rejected}


class BlockWriter:
    """Write named blobs to a destination: a local directory or a
    ``gs://bucket/prefix`` (blobs ``<prefix>/<name>``)."""

    def __init__(self, dest: str):
        self.dest = dest
        self.is_gcs = dest.startswith("gs://")
        if self.is_gcs:
            from google.cloud import storage
            bucket, *prefix = dest[len("gs://"):].split("/")
            self.bucket = storage.Client().bucket(bucket)
            self.prefix = "/".join(prefix)
        else:
            os.makedirs(dest, exist_ok=True)

    def write(self, name: str, raw: bytes, compress: bool = True):
        """``compress``: gzip with mtime=0 (identical payloads give
        identical blocks) and, on GCS, Content-Encoding gzip, as the
        reference uploads a block (model_cloudrun/transferem.py:182-184).
        ``compress=False`` writes ``raw`` as it is: the reference stores the
        ``info`` manifest plain (custom_online/predictor.py:126-127)."""
        payload = gzip.compress(raw, mtime=0) if compress else raw
        if not self.is_gcs:
            with open(os.path.join(self.dest, name), "wb") as f:
                f.write(payload)
            return
        blob = self.bucket.blob(f"{self.prefix}/{name}")
        if compress:
            blob.content_encoding = "gzip"
            blob.upload_from_string(payload,
                                    content_type="application/octet-stream")
        else:
            blob.upload_from_string(payload)


def write_ng_blocks(data_zyx: np.ndarray, dest: str, offset_xyz,
                    num_threads: int = 4):
    """Chunk a zyx volume into 64^3 gzip blocks named like the reference
    (model_cloudrun/transferem.py:172-189)."""
    writer = BlockWriter(dest)
    sz, sy, sx = data_zyx.shape
    ox, oy, oz = offset_xyz
    jobs = [(x, y, z) for z in range(0, sz, BLOCK)
            for y in range(0, sy, BLOCK) for x in range(0, sx, BLOCK)]

    def job(args):
        x, y, z = args
        block = data_zyx[z:z + BLOCK, y:y + BLOCK, x:x + BLOCK]
        name = (f"{x+ox}-{x+block.shape[2]+ox}_"
                f"{y+oy}-{y+block.shape[1]+oy}_"
                f"{z+oz}-{z+block.shape[0]+oz}")
        writer.write(name, block.tobytes())

    with ThreadPoolExecutor(max_workers=num_threads) as ex:
        list(ex.map(job, jobs))


def _validate_model_name(model_name: str):
    """'name' or 'name:version' with [A-Za-z0-9._-] components, checked
    before any path join (os.path.join honours absolute parts and '..')."""
    parts = model_name.split(":")
    if (not 1 <= len(parts) <= 2
            or any(not _NAME_RE.fullmatch(p) or p in (".", "..")
                   for p in parts)):
        raise ValueError(
            f"invalid model_name {model_name!r}: expected 'name' or "
            "'name:version' with [A-Za-z0-9._-] components")
    return parts


def _add_batcher_stats(total: dict, stats: dict) -> None:
    """Add a batcher's counters and seconds to ``total``; of the longest
    queue waits keep the larger."""
    for k in total:
        v = stats.get(k, 0)
        total[k] = max(total[k], v) if k.endswith("_max_s") else total[k] + v


class ModelCache:
    """LRU model cache keyed by model_name ("name:version" ->
    <root>/name/version/).  ``capacity`` 1 keeps the reference's single
    cached model (model_cloudrun/transferem.py:85-116).

    ``model_root`` is a local directory or ``gs://bucket/prefix``; a gs://
    model is staged blob by blob into a fresh local directory, which is
    removed when the load fails, when the model is evicted and on
    ``close()``.

    ``batcher_factory``: optional (gen, meta) -> TileBatcher; every cached
    model then carries one shared cross-request batcher, closed when the
    model is evicted or the cache is closed.  Entries are (gen, meta,
    batcher)."""

    def __init__(self, model_root: str, batcher_factory=None,
                 capacity: int = 1, device="cuda", compute_dtype=None):
        if capacity < 1:
            raise ValueError(f"capacity must be >= 1 (got {capacity})")
        self.model_root = model_root
        self.batcher_factory = batcher_factory
        self.capacity = int(capacity)
        self.device = resolve_device(device)
        self.compute_dtype = compute_dtype
        self._lock = threading.Lock()
        self._entries: OrderedDict = OrderedDict()
        self._loading = {}  # name -> Future of a load in flight
        self._gcs_dir = None  # local root of the gs:// staging dirs
        self._staging = {}  # name -> its entry's staging dir (gs:// roots)
        self._closed = False
        # Counters of evicted models' batchers, so /stats keeps the
        # service's history under eviction churn.
        self._retired = {"batches": 0, "tiles": 0, "padded": 0, "errors": 0,
                         "queue_wait_s": 0.0, "queue_wait_max_s": 0.0,
                         "linger_s": 0.0}

    def _download_gcs_model(self, parts) -> str:
        """Stage ``<root-prefix>/<name>/<version>/`` from GCS into a fresh
        local directory, blob by blob (the reference downloads the model
        from MODEL_BUCKET on every miss, model_cloudrun/transferem.py:
        85-116); a fresh directory per fetch, so a republished version
        never mixes with an earlier fetch's files."""
        from google.cloud import storage
        bucket_name, *root_prefix = self.model_root[len("gs://"):].split("/")
        prefix = "/".join([p for p in root_prefix if p] + list(parts))
        with self._lock:
            if self._closed:  # close() already removed the staging root
                raise RuntimeError("ModelCache is closed")
            if self._gcs_dir is None:
                self._gcs_dir = tempfile.mkdtemp(prefix="tem_models_")
            root = self._gcs_dir
        local = tempfile.mkdtemp(prefix="_".join(parts) + "_", dir=root)
        try:
            client = storage.Client()
            n = 0
            for blob in client.list_blobs(client.bucket(bucket_name),
                                          prefix=prefix + "/"):
                rel = blob.name[len(prefix) + 1:]
                if not rel or rel.endswith("/"):
                    continue
                dst = os.path.join(local, rel)
                os.makedirs(os.path.dirname(dst), exist_ok=True)
                blob.download_to_filename(dst)
                n += 1
            if n == 0:
                raise FileNotFoundError(
                    f"no model blobs under gs://{bucket_name}/{prefix}/")
        except BaseException:
            shutil.rmtree(local, ignore_errors=True)
            raise
        return local

    def get(self, model_name: str):
        """Return the cached ``(gen, meta, batcher)``, loading on a miss.
        The load (a gs:// download included) runs outside the cache lock,
        so hits never wait behind a miss; concurrent misses for the same
        name share one load through an in-flight Future."""
        parts = _validate_model_name(model_name)
        with self._lock:
            if self._closed:
                raise RuntimeError("ModelCache is closed")
            if model_name in self._entries:
                self._entries.move_to_end(model_name)
                return self._entries[model_name]
            fut = self._loading.get(model_name)
            loader = fut is None
            if loader:
                fut = Future()
                self._loading[model_name] = fut
        if not loader:
            return fut.result()

        evicted = evicted_dir = staged = None
        try:
            if self.model_root.startswith("gs://"):
                path = staged = self._download_gcs_model(parts)
            else:
                path = os.path.join(self.model_root, *parts)
            gen, meta = load_generator(path, device=self.device,
                                       compute_dtype=self.compute_dtype)
            check_3d_generator(gen)
            batcher = (self.batcher_factory(gen, meta)
                       if self.batcher_factory else None)
            entry = (gen, meta, batcher)
        except BaseException as e:  # noqa: BLE001 — waiters must not hang
            with self._lock:
                self._loading.pop(model_name, None)
            if staged is not None:
                shutil.rmtree(staged, ignore_errors=True)
            fut.set_exception(e)
            raise
        with self._lock:
            self._loading.pop(model_name, None)
            closed = self._closed
            if not closed:
                self._entries[model_name] = entry
                if staged is not None:
                    self._staging[model_name] = staged
                if len(self._entries) > self.capacity:
                    ev_name, (_, _, evicted) = self._entries.popitem(
                        last=False)
                    evicted_dir = self._staging.pop(ev_name, None)
        if closed:
            # close() raced this load: caching the entry would leave a live
            # batcher worker and a staging dir nobody removes.
            if batcher is not None:
                batcher.close(wait=False)
            if staged is not None:
                shutil.rmtree(staged, ignore_errors=True)
            err = RuntimeError(f"ModelCache closed while loading "
                               f"{model_name!r}")
            fut.set_exception(err)
            raise err
        fut.set_result(entry)
        if evicted is not None:
            # Non-blocking close outside the lock: its worker drains in the
            # background; an in-flight request whose later submit() raises
            # degrades to run_direct (infer/tiling.py).
            ev_stats = evicted.stats()
            with self._lock:
                _add_batcher_stats(self._retired, ev_stats)
            evicted.close(wait=False)
        if evicted_dir is not None:
            # The weights live on the device; the staged files are dead.
            shutil.rmtree(evicted_dir, ignore_errors=True)
        return entry

    def close(self):
        with self._lock:
            self._closed = True  # a load in flight sees this and cleans up
            old = [e[2] for e in self._entries.values() if e[2] is not None]
            self._entries.clear()
            self._staging.clear()  # the dirs live under gcs_dir
            gcs_dir, self._gcs_dir = self._gcs_dir, None
        for b in old:
            b.close()  # wait: shutdown leaves no worker behind
        if gcs_dir is not None:
            shutil.rmtree(gcs_dir, ignore_errors=True)

    def stats(self):
        with self._lock:
            retired = dict(self._retired)
            if not self._entries:
                s = {"model": None}
                batcher = None
            else:
                names = list(self._entries)
                batcher = self._entries[names[-1]][2]
                s = {"model": names[-1], "models": names}
        if batcher is not None:
            s["batcher"] = batcher.stats()
        if any(retired.values()):
            total = dict(retired)
            _add_batcher_stats(total, s.get("batcher", {}))
            tiles, padded = total["tiles"], total["padded"]
            total["occupancy"] = (tiles / (tiles + padded)
                                  if tiles + padded else 1.0)
            s["batcher_lifetime"] = total
        return s


def make_handler(cache: ModelCache, mesh=None,
                 limiter: Optional[_Limiter] = None,
                 request_timeout_s: Optional[float] = None):
    """The service's request handler class.  ``mesh``: split every
    request's tile batches over its 'data' axis, where the model has no
    batcher (a batcher carries the mesh itself)."""
    class Handler(BaseHTTPRequestHandler):
        # A client that sends Content-Length but never the body would pin a
        # handler thread forever, outside admission control.
        timeout = 120

        def log_message(self, *a):
            pass

        def _send(self, code, body, ctype="text/plain", headers=()):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Access-Control-Allow-Origin", "*")
            for k, v in headers:
                self.send_header(k, v)
            self.end_headers()
            self.wfile.write(body)

        def do_OPTIONS(self):
            # CORS preflight (the reference ran flask_cors CORS(app)).
            self.send_response(204)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods",
                             "GET, POST, OPTIONS")
            self.send_header("Access-Control-Allow-Headers",
                             "Content-Type, Authorization")
            self.send_header("Content-Length", "0")
            self.end_headers()

        def do_GET(self):
            if self.path.rstrip("/") == "/stats":
                s = cache.stats()
                if limiter is not None:
                    s["requests"] = limiter.stats()
                s["stages"] = {k: v for k, v in totals()["spans"].items()
                               if k.startswith(STAGES)}
                self._send(200, json.dumps(s).encode(), "application/json")
            elif self.path.rstrip("/") == "/healthz":
                self._send(200, b"ok")
            else:
                self._send(404, b"unknown path")

        def do_POST(self):
            if self.path.rstrip("/") not in ("", "/"):
                self._send(404, b"unknown path")
                return
            with span("serve.request"):
                # Read the body before any response, then admit.
                length = int(self.headers.get("Content-Length", 0))
                with span("serve.read_body"):
                    raw = self.rfile.read(length)
                if limiter is not None and not limiter.try_acquire():
                    self._send(503, b"too many concurrent requests",
                               headers=[("Retry-After", "2")])
                    return
                try:
                    self._predict(raw)
                finally:
                    if limiter is not None:
                        limiter.release()

        def _predict(self, raw: bytes):
            deadline = (time.monotonic() + request_timeout_s
                        if request_timeout_s else None)
            cancel_reason = [None]

            def should_cancel():
                if deadline is not None and time.monotonic() > deadline:
                    cancel_reason[0] = "timeout"
                    return True
                if _sock_eof(self.connection):
                    cancel_reason[0] = "disconnect"
                    return True
                return False

            try:
                config = json.loads(raw)
                location = config["location"]
                if location.startswith("gs://"):
                    location = location[len("gs://"):]
                start = config["start"]
                glbstart = config.get("glbstart", [0, 0, 0])
                size = config["size"]
                for d in range(3):
                    if (start[d] - glbstart[d]) % BLOCK != 0:
                        raise RuntimeError("start must be 64 block aligned")
                    if size[d] % BLOCK != 0:
                        raise RuntimeError("size must be 64 block aligned")

                gen, meta, batcher = cache.get(config["model_name"])
                request = current()  # the fetch threads' parent span
                with span("serve.read_volume"):
                    vol = open_volume(location)

                def fetch_tile(corner, insize):
                    with span("serve.read_volume", parent=request):
                        return vol.read(corner, (insize,) * 3)  # zyx

                with span("serve.tiles"):
                    out_zyx = predict_tiled(
                        fetch_tile, gen, start, size, meta.outdimsize,
                        meta.buffer, meta.meanstd_x, meta.meanstd_y,
                        batcher=batcher, should_cancel=should_cancel,
                        device=cache.device,
                        mesh=None if batcher is not None else mesh)
                offset = [start[d] - glbstart[d] for d in range(3)]
                with span("serve.write"):
                    write_ng_blocks(out_zyx, config["dest"], offset)
                    self._send(200, b"success")
            except InferenceCancelled:
                if cancel_reason[0] == "timeout":
                    try:
                        self._send(504, b"request timed out",
                                   headers=[("Retry-After", "2")])
                    except OSError:
                        pass  # deadline raced a client hangup
                # disconnect: the peer is gone; the thread just ends.
            except Exception:  # noqa: BLE001 — report any failure as a 400
                try:
                    self._send(400, traceback.format_exc().encode())
                except OSError:
                    pass  # client vanished mid-error

    return Handler


class ModelService:
    """Threaded model-serving HTTP service on one GPU, or on the devices of
    a mesh's 'data' axis.

    ``device``: "cuda" (default) or "cpu"; CUDA absent raises.
    ``compute_dtype``: None (float32, like the JAX service) or "bfloat16".
    ``cross_batch`` (default on): concurrent requests against one model
    share device batches up to ``max_batch`` (None: width-aware, 128 at
    wf=8), lingering ``linger_ms``; occupancy counters at GET /stats.
    ``cache_size`` (env MODEL_CACHE_SIZE, default 1), ``max_inflight``
    (env MAX_INFLIGHT, default 8, 0 disables; excess requests get 503) and
    ``request_timeout_s`` (env REQUEST_TIMEOUT_S, default 600, 0 disables;
    past it the client gets 504) as in the JAX service.  GET /stats also
    reports the batcher's queue wait and linger (``TileBatcher.stats``) and
    under ``stages`` the span totals (``telemetry.totals``) of the
    handler's ``serve.request`` > ``serve.read_body``,
    ``serve.read_volume``, ``serve.tiles``, ``serve.write``, the batcher's
    ``batcher.linger`` and ``batcher.step`` and the tile step's
    ``tile_step.*``: count and seconds each, for the process.  ``mesh``: a
    ``parallel.make_mesh`` mesh with a 'data' axis; every request's tile
    batches are split over its devices, one generator replica each (the
    multi-card path for sources streamed from storage); a mesh without a
    'data' axis raises ValueError here."""

    def __init__(self, model_root: Optional[str] = None,
                 host: str = "127.0.0.1", port: int = 0, mesh=None,
                 cross_batch: bool = True, max_batch: Optional[int] = None,
                 linger_ms: float = 5.0, cache_size: Optional[int] = None,
                 max_inflight: Optional[int] = None,
                 request_timeout_s: Optional[float] = None,
                 device="cuda", compute_dtype=None):
        dev = resolve_device(device)
        if mesh is not None:
            data_sharding(mesh, "ModelService")
        model_root = model_root or os.environ.get("MODEL_BUCKET", ".")
        if cache_size is None:
            cache_size = int(os.environ.get("MODEL_CACHE_SIZE", "1"))
        if max_inflight is None:
            max_inflight = int(os.environ.get("MAX_INFLIGHT", "8"))
        if request_timeout_s is None:
            request_timeout_s = float(os.environ.get("REQUEST_TIMEOUT_S",
                                                     "600"))
        factory = None
        if cross_batch:
            from ..infer.batcher import make_tile_batcher

            def factory(gen, meta):
                return make_tile_batcher(
                    gen, meta.meanstd_x, meta.meanstd_y, meta.outdimsize,
                    meta.buffer, device=dev, max_batch=max_batch,
                    linger_ms=linger_ms, mesh=mesh)
        self.cache = ModelCache(model_root, batcher_factory=factory,
                                capacity=cache_size, device=dev,
                                compute_dtype=compute_dtype)
        self.limiter = _Limiter(max_inflight) if max_inflight else None
        handler = make_handler(self.cache, mesh=mesh, limiter=self.limiter,
                               request_timeout_s=request_timeout_s or None)
        self.server = ThreadingHTTPServer((host, port), handler)
        self._thread = None

    @property
    def url(self) -> str:
        host, port = self.server.server_address[:2]
        return f"http://{host}:{port}"

    def start(self) -> int:
        self._thread = threading.Thread(target=self.server.serve_forever,
                                        daemon=True)
        self._thread.start()
        return self.server.server_address[1]

    def stop(self):
        # shutdown() deadlocks unless serve_forever() runs, so an unstarted
        # service goes straight to cleanup.  cache.close() waits for the
        # batchers to drain already-submitted tiles.
        if self._thread is not None:
            self.server.shutdown()
            self._thread.join(timeout=5)
        self.server.server_close()
        self.cache.close()


def main():  # pragma: no cover
    """Serve on $PORT (default 8080) until SIGTERM/SIGINT.  TF32 is off so
    the float32 convolutions on cuDNN stay float32."""
    from ..device import float32_exact
    from .data_service import serve_until_signal

    float32_exact()
    svc = ModelService(host="0.0.0.0", port=int(os.environ.get("PORT", 8080)),
                       compute_dtype=os.environ.get("COMPUTE_DTYPE") or None)
    print(f"model service on {svc.url}")
    serve_until_signal(svc)


if __name__ == "__main__":  # pragma: no cover
    main()
