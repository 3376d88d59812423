"""Data-access service: POST /volume and GET /slice/... over HTTP.

Own copy of ``transfer_em_tpu/serve/data_service.py``, the reference Cloud
Run data service (cloudrun_functions/transferem.py):

* ``POST /volume``   {location, start[xyz], size[xyz], scale_index?, jpeg?}
  -> raw bytes, F-order xyz == C-order zyx (transferem.py:109-192), or a
  JPEG for a single z slice.
* ``GET /slice/<x_y_z>/<sx_sy_sz>/<fmt>?location=...`` -> a 2D image through
  a 256-entry LRU cache capped at 1 MB an entry (transferem.py:26-106).
* ``GET /healthz`` and the ``OPTIONS`` CORS preflight.

A stdlib ThreadingHTTPServer with the reference's routes, JSON bodies and
byte contracts; any exception -> HTTP 400 with the traceback.  Loads no
torch: ``DataService(workers=N)`` forks worker processes.

    DATA_VOLUMES="name=/path/a.npy,..." DATA_WORKERS=4 PORT=8080 \\
        python -m transfer_em_tpu_torch.serve.data_service
"""

from __future__ import annotations

import io
import json
import os
import signal
import threading
import traceback
import warnings
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Optional
from urllib.parse import parse_qs, urlparse

import numpy as np

from .backends import NumpyVolume, open_volume, register_volume


class LruCache:
    """Thread-safe LRU of ``limit`` entries; values over ``max_entry``
    bytes are not cached (reference transferem.py:26-46)."""

    def __init__(self, limit: int = 256, max_entry: int = 1_000_000):
        self.cache: OrderedDict = OrderedDict()
        self.limit = limit
        self.max_entry = max_entry
        self._lock = threading.Lock()

    def get(self, key) -> Optional[bytes]:
        with self._lock:
            if key not in self.cache:
                return None
            self.cache.move_to_end(key)
            return self.cache[key]

    def put(self, key, val: bytes) -> None:
        if len(val) > self.max_entry:
            return
        with self._lock:
            self.cache[key] = val
            self.cache.move_to_end(key)
            if len(self.cache) > self.limit:
                self.cache.popitem(last=False)


def _encode_image(data2d: np.ndarray, fmt: str) -> bytes:
    from PIL import Image
    buf = io.BytesIO()
    Image.fromarray(data2d).save(buf, format=fmt.upper().replace("JPG", "JPEG"))
    return buf.getvalue()


def make_handler(slice_cache: LruCache):
    class Handler(BaseHTTPRequestHandler):
        # A half-sent body must not pin a handler thread forever.
        timeout = 120

        def log_message(self, *a):
            pass

        def _send(self, code: int, body: bytes, ctype: str):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.send_header("Access-Control-Allow-Origin", "*")
            self.end_headers()
            self.wfile.write(body)

        def do_OPTIONS(self):
            # CORS preflight (the reference ran flask_cors CORS(app),
            # cloudrun_functions/transferem.py:21): a browser's JSON POST
            # /volume is preflighted.
            self.send_response(204)
            self.send_header("Access-Control-Allow-Origin", "*")
            self.send_header("Access-Control-Allow-Methods",
                             "GET, POST, OPTIONS")
            self.send_header("Access-Control-Allow-Headers",
                             "Content-Type, Authorization")
            self.send_header("Content-Length", "0")
            self.end_headers()

        def do_POST(self):
            if urlparse(self.path).path != "/volume":
                return self._send(404, b"not found", "text/plain")
            try:
                length = int(self.headers.get("Content-Length", 0))
                config = json.loads(self.rfile.read(length))
                location = config["location"]
                if location.startswith("gs://"):
                    location = location[len("gs://"):]
                start = config["start"]   # xyz
                size = config["size"]     # xyz
                vol = open_volume(location, config.get("scale_index", 0))
                data_zyx = vol.read(start, size)
                if not config.get("jpeg", False) or size[2] > 1:
                    # C-order zyx bytes == F-order xyz bytes
                    self._send(200, data_zyx.tobytes(),
                               "application/octet-stream")
                else:
                    img = np.squeeze(data_zyx)  # (sy, sx)
                    self._send(200, _encode_image(img, "jpeg"), "image/jpeg")
            except Exception:  # noqa: BLE001 — any failure is a 400
                self._send(400, traceback.format_exc().encode(), "text/plain")

        def do_GET(self):
            parsed = urlparse(self.path)
            if parsed.path.rstrip("/") == "/healthz":
                return self._send(200, b"ok", "text/plain")
            parts = parsed.path.strip("/").split("/")
            if len(parts) != 4 or parts[0] != "slice":
                return self._send(404, b"not found", "text/plain")
            try:
                startstr, sizestr, fmt = parts[1], parts[2], parts[3]
                start = [int(v) for v in startstr.split("_")]
                size = [int(v) for v in sizestr.split("_")]
                location = parse_qs(parsed.query)["location"][0]
                if 1 not in size[:3]:
                    return self._send(400, b"one dimension must be size 1",
                                      "text/plain")
                # A tuple key, where the reference joins a string
                # (transferem.py:72): the cache is internal.
                key = (location, startstr, sizestr, fmt)
                resp = slice_cache.get(key)
                if resp is None:
                    data = np.squeeze(open_volume(location).read(start, size))
                    resp = _encode_image(data, fmt)
                    slice_cache.put(key, resp)
                self._send(200, resp, f"image/{fmt}")
            except Exception:  # noqa: BLE001 — any failure is a 400
                self._send(400, traceback.format_exc().encode(), "text/plain")

    return Handler


class DataService:
    """Threaded HTTP data service; ``start()`` returns the bound port.

    ``workers=N`` runs N prefork worker processes that all accept from the
    one inherited listening socket (the reference ran 9 gunicorn workers x 2
    threads, cloudrun_functions/Dockerfile), each threaded, with a per-worker
    slice cache; a monitor thread reforks a worker that dies.  Volumes must
    be registered before ``start()``: workers inherit the registry by fork.
    Fork only from a process that has not initialised CUDA.  ``workers=0``
    (default) keeps one threaded process.
    """

    def __init__(self, host: str = "127.0.0.1", port: int = 0,
                 workers: int = 0):
        self.cache = LruCache()
        self.server = ThreadingHTTPServer((host, port),
                                          make_handler(self.cache))
        self.workers = int(workers)
        self._pids: list = []
        self._thread: Optional[threading.Thread] = None
        self._stopping = threading.Event()

    @property
    def port(self) -> int:
        return self.server.server_address[1]

    @property
    def url(self) -> str:
        host, port = self.server.server_address[:2]
        return f"http://{host}:{port}"

    def _fork_worker(self) -> int:
        pid = os.fork()
        if pid == 0:  # worker: accept from the inherited socket
            try:
                signal.signal(signal.SIGTERM, signal.SIG_DFL)
                self.server.serve_forever()
            finally:
                os._exit(0)
        return pid

    def _monitor_workers(self):
        """Reap dead workers and refork them (gunicorn's arbiter): without
        it a crash silently lowers capacity, and with every worker dead the
        listening socket accepts connections no process serves."""
        while not self._stopping.wait(0.5):
            for i, pid in enumerate(list(self._pids)):
                try:
                    done, status = os.waitpid(pid, os.WNOHANG)
                except ChildProcessError:  # reaped elsewhere: still dead
                    done, status = pid, "?"
                if done:
                    warnings.warn(f"data-service worker {pid} died (status "
                                  f"{status}); reforking", RuntimeWarning)
                    self._pids[i] = self._fork_worker()

    def start(self) -> int:
        if self.workers:
            # Import PIL before forking: a fork taken while another thread
            # holds an import lock deadlocks the child's first import.
            from PIL import Image  # noqa: F401
            for _ in range(self.workers):
                self._pids.append(self._fork_worker())
            target = self._monitor_workers
        else:
            target = self.server.serve_forever
        self._thread = threading.Thread(target=target, daemon=True)
        self._thread.start()
        return self.port

    def stop(self):
        if self._pids:
            self._stopping.set()  # stop the monitor before the workers
            if self._thread:
                self._thread.join(timeout=5)
            for pid in self._pids:
                try:
                    os.kill(pid, signal.SIGTERM)
                except ProcessLookupError:
                    pass
            for pid in self._pids:
                try:
                    os.waitpid(pid, 0)
                except ChildProcessError:
                    pass
            self._pids = []
        else:
            self.server.shutdown()
            if self._thread:
                self._thread.join(timeout=5)
        self.server.server_close()  # release the listening socket


def serve_until_signal(svc):  # pragma: no cover
    """Run a service until SIGTERM/SIGINT, then stop it (Cloud Run sends
    SIGTERM before it kills the container)."""
    done = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *_: done.set())
    svc.start()
    done.wait()
    svc.stop()


def _register_env_volumes():  # pragma: no cover
    """DATA_VOLUMES="name=/path/a.npy,other=/path/b.npy": serve local numpy
    arrays (memory-mapped) under those locations."""
    for item in filter(None, os.environ.get("DATA_VOLUMES", "").split(",")):
        name, path = (s.strip() for s in item.split("=", 1))
        register_volume(name, NumpyVolume(np.load(path, mmap_mode="r")))
        print(f"registered volume {name} from {path}")


def main():  # pragma: no cover
    _register_env_volumes()
    svc = DataService(host="0.0.0.0",
                      port=int(os.environ.get("PORT", 8080)),
                      workers=int(os.environ.get("DATA_WORKERS", "0")))
    print(f"data service on {svc.url} ({svc.workers or 'single'}-process)")
    serve_until_signal(svc)


if __name__ == "__main__":  # pragma: no cover
    main()
