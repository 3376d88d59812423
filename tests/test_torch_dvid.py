"""The port's DVID and cloud-run sources against the JAX package's, over a
fake DVID HTTP server on 127.0.0.1 (the JAX package's tests/test_dvid.py
serves the same routes; this file keeps its own copy of the server).

Each call runs through both packages: fetched bytes and arrays equal, the
errors' messages equal (the wrong-length diagnostic with the instance's
``Base.TypeName``), the instance info equal, the cloud-run fetcher's
diagnostics equal, ``volume3d_dvid``'s cube stream equal.  Through
``create_dataset_from_generator`` both read the same cubes; the port's
batches are the float32 definition over them bit for bit, and the JAX
package's within the bars its pipelines are held to elsewhere.
"""

import re
import threading
import warnings
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import pytest
import requests
import torch

from transfer_em_tpu.data import create_dataset_from_generator as jax_dataset
from transfer_em_tpu.data import sources as jax_sources
from transfer_em_tpu_torch.data import create_dataset_from_generator
from transfer_em_tpu_torch.data import sources

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def fake_dvid():
    """Serves /api/node/<uuid>/<instance>/raw/0_1_2/<sx_sy_sz>/<ox_oy_oz>
    from a synthetic zyx volume, like a DVID uint8blk instance
    (reference generators.py:170-223 documents the contract), and
    /api/node/<uuid>/<instance>/info."""
    rng = np.random.default_rng(0)
    vol = rng.integers(0, 255, size=(96, 96, 96), dtype=np.uint8)  # zyx

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_GET(self):
            mi = re.match(r"/api/node/(\w+)/(\w+)/info$", self.path)
            if mi:
                # DVID instance info JSON (the wrong-length diagnostic
                # reads Base.TypeName from this route).
                body = (b'{"Base": {"TypeName": "uint64blk", '
                        b'"Name": "%s"}}' % mi.group(2).encode())
                self.send_response(200)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            m = re.match(
                r"/api/node/(\w+)/(\w+)/raw/0_1_2/(\d+)_(\d+)_(\d+)/"
                r"(-?\d+)_(-?\d+)_(-?\d+)", self.path)
            if not m:
                self.send_response(404)
                self.end_headers()
                return
            sx, sy, sz = (int(m.group(i)) for i in (3, 4, 5))
            if m.group(2) == "labels64":
                # a non-uint8 instance: 8 bytes a voxel, the wrong length
                body = b"\0" * (sx * sy * sz * 8)
                self.send_response(200)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)
                return
            ox, oy, oz = (int(m.group(i)) for i in (6, 7, 8))
            out = np.zeros((sz, sy, sx), np.uint8)
            z0, z1 = max(0, oz), min(96, oz + sz)
            y0, y1 = max(0, oy), min(96, oy + sy)
            x0, x1 = max(0, ox), min(96, ox + sx)
            if z0 < z1 and y0 < y1 and x0 < x1:
                out[z0 - oz:z1 - oz, y0 - oy:y1 - oy, x0 - ox:x1 - ox] = \
                    vol[z0:z1, y0:y1, x0:x1]
            body = out.tobytes()
            self.send_response(200)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    t = threading.Thread(target=server.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{server.server_address[1]}", vol
    server.shutdown()


def _raised(fn, exc_type):
    with pytest.raises(exc_type) as ei:
        fn()
    return ei.value


def test_fetch_raw_dvid(fake_dvid):
    """The same zyx array from both packages, equal to the volume's box,
    including a box that overhangs the volume (zeros outside)."""
    url, vol = fake_dvid
    for box in ([[8, 16, 24], [24, 48, 56]], [[80, -4, 90], [100, 12, 99]]):
        got = sources.fetch_raw_dvid(url, "abc9", "grayscale", box)
        want = jax_sources.fetch_raw_dvid(url, "abc9", "grayscale", box)
        assert got.dtype == want.dtype == np.uint8
        assert got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    np.testing.assert_array_equal(
        sources.fetch_raw_dvid(url, "abc9", "grayscale",
                               [[8, 16, 24], [24, 48, 56]]),
        vol[8:24, 16:48, 24:56])


def test_fetch_raw_dvid_length_check(fake_dvid):
    """A bad instance path 404s: requests.HTTPError from both, with the
    same message."""
    url, _ = fake_dvid
    box = [[0, 0, 0], [8, 8, 8]]
    got = _raised(lambda: sources.fetch_raw_dvid(url, "abc9", "bad/instance",
                                                 box), requests.HTTPError)
    want = _raised(lambda: jax_sources.fetch_raw_dvid(
        url, "abc9", "bad/instance", box), requests.HTTPError)
    assert str(got) == str(want)
    assert got.response.status_code == want.response.status_code == 404


def test_fetch_instance_info(fake_dvid):
    url, _ = fake_dvid
    got = sources.fetch_instance_info(url, "abc9", "grayscale")
    want = jax_sources.fetch_instance_info(url, "abc9", "grayscale")
    assert got == want
    assert got["Base"]["TypeName"] == "uint64blk"


def test_wrong_length_error_names_instance_type(fake_dvid):
    """The wrong-length diagnostic names the instance's actual type
    (Base.TypeName) in the same words in both packages."""
    url, _ = fake_dvid
    box = [[0, 0, 0], [8, 8, 8]]
    got = _raised(lambda: sources.fetch_raw_dvid(url, "abc9", "labels64",
                                                 box), RuntimeError)
    want = _raised(lambda: jax_sources.fetch_raw_dvid(url, "abc9",
                                                      "labels64", box),
                   RuntimeError)
    assert str(got) == str(want)
    assert re.search(r"has type 'uint64blk'.*uint8", str(got), re.S)


def test_cloudrun_fetch_error_diagnostics(monkeypatch):
    """A failed cloud-run /volume fetch raises with the HTTP status, the
    server and a body snippet, and a missing gcloud warns once a process:
    the same message and the same warnings from both packages."""

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *a):
            pass

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            body = b"location not found: gs://nope"
            self.send_response(500)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

    server = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=server.serve_forever, daemon=True).start()
    url = f"http://127.0.0.1:{server.server_address[1]}"

    def run(mod):
        monkeypatch.setattr(mod.CloudRunFetcher, "_token_warning_issued",
                            False)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            f = mod.CloudRunFetcher(url, "gs://nope")  # no gcloud: warn
            err = _raised(lambda: f.fetch((0, 0, 0), 8), RuntimeError)
        return str(err), [str(w.message) for w in caught
                          if "identity-token" in str(w.message)]

    try:
        got, got_warn = run(sources)
        want, want_warn = run(jax_sources)
    finally:
        server.shutdown()
    assert got == want
    assert "HTTP 500" in got and "location not found" in got and url in got
    # the first token attempt and the in-fetch refresh both fail; one warning
    assert got_warn == want_warn and len(got_warn) == 1


def test_volume3d_dvid_stream(fake_dvid):
    """The seeded corner stream gives the same cubes in both packages, and
    again on a second pass."""
    url, _ = fake_dvid
    kw = dict(bbox=((0, 0, 0), (30, 30, 30)), size=16, seed=5)
    src = sources.volume3d_dvid(url, "abc9", "grayscale", **kw)
    jsrc = jax_sources.volume3d_dvid(url, "abc9", "grayscale", **kw)
    it, jit = src(), jsrc()
    cubes = [next(it) for _ in range(6)]
    for c in cubes:
        want = next(jit)
        assert c.shape == (16, 16, 16) and c.dtype == np.uint8
        np.testing.assert_array_equal(c, want)
    it2 = src()
    for c in cubes:
        np.testing.assert_array_equal(next(it2), c)


def test_volume3d_dvid_with_pipeline(fake_dvid):
    """volume3d_dvid through create_dataset_from_generator.  Both packages
    read the same cubes, and the port's ``meanstd`` and batches are the
    definitions in float32 over them, bit for bit: the mean of the cubes'
    means and the root of the mean of their variances (within 1e-6
    relative of float64; float32 sums in another order than numpy's), and
    (x / 127.5 - 1 - mean) / std.  The JAX package's agree to the bars
    tests/test_torch_data.py holds its pipelines to: its float32 means sum
    in XLA's order (5e-5 relative) and its one jitted map rounds the
    standardization otherwise (1e-6)."""
    url, _ = fake_dvid
    kw = dict(bbox=((0, 0, 0), (40, 40, 40)), size=16, seed=1)
    src = sources.volume3d_dvid(url, "abc9", "grayscale", **kw)
    jsrc = jax_sources.volume3d_dvid(url, "abc9", "grayscale", **kw)
    ds, meanstd = create_dataset_from_generator(src, batch_size=2,
                                                epoch_size=4, device="cpu")
    jds, jmeanstd = jax_dataset(jsrc, batch_size=2, epoch_size=4)
    it, jit = src(), jsrc()
    cubes = [next(it) for _ in range(4)]
    for c in cubes:
        np.testing.assert_array_equal(c, next(jit))
    scaled = [c.astype(np.float32)[..., None] / np.float32(127.5)
              - np.float32(1.0) for c in cubes]
    want = (np.mean([x.astype(np.float64).mean() for x in scaled]),
            np.sqrt(np.mean([x.astype(np.float64).var() for x in scaled])))
    np.testing.assert_allclose(meanstd, want, rtol=1e-6)
    np.testing.assert_allclose(jmeanstd, meanstd, rtol=5e-5)

    mean, std = np.float32(meanstd[0]), np.float32(meanstd[1])
    batches, jbatches = list(ds), list(jds)
    assert len(batches) == len(jbatches) == 2
    for i, (got, jgot) in enumerate(zip(batches, jbatches)):
        assert tuple(got.shape) == (2, 16, 16, 16, 1)
        assert got.dtype == torch.float32
        want = np.stack([(x - mean) / std for x in scaled[2 * i:2 * i + 2]])
        np.testing.assert_array_equal(got.numpy(), want)
        jwant = (np.asarray(jgot) * np.float32(jmeanstd[1])
                 + np.float32(jmeanstd[0]) - mean) / std
        np.testing.assert_allclose(got.numpy(), jwant, rtol=1e-6, atol=1e-6)
