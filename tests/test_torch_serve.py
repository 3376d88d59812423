"""The port's inference and serving path against the JAX package: tile
plan, fused tile step, predict_tiled (unbatched and batched), export/load
in both formats, and ModelService(device="cpu") over HTTP.

wf=32 (as tests/test_export_serve.py uses) keeps the JAX side cheap; the
weights are numpy-seeded and exported by the JAX package (msgpack), then
read by the port.
"""

import dataclasses
import gzip
import json
import os
import urllib.error
import urllib.request

import jax
import numpy as np
import pytest
import torch
from test_torch_models import numpy_params

from transfer_em_tpu.config import ExportMeta as JaxMeta
from transfer_em_tpu.infer import export as jexport
from transfer_em_tpu.infer import tiling as jtiling
from transfer_em_tpu.native import gather_blocks as jgather
from transfer_em_tpu_torch.infer import (export_generator, load_generator,
                                         make_tile_batcher, make_tile_step,
                                         plan_tiles, predict_tiled)
from transfer_em_tpu_torch.infer.export import MSGPACK_FILE, PARAMS_FILE
from transfer_em_tpu_torch.models import UNetGenerator
from transfer_em_tpu_torch.models.convert import params_from_jax
from transfer_em_tpu_torch.native import gather_blocks
from transfer_em_tpu_torch.serve import ModelService, NumpyVolume
from transfer_em_tpu_torch.serve import register_volume

torch.set_num_threads(1)

MS_X, MS_Y = (0.1, 0.9), (0.2, 1.1)
LOCATION = "torchtest/vol"


@pytest.fixture(scope="module")
def jax_export(tmp_path_factory):
    """A wf=32 generator exported by the JAX package (generator.msgpack)."""
    d = str(tmp_path_factory.mktemp("jexport") / "model")
    params = numpy_params(32, seed=0)
    meta = JaxMeta(buffer=17, outdimsize=40, meanstd_x=MS_X, meanstd_y=MS_Y,
                   dimsize=74, is3d=True, wf=32)
    jexport.export_generator(params, meta, d)
    jgen, jparams, jmeta = jexport.load_generator(d)
    return d, params, (jgen, jparams, jmeta)


@pytest.fixture(scope="module")
def volume():
    rng = np.random.default_rng(0)
    vol = rng.integers(0, 255, size=(160, 160, 160), dtype=np.uint8)
    register_volume(LOCATION, NumpyVolume(vol))
    return vol


@pytest.fixture(scope="module")
def port_gen(jax_export):
    gen, meta = load_generator(jax_export[0], device="cpu")
    return gen, meta


def _jax_predict(jax_export, volume, start, size):
    jgen, jparams, jmeta = jax_export[2]
    return jtiling.predict_tiled(
        lambda c, s: jgather(volume, [c], s)[0], jgen.apply, jparams, start,
        size, jmeta.outdimsize, jmeta.buffer, jmeta.meanstd_x,
        jmeta.meanstd_y)


@pytest.fixture(scope="module")
def jax_chunk(jax_export, volume):
    """JAX predict_tiled of the 64^3 chunk at (64, 64, 64): 8 tiles, B=8."""
    return _jax_predict(jax_export, volume, (64, 64, 64), (64, 64, 64))


def _assert_close_u8(got, want):
    """uint8 outputs within one level, on at most 1e-3 of the voxels
    (float32 sums in another order may cross a rounding boundary)."""
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()


def _fetch(volume):
    return lambda corner, insize: gather_blocks(volume, [corner], insize)[0]


@pytest.mark.parametrize("start,size,outdim,buf", [
    ((64, 64, 64), (40, 40, 40), 40, 17),
    ((0, 5, 7), (100, 64, 37), 40, 17),
    ((3, 3, 3), (10, 20, 30), 35, 10),
    ((0, 0, 0), (5, 5, 5), 4, 3),
])
def test_plan_tiles_matches_jax(start, size, outdim, buf):
    got = plan_tiles(start, size, outdim, buf)
    want = jtiling.plan_tiles(start, size, outdim, buf)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.insize == want.insize and got.num_tiles == want.num_tiles


def test_tile_step_matches_jax(jax_export, port_gen, volume):
    jgen, jparams, jmeta = jax_export[2]
    gen, meta = port_gen
    plan = plan_tiles((64, 64, 64), (40, 40, 40), meta.outdimsize,
                      meta.buffer)
    assert plan.num_tiles == 8 and plan.tpad == 2
    tiles = jgather(volume, plan.corners, plan.insize)
    jstep = jtiling.make_tile_step(jgen.apply, jparams, MS_X, MS_Y, plan.tpad)
    want = np.asarray(jstep(jax.numpy.asarray(tiles)))
    got = make_tile_step(gen, MS_X, MS_Y, plan.tpad, device="cpu")(tiles)
    assert got.shape == (8, 36, 36, 36)
    _assert_close_u8(got, want)


def test_predict_tiled_matches_jax(jax_export, port_gen, volume):
    """A 40^3 request (8 tiles of 36^3) against JAX predict_tiled."""
    gen, meta = port_gen
    want = _jax_predict(jax_export, volume, (64, 64, 64), (40, 40, 40))
    got = predict_tiled(_fetch(volume), gen, (64, 64, 64), (40, 40, 40),
                        meta.outdimsize, meta.buffer, meta.meanstd_x,
                        meta.meanstd_y, device="cpu")
    _assert_close_u8(got, want)


def test_batched_bit_identical_to_unbatched(port_gen, volume):
    """Same bytes through the shared batcher as through the unbatched loop,
    also into a caller-owned ``out`` buffer."""
    gen, meta = port_gen
    args = ((3, 70, 11), (40, 40, 40), meta.outdimsize, meta.buffer,
            meta.meanstd_x, meta.meanstd_y)
    plain = predict_tiled(_fetch(volume), gen, *args, device="cpu")
    batcher = make_tile_batcher(gen, meta.meanstd_x, meta.meanstd_y,
                                meta.outdimsize, meta.buffer, device="cpu")
    out = np.full((40, 40, 40), 7, np.uint8)
    try:
        got = predict_tiled(_fetch(volume), gen, *args, device="cpu",
                            batcher=batcher, out=out)
        assert batcher.stats()["tiles"] == 8
        assert batcher.max_batch == 128  # width-aware default at wf=32
    finally:
        batcher.close()
    assert got is out
    np.testing.assert_array_equal(got, plain)


def test_batcher_rejects_other_model_or_plan(port_gen, volume):
    gen, meta = port_gen
    batcher = make_tile_batcher(gen, meta.meanstd_x, meta.meanstd_y,
                                meta.outdimsize, meta.buffer, device="cpu")
    try:
        with pytest.raises(ValueError, match="different generator"):
            predict_tiled(_fetch(volume), UNetGenerator(wf=32), (0, 0, 0),
                          (36, 36, 36), 40, 17, MS_X, MS_Y, device="cpu",
                          batcher=batcher)
        with pytest.raises(ValueError, match="meanstd_y"):
            predict_tiled(_fetch(volume), gen, (0, 0, 0), (36, 36, 36), 40,
                          17, MS_X, (0.0, 1.0), device="cpu", batcher=batcher)
        with pytest.raises(ValueError, match="outdimsize"):
            predict_tiled(_fetch(volume), gen, (0, 0, 0), (36, 36, 36), 34,
                          20, MS_X, MS_Y, device="cpu", batcher=batcher)
    finally:
        batcher.close()


def test_export_read_back_both_formats(jax_export, port_gen, tmp_path):
    """The JAX package's msgpack and the port's npz load to the same
    weights, and the npz holds flax-path keys in the JAX layout."""
    d, params, _ = jax_export
    assert os.path.exists(os.path.join(d, MSGPACK_FILE))
    gen, meta = port_gen
    want = params_from_jax(params)
    for k, v in gen.state_dict().items():
        assert torch.equal(v, want[k]), k
    assert meta.meanstd_x == MS_X and meta.wf == 32

    out = str(tmp_path / "npz_model")
    export_generator(gen, meta, out)
    with np.load(os.path.join(out, PARAMS_FILE)) as data:
        assert "down1/conv/kernel" in data.files
        np.testing.assert_array_equal(data["up1/up/kernel"],
                                      params["params"]["up1"]["up"]["kernel"])
    gen2, meta2 = load_generator(out, device="cpu")
    assert meta2 == meta
    for k, v in gen2.state_dict().items():
        assert torch.equal(v, want[k]), k


@pytest.fixture(scope="module")
def model_root(jax_export, tmp_path_factory):
    root = tmp_path_factory.mktemp("models")
    os.makedirs(root / "m1")
    os.symlink(jax_export[0], root / "m1" / "v1")
    return str(root)


def _post(url, cfg):
    req = urllib.request.Request(url + "/", data=json.dumps(cfg).encode(),
                                 headers={"Content-type": "application/json"})
    return urllib.request.urlopen(req, timeout=300)


def _chunk(dest, start=(64, 64, 64), name="m1:v1"):
    return {"location": LOCATION, "start": list(start),
            "glbstart": [0, 0, 0], "size": [64, 64, 64],
            "model_name": name, "dest": str(dest)}


def test_model_service_chunk_matches_jax(model_root, volume, jax_chunk,
                                         tmp_path):
    svc = ModelService(model_root=model_root, device="cpu")
    svc.start()
    try:
        dest = tmp_path / "out"
        assert _post(svc.url, _chunk(dest)).read() == b"success"
        assert os.listdir(dest) == ["64-128_64-128_64-128"]
        raw = gzip.decompress(open(dest / "64-128_64-128_64-128",
                                   "rb").read())
        block = np.frombuffer(raw, np.uint8).reshape(64, 64, 64)
        _assert_close_u8(block, jax_chunk)
        s = json.loads(urllib.request.urlopen(svc.url + "/stats").read())
        assert s["model"] == "m1:v1" and s["batcher"]["tiles"] == 8
    finally:
        svc.stop()
    assert svc.cache.stats() == {"model": None}


def test_model_service_rejects_bad_requests(model_root, volume, tmp_path):
    """400 on an unaligned chunk and on a path-traversal model_name; 404
    off the root path."""
    svc = ModelService(model_root=model_root, device="cpu")
    svc.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(svc.url, _chunk(tmp_path / "o", start=(1, 0, 0)))
        assert e.value.code == 400
        assert b"64 block aligned" in e.value.read()
        for bad in ("/tmp/evil:v1", "..:..", "m1:v1:extra"):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(svc.url, _chunk(tmp_path / "o", name=bad))
            assert e.value.code == 400
            assert b"invalid model_name" in e.value.read()
        req = urllib.request.Request(svc.url + "/volume", data=b"{}",
                                     method="POST")
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req)
        assert e.value.code == 404
        assert not os.path.exists(tmp_path / "o")
    finally:
        svc.stop()


def test_model_service_admission_and_timeout(model_root, volume, tmp_path,
                                             monkeypatch):
    """max_inflight=1: a second concurrent request gets 503; a request past
    request_timeout_s gets 504."""
    import threading
    import time

    from transfer_em_tpu_torch.infer.tiling import InferenceCancelled
    from transfer_em_tpu_torch.serve import model_service as ms

    started, release = threading.Event(), threading.Event()

    def stub(fetch_tile, gen, start, size, *a, should_cancel=None, **kw):
        started.set()
        deadline = time.time() + 60
        while not release.is_set() and time.time() < deadline:
            if should_cancel():
                raise InferenceCancelled("cancelled")
            time.sleep(0.005)
        return np.zeros(tuple(reversed(size)), np.uint8)

    monkeypatch.setattr(ms, "predict_tiled", stub)
    svc = ModelService(model_root=model_root, device="cpu", max_inflight=1,
                       cross_batch=False)
    svc.start()
    codes = {}
    try:
        def first():
            codes["first"] = _post(svc.url, _chunk(tmp_path / "a")).status

        t = threading.Thread(target=first)
        t.start()
        assert started.wait(timeout=60)
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(svc.url, _chunk(tmp_path / "b"))
        assert e.value.code == 503 and e.value.headers["Retry-After"] == "2"
        release.set()
        t.join(timeout=60)
        assert not t.is_alive() and codes["first"] == 200
    finally:
        release.set()
        svc.stop()

    release.clear()
    svc = ModelService(model_root=model_root, device="cpu",
                       request_timeout_s=0.1, cross_batch=False)
    svc.start()
    try:
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(svc.url, _chunk(tmp_path / "c"))
        assert e.value.code == 504
    finally:
        svc.stop()


def test_model_service_disconnect_frees_slot(model_root, volume, tmp_path,
                                             monkeypatch):
    """A client that hangs up mid-compute cancels its request (the polled
    socket reads EOF) and frees its admission slot."""
    import socket
    import threading
    import time

    from transfer_em_tpu_torch.infer.tiling import InferenceCancelled
    from transfer_em_tpu_torch.serve import model_service as ms

    cancelled = threading.Event()
    calls = []

    def stub(fetch_tile, gen, start, size, *a, should_cancel=None, **kw):
        calls.append(1)
        if len(calls) == 1:
            deadline = time.time() + 60
            while time.time() < deadline:
                if should_cancel():
                    cancelled.set()
                    raise InferenceCancelled("client gone")
                time.sleep(0.005)
            raise AssertionError("disconnect never observed")
        return np.zeros(tuple(reversed(size)), np.uint8)

    monkeypatch.setattr(ms, "predict_tiled", stub)
    svc = ModelService(model_root=model_root, device="cpu", max_inflight=1,
                       cross_batch=False)
    svc.start()
    try:
        body = json.dumps(_chunk(tmp_path / "dc")).encode()
        host, port = svc.server.server_address[:2]
        s = socket.create_connection((host, port))
        s.sendall((f"POST / HTTP/1.1\r\nHost: t\r\n"
                   f"Content-Length: {len(body)}\r\n"
                   "Content-Type: application/json\r\n\r\n").encode() + body)
        time.sleep(0.2)
        s.close()
        assert cancelled.wait(timeout=60)
        status = None
        for _ in range(200):  # the slot frees as the handler unwinds
            try:
                status = _post(svc.url, _chunk(tmp_path / "dc2")).status
                break
            except urllib.error.HTTPError as e:
                assert e.code == 503
                time.sleep(0.05)
        assert status == 200
    finally:
        svc.stop()


def test_model_cache_eviction_keeps_lifetime_stats(tmp_path, monkeypatch):
    """capacity 1: loading a second model evicts (and closes) the first
    one's batcher, and /stats keeps the evicted counters: sums, and the
    larger of the longest queue waits."""
    from transfer_em_tpu_torch.serve import model_service as ms

    class FakeBatcher:
        closed = False

        def stats(self):
            return {"batches": 2, "tiles": 14, "padded": 2, "largest": 8,
                    "errors": 0, "queue_wait_s": 0.5,
                    "queue_wait_max_s": 0.25, "linger_s": 0.125}

        def close(self, wait=True):
            self.closed = True

    monkeypatch.setattr(ms, "load_generator",
                        lambda path, **kw: (object(), object()))
    cache = ms.ModelCache(str(tmp_path), batcher_factory=lambda g, m:
                          FakeBatcher(), capacity=1, device="cpu")
    first = cache.get("a:v")[2]
    cache.get("b:v")
    assert first.closed
    lt = cache.stats()["batcher_lifetime"]
    assert lt["tiles"] == 28 and lt["padded"] == 4
    assert lt["occupancy"] == 28 / 32
    assert lt["queue_wait_s"] == 1.0 and lt["linger_s"] == 0.25
    assert lt["queue_wait_max_s"] == 0.25
    assert cache.get("b:v")[2] is not first  # cached: no reload
    cache.close()
    assert cache.stats() == {"model": None, "batcher_lifetime": {
        "batches": 2, "tiles": 14, "padded": 2, "errors": 0,
        "queue_wait_s": 0.5, "queue_wait_max_s": 0.25, "linger_s": 0.125,
        "occupancy": 14 / 16}}

