"""The port's serving of neuroglancer-precomputed volumes against the JAX
package: TensorstoreVolume, open_volume, predict_ng_cube (tensorstore and
data-service transports), predict_cube_from_saved_model, ModelService over
an ng volume, the data service (routes, bytes, prefork workers), the
clients and the predictors.

Volumes are written locally with tensorstore's ``file`` driver; the model
is a wf=32 generator with numpy-seeded weights exported by the JAX package
(msgpack) and read by the port.  Byte contracts are held exactly; uint8
predictions within one level on at most 1e-3 of the voxels.
"""

import base64
import concurrent.futures as cf
import gzip
import io
import json
import os
import signal
import socket
import subprocess
import sys
import time
import types
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from test_torch_models import numpy_params

from transfer_em_tpu import serve as jserve
from transfer_em_tpu.config import ExportMeta as JaxMeta
from transfer_em_tpu.infer import export as jexport
from transfer_em_tpu.infer import tiling as jtiling
from transfer_em_tpu.serve import backends as jbackends
from transfer_em_tpu.serve import client as jclient
from transfer_em_tpu_torch.infer import load_generator
from transfer_em_tpu_torch.infer.export import predict_cube_from_saved_model
from transfer_em_tpu_torch.infer.tiling import predict_ng_cube
from transfer_em_tpu_torch.native import gather_box
from transfer_em_tpu_torch.serve import (DataService, LruCache, ModelService,
                                         NgOutputPredictor, NumpyVolume,
                                         TensorstoreVolume,
                                         TransferEMPredictor, backends,
                                         fetch_subvolume,
                                         open_volume, predict_chunk,
                                         predict_cloud, register_volume)

ts = pytest.importorskip("tensorstore")

torch.set_num_threads(1)

MS_X, MS_Y = (0.1, 0.9), (0.2, 1.1)
NP_LOCATION = "ngtest/np"


def write_ng(path, data_xyz, chunk):
    """A uint8 single-channel ng-precomputed volume (raw chunks) at
    ``path``; returns its ``file://`` location."""
    spec = {
        "driver": "neuroglancer_precomputed",
        "kvstore": {"driver": "file", "path": str(path)},
        "scale_metadata": {"size": list(data_xyz.shape),
                           "resolution": [8, 8, 8],
                           "chunk_size": [chunk] * 3, "encoding": "raw"},
        "multiscale_metadata": {"data_type": "uint8", "num_channels": 1,
                                "type": "image"},
        "create": True,
    }
    ts.open(spec).result()[...] = data_xyz[..., None]
    return "file://" + str(path)


def export_jax(d, wf=32, seed=0):
    """A generator exported by the JAX package (generator.msgpack)."""
    meta = JaxMeta(buffer=17, outdimsize=40, meanstd_x=MS_X, meanstd_y=MS_Y,
                   dimsize=74, is3d=True, wf=wf)
    jexport.export_generator(numpy_params(wf, seed=seed), meta, str(d))
    return str(d)


def assert_close_u8(got, want):
    """uint8 outputs within one level, on at most 1e-3 of the voxels."""
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()


@pytest.fixture(scope="module")
def small_ng(tmp_path_factory):
    """16^3 volume in 8^3 chunks: (location, data xyz)."""
    data = np.random.default_rng(0).integers(1, 255, (16, 16, 16),
                                             dtype=np.uint8)
    return write_ng(tmp_path_factory.mktemp("small_ng"), data, 8), data


@pytest.fixture(scope="module")
def big_ng(tmp_path_factory):
    """120^3 volume in 64^3 chunks: (location, data zyx)."""
    data = np.random.default_rng(1).integers(0, 255, (120, 120, 120),
                                             dtype=np.uint8)
    loc = write_ng(tmp_path_factory.mktemp("big_ng"), data, 64)
    return loc, np.ascontiguousarray(data.transpose(2, 1, 0))


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """(export dir, the JAX package's (gen, params, meta), the port's gen)."""
    d = export_jax(tmp_path_factory.mktemp("export") / "model")
    gen, _meta = load_generator(d, device="cpu")
    return d, jexport.load_generator(d), gen


@pytest.fixture(scope="module")
def services():
    """The port's and the JAX package's DataService over the same 64^3
    volume, registered under NP_LOCATION in each."""
    vol = np.random.default_rng(2).integers(0, 255, (64, 64, 64),
                                            dtype=np.uint8)
    register_volume(NP_LOCATION, NumpyVolume(vol))
    jserve.register_volume(NP_LOCATION, jserve.NumpyVolume(vol))
    port, jax_svc = DataService(), jserve.DataService()
    port.start()
    jax_svc.start()
    yield port, jax_svc, vol
    port.stop()
    jax_svc.stop()


def _jax_ng(model, location, start, size, cloudrun=None, **kw):
    jgen, jparams, jmeta = model[1]
    return jtiling.predict_ng_cube(
        location, start, size, (jgen.apply, jparams), MS_X, MS_Y, cloudrun,
        outdimsize=jmeta.outdimsize, buffer=jmeta.buffer, **kw)


def _port_ng(model, location, start, size, cloudrun=None, **kw):
    return predict_ng_cube(location, start, size, model[2], MS_X, MS_Y,
                           cloudrun, outdimsize=40, buffer=17, device="cpu",
                           **kw)


# ------------------------------------------------------ TensorstoreVolume

READS = {"interior": ((2, 3, 4), (8, 7, 6)),
         "overhang": ((8, 8, 8), (12, 12, 12)),
         "negative": ((-4, 10, 12), (8, 8, 8)),
         "disjoint": ((-20, 0, 0), (4, 4, 4))}


@pytest.mark.parametrize("case", sorted(READS))
def test_tensorstore_volume_read_matches_jax(small_ng, case):
    """Bit-equal to the JAX package's TensorstoreVolume and to NumpyVolume
    over the same voxels, zero-filled outside the domain."""
    loc, data = small_ng
    start, size = READS[case]
    got = TensorstoreVolume(loc).read(start, size)
    assert got.shape == size[::-1] and got.dtype == np.uint8
    np.testing.assert_array_equal(
        got, jbackends.TensorstoreVolume(loc).read(start, size))
    np.testing.assert_array_equal(
        got, NumpyVolume(np.ascontiguousarray(data.transpose(2, 1, 0)))
        .read(start, size))
    if case == "disjoint":
        assert not got.any()


def test_tensorstore_volume_rejects_non_uint8(tmp_path):
    spec = {"driver": "neuroglancer_precomputed",
            "kvstore": {"driver": "file", "path": str(tmp_path)},
            "create": True,
            "schema": {"dtype": "uint16", "domain": {"shape": [8, 8, 8, 1]},
                       "chunk_layout": {"chunk": {"shape": [8, 8, 8, 1]}}}}
    ts.open(spec).result()[...] = np.full((8, 8, 8, 1), 300, np.uint16)
    with pytest.raises(ValueError, match="uint8-only"):
        TensorstoreVolume("file://" + str(tmp_path))


def test_numpy_volume_rejects_non_uint8():
    for dtype in (np.float32, np.uint16):
        with pytest.raises(ValueError, match="uint8"):
            NumpyVolume(np.zeros((4, 4, 4), dtype))


def test_open_volume_cached_by_location_and_scale(monkeypatch, tmp_path):
    opened = []

    class Fake(backends.VolumeBackend):
        def __init__(self, location, scale_index=0):
            opened.append((location, scale_index))

    monkeypatch.setattr(backends, "TensorstoreVolume", Fake)
    backends._open_uncached.cache_clear()
    try:
        a = open_volume("bucket/a")
        assert open_volume("bucket/a", 0) is a
        assert open_volume("bucket/a", 1) is not a
        assert opened == [("bucket/a", 0), ("bucket/a", 1)]
        np.save(tmp_path / "v.npy", np.zeros((2, 2, 2), np.uint8))
        assert isinstance(open_volume(str(tmp_path / "v.npy")), NumpyVolume)
        reg = NumpyVolume(np.zeros((2, 2, 2), np.uint8))
        register_volume("bucket/a", reg)
        assert open_volume("bucket/a") is reg  # registered first
    finally:
        backends._REGISTRY.pop("bucket/a", None)
        backends._open_uncached.cache_clear()


# ----------------------------------------------------------- predict_ng_cube

REQUESTS = {"interior": ((20, 30, 10), (64, 40, 36)),  # 4 tiles
            "edge": ((90, 0, 84), (36, 50, 36))}        # halo past the face


@pytest.mark.parametrize("case", sorted(REQUESTS))
def test_predict_ng_cube_matches_jax(big_ng, model, services, case):
    """Through tensorstore and through the port's data service: the same
    tiles, so the same bytes; within one level of JAX's predict_ng_cube."""
    loc, _ = big_ng
    start, size = REQUESTS[case]
    want = _jax_ng(model, loc, start, size)
    got = _port_ng(model, loc, start, size)
    assert got.shape == size[::-1] and got.std() > 2
    assert_close_u8(got, want)
    via_service = _port_ng(model, loc, start, size, services[0].url)
    np.testing.assert_array_equal(via_service, got)


def test_predict_ng_cube_fetch_input(big_ng, model):
    loc, vol = big_ng
    start, size = REQUESTS["edge"]
    inp, pred = _port_ng(model, loc, start, size, fetch_input=True)
    np.testing.assert_array_equal(inp, gather_box(vol, start, size))
    np.testing.assert_array_equal(pred, _port_ng(model, loc, start, size))
    jinp, _ = _jax_ng(model, loc, start, size, fetch_input=True)
    np.testing.assert_array_equal(inp, jinp)


def test_predict_ng_cube_takes_em2em(big_ng, tmp_path):
    from transfer_em_tpu_torch import EM2EM

    loc, _ = big_ng
    em = EM2EM(74, "ngtest", wf=32, checkpoint_root=str(tmp_path),
               device="cpu")
    start, size = REQUESTS["interior"]
    got = predict_ng_cube(loc, start, size, em, MS_X, MS_Y, device="cpu")
    want = predict_ng_cube(loc, start, size, em.state.gg, MS_X, MS_Y,
                           outdimsize=em.outdimsize, buffer=em.buffer,
                           device="cpu")
    np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError, match="outdimsize"):
        predict_ng_cube(loc, start, size, em.state.gg, MS_X, MS_Y,
                        device="cpu")


def test_predict_cube_from_saved_model_matches_jax(big_ng, model):
    loc, _ = big_ng
    start, size = REQUESTS["interior"]
    want = jexport.predict_cube_from_saved_model(loc, start, size, None,
                                                 model[0])
    got = predict_cube_from_saved_model(loc, start, size, None, model[0],
                                        device="cpu")
    assert_close_u8(got, want)
    np.testing.assert_array_equal(got, _port_ng(model, loc, start, size))


def _post(url, cfg):
    req = urllib.request.Request(url, data=json.dumps(cfg).encode(),
                                 headers={"Content-type": "application/json"})
    return urllib.request.urlopen(req, timeout=300)


def _read_blocks(dest, start, size):
    """Stitch the gzip ng blocks under dest into a zyx array of size."""
    got = np.zeros(size[::-1], np.uint8)
    for nm in os.listdir(dest):
        (x0, x1), (y0, y1), (z0, z1) = (
            tuple(int(v) for v in p.split("-")) for p in nm.split("_"))
        raw = gzip.decompress(open(os.path.join(dest, nm), "rb").read())
        got[z0 - start[2]:z1 - start[2], y0 - start[1]:y1 - start[1],
            x0 - start[0]:x1 - start[0]] = np.frombuffer(
                raw, np.uint8).reshape(z1 - z0, y1 - y0, x1 - x0)
    return got


def test_model_service_serves_ng_volume(big_ng, model, tmp_path):
    """ModelService(device="cpu") over a file:// ng location: the written
    blocks within one level of JAX's predict_ng_cube of the chunk; the
    client's predict_chunk drives it."""
    loc, _ = big_ng
    root = tmp_path / "models"
    os.makedirs(root / "m1")
    os.symlink(model[0], root / "m1" / "v1")
    start, size = (64, 0, 64), (64, 64, 64)
    svc = ModelService(model_root=str(root), device="cpu")
    svc.start()
    try:
        predict_chunk(svc.url, loc, start, size, "m1:v1",
                      str(tmp_path / "out"))
    finally:
        svc.stop()
    assert os.listdir(tmp_path / "out") == ["64-128_0-64_64-128"]
    assert_close_u8(_read_blocks(tmp_path / "out", start, size),
                    _jax_ng(model, loc, start, size))


def test_predict_chunk_honours_retry_after(monkeypatch):
    """503 + Retry-After is retried until max_wait_s; another status
    raises with the body."""
    replies = []

    def post(url, data=None, headers=None):
        code, body = replies.pop(0)
        return types.SimpleNamespace(status_code=code, content=body,
                                     headers={"Retry-After": "0"})

    import requests
    monkeypatch.setattr(requests, "post", post)
    replies[:] = [(503, b"full"), (503, b"full"), (200, b"success")]
    predict_chunk("http://svc", "loc", (0, 0, 0), (64,) * 3, "m:v", "d")
    assert not replies
    replies[:] = [(400, b"bad chunk")]
    with pytest.raises(RuntimeError, match="bad chunk"):
        predict_chunk("http://svc", "loc", (0, 0, 0), (64,) * 3, "m:v", "d")
    replies[:] = [(503, b"still full")]
    with pytest.raises(RuntimeError, match="still full"):
        predict_chunk("http://svc", "loc", (0, 0, 0), (64,) * 3, "m:v", "d",
                      max_wait_s=0)


# -------------------------------------------------------------- data service

def _volume_bytes(url, cfg):
    resp = _post(url + "/volume", cfg)
    return resp.headers["Content-Type"], resp.read()


VOLUME_REQUESTS = {
    "numpy": (NP_LOCATION, (0, 0, 0), (8, 4, 2)),
    "gs_prefix": ("gs://" + NP_LOCATION, (5, 6, 7), (16, 16, 16)),
    "numpy_overhang": (NP_LOCATION, (-4, 60, 3), (12, 8, 5)),
    "ng": (None, (10, 20, 30), (16, 8, 4)),
    "ng_overhang": (None, (110, -3, 100), (16, 16, 16)),
}


@pytest.mark.parametrize("case", sorted(VOLUME_REQUESTS))
def test_data_service_volume_bytes_match_jax(services, big_ng, case):
    """POST /volume: C-order zyx bytes (== F-order xyz), byte for byte the
    JAX package's service's answer."""
    port, jax_svc, vol = services
    loc, start, size = VOLUME_REQUESTS[case]
    if loc is None:
        loc, vol = big_ng
    cfg = {"location": loc, "start": list(start), "size": list(size),
           "scale_index": 0}
    ctype, body = _volume_bytes(port.url, cfg)
    assert ctype == "application/octet-stream"
    assert (ctype, body) == _volume_bytes(jax_svc.url, cfg)
    np.testing.assert_array_equal(
        np.frombuffer(body, np.uint8).reshape(size[::-1]),
        gather_box(vol, start, size))


def test_data_service_jpeg_slice_matches_jax(services):
    port, jax_svc, _ = services
    cfg = {"location": NP_LOCATION, "start": [0, 0, 5], "size": [32, 16, 1],
           "jpeg": True}
    ctype, body = _volume_bytes(port.url, cfg)
    assert ctype == "image/jpeg"
    assert (ctype, body) == _volume_bytes(jax_svc.url, cfg)
    from PIL import Image
    assert np.asarray(Image.open(io.BytesIO(body))).shape == (16, 32)


def test_data_service_slice_png_matches_jax(services):
    from PIL import Image

    port, jax_svc, vol = services
    path = f"/slice/5_10_20/16_16_1/png?location={NP_LOCATION}"
    body = urllib.request.urlopen(port.url + path).read()
    assert body == urllib.request.urlopen(jax_svc.url + path).read()
    np.testing.assert_array_equal(np.asarray(Image.open(io.BytesIO(body))),
                                  vol[20, 10:26, 5:21])
    assert urllib.request.urlopen(port.url + path).read() == body  # cached
    assert (NP_LOCATION, "5_10_20", "16_16_1", "png") in port.cache.cache


@pytest.mark.parametrize("method,path,body", [
    ("GET", f"/slice/0_0_0/16_16_16/png?location={NP_LOCATION}", None),
    ("GET", "/slice/0_0_0/16_16_1/png?location=no/such.npy", None),
    ("POST", "/volume", b"not json"),
    ("POST", "/volume", json.dumps({"start": [0, 0, 0]}).encode()),
])
def test_data_service_bad_request_is_400(services, method, path, body):
    """Any failure answers 400 with the traceback, as JAX's service does."""
    codes = []
    for svc in services[:2]:
        req = urllib.request.Request(svc.url + path, data=body,
                                     method=method)
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req)
        codes.append(e.value.code)
    assert codes == [400, 400]


def test_data_service_healthz_cors_and_404(services):
    port = services[0]
    assert urllib.request.urlopen(port.url + "/healthz").read() == b"ok"
    resp = urllib.request.urlopen(
        urllib.request.Request(port.url + "/volume", method="OPTIONS"))
    assert resp.status == 204
    assert resp.headers["Access-Control-Allow-Origin"] == "*"
    assert "POST" in resp.headers["Access-Control-Allow-Methods"]
    assert "Content-Type" in resp.headers["Access-Control-Allow-Headers"]
    for req in (port.url + "/nowhere",
                urllib.request.Request(port.url + "/other", data=b"{}")):
        with pytest.raises(urllib.error.HTTPError) as e:
            urllib.request.urlopen(req)
        assert e.value.code == 404


def test_fetch_subvolume_concurrent_matches_jax_client(services):
    """The port's client against the port's threaded service, eight boxes
    at once; the same arrays as the JAX client against the JAX service."""
    port, jax_svc, vol = services
    boxes = [[(z, z + 1, z + 2), (z + 16, z + 17, z + 18)]
             for z in range(0, 46, 6)]
    with cf.ThreadPoolExecutor(max_workers=8) as ex:
        got = list(ex.map(lambda b: fetch_subvolume(port.url, NP_LOCATION, b),
                          boxes))
    for box, arr in zip(boxes, got):
        (z0, y0, x0), (z1, y1, x1) = box
        np.testing.assert_array_equal(arr, vol[z0:z1, y0:y1, x0:x1])
        np.testing.assert_array_equal(
            arr, jclient.fetch_subvolume(jax_svc.url, NP_LOCATION, box))
    with pytest.raises(RuntimeError, match="Traceback"):
        fetch_subvolume(port.url, "no/such.npy", [(0, 0, 0), (2, 2, 2)])


def test_lru_cache_limits():
    cache = LruCache(limit=2, max_entry=4)
    cache.put("a", b"1")
    cache.put("b", b"2")
    assert cache.get("a") == b"1"  # a is now the most recent
    cache.put("c", b"3")
    assert cache.get("b") is None and cache.get("a") == b"1"
    cache.put("big", b"12345")  # over max_entry: not cached
    assert cache.get("big") is None and len(cache.cache) == 2


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _children_of(pid):
    kids = []
    try:  # all threads: the monitor thread forks the respawned workers
        for tid in os.listdir(f"/proc/{pid}/task"):
            with open(f"/proc/{pid}/task/{tid}/children") as f:
                kids += [int(p) for p in f.read().split()]
    except OSError:
        pass
    return kids


def _wait_for(cond, seconds, what):
    deadline = time.time() + seconds
    while not cond():
        assert time.time() < deadline, what
        time.sleep(0.1)


def test_data_service_prefork_workers(tmp_path):
    """``python -m transfer_em_tpu_torch.serve.data_service`` with
    DATA_VOLUMES and DATA_WORKERS=4: four prefork workers serve /volume and
    /slice, a killed worker is reforked, SIGTERM stops every worker."""
    from PIL import Image

    vol = np.random.default_rng(3).integers(0, 255, (64, 64, 64),
                                            dtype=np.uint8)
    np.save(tmp_path / "vol.npy", vol)
    port = _free_port()
    env = dict(os.environ, DATA_VOLUMES=f"pf/vol={tmp_path / 'vol.npy'}",
               DATA_WORKERS="4", PORT=str(port))
    proc = subprocess.Popen(
        [sys.executable, "-m", "transfer_em_tpu_torch.serve.data_service"],
        env=env, stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)
    url = f"http://127.0.0.1:{port}"

    def up():
        try:
            return urllib.request.urlopen(url + "/healthz",
                                          timeout=2).read() == b"ok"
        except OSError:
            return False

    try:
        _wait_for(up, 60, "service never came up")
        _wait_for(lambda: len(_children_of(proc.pid)) == 4, 20, "workers")
        workers = _children_of(proc.pid)
        boxes = [[(z, z + 1, z + 2), (z + 16, z + 17, z + 18)]
                 for z in range(0, 44, 4)]
        with cf.ThreadPoolExecutor(max_workers=16) as ex:
            for box, got in zip(boxes, ex.map(
                    lambda b: fetch_subvolume(url, "pf/vol", b), boxes)):
                (z0, y0, x0), (z1, y1, x1) = box
                np.testing.assert_array_equal(got, vol[z0:z1, y0:y1, x0:x1])
        img = urllib.request.urlopen(
            f"{url}/slice/5_10_20/16_16_1/png?location=pf/vol").read()
        np.testing.assert_array_equal(
            np.asarray(Image.open(io.BytesIO(img))), vol[20, 10:26, 5:21])

        os.kill(workers[0], signal.SIGKILL)
        _wait_for(lambda: (len(_children_of(proc.pid)) == 4
                           and workers[0] not in _children_of(proc.pid)),
                  20, "worker not reforked")
        np.testing.assert_array_equal(
            fetch_subvolume(url, "pf/vol", [(0, 0, 0), (8, 8, 8)]),
            vol[:8, :8, :8])

        workers = _children_of(proc.pid)
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=30) == 0
        for pid in workers:
            with pytest.raises(OSError):
                os.kill(pid, 0)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


# ---------------------------------------------------------------- predict_cloud

class _Chain:
    """service.projects().predict(name=..., body=...).execute()"""

    def __init__(self, response):
        self.response = response
        self.calls = []

    def projects(self):
        return self

    def predict(self, name, body):
        self.calls.append((name, body))
        return self

    def execute(self):
        return self.response


@pytest.fixture
def fake_discovery(monkeypatch):
    mod = types.ModuleType("googleapiclient")
    disc = types.ModuleType("googleapiclient.discovery")
    state = {"services": []}

    def build(api, version):
        state["api"] = (api, version)
        return state["services"].pop(0)

    disc.build = build
    mod.discovery = disc
    monkeypatch.setitem(sys.modules, "googleapiclient", mod)
    monkeypatch.setitem(sys.modules, "googleapiclient.discovery", disc)
    return state


@pytest.mark.parametrize("as_str", [True, False])
def test_predict_cloud_matches_jax(fake_discovery, as_str):
    size = [4, 3, 2]  # xyz -> zyx (2, 3, 4)
    vol = np.arange(24, dtype=np.uint8).reshape(2, 3, 4)
    payload = base64.encodebytes(vol.tobytes())
    if as_str:
        payload = payload.decode("ascii")
    chains = [_Chain({"predictions": payload}) for _ in range(2)]
    fake_discovery["services"] = list(chains)
    args = ("proj", "mdl", "bucket/vol", "https://svc", [10, 20, 30], size)
    got = predict_cloud(*args, version="v7")
    want = jclient.predict_cloud(*args, version="v7")
    np.testing.assert_array_equal(got, vol)
    np.testing.assert_array_equal(got, want)
    assert fake_discovery["api"] == ("ml", "v1")
    assert chains[0].calls == chains[1].calls == [(
        "projects/proj/models/mdl/versions/v7",
        {"instances": [{"location": "bucket/vol", "cloudrun": "https://svc",
                        "start": [10, 20, 30], "size": size}]})]


def test_predict_cloud_no_version_and_error(fake_discovery):
    chain = _Chain({"error": "model not deployed"})
    fake_discovery["services"] = [chain]
    with pytest.raises(RuntimeError, match="model not deployed"):
        predict_cloud("p", "m", "loc", "cr", [0, 0, 0], [1, 1, 1])
    assert chain.calls[0][0] == "projects/p/models/m"



# ----------------------------------------------------------------- predictors

def _inst(loc, start=(64, 64, 64), size=(64, 64, 64), cloudrun=None):
    return {"location": loc, "cloudrun": cloudrun, "start": start,
            "size": size}


def test_predictor_base64_matches_jax(big_ng, model, services):
    loc, _ = big_ng
    pred = TransferEMPredictor.from_path(model[0], device="cpu")
    try:
        (b64,) = pred.predict([_inst(loc)])
        (via_service,) = pred.predict([_inst(loc, cloudrun=services[0].url)])
    finally:
        pred.close()
    got = np.frombuffer(base64.b64decode(b64), np.uint8).reshape(64, 64, 64)
    assert via_service == b64
    jpred = jserve.TransferEMPredictor.from_path(model[0])
    try:
        (jb64,) = jpred.predict([_inst(loc)])
    finally:
        jpred.close()
    assert_close_u8(got, np.frombuffer(base64.b64decode(jb64),
                                       np.uint8).reshape(64, 64, 64))
    with pytest.raises(RuntimeError, match="one instance"):
        pred.predict([_inst(loc)] * 2)


def test_predictor_cross_call_batching(big_ng, model):
    """Concurrent predicts share device batches and match the unbatched
    predictor; close() is idempotent and terminal.  (On the CPU a conv's
    sums depend on the batch: the shared batch of 8 may move a level
    against two single-tile batches.)"""
    loc, _ = big_ng
    insts = [_inst(loc, s, (36, 36, 36)) for s in ((40, 40, 40),
                                                  (80, 80, 80))]
    plain = TransferEMPredictor.from_path(model[0], device="cpu",
                                          cross_batch=False)
    want = [plain.predict([i])[0] for i in insts]
    assert plain._batcher is None
    pred = TransferEMPredictor.from_path(model[0], device="cpu")
    try:
        with cf.ThreadPoolExecutor(max_workers=2) as ex:
            got = list(ex.map(lambda i: pred.predict([i])[0], insts))
        for g, w in zip(got, want):
            assert_close_u8(*(np.frombuffer(base64.b64decode(v), np.uint8)
                              for v in (g, w)))
        assert pred._batcher.stats()["tiles"] == 2
    finally:
        pred.close()
        pred.close()
    assert pred.predict([insts[0]])[0] == want[0]
    assert pred._batcher is None


def test_ng_output_predictor_local(big_ng, model, tmp_path):
    """info (plain JSON) and one gzip 64^3 block under a uuid-named dir,
    equal to the base64 predictor's volume; a viewer URL back."""
    loc, _ = big_ng
    pred = NgOutputPredictor.from_path(model[0], dest_root=str(tmp_path),
                                       device="cpu")
    try:
        (url,) = pred.predict([_inst(loc)])
    finally:
        pred.close()
    (name,) = os.listdir(tmp_path)
    assert url.startswith("https://neuroglancer-demo.appspot.com/#!")
    state = json.loads(url.split("#!", 1)[1])
    assert state["layers"] == [{"type": "image", "name": name,
                                "source": f"precomputed://{tmp_path / name}"}]
    info = json.load(open(tmp_path / name / "info"))
    assert info["data_type"] == "uint8" and info["num_channels"] == 1
    assert info["scales"][0]["size"] == [64, 64, 64]
    assert info["scales"][0]["chunk_sizes"] == [[64, 64, 64]]
    assert info["scales"][0]["key"] == "64_64_64"
    assert os.listdir(tmp_path / name / "64_64_64") == ["0-64_0-64_0-64"]
    got = _read_blocks(tmp_path / name / "64_64_64", (0, 0, 0), (64,) * 3)
    b64 = TransferEMPredictor.from_path(model[0], device="cpu",
                                        cross_batch=False).predict(
                                            [_inst(loc)])[0]
    np.testing.assert_array_equal(
        got, np.frombuffer(base64.b64decode(b64), np.uint8).reshape(
            64, 64, 64))
    assert_close_u8(got, _jax_ng(model, loc, (64, 64, 64), (64, 64, 64)))
