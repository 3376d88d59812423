"""The port's gs:// transports against the JAX package, on an in-memory
fake of ``google.cloud.storage.Client`` that records what a bucket would
receive (blob names, payloads, content encoding and type): ng blocks and
the info manifest written by BlockWriter and NgOutputPredictor, models
fetched by ModelCache from a gs:// root (staging, eviction, close), a
ModelService from a gs:// root to a gs:// destination, and the tensorstore
spec of a 'bucket/path' location.
"""

import gzip
import json
import os
import shutil
import threading
import time

import numpy as np
import pytest
import torch
from test_torch_ng_serve import _inst, assert_close_u8, export_jax, write_ng

from transfer_em_tpu import serve as jserve
from transfer_em_tpu.data import sources as jsources
from transfer_em_tpu.infer import tiling as jtiling
from transfer_em_tpu.infer.export import load_generator as jload_generator
from transfer_em_tpu.serve import model_service as jms
from transfer_em_tpu_torch.data import sources
from transfer_em_tpu_torch.infer import load_generator
from transfer_em_tpu_torch.models.convert import params_from_jax
from transfer_em_tpu_torch.serve import ModelService, NgOutputPredictor
from transfer_em_tpu_torch.serve import model_service as ms

pytest.importorskip("google.cloud.storage")

torch.set_num_threads(1)


class FakeBlob:
    def __init__(self, store, name):
        self._store = store
        self.name = name
        self.content_encoding = None

    def upload_from_string(self, data, content_type=None):
        if isinstance(data, str):
            data = data.encode()
        self._store[self.name] = {"data": bytes(data),
                                  "content_encoding": self.content_encoding,
                                  "content_type": content_type}

    def download_to_filename(self, filename):
        with open(filename, "wb") as f:
            f.write(self._store[self.name]["data"])


class FakeBucket:
    def __init__(self, buckets, name):
        self.name = name
        self.store = buckets.setdefault(name, {})

    def blob(self, name):
        return FakeBlob(self.store, name)


@pytest.fixture()
def fake_gcs(monkeypatch):
    """Patch google.cloud.storage.Client; returns {bucket: {blob: record}}."""
    from google.cloud import storage

    buckets = {}

    class FakeClient:
        def __init__(self, *a, **k):
            pass

        def bucket(self, name):
            return FakeBucket(buckets, name)

        def list_blobs(self, bucket, prefix=""):
            store = (bucket.store if isinstance(bucket, FakeBucket)
                     else buckets.setdefault(bucket, {}))
            for name in sorted(store):
                if name.startswith(prefix):
                    yield FakeBlob(store, name)

    monkeypatch.setattr(storage, "Client", FakeClient)
    return buckets


@pytest.fixture(scope="module")
def export_dir(tmp_path_factory):
    return export_jax(tmp_path_factory.mktemp("gcs_export") / "model")


def _publish(fake_gcs, export_dir, versions=("v1",)):
    """Upload the export under gs://model-bucket/models/em2em/<version>/."""
    store = fake_gcs.setdefault("model-bucket", {})
    for fname in os.listdir(export_dir):
        with open(os.path.join(export_dir, fname), "rb") as f:
            data = f.read()
        for ver in versions:
            FakeBlob(store, f"models/em2em/{ver}/{fname}").upload_from_string(
                data)


# ------------------------------------------------------------ block writer

@pytest.mark.parametrize("shape,offset", [((64, 64, 128), (256, 64, 0)),
                                          ((100, 64, 70), (0, 0, 64))])
def test_write_ng_blocks_gcs_records_match_jax(fake_gcs, shape, offset):
    """Blob names, gzip payloads (mtime 0), encodings and content types
    equal the JAX package's BlockWriter's on the same volume."""
    data = np.random.default_rng(0).integers(0, 256, shape, dtype=np.uint8)
    ms.write_ng_blocks(data, "gs://port-bucket/pred/run1", offset)
    jms.write_ng_blocks(data, "gs://jax-bucket/pred/run1", offset)
    port, jax_store = fake_gcs["port-bucket"], fake_gcs["jax-bucket"]
    assert port == jax_store and len(port) == np.prod(
        [-(-s // 64) for s in shape])
    x0, y0, z0 = offset
    for name, rec in port.items():
        assert rec["content_encoding"] == "gzip"
        assert rec["content_type"] == "application/octet-stream"
        (a0, a1), (b0, b1), (c0, c1) = (
            tuple(int(v) for v in p.split("-"))
            for p in name[len("pred/run1/"):].split("_"))
        block = np.frombuffer(gzip.decompress(rec["data"]), np.uint8)
        np.testing.assert_array_equal(
            block.reshape(c1 - c0, b1 - b0, a1 - a0),
            data[c0 - z0:c1 - z0, b0 - y0:b1 - y0, a0 - x0:a1 - x0])


def test_block_writer_plain_write_matches_jax(fake_gcs, tmp_path):
    """compress=False uploads the bytes as they are, with no encoding
    (the info manifest); locally it writes them as they are."""
    for mod, bucket in ((ms, "p"), (jms, "j")):
        mod.BlockWriter(f"gs://{bucket}/a/b").write("info", b'{"k": 1}',
                                                    compress=False)
    assert fake_gcs["p"] == fake_gcs["j"] == {"a/b/info": {
        "data": b'{"k": 1}', "content_encoding": None, "content_type": None}}
    ms.BlockWriter(str(tmp_path)).write("info", b"raw", compress=False)
    assert open(tmp_path / "info", "rb").read() == b"raw"


def test_write_ng_blocks_gcs_matches_local_dir(fake_gcs, tmp_path):
    data = np.random.default_rng(1).integers(0, 256, (128, 64, 64),
                                             dtype=np.uint8)
    ms.write_ng_blocks(data, "gs://b/p", (0, 0, 64))
    ms.write_ng_blocks(data, str(tmp_path / "local"), (0, 0, 64))
    local = {n: open(tmp_path / "local" / n, "rb").read()
             for n in os.listdir(tmp_path / "local")}
    gcs = {n[len("p/"):]: rec["data"] for n, rec in fake_gcs["b"].items()}
    assert local == gcs and len(local) == 2


# ----------------------------------------------------- ng-output predictor

def test_ng_output_predictor_gcs(fake_gcs, export_dir, tmp_path):
    """To gs://: a plain info and a gzip block under <uuid>/64_64_64/, the
    block equal to the local-dir predictor's and within one level of the
    JAX package's gs:// predictor."""
    data = np.random.default_rng(4).integers(0, 255, (96, 96, 96),
                                             dtype=np.uint8)
    loc = write_ng(tmp_path / "vol", data, 64)
    inst = _inst(loc, (16, 16, 16), (64, 64, 64))
    records = {}
    for tag, cls, kw in (("port", NgOutputPredictor, {"device": "cpu"}),
                         ("jax", jserve.NgOutputPredictor, {})):
        pred = cls.from_path(export_dir, dest_root=f"gs://ng-{tag}/tmp",
                             **kw)
        try:
            (url,) = pred.predict([dict(inst)])
        finally:
            pred.close()
        assert "precomputed://gs://ng-" + tag + "/tmp/" in url
        store = fake_gcs["ng-" + tag]
        assert len(store) == 2, sorted(store)
        (info_name,) = [n for n in store if n.endswith("/info")]
        run = info_name[len("tmp/"):-len("/info")]
        records[tag] = (store[info_name],
                        store[f"tmp/{run}/64_64_64/0-64_0-64_0-64"])
    info_rec, block_rec = records["port"]
    assert info_rec["content_encoding"] is None
    assert info_rec == records["jax"][0]
    assert json.loads(info_rec["data"])["scales"][0]["size"] == [64, 64, 64]
    assert block_rec["content_encoding"] == "gzip"
    assert block_rec["content_type"] == "application/octet-stream"
    block = np.frombuffer(gzip.decompress(block_rec["data"]), np.uint8)
    assert_close_u8(block, np.frombuffer(
        gzip.decompress(records["jax"][1]["data"]), np.uint8))

    pred = NgOutputPredictor.from_path(export_dir, device="cpu",
                                       dest_root=str(tmp_path / "ng_local"))
    pred.predict([dict(inst)])
    pred.close()
    (run,) = os.listdir(tmp_path / "ng_local")
    local = tmp_path / "ng_local" / run / "64_64_64" / "0-64_0-64_0-64"
    assert open(local, "rb").read() == block_rec["data"]


# ------------------------------------------------------- model cache fetch

def test_model_cache_fetches_from_gcs(fake_gcs, export_dir):
    """A gs:// root stages <prefix>/<name>/<version>/ and loads the same
    weights as the local export; a hit reuses the entry; no blobs raise
    FileNotFoundError and leave no staging dir."""
    _publish(fake_gcs, export_dir)
    cache = ms.ModelCache("gs://model-bucket/models/", device="cpu")
    try:
        gen, meta, _ = entry = cache.get("em2em:v1")
        want, want_meta = load_generator(export_dir, device="cpu")
        assert meta == want_meta
        for k, v in gen.state_dict().items():
            assert torch.equal(v, want.state_dict()[k]), k
        assert cache.get("em2em:v1") is entry
        root = cache._gcs_dir
        with pytest.raises(FileNotFoundError, match="no model blobs"):
            cache.get("missing:v9")
        assert len(os.listdir(root)) == 1  # the failed fetch's dir is gone
    finally:
        cache.close()
    assert not os.path.exists(root)
    # the JAX package stages the same blobs to the same parameters
    jcache = jms.ModelCache("gs://model-bucket/models/")
    try:
        _, jparams, jmeta, _ = jcache.get("em2em:v1")
    finally:
        jcache.close()
    assert jmeta.wf == meta.wf == 32
    for k, v in params_from_jax(jparams).items():
        assert torch.equal(v, gen.state_dict()[k]), k


def test_model_cache_miss_does_not_convoy_hits(fake_gcs, export_dir,
                                               monkeypatch):
    """A slow gs:// download of one model does not block hits on a resident
    one, and concurrent misses for one name share one download."""
    _publish(fake_gcs, export_dir, ("v1", "v2"))
    cache = ms.ModelCache("gs://model-bucket/models", capacity=2,
                          device="cpu")
    resident = cache.get("em2em:v1")
    gate = threading.Event()
    downloads = []
    orig = ms.ModelCache._download_gcs_model

    def slow_download(self, parts):
        downloads.append(parts)
        assert gate.wait(30)
        return orig(self, parts)

    monkeypatch.setattr(ms.ModelCache, "_download_gcs_model", slow_download)
    threads = [threading.Thread(target=cache.get, args=("em2em:v2",))
               for _ in range(2)]
    try:
        for t in threads:
            t.start()
        time.sleep(0.2)  # both misses wait inside the download
        t0 = time.monotonic()
        assert cache.get("em2em:v1") is resident
        assert time.monotonic() - t0 < 5.0
    finally:
        gate.set()
        for t in threads:
            t.join(timeout=30)
    assert not any(t.is_alive() for t in threads)
    assert downloads == [["em2em", "v2"]]
    assert cache.get("em2em:v2")[1].wf == 32
    cache.close()


def test_model_cache_eviction_reclaims_staging_dir(fake_gcs, export_dir):
    _publish(fake_gcs, export_dir, ("v1", "v2"))
    cache = ms.ModelCache("gs://model-bucket/models", capacity=1,
                          device="cpu")
    try:
        cache.get("em2em:v1")
        root = cache._gcs_dir
        assert len(os.listdir(root)) == 1
        for _ in range(3):  # each get evicts the other model
            for name in ("em2em:v2", "em2em:v1"):
                cache.get(name)
                assert len(os.listdir(root)) == 1
    finally:
        cache.close()
    assert not os.path.exists(root)


@pytest.mark.parametrize("root_kind", ["local", "gcs"])
def test_model_cache_close_races_inflight_load(fake_gcs, export_dir,
                                               tmp_path, monkeypatch,
                                               root_kind):
    """A load that completes after close() caches nothing, closes its fresh
    batcher and removes its staging dir."""
    from transfer_em_tpu_torch.infer.batcher import make_tile_batcher

    if root_kind == "gcs":
        _publish(fake_gcs, export_dir)
        root = "gs://model-bucket/models"
    else:
        os.makedirs(tmp_path / "models" / "em2em")
        shutil.copytree(export_dir, tmp_path / "models" / "em2em" / "v1")
        root = str(tmp_path / "models")
    built = []

    def factory(gen, meta):
        built.append(make_tile_batcher(gen, meta.meanstd_x, meta.meanstd_y,
                                       meta.outdimsize, meta.buffer,
                                       device="cpu", max_batch=4))
        return built[-1]

    cache = ms.ModelCache(root, batcher_factory=factory, device="cpu")
    loaded, gate = threading.Event(), threading.Event()
    orig = ms.load_generator

    def gated_load(path, **kw):
        out = orig(path, **kw)
        loaded.set()
        assert gate.wait(30)  # hold the loaded model until close() ran
        return out

    monkeypatch.setattr(ms, "load_generator", gated_load)
    errs = []

    def loader():
        try:
            cache.get("em2em:v1")
        except RuntimeError as e:
            errs.append(e)

    t = threading.Thread(target=loader)
    t.start()
    try:
        assert loaded.wait(30)
        staging = cache._gcs_dir
        cache.close()
    finally:
        gate.set()
        t.join(timeout=30)
    assert not t.is_alive()
    assert len(errs) == 1 and "closed" in str(errs[0])
    assert not cache._entries and not cache._staging
    assert built and built[0]._closed
    if root_kind == "gcs":
        assert staging is not None and not os.path.exists(staging)
    with pytest.raises(RuntimeError, match="closed"):
        cache.get("em2em:v1")


def test_model_service_gcs_root_to_gcs_dest(fake_gcs, export_dir, tmp_path):
    """ModelService over a gs:// model root writes its blocks to a gs://
    destination, within one level of the JAX package's prediction."""
    import urllib.request

    _publish(fake_gcs, export_dir)
    data = np.random.default_rng(5).integers(0, 255, (96, 96, 96),
                                             dtype=np.uint8)
    loc = write_ng(tmp_path / "vol", data, 64)
    svc = ModelService(model_root="gs://model-bucket/models", device="cpu")
    svc.start()
    cfg = {"location": loc, "start": [0, 64, 0], "glbstart": [0, 0, 0],
           "size": [64, 64, 64], "model_name": "em2em:v1",
           "dest": "gs://out-bucket/pred"}
    try:
        req = urllib.request.Request(
            svc.url + "/", data=json.dumps(cfg).encode(),
            headers={"Content-type": "application/json"})
        assert urllib.request.urlopen(req, timeout=300).read() == b"success"
    finally:
        svc.stop()
    (rec,) = fake_gcs["out-bucket"].values()
    assert list(fake_gcs["out-bucket"]) == ["pred/0-64_64-128_0-64"]
    got = np.frombuffer(gzip.decompress(rec["data"]), np.uint8)
    jgen, jparams, jmeta = jload_generator(export_dir)
    want = jtiling.predict_ng_cube(loc, (0, 64, 0), (64, 64, 64),
                                   (jgen.apply, jparams), jmeta.meanstd_x,
                                   jmeta.meanstd_y, None, outdimsize=40,
                                   buffer=17)
    assert_close_u8(got.reshape(64, 64, 64), want)


# ----------------------------------------------- tensorstore gcs spec shape

def test_open_tensorstore_gcs_spec_matches_jax(monkeypatch):
    """'bucket/path' -> the gcs kvstore spec the reference uses
    (generators.py:116-126), the JAX package's spec exactly."""
    import tensorstore as ts

    captured = []

    class FakeDS:
        def __getitem__(self, *_):
            return self

        def result(self):
            return self

    def fake_open(spec):
        captured.append(spec)
        return FakeDS()

    monkeypatch.setattr(ts, "open", fake_open)
    sources.open_tensorstore("mybucket/em/snapshot", scale_index=2)
    jsources.open_tensorstore("mybucket/em/snapshot", scale_index=2)
    assert captured[0] == captured[1]
    assert captured[0]["kvstore"] == {"driver": "gcs", "bucket": "mybucket"}
    assert captured[0]["path"] == "em/snapshot"
    assert captured[0]["scale_index"] == 2
