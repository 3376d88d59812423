"""The port's spans and counters (``transfer_em_tpu_torch.telemetry``) on
the CPU: totals without a profiler and no records; under a profiler,
records with parents and request ids on the profiler's own clock; self
times; one session's records at a time; the data pipeline's spans closed
at every yield; the spans of the train step, device-mode
``predict_volume``, the tile batcher and the model service, in their
nesting; the batcher's queue-wait counters at ``GET /stats``; and outputs
bit-equal with and without a profiler."""

import json
import os
import time
import urllib.request

import numpy as np
import pytest
import torch
from torch._C._profiler import _ExperimentalConfig
from torch.profiler import ProfilerActivity, profile

from transfer_em_tpu_torch import telemetry
from transfer_em_tpu_torch.config import CycleGANConfig, ExportMeta
from transfer_em_tpu_torch.data.pipeline import (
    create_dataset_from_generator, create_dataset_from_tensors)
from transfer_em_tpu_torch.infer import (export_generator, make_tile_batcher,
                                         plan_tiles, predict_volume)
from transfer_em_tpu_torch.models import UNetGenerator
from transfer_em_tpu_torch.native import gather_blocks
from transfer_em_tpu_torch.ops import convs
from transfer_em_tpu_torch.ops.counts import read_counts, reset_counts
from transfer_em_tpu_torch.serve import (ModelService, NumpyVolume,
                                         register_volume)
from transfer_em_tpu_torch.train import build_step_fn, create_state

torch.set_num_threads(1)

MS_X, MS_Y = (0.1, 0.9), (0.2, 1.1)
ONE_CLOCK_NS = 100_000  # a record and its annotation start within 0.1 ms


@pytest.fixture(autouse=True)
def fresh_registry():
    telemetry.reset()
    yield
    telemetry.reset()


def profiled(fn):
    """``fn()`` under a CPU profiler that traces every thread; returns its
    result and the profiler's raw events."""
    with profile(activities=[ProfilerActivity.CPU],
                 experimental_config=_ExperimentalConfig(
                     profile_all_threads=True)) as prof:
        out = fn()
    return out, prof.profiler.kineto_results.events()


def by_name(recs, name):
    return [r for r in recs if r["name"] == name]


def children(recs, rec):
    return [r["name"] for r in recs if r["parent"] == rec["id"]]


@pytest.fixture(scope="module")
def gen():
    torch.manual_seed(0)
    return UNetGenerator(wf=32).eval()


def test_off_keeps_totals_and_no_records():
    for _ in range(3):
        with telemetry.span("a"):
            with telemetry.span("b"):
                pass
    telemetry.count("c", 2)
    telemetry.count("c")
    t = telemetry.totals()
    assert t["spans"]["a"]["count"] == t["spans"]["b"]["count"] == 3
    assert t["spans"]["a"]["seconds"] >= t["spans"]["b"]["seconds"] >= 0
    assert t["counts"] == {"c": 3}
    assert telemetry.records() == [] and telemetry.current() is None
    snap = telemetry.snapshot()
    assert snap["spans"] == t["spans"] and snap["counts"] == t["counts"]
    assert snap["launches"] == read_counts()
    telemetry.reset()
    assert telemetry.totals() == {"spans": {}, "counts": {}}


def test_reset_zeroes_the_kernels_counts():
    """The kernels' counts (a form picked here; launches only on the card)
    read through read_counts() and snapshot()["launches"], in
    telemetry.LAUNCHES' order, and stay out of totals()["counts"];
    reset_counts() zeroes them alone, telemetry.reset() with the rest."""
    def convs_once():
        with torch.inference_mode():
            convs.conv_nd(torch.randn(1, 34, 34, 34, 2),
                          torch.randn(4, 4, 4, 2, 4), stride=2)
            convs.conv_transpose_nd(torch.randn(1, 5, 5, 5, 2),
                                    torch.randn(4, 4, 4, 2, 3),
                                    phase_decompose=False)

    telemetry.reset()
    convs_once()
    telemetry.count("c")
    c = read_counts()
    assert list(c) == list(telemetry.LAUNCHES)
    assert {k: n for k, n in c.items() if n} == {"down_k4": 1,
                                                 "transpose_cudnn": 1}
    assert telemetry.snapshot()["launches"] == c
    assert telemetry.totals()["counts"] == {"c": 1}
    reset_counts()
    assert not any(read_counts().values())
    assert telemetry.totals()["counts"] == {"c": 1}
    convs_once()
    assert read_counts()["down_k4"] == 1
    telemetry.reset()
    assert not any(read_counts().values())
    assert telemetry.totals() == {"spans": {}, "counts": {}}


def _nested_work():
    for _ in range(2):
        with telemetry.span("volume.call"):
            with telemetry.span("volume.upload"):
                torch.ones(8).add_(1)
            with telemetry.span("volume.tiles"):
                with telemetry.span("tile_step.forward"):
                    time.sleep(0.002)
    with telemetry.span("train.data_wait"):
        pass


def test_profiled_spans_are_records_on_the_profilers_clock():
    _, events = profiled(_nested_work)
    recs = telemetry.records()
    one = ["volume.call", "volume.upload", "volume.tiles",
           "tile_step.forward"]
    assert [r["name"] for r in recs] == one * 2 + ["train.data_wait"]
    ids = {r["id"]: r for r in recs}
    for call in by_name(recs, "volume.call"):
        assert call["parent"] is None and call["request"] is not None
        assert children(recs, call) == ["volume.upload", "volume.tiles"]
    first, second = by_name(recs, "volume.call")
    assert first["request"] != second["request"]
    for r in recs[:8]:  # each call's spans carry its request id
        call = r
        while call["parent"] is not None:
            call = ids[call["parent"]]
        assert r["request"] == call["request"]
    fwd = by_name(recs, "tile_step.forward")
    assert all(ids[r["parent"]]["name"] == "volume.tiles" for r in fwd)
    wait = by_name(recs, "train.data_wait")[0]
    assert wait["parent"] is None and wait["request"] is None
    assert all(r["device_ms"] is None for r in recs)  # no card
    assert telemetry.totals()["spans"]["volume.call"]["count"] == 2
    # each span is a user annotation of the profiler's trace, starting
    # where its record starts: one clock
    notes = {}
    for e in events:
        if e.is_user_annotation():
            notes.setdefault(e.name(), []).append(e.start_ns())
    for name in set(r["name"] for r in recs):
        starts = sorted(notes[name])
        mine = [r["start_ns"] for r in by_name(recs, name)]
        assert len(starts) == len(mine)
        assert max(abs(a - b) for a, b in zip(starts, mine)) < ONE_CLOCK_NS


def test_self_time_is_the_duration_less_the_childrens():
    profiled(_nested_work)
    recs = telemetry.records()
    for r in recs:
        kids = [c for c in recs if c["parent"] == r["id"]]
        dur = r["end_ns"] - r["start_ns"]
        assert r["self_ns"] == dur - sum(c["end_ns"] - c["start_ns"]
                                         for c in kids)
        assert r["self_ns"] >= 0
    tiles = by_name(recs, "volume.tiles")
    assert all(r["self_ns"] < 0.5 * (r["end_ns"] - r["start_ns"])
               for r in tiles)  # the child's 2 ms sleep is not its own


def test_a_new_session_clears_the_last_ones_records():
    def one(name):
        with telemetry.span(name):
            pass

    profiled(lambda: one("first"))
    assert [r["name"] for r in telemetry.records()] == ["first"]
    one("between")  # no profiler: ends the session, keeps its records
    assert [r["name"] for r in telemetry.records()] == ["first"]
    profiled(lambda: one("second"))
    assert [r["name"] for r in telemetry.records()] == ["second"]
    assert telemetry.totals()["spans"]["between"]["count"] == 1


def _elements(n=6, side=20, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 255, (side,) * 3, dtype=np.uint8)
            for _ in range(n)]


@pytest.mark.parametrize("kind", ["tensors", "stream", "stream_threads"])
def test_pipeline_spans_close_before_each_yield(kind):
    els = _elements()
    if kind == "tensors":
        ds, _ = create_dataset_from_tensors(
            els, batch_size=2, randomize=True, seed=3, device="cpu")
    else:
        ds, _ = create_dataset_from_generator(
            lambda: iter(els), batch_size=2, epoch_size=6, seed=3,
            fetch_threads=2 if kind == "stream_threads" else 0,
            device="cpu")

    def consume():
        open_at_yield = []
        for _ in range(2):  # two epochs
            for _b in ds:
                open_at_yield.append(telemetry.current())
                with telemetry.span("consumer"):
                    time.sleep(0.001)
        return open_at_yield

    open_at_yield, _ = profiled(consume)
    assert len(open_at_yield) == 6 and not any(open_at_yield)
    recs = telemetry.records()
    ids = {r["id"]: r for r in recs}
    batches = by_name(recs, "data.batch")
    assert len(batches) == 8  # 3 batches and the epoch's end, twice
    for r in recs:
        if r["name"] in ("data.gather", "data.transform"):
            assert ids[r["parent"]]["name"] == "data.batch"
        elif r["name"] in ("data.batch", "consumer"):
            assert r["parent"] is None
    assert len(by_name(recs, "data.transform")) == 6
    for c in by_name(recs, "consumer"):
        for b in batches:
            assert b["end_ns"] <= c["start_ns"] or b["start_ns"] >= c["end_ns"]


def _train_once(profile_it: bool):
    cfg = CycleGANConfig(dimsize=74, wf=32, batch_size=1)
    state = create_state(cfg, 0, device="cpu")
    step = build_step_fn(cfg)
    g = torch.Generator().manual_seed(5)
    x = 0.3 * torch.randn(1, 74, 74, 74, 1, generator=g)
    y = 0.3 * torch.randn(1, 74, 74, 74, 1, generator=g)
    run = lambda: step(state, x, y, 11)  # noqa: E731
    loss = profiled(run)[0] if profile_it else run()
    return loss, {f"{k}.{n}": p.detach().clone()
                  for k in ("gg", "gf", "dx", "dy")
                  for n, p in getattr(state, k).named_parameters()}


def test_train_step_spans_and_bit_equal_outputs():
    loss, params = _train_once(True)
    recs = telemetry.records()
    assert [r["name"] for r in recs] == ["train.step", "train.forward",
                                         "train.backward", "train.adam"]
    step = recs[0]
    assert step["parent"] is None and step["request"] is not None
    assert children(recs, step) == ["train.forward", "train.backward",
                                    "train.adam"]
    assert all(r["request"] == step["request"] for r in recs)
    loss_off, params_off = _train_once(False)
    assert torch.equal(loss, loss_off)
    assert all(torch.equal(params[k], params_off[k]) for k in params)


def test_predict_volume_spans_and_bit_equal_outputs(gen):
    vol = np.random.default_rng(1).integers(0, 255, (90, 90, 90),
                                            dtype=np.uint8)

    def call():
        return predict_volume(vol, gen, (10, 10, 10), (72, 72, 72), MS_X,
                              MS_Y, device="cpu")

    out, _ = profiled(call)
    recs = telemetry.records()
    assert len(by_name(recs, "volume.call")) == 1
    top = by_name(recs, "volume.call")[0]
    assert top["parent"] is None and top["request"] is not None
    assert children(recs, top) == ["volume.upload", "volume.prepare",
                                   "volume.tiles", "volume.wait",
                                   "volume.download"]
    assert all(r["request"] == top["request"] for r in recs)
    assert np.array_equal(out, call())


def test_batcher_spans_queue_wait_and_bit_equal_outputs(gen):
    vol = np.random.default_rng(2).integers(0, 255, (160, 160, 160),
                                            dtype=np.uint8)
    plan = plan_tiles((64, 64, 64), (64, 64, 64), 40, 17)
    tiles = gather_blocks(vol, plan.corners, plan.insize)
    batcher = make_tile_batcher(gen, MS_X, MS_Y, 40, 17, device="cpu",
                                max_batch=8, linger_ms=200)
    try:
        def request():
            with telemetry.span("serve.request"):
                futs = [batcher.submit(t) for t in tiles]
                return np.stack([f.result(timeout=300) for f in futs])

        out, _ = profiled(request)
        recs = telemetry.records()
        rid = by_name(recs, "serve.request")[0]["request"]
        linger = by_name(recs, "batcher.linger")
        steps = by_name(recs, "batcher.step")
        assert len(linger) == len(steps) == 1  # 8 tiles, one batch
        assert linger[0]["parent"] is None and linger[0]["request"] == rid
        assert steps[0]["parent"] is None and steps[0]["request"] == rid
        assert children(recs, steps[0]) == ["tile_step.h2d",
                                            "tile_step.forward",
                                            "tile_step.d2h"]
        assert all(r["request"] == rid for r in recs)
        s = batcher.stats()
        assert s["tiles"] == 8
        assert 0 < s["queue_wait_max_s"] <= s["queue_wait_s"]
        assert s["linger_s"] > 0
        again = np.stack([f.result(timeout=300)
                          for f in [batcher.submit(t) for t in tiles]])
        assert np.array_equal(out, again)
        assert batcher.stats()["queue_wait_max_s"] >= s["queue_wait_max_s"]
    finally:
        batcher.close()


def test_model_service_stats_carry_queue_wait_and_stages(gen, tmp_path):
    root = tmp_path / "models"
    export_generator(gen, ExportMeta(buffer=17, outdimsize=40,
                                     meanstd_x=MS_X, meanstd_y=MS_Y, wf=32),
                     str(root / "m1" / "v1"))
    vol = np.random.default_rng(3).integers(0, 255, (160, 160, 160),
                                            dtype=np.uint8)
    register_volume("telemetrytest/vol", NumpyVolume(vol))
    svc = ModelService(model_root=str(root), device="cpu")
    svc.start()

    def post(start):
        cfg = {"location": "telemetrytest/vol", "start": list(start),
               "glbstart": [0, 0, 0], "size": [64, 64, 64],
               "model_name": "m1:v1", "dest": str(tmp_path / "out")}
        req = urllib.request.Request(
            svc.url + "/", data=json.dumps(cfg).encode(),
            headers={"Content-type": "application/json"})
        return urllib.request.urlopen(req, timeout=300).read()

    try:
        assert post((0, 0, 0)) == b"success"  # untraced
        assert profiled(lambda: post((64, 64, 64)))[0] == b"success"
        s = json.loads(urllib.request.urlopen(svc.url + "/stats",
                                              timeout=60).read())
    finally:
        svc.stop()
    b = s["batcher"]
    assert b["tiles"] == 16
    for k in ("queue_wait_s", "queue_wait_max_s", "linger_s"):
        assert b[k] > 0, k
    assert b["queue_wait_max_s"] <= b["queue_wait_s"]
    st = s["stages"]
    for k in ("serve.request", "serve.read_body", "serve.tiles",
              "serve.write"):
        assert st[k]["count"] == 2, k
    assert st["serve.read_volume"]["count"] == 2 * (1 + 8)  # open, 8 reads
    assert st["batcher.step"]["count"] == b["batches"]
    assert st["tile_step.forward"]["count"] == b["batches"]
    assert set(st) <= {k for k in telemetry.totals()["spans"]
                       if k.startswith(("serve.", "batcher.", "tile_step."))}
    assert len(os.listdir(tmp_path / "out")) == 2
    # the traced request's spans, in their nesting, the fetch threads'
    # under the handler's request
    recs = telemetry.records()
    top = by_name(recs, "serve.request")
    assert len(top) == 1
    kids = children(recs, top[0])
    assert kids[:3] == ["serve.read_body", "serve.read_volume",
                        "serve.tiles"] and kids[-1] == "serve.write"
    assert kids.count("serve.read_volume") == 9
    assert all(r["request"] == top[0]["request"] for r in recs
               if r["name"].startswith("serve."))
