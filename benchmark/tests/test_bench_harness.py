"""The harness finds every cell, configuration, driver and metric by name,
picks up a new cell from its file alone, reduces a trace and writes the
result line."""

import json
import os
import shutil
import time
from types import SimpleNamespace

import pytest

from benchmark import harness
from benchmark.tests import helpers

BENCH = harness.load_benchmark()


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]])
def test_config_loads_by_name(name):
    entry = next(c for c in BENCH["configs"] if c["name"] == name)
    cfg = harness.load_json("configs", name)
    assert entry["file"] == f"benchmark/configs/{name}.json"
    assert cfg["name"] == name and cfg["reduced"] == entry["reduced"]
    assert entry["source"].startswith("https://")


@pytest.mark.parametrize("name", [w["name"] for w in BENCH["workloads"]])
def test_cell_loads_by_name(name):
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    cell = harness.load_json("workloads", name)
    for k in ("config", "traffic", "chips", "why"):
        assert cell[k] == entry[k], k
    assert any(c["name"] == cell["config"] for c in BENCH["configs"])
    assert callable(harness.load_module("drivers", cell["driver"]).run)
    e2e = harness.cell_metrics(BENCH, name, "end_to_end")
    assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
    assert harness.cell_metrics(BENCH, name, "per_layer")


@pytest.mark.parametrize("name", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_loads_by_name(name):
    m = next(m for m in BENCH["per_layer"] if m["name"] == name)
    assert callable(harness.load_module("metrics", name).read)
    e2e = {e["name"]: e for e in BENCH["end_to_end"]}
    assert m["moves"] in e2e
    for w in m["workloads"]:
        assert w in e2e[m["moves"]].get("workloads", [w])


def test_every_metric_file_has_an_entry():
    """No reader under ``metrics/`` outlives its entry in ``per_layer``."""
    files = {f[:-3] for f in os.listdir(os.path.join(harness.HERE,
                                                     "metrics"))
             if f.endswith(".py")}
    assert files - {m["name"] for m in BENCH["per_layer"]} == set()


def test_a_new_cell_is_picked_up_from_its_file(tmp_path, monkeypatch):
    """A copy of the benchmark gains a cell by new files and entries only;
    the harness runs it without an edit to any existing file."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    new = "volume-wf32-tiny"
    cell = harness.load_json("workloads", "volume-wf8-f32")
    cell.update(helpers.TINY["volume-wf8-f32"]["cell"], name=new,
                config="tem3d-wf32")
    cfg = dict(harness.load_json("configs", "tem3d-wf8"), name="tem3d-wf32",
               wf=32)
    (root / "benchmark" / "workloads" / f"{new}.json").write_text(
        json.dumps(cell))
    (root / "benchmark" / "configs" / "tem3d-wf32.json").write_text(
        json.dumps(cfg))
    bench["workloads"].append({k: cell[k] for k in
                               ("config", "traffic", "chips", "why")}
                              | {"name": new})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if "volume-wf8-f32" in m.get("workloads", []):
            m["workloads"].append(new)
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    monkeypatch.setattr(harness, "HERE", str(root / "benchmark"))
    monkeypatch.setattr(harness, "ROOT", str(root))
    line = helpers.run_cell(new, overrides={})
    assert line["correct"] is True
    assert set(line["metrics"]) == {"volume_mvox_per_s", "setup_s"}
    traced = helpers.run_cell(new, trace=1, overrides={})
    assert "idle_share.volume" not in traced["metrics"]  # no device here
    assert traced["device"]["window_s"] > 0


def test_result_line(capsys):
    line = helpers.run_cell("volume-wf8-f32")
    assert list(line) == ["correct", "attempted", "failed", "metrics",
                          "device", "checks"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] > 0
    assert set(line["checks"]) == {"off_share"}
    err = capsys.readouterr().err.strip().splitlines()
    assert err[-1].startswith("check off_share:")


class _Ev:
    def __init__(self, name, dev, s, t, corr=0, tid=1, user=False):
        from torch.autograd import DeviceType
        self._n, self._s, self._t, self._c = name, s, t, corr
        self._d = DeviceType.CUDA if dev else DeviceType.CPU
        self._tid, self._u = tid, user

    def name(self):
        return self._n

    def device_type(self):
        return self._d

    def device_index(self):
        return 0

    def start_ns(self):
        return self._s

    def end_ns(self):
        return self._t

    def correlation_id(self):
        return self._c

    def start_thread_id(self):
        return self._tid

    def is_user_annotation(self):
        return self._u


def test_reduce_trace():
    ms = 1_000_000
    events = [
        _Ev(harness.WINDOW, False, 0, 100 * ms, user=True),
        _Ev("port.step", False, 0, 60 * ms, user=True),
        _Ev("aten::convolution_backward", False, 10 * ms, 30 * ms),
        _Ev("cudaLaunchKernel", False, 11 * ms, 12 * ms, corr=7),
        _Ev("cudaLaunchKernel", False, 40 * ms, 41 * ms, corr=8),
        _Ev("dgrad_kernel", True, 20 * ms, 50 * ms, corr=7),
        _Ev("conv3_tc_kernel<float>", True, 45 * ms, 70 * ms, corr=8),
        _Ev("Memcpy HtoD (Pageable -> Device)", True, 90 * ms, 95 * ms),
    ]
    t = harness.reduce_trace(events, 1)
    assert t["window_s"] == pytest.approx(0.1)
    assert t["busy_s"] == pytest.approx(0.055)  # 20-70 and 90-95
    assert dict(t["device_ops"])["dgrad_kernel"] == pytest.approx(0.03)
    assert t["by_host_op"] == {"aten::convolution_backward":
                               pytest.approx(0.03)}
    gaps = t["idle_gaps"]  # 70-90, 0-20 (under the span), 95-100 ms
    assert gaps == [["no host activity", pytest.approx(0.02)],
                    ["port.step", pytest.approx(0.02)],
                    ["no host activity", pytest.approx(0.005)]]


def test_refuses_without_the_card(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = SimpleNamespace(workload="volume-wf8-f32", seed=1, seconds=1,
                           trace=0)
    with pytest.raises(SystemExit):
        harness.run(args, time.perf_counter())


def test_checkout_without_the_program_fails(tmp_path):
    """A directory holding only BENCHMARK.json and benchmark/ has no
    system to run: the command exits non-zero and prints no result."""
    import subprocess
    import sys
    shutil.copytree(harness.HERE, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(harness.ROOT, "BENCHMARK.json"), tmp_path)
    res = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                          "volume-wf8-f32", "--seed", "1", "--seconds", "1",
                          "--trace", "0"], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode != 0 and res.stdout.strip() == ""
