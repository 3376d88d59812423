"""The readers of the port's own spans (``benchmark/spans.py``): each cell
run small on the CPU with a trace, through the harness; the host-time
readers read numbers, the device-time readers nothing (no card); and a
port that keeps no span records leaves every such metric out."""

import sys
import time

import pytest
import torch

from benchmark import harness, spans
from benchmark.tests import helpers

HOST = {"train-wf1-bf16": ["data_host_ms.train"],
        "volume-wf8-f32": ["upload_ms.volume", "download_ms.volume"],
        "volume-wf1-bf16": ["upload_ms.volume", "download_ms.volume"]}
DEVICE = {"train-wf1-bf16": ["fwd_ms.train", "bwd_ms.train",
                             "adam_ms.train", "data_dev_ms.train"],
          "volume-wf8-f32": ["tiles_ms.volume"],
          "volume-wf1-bf16": ["tiles_ms.volume"]}
ENTRY = {"train-wf1-bf16": "train.step", "volume-wf8-f32": "volume.call",
         "volume-wf1-bf16": "volume.call"}


def _traced(name):
    line, _ = harness.measure(helpers._args(name, 2 ** 31 + 19, 1),
                              time.perf_counter(),
                              devices=[torch.device("cpu")],
                              overrides=helpers.TINY[name])
    return line


@pytest.mark.parametrize("name", sorted(HOST))
def test_span_readers_on_the_cpu(name):
    from transfer_em_tpu_torch import telemetry
    telemetry.reset()
    line = _traced(name)
    assert line["correct"] is True
    metrics = line["metrics"]
    for k in HOST[name]:
        assert metrics[k]["unit"] == "ms" and metrics[k]["value"] > 0, k
    for k in DEVICE[name]:
        assert k not in metrics, k
    # the records are the traced window's: one entry span an operation
    recs = telemetry.records()
    assert sum(r["name"] == ENTRY[name] for r in recs) == line["attempted"]


@pytest.mark.parametrize("name", sorted(HOST))
def test_span_metrics_are_registered(name):
    entries = {m["name"]: m for m in harness.load_benchmark()["per_layer"]}
    for k in HOST[name] + DEVICE[name]:
        m = entries[k]
        assert m["source"] == "program_counter" and m["unit"] == "ms"
        assert m["workloads"] == [c for c in m["workloads"]
                                  if k in HOST[c] + DEVICE[c]]
        assert name in m["workloads"]


def test_a_port_without_span_records_reads_nothing(monkeypatch):
    """In a checkout whose port has no ``transfer_em_tpu_torch.telemetry``
    every span reader gives None and raises nothing."""
    import transfer_em_tpu_torch
    monkeypatch.setitem(sys.modules, "transfer_em_tpu_torch.telemetry", None)
    monkeypatch.delattr(transfer_em_tpu_torch, "telemetry", raising=False)
    assert spans.total_ms("train.forward", device=True) is None
    for name in HOST:
        obs = {"kind": name.split("-")[0], "steps": 3, "calls": 3}
        for k in HOST[name] + DEVICE[name]:
            assert harness.load_module("metrics", k).read(obs) is None, k
