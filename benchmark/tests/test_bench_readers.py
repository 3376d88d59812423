"""The volume cell's kernel readers count the work of the convs whose
time they divide by: the work a tile of the down and transposed convs,
the port's form counts of the window, and each reader's share on a
made-up trace."""

import time

import pytest
import torch

from benchmark import counts, harness
from benchmark.tests import helpers

WORK = {k: counts.tile_work("gen", 8, "float32", (k,))
        for k in ("k3", "k4", "transposed")}


def test_work_a_tile_of_the_down_and_transposed_convs():
    """wf=8, from the reference's layer shapes: the two k4 down convs and
    the two transposed convs (the algorithm's 64 taps an input voxel)."""
    k4, tr = WORK["k4"], WORK["transposed"]
    assert k4["flops"] == 432_570_368
    assert tr["flops"] == 318_439_424
    # x and y a tile (8·70³ + 8·34³ + 16·32³ + 16·15³ floats), w a call
    assert k4["bytes"] == 4 * 3_636_720
    assert k4["weight_bytes"] == 4 * 64 * (8 * 8 + 16 * 16)
    # 32·13³ + 16·26³ + 16·22³ + 8·44³ floats a tile
    assert tr["bytes"] == 4 * 1_203_360
    assert tr["weight_bytes"] == 4 * 64 * (32 * 16 + 16 * 8)
    assert counts.forward_flops("gen", 8) == (
        WORK["k3"]["flops"] + k4["flops"] + tr["flops"])


def _obs(device_ops, forms, calls=10, tiles=10_000):
    return {"kind": "volume", "calls": calls, "tiles": tiles,
            "dtype": "float32", "work": WORK, "forms": forms,
            "trace": {"device_ops": device_ops}}


def _read(name, obs):
    return harness.load_module("metrics", name).read(obs)


CONV3_ROWS = [("void tem::tc::conv3_tc_kernel<float, 8, 1>(...)", 0.8),
              ("void tem::direct::conv3_direct_kernel<float, 8>(...)", 0.3),
              ("void tem::down4::down4_tc_kernel<8, 1>(...)", 0.2)]


def test_conv3_roofline_counts_the_phase_convs_it_ran():
    """The numerator holds the transposed layers at the share that the
    port's counters put in the phase form, and drops what ran on cuDNN."""
    k3 = counts.least_seconds([(WORK["k3"], 1.0)], 10_000, 10, "float32")
    both = counts.least_seconds(
        [(WORK["k3"], 1.0), (WORK["transposed"], 1.0)], 10_000, 10,
        "float32")
    half = counts.least_seconds(
        [(WORK["k3"], 1.0), (WORK["transposed"], 0.5)], 10_000, 10,
        "float32")
    cases = [({"transpose_phase": 160, "transpose_cudnn": 0}, both),
             ({"transpose_phase": 80, "transpose_cudnn": 80}, half),
             ({"transpose_phase": 0, "transpose_cudnn": 160}, k3),
             ({}, k3)]
    for forms, least in cases:
        got = _read("conv3_roofline.volume", _obs(CONV3_ROWS, forms))
        assert got == pytest.approx(100 * least / 1.1, rel=1e-12), forms
    assert k3 < half < both
    # wf=8: bytes bound every part; the phase convs add 1.44 ms a call
    assert (both - k3) / 10 == pytest.approx(4 * (1_203_360 * 1000
                                                  + 64 * 640) / 3.35e12)


def test_down4_roofline():
    forms = {"down_k4": 160, "down_cudnn": 0}
    assert _read("down4_roofline.volume", _obs(CONV3_ROWS[:2], forms)) \
        is None  # no down4 rows
    assert _read("down4_roofline.volume", _obs(CONV3_ROWS, {})) is None
    got = _read("down4_roofline.volume", _obs(CONV3_ROWS, forms))
    # bound by bytes: x and y of 10,000 tiles, w in each of 10 calls
    least = 4 * (3_636_720 * 10_000 + 64 * 320 * 10) / 3.35e12
    assert least > 432_570_368 * 10_000 / 495e12  # over the FLOPs' time
    assert got == pytest.approx(100 * least / 0.2, rel=1e-12)
    assert 21 < got < 22
    half = _read("down4_roofline.volume", _obs(
        CONV3_ROWS, {"down_k4": 80, "down_cudnn": 80}))
    assert half == pytest.approx(got / 2, rel=1e-12)


def test_the_window_counts_the_forms():
    """The volume driver reads the port's form counts around the window:
    on the CPU every transposed conv takes the phase form and every down
    conv the down4 form, two of each a generator forward."""
    line, out = harness.measure(helpers._args("volume-wf8-f32", 2 ** 31 + 23,
                                              0), time.perf_counter(),
                                devices=[torch.device("cpu")],
                                overrides=helpers.TINY["volume-wf8-f32"])
    forms = out["obs"]["forms"]
    assert line["correct"] is True
    assert forms["transpose_cudnn"] == forms["down_cudnn"] == 0
    assert forms["transpose_phase"] == forms["down_k4"] > 0
    assert forms["down_k4"] % (2 * line["attempted"]) == 0


WORK_BF16 = {k: counts.tile_work("gen", 1, "bfloat16", (k,))
             for k in ("k4", "transposed")}


def _bf16_obs(by_host_op, forms, calls=10, tiles=10_000):
    return {"kind": "volume", "calls": calls, "tiles": tiles,
            "dtype": "bfloat16", "work": WORK_BF16, "forms": forms,
            "trace": {"device_ops": CONV3_ROWS, "by_host_op": by_host_op}}


def test_cudnn_roofline_counts_the_convs_it_ran():
    """wf=1 in bf16: the k4 down and transposed convs that ran in the
    cudnn form, at the bf16 peak (FLOPs bound both kinds), over the device
    time under aten::convolution; None without that time."""
    k4, tr = WORK_BF16["k4"], WORK_BF16["transposed"]
    assert k4["flops"] + tr["flops"] == 48_064_626_688  # 48.1 GFLOP a tile
    assert k4["flops"] / 989e12 > k4["bytes"] / 3.35e12
    assert tr["flops"] / 989e12 > tr["bytes"] / 3.35e12
    cudnn = {"down_cudnn": 20, "down_k4": 0, "transpose_cudnn": 20,
             "transpose_phase": 0}
    conv = {"aten::convolution": 2.0}
    got = _read("cudnn_roofline.volume", _bf16_obs(conv, cudnn))
    least = max(10_000 * (k4["flops"] + tr["flops"]) / 989e12,
                (10_000 * (k4["bytes"] + tr["bytes"])
                 + 10 * (k4["weight_bytes"] + tr["weight_bytes"])) / 3.35e12)
    assert got == pytest.approx(100 * least / 2.0, rel=1e-12)
    # the down convs on down4: only the transposed convs' work is cuDNN's
    half = _read("cudnn_roofline.volume", _bf16_obs(
        conv, dict(cudnn, down_cudnn=0, down_k4=20)))
    assert half == pytest.approx(100 * counts.least_seconds(
        [(tr, 1.0)], 10_000, 10, "bfloat16") / 2.0, rel=1e-12)
    for by_host_op in ({}, {"aten::convolution": 0.0},
                       {"aten::convolution_backward": 1.0}):
        assert _read("cudnn_roofline.volume",
                     _bf16_obs(by_host_op, cudnn)) is None
    assert _read("cudnn_roofline.volume",
                 dict(_bf16_obs(conv, cudnn), calls=0)) is None


def _volume_run(name):
    line, out = harness.measure(helpers._args(name, 2 ** 31 + 29, 0),
                                time.perf_counter(),
                                devices=[torch.device("cpu")],
                                overrides=helpers.TINY[name])
    assert line["correct"] is True, line["checks"]
    return out["obs"]


def test_the_volume_driver_takes_its_dtype_from_the_cell():
    """Without a ``dtype`` key the driver runs float32: the f32 cell's obs
    hold the same keys as before the key existed, its work counted at 4
    bytes an element, and every down and transposed conv took the port's
    f32 forms; the bf16 cell counts at 2 bytes, and its convs took the
    cudnn form, which the port keeps for bf16."""
    wf = helpers.TINY["volume-wf8-f32"]["config"]["wf"]
    assert "dtype" not in harness.load_json("workloads", "volume-wf8-f32")
    f32 = _volume_run("volume-wf8-f32")
    assert set(f32) == {"kind", "calls", "tiles", "dtype",
                        "gen_flops_per_tile", "work", "forms"}
    assert f32["dtype"] == "float32"
    assert f32["work"] == {k: counts.tile_work("gen", wf, "float32", (k,))
                           for k in ("k3", "k4", "transposed")}
    assert f32["forms"]["down_cudnn"] == f32["forms"]["transpose_cudnn"] == 0
    wf = helpers.TINY["volume-wf1-bf16"]["config"]["wf"]
    bf16 = _volume_run("volume-wf1-bf16")
    assert set(bf16) == set(f32) and bf16["dtype"] == "bfloat16"
    assert bf16["work"] == {k: counts.tile_work("gen", wf, "bfloat16", (k,))
                            for k in ("k3", "k4", "transposed")}
    assert bf16["forms"]["down_k4"] == bf16["forms"]["transpose_phase"] == 0
    assert bf16["forms"]["down_cudnn"] == bf16["forms"][
        "transpose_cudnn"] > 0
