"""The port's benches (``transfer_em_tpu_torch/bench/``) on the CPU at tiny
sizes: each module's ``main`` prints JSON lines under the JAX bench's
metric names, fidelity's per-fixture PSNR sits within 0.5 dB of the JAX
package's on the same goldens, the data fleet runs single-process and
prefork, the DP bench's meshed step equals the unmeshed step, each module
defaults to ``cuda`` and raises without it, and no bench module imports
jax or the JAX package."""

import ast
import copy
import glob
import json
import os

import jax
import numpy as np
import pytest
import torch

from transfer_em_tpu_torch.bench import baseline_configs, dp, fidelity
from transfer_em_tpu_torch.bench import int8 as bench_int8
from transfer_em_tpu_torch.bench import serve
from transfer_em_tpu_torch.config import CycleGANConfig

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(REPO, "transfer_em_tpu_torch", "bench")
KERNELS = {"conv3", "preprocess_u8", "postprocess_u8", "leaky_relu",
           "conv_int8", "quantize_int8"}


def _lines(capsys):
    out = capsys.readouterr().out
    return [json.loads(line) for line in out.splitlines()
            if line.startswith("{")]


def _check_common(rec):
    assert rec["device"] == "cpu" and rec["card"] is None
    assert isinstance(rec["value"], float) and np.isfinite(rec["value"])


def test_fidelity_matches_jax_per_fixture(capsys):
    """Both dtypes' lines above the 40 dB bar; in f32 each fixture within
    0.5 dB of the JAX package's PSNR, or, past 120 dB, where both sit on
    float32's rounding floor and the summation order alone moves it by
    ~10 dB (gen_3d: 155.1 against 143.8, max |diff| 2.6e-9), no lower
    than JAX's."""
    from golden_utils import (DISC_ORDER_2D, DISC_ORDER_3D, GEN_ORDER,
                              assign_weights, load_golden, psnr)
    from transfer_em_tpu.models import Discriminator, UNetGenerator

    assert fidelity.main(["--device", "cpu", "--dtype", "f32,bf16"]) == 0
    f32, bf16 = _lines(capsys)
    for rec, dtype in ((f32, "float32"), (bf16, "bfloat16")):
        _check_common(rec)
        assert rec["metric"] == "golden_psnr_db_min"
        assert rec["dtype"] == dtype and rec["unit"] == "dB"
        assert rec["value"] == min(rec["psnr_db"].values()) >= 40.0
        assert rec["vs_baseline"] == pytest.approx(rec["value"] / 40.0)
    for name in ("gen_2d", "gen_3d", "disc_2d", "disc_3d"):
        x, want, weights = load_golden(name)
        tag = name[-2:]
        if name.startswith("gen"):
            mod, order = UNetGenerator(wf=8), GEN_ORDER
        else:
            mod = Discriminator(is3d=tag == "3d", wf=8)
            order = DISC_ORDER_3D if tag == "3d" else DISC_ORDER_2D
        params = assign_weights(mod.init(jax.random.PRNGKey(0), x), order,
                                weights)
        jpsnr = psnr(np.asarray(jax.jit(mod.apply)(params, x)), want)
        got = f32["psnr_db"][name]
        assert got > jpsnr - 0.5, (name, got, jpsnr)
        assert abs(got - jpsnr) < 0.5 or min(got, jpsnr) > 120, (name, got,
                                                                 jpsnr)


def test_fidelity_wf1_self(capsys):
    """``--wf1``: the full-width generator on the device against the CPU's
    plain float32 forward (here both are the CPU's: far above the bar)."""
    assert fidelity.main(["--device", "cpu", "--wf1"]) == 0
    (rec,) = _lines(capsys)
    assert {"gen_2d_wf1_self", "gen_3d_wf1_self"} <= set(rec["psnr_db"])
    assert min(rec["psnr_db"][k] for k in ("gen_2d_wf1_self",
                                           "gen_3d_wf1_self")) > 100.0


@pytest.mark.parametrize("workers", [0, 2])
def test_serve_data_fleet(capsys, workers):
    assert serve.main(["data", "--device", "cpu", "--clients", "2",
                       "--reqs-per-client", "4", "--workers", str(workers),
                       "--reps", "1", "--side", "128"]) == 0
    (rec,) = _lines(capsys)
    _check_common(rec)
    assert rec["metric"] == "data_fleet_req_per_sec"
    assert rec["vs_baseline"] == 1.0 and list(rec["by_workers"]) == [
        str(workers)]
    assert rec["launches"] == {}


def test_serve_model_fleet(capsys):
    assert serve.main(["model", "--device", "cpu", "--reqs", "2", "--reps",
                       "1", "--wf", "32", "--side", "128"]) == 0
    (rec,) = _lines(capsys)
    _check_common(rec)
    assert rec["metric"] == "serve_fleet_mvox_per_sec"
    assert set(rec["modes"]) == {"unbatched", "batched"}
    assert rec["batcher"]["tiles"] == 2 * 2 * 8  # warm + one rep, 8 a chunk
    assert KERNELS <= set(rec["launches"])


def test_serve_soak(capsys):
    """Both soak lines under the JAX names, with their bars; the exit
    code says whether every bar held."""
    rc = serve.main(["soak", "--device", "cpu", "--soak-data-reqs", "40",
                     "--soak-model-reqs", "4", "--soak-workers", "2",
                     "--wf", "32", "--side", "128"])
    data, model = _lines(capsys)
    assert data["metric"] == "serve_soak_data_req_per_sec"
    assert model["metric"] == "serve_soak_model_req_per_sec"
    assert set(data["bars"]) == {"latency_drift_ok", "fd_stable_ok",
                                 "rss_bounded_ok", "errors_ok", "respawn_ok"}
    assert data["bars"]["respawn_ok"] and data["workers"] == [2, 2]
    assert model["errors"] == 0
    assert rc == (0 if data["pass"] and model["pass"] else 1)


def test_serve_soak_model_churn(capsys):
    """Two models against cache_size=1: every verified response is its
    own model's bytes, and both models are verified."""
    serve.main(["soak", "--models", "2", "--device", "cpu",
                "--soak-model-reqs", "8", "--wf", "32", "--side", "128"])
    (rec,) = _lines(capsys)
    assert rec["metric"] == "serve_soak_model_churn2_req_per_sec"
    assert rec["errors"] == 0 and rec["verified_models"] == [0, 1]


def test_serve_combined(capsys):
    assert serve.main(["combined", "--device", "cpu", "--clients", "2",
                       "--batch", "1", "--epoch-size", "1", "--extent",
                       "96", "--combined-workers", "2", "--wf", "32",
                       "--dtype", "f32"]) == 0
    (rec,) = _lines(capsys)
    _check_common(rec)
    assert rec["metric"] == "combined_stream_train_tiles74_per_sec"
    assert rec["fleet_req_per_sec"] > 0 and rec["alone_tiles_per_sec"] > 0


def test_dp_cpu_mesh(capsys):
    assert dp.main(["--cpu", "2", "--steps", "1", "--batch", "1"]) == 0
    (rec,) = _lines(capsys)
    _check_common(rec)
    assert rec["metric"] == "dp_train_tiles_per_sec" and rec["ndev"] == 2
    assert [m["ndev"] for m in rec["meshes"]] == [1, 2]
    assert rec["vs_baseline"] is None
    assert rec["config"] == {"dim": 74, "is3d": False, "wf": 32,
                             "per_dev_batch": 1, "dtype": "float32"}


def test_dp_bench_step_equals_unmeshed_step():
    """The bench's meshed step over 2 CPU positions against
    make_train_step on the same global batch and state, two steps (dropout
    on), as tests/test_torch_parallel.py holds the DP step."""
    from test_torch_parallel import assert_state_close

    from transfer_em_tpu_torch.train import create_state, make_train_step

    cfg = CycleGANConfig(dimsize=74, is3d=False, wf=32)
    state0 = create_state(cfg, 0, device="cpu")
    cpu = torch.device("cpu")
    step, meshed, xs, ys, _ = dp.make_case(cfg, state0, [cpu] * 2, 2, 2)
    single = copy.deepcopy(state0)
    step1 = make_train_step(cfg, device="cpu")
    x, y = xs.gather(cpu), ys.gather(cpu)
    for seed in (1, 2):
        l1 = step1(single, x, y, seed)
        l2 = step(meshed, xs, ys, seed)
        np.testing.assert_allclose(l2.numpy(), l1.numpy(), rtol=2e-4,
                                   atol=1e-5)
    assert meshed.step == single.step == 2
    assert_state_close(meshed, single)


def test_int8_bench(capsys):
    assert bench_int8.main(["--device", "cpu", "--configs", "32:1,32:2",
                            "--reps", "1"]) == 0
    (rec,) = _lines(capsys)
    _check_common(rec)
    assert rec["metric"] == "int8_speedup_b1_wf32"
    assert [(r["wf"], r["batch"]) for r in rec["configs"]] == [(32, 1),
                                                             (32, 2)]
    assert rec["golden_psnr_db_min"] >= 40.0
    assert set(rec["golden_psnr_db"]) == {"gen_2d_int8", "gen_3d_int8"}
    assert {"conv_int8", "quantize_int8"} <= set(rec["launches"])


def test_baseline_configs(capsys):
    assert baseline_configs.main([
        "--device", "cpu", "--ladder", "2,4", "--steps", "1", "--batch",
        "1", "--epoch-size", "1", "--epochs", "1", "--extent", "96",
        "--wf", "32", "--dtype", "f32"]) == 0
    cfg2, cfg4 = _lines(capsys)
    _check_common(cfg2)
    _check_common(cfg4)
    assert cfg2["metric"] == "inference2d_mvox_per_sec"
    assert [r["batch"] for r in cfg2["rungs"]] == [2, 4]
    assert all(r["out_shape"][1:] == [40, 40] for r in cfg2["rungs"])
    assert cfg4["metric"] == "stream_train_tiles74_per_sec"
    assert cfg4["tiles"] == 1


@pytest.mark.parametrize("module,argv", [
    (fidelity, []), (serve, ["model"]), (serve, ["data"]), (dp, []),
    (bench_int8, []), (baseline_configs, ["config2"])])
def test_bench_defaults_to_cuda(module, argv):
    """Without a card, each bench's default device raises (no silent run
    on the CPU)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        module.main(argv)


@pytest.mark.parametrize("path", sorted(glob.glob(os.path.join(BENCH_DIR,
                                                               "*.py"))))
def test_bench_imports_no_jax(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""] if node.level == 0 else []
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "transfer_em_tpu"), \
                (path, name)
