"""The port's EM2EM orchestrator on the CPU: train against the step loop,
checkpoints (round trip, partials, other experiments, retention,
crash-resume), export into serving, priors against the JAX package, and the
metrics.  3D, wf=32, 74^3, B=1; inputs from numpy seeds.  Bit-equal means
exactly equal float32 values."""

import json
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transfer_em_tpu.infer.export import export_generator as jax_export
from transfer_em_tpu.models.generator import UNetGenerator as JaxGenerator
from transfer_em_tpu.train.cgan import create_prior_helper as jax_prior
from transfer_em_tpu.train.metrics import MetricsLogger as JaxMetricsLogger
from transfer_em_tpu_torch.config import CycleGANConfig, ExportMeta
from transfer_em_tpu_torch.data import create_dataset_from_tensors
from transfer_em_tpu_torch.infer import export_generator, load_generator
from transfer_em_tpu_torch.models.convert import TREES, params_from_jax
from transfer_em_tpu_torch.ops.warp import make_warp_map
from transfer_em_tpu_torch.train import (EM2EM, CheckpointManager,
                                         MetricsLogger, StepTimer,
                                         create_prior_helper, create_state,
                                         make_train_step, profile_trace)
from transfer_em_tpu_torch.train.checkpoints import read_checkpoint

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _model(root, name="exp", **kw):
    return EM2EM(74, name, wf=32, checkpoint_root=str(root), device="cpu",
                 **kw)


def _tensors(state):
    """Every tensor of a train state in a fixed order, and the ints."""
    out, ints = [], [state.step]
    for t in TREES:
        out += list(getattr(state, t).parameters())
        opt = getattr(state, "opt_" + t)
        out += [opt.mu[k] for k in sorted(opt.mu)]
        out += [opt.nu[k] for k in sorted(opt.nu)]
        ints.append(opt.count)
    return out, ints


def _assert_states_equal(a, b):
    ta, ia = _tensors(a)
    tb, ib = _tensors(b)
    assert ia == ib
    assert len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert torch.equal(x, y)


def _scramble(state, seed):
    """Non-zero parameters, moments, counts and step from a seed."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for t in _tensors(state)[0]:
            t.copy_(torch.from_numpy(
                rng.normal(0, 0.1, tuple(t.shape)).astype(np.float32)))
    for i, t in enumerate(TREES):
        getattr(state, "opt_" + t).count = 3 + i
    state.step = 11


def _datasets():
    cubes = [np.random.default_rng(40 + i).integers(60, 200, (74,) * 3,
                                                    dtype=np.uint8)
             for i in range(1)]
    src, _ = create_dataset_from_tensors(cubes, batch_size=1,
                                         custom_map=make_warp_map(1),
                                         device="cpu")
    tgt, _ = create_dataset_from_tensors(cubes, batch_size=1, device="cpu")
    return src, tgt


def test_train_is_the_step_loop(tmp_path):
    """2 epochs of EM2EM.train (1 batch each, warp + augmentation on) give a
    state bit-equal to create_state + make_train_step over the same batches
    with the same seed; a checkpoint per epoch; one metrics record per
    epoch with the mean loss of its steps."""
    model = _model(tmp_path, seed=4)
    log = tmp_path / "m.jsonl"
    model.train(*_datasets(), epochs=2, check_freq=1, metrics_log=str(log))

    cfg = CycleGANConfig(dimsize=74, wf=32)
    state = create_state(cfg, 4, device="cpu")
    step = make_train_step(cfg, device="cpu")
    src, tgt = _datasets()
    losses = [step(state, x, y, 4) for _ in range(2)
              for x, y in zip(src, tgt)]
    _assert_states_equal(model.state, state)
    assert state.step == 2
    recs = [json.loads(line) for line in open(log)]
    assert [r["epoch"] for r in recs] == [1, 2]
    assert [r["steps"] for r in recs] == [1, 1]
    np.testing.assert_array_equal(
        np.float32(list(recs[1]["loss"].values())), losses[1].numpy())
    assert model._ckpt.all_steps() == [1, 2]


def test_checkpoint_round_trip_and_restore_in_place(tmp_path):
    """make_checkpoint -> a new EM2EM of the same experiment auto-restores
    it bit-equal (parameters, Adam count / mu / nu, step); restore writes in
    place and moves every parameter's version counter (conv3's pack cache
    keys on it); restore(path) takes another experiment's step directory."""
    a = _model(tmp_path)
    _scramble(a.state, 1)
    a.make_checkpoint(1)
    a.wait_until_finished()
    b = _model(tmp_path)
    _assert_states_equal(a.state, b.state)

    c = _model(tmp_path, name="other")
    params = [p for t in TREES for p in getattr(c.state, t).parameters()]
    versions = [p._version for p in params]
    c.restore(os.path.join(a.checkpoint_path, "1"))
    _assert_states_equal(a.state, c.state)
    assert all(p._version > v for p, v in zip(params, versions))
    assert [p for t in TREES for p in getattr(c.state, t).parameters()] \
        == params  # the same tensors, written in place

    d = _model(tmp_path, name="third", ckpt_restore=os.path.join(
        a.checkpoint_path, "1"))
    _assert_states_equal(a.state, d.state)


def test_latest_step_ignores_partials_and_retention_keeps_50(tmp_path):
    """A crashed writer's temporary directory and a step directory without
    its state file are not steps; the latest committed step is restored.
    Saving 53 steps keeps the newest 50."""
    a = _model(tmp_path)
    _scramble(a.state, 2)
    a.make_checkpoint(3)
    a.wait_until_finished()
    root = a.checkpoint_path
    os.makedirs(os.path.join(root, ".tmp-9-dead"))
    with open(os.path.join(root, ".tmp-9-dead", "state.pt"), "wb") as f:
        f.write(b"\x80\x02truncated")
    os.makedirs(os.path.join(root, "8"))
    assert a._ckpt.latest_step() == 3
    _assert_states_equal(a.state, _model(tmp_path).state)

    mgr = CheckpointManager(str(tmp_path / "many"))
    for s in range(1, 54):
        mgr.save(s, {"step": s, "x": torch.full((2,), float(s))})
    mgr.wait_until_finished()
    assert mgr.all_steps() == list(range(4, 54))
    assert read_checkpoint(mgr.step_path(53))["step"] == 53


WORKER = r"""
import os, signal, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, {repo!r})
from transfer_em_tpu_torch.train import EM2EM

model = EM2EM(74, "crash", wf=32, checkpoint_root=sys.argv[1], seed=0,
              device="cpu")
rng = np.random.default_rng(5)
def batch():
    return [torch.from_numpy(rng.normal(0, 0.3, (1, 74, 74, 74, 1))
                             .astype(np.float32)) for _ in range(2)]
model.train_step(*batch())
model.make_checkpoint(1)
model.wait_until_finished()  # step 1 is committed
model.train_step(*batch())
model.make_checkpoint(2)     # written on the background thread ...
os.kill(os.getpid(), signal.SIGKILL)  # ... killed before it is drained
"""


def test_sigkill_right_after_make_checkpoint_then_resume(tmp_path):
    """A training process SIGKILLed right after make_checkpoint restarts
    onto its last committed step (1 or 2, whichever the writer committed),
    bit-equal to an uninterrupted control at that step; a continued step is
    bit-equal to the control's; a new save after the restart commits and
    becomes the latest."""
    root = tmp_path / "crashed"
    root.mkdir()
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER.format(repo=REPO))
    p = subprocess.run([sys.executable, str(worker), str(root)], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == -signal.SIGKILL, (p.returncode, p.stderr[-2000:])

    rng = np.random.default_rng(5)
    batches = [[torch.from_numpy(rng.normal(0, 0.3, (1, 74, 74, 74, 1))
                                 .astype(np.float32)) for _ in range(2)]
               for _ in range(3)]
    ctrl = EM2EM(74, "crash", wf=32, checkpoint_root=str(tmp_path / "ctrl"),
                 seed=0, device="cpu")
    ctrl.train_step(*batches[0])
    ctrl.make_checkpoint(1)
    ctrl.train_step(*batches[1])
    ctrl.make_checkpoint(2)
    ctrl.wait_until_finished()

    resumed = EM2EM(74, "crash", wf=32, checkpoint_root=str(root), seed=0,
                    device="cpu")
    latest = resumed._ckpt.latest_step()
    assert latest in (1, 2)
    ctrl_at = EM2EM(74, "crash", wf=32, seed=0, device="cpu",
                    checkpoint_root=str(tmp_path / "ctrl_at"),
                    ckpt_restore=os.path.join(ctrl.checkpoint_path,
                                              str(latest)))
    _assert_states_equal(resumed.state, ctrl_at.state)
    assert torch.equal(resumed.train_step(*batches[latest]),
                       ctrl_at.train_step(*batches[latest]))
    _assert_states_equal(resumed.state, ctrl_at.state)
    if latest == 1:  # the control carried on uninterrupted to step 2
        _assert_states_equal(resumed.state, ctrl.state)

    resumed.make_checkpoint(latest + 1)
    resumed.wait_until_finished()
    assert resumed._ckpt.latest_step() == latest + 1


def test_save_model_serves_what_predict_gives(tmp_path):
    """save_model (through its CLI) from a checkpoint -> load_generator
    reproduces EM2EM.predict exactly; meta.json holds the geometry and the
    meanstds."""
    from transfer_em_tpu_torch.cli.save_model import main

    a = _model(tmp_path)
    _scramble(a.state, 3)
    a.make_checkpoint(1)
    a.wait_until_finished()
    out = str(tmp_path / "export")
    assert main([out, os.path.join(a.checkpoint_path, "1"), "0.1", "0.9",
                 "-0.2", "0.7", "74", "1", "32", "--device=cpu"]) == 0
    gen, meta = load_generator(out, device="cpu")
    assert (meta.buffer, meta.outdimsize, meta.wf) == (17, 40, 32)
    assert meta.meanstd_x == (0.1, 0.9) and meta.meanstd_y == (-0.2, 0.7)
    x = torch.from_numpy(np.random.default_rng(6).normal(
        size=(1, 74, 74, 74, 1)).astype(np.float32))
    with torch.no_grad():
        assert torch.equal(gen(x), a.predict(x))
    assert main([out, "missing-args"]) == 1


@pytest.mark.parametrize("fmt", ["npz", "msgpack"])
@pytest.mark.parametrize("layer", ["down1", "mid"])
def test_create_prior_helper_matches_jax(tmp_path, fmt, layer):
    """A prior from the port's export (generator.npz) or the JAX package's
    (generator.msgpack) taps the same features as the JAX package's
    create_prior_helper on the same weights: 1e-5."""
    gen = JaxGenerator(wf=32)
    x = np.random.default_rng(7).normal(size=(1, 74, 74, 74, 1)).astype(
        np.float32)
    params = jax.tree.map(np.asarray, gen.init(jax.random.PRNGKey(3),
                                               jnp.asarray(x)))
    meta = ExportMeta(buffer=17, outdimsize=40, meanstd_x=(0.0, 1.0),
                      meanstd_y=(0.0, 1.0), wf=32)
    jdir = str(tmp_path / "jax")
    jax_export(params, meta, jdir)
    want = np.asarray(jax_prior(jdir, layer)(jnp.asarray(x)))
    src = jdir
    if fmt == "npz":
        from transfer_em_tpu_torch.models import UNetGenerator
        g = UNetGenerator(wf=32)
        g.load_state_dict(params_from_jax(params))
        src = str(tmp_path / "port")
        export_generator(g, meta, src)
        assert os.path.exists(os.path.join(src, "generator.npz"))
    prior = create_prior_helper(src, layer, device="cpu")
    with torch.no_grad():
        got = prior(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_metrics_records_match_jax(tmp_path):
    """MetricsLogger writes the JAX package's JSONL record; StepTimer's
    per-item EMA; profile_trace writes a Chrome trace (and is a no-op
    without a directory)."""
    loss = np.arange(7, dtype=np.float32) / 3
    for cls, name in ((MetricsLogger, "port"), (JaxMetricsLogger, "jax")):
        lg = cls(str(tmp_path / f"{name}.jsonl"))
        lg.log_epoch(3, loss, 1.5, 4)
        lg.close()
    port = (tmp_path / "port.jsonl").read_text()
    assert port == (tmp_path / "jax.jsonl").read_text()
    assert list(json.loads(port)["loss"]) == [
        "g_gen_total", "f_gen_total", "disc_y", "disc_x", "g_gen_only",
        "f_gen_only", "cycle"]

    t = StepTimer()
    t.start()
    t.stop(items=4)
    assert t.count == 4 and t.items_per_sec > 0

    with profile_trace(None):
        pass
    with profile_trace(str(tmp_path / "prof")):
        torch.ones(8).sum()
    trace = json.loads((tmp_path / "prof" / "trace.json").read_text())
    assert trace["traceEvents"]


LATER = {
    # entry points of later slices, ported since, default to cuda and raise
    # here before doing anything: to_mesh (A4) builds make_mesh() over the
    # local cards (tests/test_torch_parallel.py runs it on a CPU mesh), the
    # TF interop (A3) reads on cuda (tests/test_torch_compat.py runs it on
    # the CPU)
    "to_mesh": (lambda m: m.to_mesh(), RuntimeError,
                "torch.cuda.is_available"),
    "from_reference_checkpoint": (
        lambda m: EM2EM.from_reference_checkpoint("ckpt", "x"),
        RuntimeError, "torch.cuda.is_available"),
    "keras_prior": (lambda m: create_prior_helper("prior.h5", "down1"),
                    RuntimeError, "torch.cuda.is_available"),
}


@pytest.mark.parametrize("case", list(LATER))
def test_later_slices_raise(tmp_path, case):
    call, error, match = LATER[case]
    m = _model(tmp_path)
    with pytest.raises(error, match=match):
        call(m)


PORTED = {
    # A1.6 and A1.5, which raised in earlier slices of the port
    "2D": dict(is3d=False, compute_dtype="bfloat16"),
    "bf16": dict(compute_dtype="bfloat16"),
    "remat": dict(remat=True),
    "ensemble_apps": dict(ensemble_apps=True),
}


@pytest.mark.parametrize("case", list(PORTED))
def test_ported_options_train(tmp_path, case):
    """bf16 (3D and 2D), remat and ensemble_apps: EM2EM builds, a step
    updates all four networks with finite losses, and predict gives float32
    at the generator's output size."""
    kw = PORTED[case]
    m = _model(tmp_path, **kw)
    is3d = kw.get("is3d", True)
    shape = (1,) + (74,) * (3 if is3d else 2) + (1,)
    x = torch.from_numpy((0.3 * np.random.default_rng(9).normal(
        size=shape)).astype(np.float32))
    before = [p.detach().clone() for p in m.state.dx.parameters()]
    loss = m.train_step(x, x)
    assert torch.isfinite(loss).all() and m.state.step == 1
    assert any(not torch.equal(a, b)
               for a, b in zip(before, m.state.dx.parameters()))
    out = m.predict(x)
    assert out.dtype == torch.float32
    assert out.shape[1:-1] == (40,) * (3 if is3d else 2)


def test_later_methods_raise_plots_and_sample(tmp_path, monkeypatch,
                                              capsys):
    """to_mesh and from_reference_checkpoint default to cuda and raise
    here; plot_* write a table of the parameters; the bound networks run
    the live parameters without gradients; with debug and a sample, an
    epoch ends with the sample's accuracy and <exp_name>_sample.png."""
    monkeypatch.chdir(tmp_path)
    m = _model(tmp_path)
    x = torch.from_numpy(np.random.default_rng(8).normal(
        0, 0.3, (1, 74, 74, 74, 1)).astype(np.float32))
    m.train([], [], epochs=1, debug=True, sample=x, sample_gt=x)
    assert "Accuracy on sample: " in capsys.readouterr().out
    assert (tmp_path / "exp_sample.png").exists()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        m.to_mesh()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        EM2EM.from_reference_checkpoint("ckpt", "x")
    m.plot_generator(str(tmp_path / "g.txt"))
    m.plot_discriminator(str(tmp_path / "d.txt"))
    g = (tmp_path / "g.txt").read_text()
    assert "stem.kernel" in g and "(3, 3, 3, 1, 2)" in g
    assert "down1.conv.kernel" in (tmp_path / "d.txt").read_text()
    y = m.discriminator_x(torch.zeros(1, 40, 40, 40, 1))
    assert not y.requires_grad
    assert m.generator_f.params.keys() == m.generator_g.params.keys()
