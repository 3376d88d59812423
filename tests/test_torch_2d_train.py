"""The port's 2D CycleGAN on the CPU against the JAX package: the 2D warp,
augment and pipelines, the 2D train step (losses and every gradient),
EM2EM(is3d=False) (train, checkpoints, restore, predict, crash-resume), the
2D export in both formats, the fused tile step on 2D tiles, and the 3D
tile-grid entry points refusing a 2D generator.  wf=32, 74^2 (the JAX
package's tests/test_train.py, test_e2e.py and test_crash_resume.py);
inputs from numpy seeds; each test states its tolerance.  Bit-equal means
exactly equal float32 values."""

import itertools
import os
import signal
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transfer_em_tpu.config import CycleGANConfig as JaxConfig
from transfer_em_tpu.config import ExportMeta as JaxMeta
from transfer_em_tpu.data import create_dataset_from_tensors as jax_tensor_ds
from transfer_em_tpu.debug import accuracy as jax_accuracy
from transfer_em_tpu.infer.export import export_generator as jax_export
from transfer_em_tpu.infer.export import load_generator as jax_load
from transfer_em_tpu.infer.tiling import make_tile_step as jax_tile_step
from transfer_em_tpu.ops import normalize as jnorm
from transfer_em_tpu.ops import warp as jwarp
from transfer_em_tpu.ops.convs import conv_nd as jax_conv_nd
from transfer_em_tpu.train import create_state as jax_create_state
from transfer_em_tpu.train.cgan import build_models as jax_build_models
from transfer_em_tpu.train.cgan import build_step_fn as jax_build_step_fn
from transfer_em_tpu.train.cgan import create_prior_helper as jax_prior
from transfer_em_tpu.train.cgan import cyclegan_losses as jax_losses
from transfer_em_tpu_torch.config import CycleGANConfig, ExportMeta
from transfer_em_tpu_torch.data import create_dataset_from_tensors
from transfer_em_tpu_torch.debug import accuracy, generate_images
from transfer_em_tpu_torch.infer import (device_predict_tiled,
                                         export_generator, load_generator,
                                         make_tile_step, plan_tiles,
                                         predict_tiled, predict_volume,
                                         predict_volume_streaming, save_model,
                                         slab_predict)
from transfer_em_tpu_torch.models import UNetGenerator
from transfer_em_tpu_torch.models.convert import (TREES, load_jax_state,
                                                  params_from_jax,
                                                  params_to_jax)
from transfer_em_tpu_torch.ops import normalize
from transfer_em_tpu_torch.ops.augment import apply_augment
from transfer_em_tpu_torch.ops.convs import conv_nd
from transfer_em_tpu_torch.ops.warp import (_box_filter, make_warp_map,
                                            warp_with_mask)
from transfer_em_tpu_torch.shapes import generator_shapes
from transfer_em_tpu_torch.train import (EM2EM, build_step_fn,
                                         create_prior_helper, create_state,
                                         cyclegan_losses, make_train_step)

torch.set_num_threads(1)
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUFFER = generator_shapes(74).buffer
JAX_CFG = JaxConfig(dimsize=74, is3d=False, wf=32)
CFG = CycleGANConfig(dimsize=74, is3d=False, wf=32)


def _u8(seed, shape, lo=0, hi=256):
    return np.random.default_rng(seed).integers(lo, hi, shape, dtype=np.uint8)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def make_patches(seed, n, size=74):
    """Smoothed uint8 2D patches (tests/test_e2e.py's make_patches)."""
    rng = np.random.default_rng(seed)
    xs = []
    for _ in range(n):
        v = rng.normal(size=(size + 8, size + 8)).astype(np.float32)
        c = np.cumsum(np.cumsum(v, 0), 1)
        s = (c[8:, 8:] - c[:-8, 8:] - c[8:, :-8] + c[:-8, :-8])[:size, :size]
        s = (s - s.min()) / max(float(np.ptp(s)), 1e-6)
        xs.append((s * 255).astype(np.uint8))
    return xs


# -- warp, augment, pipelines -----------------------------------------------------

def test_warp_2d_matches_jax():
    """Given the same hole mask, the 2D warp (3^2 blur, 4^2 dilation, fill
    with the blurred mean) against the JAX package's conv_nd SAME and
    _box_filter in 2D (ops/warp.py:45-59): the dilated mask exactly, the
    warp to 1e-6; holes at the low and high faces pin the even kernel's
    (1, 2) SAME padding."""
    x = (_u8(20, (15, 16)).astype(np.float32) / 127.5 - 1)[..., None]
    mask = np.zeros((15, 16, 1), np.float32)
    for y, w in [(0, 0), (14, 15), (0, 15), (7, 3)]:
        mask[y, w] = 1.0
    jx, jm = jnp.asarray(x)[None], jnp.asarray(mask)[None]
    jxb = jax_conv_nd(jx, jwarp._box_filter(2, 3, True), padding="SAME")
    jholes = jax_conv_nd(jm, jwarp._box_filter(2, 4, False), padding="SAME")
    want = jnp.where(jholes > 0, jnp.mean(jxb), jxb)[0]

    holes = conv_nd(_t(mask)[None], _box_filter(4, False, "cpu", 2),
                    padding="SAME")[0]
    np.testing.assert_array_equal(holes.numpy(), np.asarray(jholes[0]))
    got = warp_with_mask(_t(x)[None], _t(mask)[None])[0]
    assert got.shape == (15, 16, 1)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    assert holes[1, 1, 0] > 0 and holes[2, 0, 0] == 0  # lo pad 1, hi pad 2
    # make_warp_map takes a 2D (H, W, 1) element
    el = _t(x)
    assert make_warp_map(1)(el, 3).shape == el.shape


PERMS_2D = list(itertools.permutations(range(2)))
FLIPS_2D = list(itertools.product([False, True], repeat=2))


@pytest.mark.parametrize("flips", FLIPS_2D, ids=lambda f: "".join(
    "f" if v else "-" for v in f))
@pytest.mark.parametrize("perm", range(2), ids=lambda i: str(PERMS_2D[i]))
def test_augment_2d_matches_jax_composition(perm, flips):
    """2D: 2 permutations x 4 flip patterns with a jitter, against
    jnp.transpose, jnp.flip of the transposed axes, x * v + m
    (transfer_em_tpu/ops/augment.py:36-47): exact."""
    x = np.random.default_rng(30).normal(size=(5, 6, 1)).astype(np.float32)
    v, m = np.float32(1.0312), np.float32(-0.0271)
    want = jnp.transpose(jnp.asarray(x), PERMS_2D[perm] + (2,))
    for d in range(2):
        if flips[d]:
            want = jnp.flip(want, axis=d)
    want = want * v + m
    got = apply_augment(_t(x), (perm, flips, float(m), float(v)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_2d_tensor_dataset_matches_jax():
    """2D patches, no custom map, no augmentation: meanstd to 5e-5
    relative of the JAX pipeline's and the batches to 1e-6 after
    restandardizing JAX's with the port's meanstd (as in
    tests/test_torch_data.py)."""
    patches = [_u8(40 + i, (20, 20), 30, 220) for i in range(5)]
    jds, jms = jax_tensor_ds(patches, batch_size=2,
                             enable_augmentation=False)
    ds, ms = create_dataset_from_tensors(patches, batch_size=2,
                                         enable_augmentation=False,
                                         device="cpu")
    np.testing.assert_allclose(ms, jms, rtol=5e-5)
    want = [((np.asarray(b) * jms[1] + jms[0]) - ms[0]) / ms[1] for b in jds]
    got = [b.numpy() for b in ds]
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.shape == w.shape == (2, 20, 20, 1)
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6)


def test_2d_dataset_with_warp_and_augment():
    """custom_map=make_warp_map on 2D patches, augmentation on: meanstd is
    the JAX package's get_meanstd over the port's own mapped elements (to
    5e-5 relative), and every augmented element is one of the 8 2D
    transposes / flips of the unaugmented one, times v in [1, 1.05], plus m
    in [-0.05, 0.05] (fitted, residual 1e-5)."""
    patches = [_u8(50 + i, (20, 20), 30, 220) for i in range(4)]
    warp_map = make_warp_map(3)
    mapped = []

    def recording(el, key):
        out = warp_map(el, key)
        mapped.append(out.numpy().copy())
        return out

    kw = dict(batch_size=2, custom_map=recording, seed=5, device="cpu")
    plain, ms = create_dataset_from_tensors(patches,
                                            enable_augmentation=False, **kw)
    assert len(mapped) == 4  # the statistics pass maps each element once
    want = jnorm.get_meanstd(jnp.asarray(m) for m in mapped)
    np.testing.assert_allclose(ms, want, rtol=5e-5)
    aug, ms2 = create_dataset_from_tensors(patches, enable_augmentation=True,
                                           **kw)
    assert ms2 == ms
    for a, p in zip(aug, plain):
        assert a.shape == p.shape == (2, 20, 20, 1)
        for ai, pi in zip(a.numpy(), p.numpy()):
            fits = []
            for perm, flips in itertools.product(PERMS_2D, FLIPS_2D):
                t = np.transpose(pi, perm + (2,))
                t = np.flip(t, [d for d in range(2) if flips[d]]).ravel()
                v, m = np.polyfit(t, ai.ravel(), 1)
                res = np.abs(v * t + m - ai.ravel()).max()
                fits.append((res, v, m))
            res, v, m = min(fits)
            assert res < 1e-5 and 1 <= v <= 1.05 + 1e-6
            assert -0.05 - 1e-6 <= m <= 0.05 + 1e-6


# -- the train step ---------------------------------------------------------------

def redrawn(jstate, seed):
    """jstate with every network's parameters redrawn from a numpy seed:
    kernels with std 1/sqrt(fan-in), 1-D params N(0, 0.1), so every
    network's outputs and gradients are O(1)."""
    rng = np.random.default_rng(seed)

    def draw(a):
        std = 0.1 if a.ndim == 1 else float(np.prod(a.shape[:-1])) ** -0.5
        return jnp.asarray(rng.normal(0, std, a.shape).astype(np.float32))

    return jstate.replace(**{t: jax.tree.map(draw, getattr(jstate, t))
                             for t in TREES})


def batches(seed, n):
    """Two (n, 74, 74, 1) image batches, N(0, 0.3^2): |real - cycled|
    stays far below 2, where the focal CE's clip makes the gradient jump
    (tests/test_torch_train_step.py)."""
    rng = np.random.default_rng(seed)
    return [(0.3 * rng.normal(size=(n, 74, 74, 1))).astype(np.float32)
            for _ in range(2)]


@pytest.fixture(scope="module")
def setup():
    jstate = redrawn(jax_create_state(JAX_CFG, jax.random.PRNGKey(0)), 1)
    x, y = batches(42, 2)
    return jstate, jax.tree.map(np.asarray, jstate), x, y


def port_state(jstate_np):
    state = create_state(CFG, 0, device="cpu")
    load_jax_state(state, jstate_np)
    return state


def test_2d_state_matches_jax_tree(setup):
    """create_state(is3d=False) builds the JAX 2D trees key for key (no
    down1 in either discriminator), and state_to_jax is the inverse."""
    from transfer_em_tpu_torch.models.convert import state_to_jax

    _, jnp_state, _, _ = setup
    state = port_state(jnp_state)
    for t in TREES:
        want = params_from_jax(getattr(jnp_state, t))
        got = dict(getattr(state, t).named_parameters())
        assert set(got) == set(want), t
        assert all(torch.equal(got[k], want[k]) for k in want)
    assert not any(k.startswith("down1") for k in want)
    back = state_to_jax(state)
    np.testing.assert_array_equal(
        back["dy"]["params"]["hack"]["kernel"],
        np.asarray(jnp_state.dy["params"]["hack"]["kernel"]))


def test_2d_losses_and_gradients_match_jax(setup):
    """wf=32, 74^2, B=2, dropout off: the 7-loss vector rtol 1e-4, each
    network's gradients within 1e-3 of its largest |g|."""
    jstate, jnp_state, x, y = setup
    gen, disc_x, disc_y = jax_build_models(JAX_CFG)
    jgrads, jvec = jax.jit(jax.grad(
        lambda gg, gf, dx, dy: jax_losses(
            gen, disc_x, disc_y, BUFFER, 2.0, gg, gf, dx, dy, jnp.asarray(x),
            jnp.asarray(y), jax.random.PRNGKey(0), deterministic=True),
        argnums=(0, 1, 2, 3), has_aux=True))(
            jstate.gg, jstate.gf, jstate.dx, jstate.dy)

    state = port_state(jnp_state)
    nets = [getattr(state, t) for t in TREES]
    combined, vec = cyclegan_losses(*nets, BUFFER, 2.0, _t(x), _t(y),
                                    deterministic=True)
    combined.backward()
    np.testing.assert_allclose(vec.numpy(), np.asarray(jvec), rtol=1e-4)
    for t, net, jg in zip(TREES, nets, jgrads):
        want = {k: v.numpy() for k, v in params_from_jax(
            jax.tree.map(np.asarray, jg)).items()}
        got = {k: p.grad.numpy() for k, p in net.named_parameters()}
        assert set(got) == set(want), t
        scale = max(float(np.abs(w).max()) for w in want.values())
        assert scale > 0, t
        for k in want:
            err = float(np.abs(got[k] - want[k]).max())
            assert err <= 1e-3 * scale, (t, k, err, scale)


def test_2d_two_steps_match_jax(setup):
    """Step 1's and step 2's loss vectors (after one Keras-Adam update of
    all four networks) against JAX's: rtol 1e-4."""
    jstate, jnp_state, x, y = setup
    jstep = jax.jit(jax_build_step_fn(JAX_CFG, deterministic=True))
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    js1, jl1 = jstep(jstate, jx, jy, jax.random.PRNGKey(0))
    _, jl2 = jstep(js1, jx, jy, jax.random.PRNGKey(0))

    state = port_state(jnp_state)
    step = build_step_fn(CFG, deterministic=True)
    l1 = step(state, _t(x), _t(y), 0)
    l2 = step(state, _t(x), _t(y), 0)
    assert state.step == 2
    np.testing.assert_allclose(l1.numpy(), np.asarray(jl1), rtol=1e-4)
    np.testing.assert_allclose(l2.numpy(), np.asarray(jl2), rtol=1e-4)


# -- EM2EM(is3d=False) ------------------------------------------------------------

def _model(root, name="e2e2d", **kw):
    return EM2EM(74, name, is3d=False, wf=32, checkpoint_root=str(root),
                 device="cpu", **kw)


def _tensors(state):
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
    assert ia == ib and len(ta) == len(tb)
    for x, y in zip(ta, tb):
        assert torch.equal(x, y)


def _datasets(seed=0):
    """tests/test_e2e.py's fixture: 4 patches, batch 2, the source warped."""
    patches = make_patches(seed, 4)
    tgt, ms_y = create_dataset_from_tensors(
        patches, batch_size=2, enable_augmentation=False, device="cpu")
    src, ms_x = create_dataset_from_tensors(
        patches, batch_size=2, custom_map=make_warp_map(1),
        enable_augmentation=False, device="cpu")
    return src, tgt, ms_x, ms_y


def test_em2em_2d_train_checkpoint_restore_predict(tmp_path, monkeypatch,
                                                   capsys):
    """One epoch of EM2EM(74, is3d=False, wf=32) (2 steps) is the step loop
    bit for bit; its checkpoint auto-restores bit-equal into a model of
    another init seed, which predicts what the trained one does and trains
    on; restore(path) from another experiment; predict / predict_f give
    (2, 40, 40, 1); the bound networks, plots and the debug sample run in
    2D."""
    monkeypatch.chdir(tmp_path)
    src, tgt, _, _ = _datasets()
    model = _model(tmp_path, seed=4)
    model.train(src, tgt, epochs=1, check_freq=1)
    assert model.state.step == 2 and model._ckpt.all_steps() == [1]

    state = create_state(CFG, 4, device="cpu")
    step = make_train_step(CFG, device="cpu")
    for x, y in zip(src, tgt):
        step(state, x, y, 4)
    _assert_states_equal(model.state, state)

    restored = _model(tmp_path, seed=123)
    _assert_states_equal(model.state, restored.state)
    batch = next(iter(src))
    pred = model.predict(batch)
    assert pred.shape == (2, 40, 40, 1) and not pred.requires_grad
    assert torch.equal(restored.predict(batch), pred)
    assert model.predict_f(batch).shape == (2, 40, 40, 1)
    assert model.discriminator_y(pred).shape == (2, 6, 6, 1)
    restored.train_step(batch, batch)
    assert restored.state.step == 3

    other = _model(tmp_path / "ck2", name="other", ckpt_restore=os.path.join(
        model.checkpoint_path, "1"))
    _assert_states_equal(model.state, other.state)

    gt = batch[:, BUFFER:-BUFFER, BUFFER:-BUFFER]
    err = accuracy(gt[0], pred[0])
    assert err == pytest.approx(jax_accuracy(gt[0].numpy(), pred[0].numpy()),
                                rel=1e-5)
    model.train([], [], epochs=1, start=1, debug=True, sample=batch,
                sample_gt=batch)
    assert "Accuracy on sample: " in capsys.readouterr().out
    assert (tmp_path / "e2e2d_sample.png").exists()
    generate_images(batch, pred, show=False,
                    save_path=str(tmp_path / "g.png"))
    assert (tmp_path / "g.png").exists()
    model.plot_discriminator(str(tmp_path / "d.txt"))
    table = (tmp_path / "d.txt").read_text()
    assert "hack.kernel" in table and "(3, 3, 1, 16)" in table
    assert "down1" not in table


WORKER = r"""
import os, signal, sys
import numpy as np
import torch
torch.set_num_threads(1)
sys.path.insert(0, {repo!r})
from transfer_em_tpu_torch.train import EM2EM

model = EM2EM(74, "crash", is3d=False, wf=32, checkpoint_root=sys.argv[1],
              seed=0, device="cpu")
rng = np.random.default_rng(5)
def batch():
    return [torch.from_numpy(rng.normal(0, 0.3, (2, 74, 74, 1))
                             .astype(np.float32)) for _ in range(2)]
model.train_step(*batch())
model.make_checkpoint(1)
model.wait_until_finished()  # step 1 is committed
model.train_step(*batch())
model.make_checkpoint(2)     # written on the background thread ...
os.kill(os.getpid(), signal.SIGKILL)  # ... killed before it is drained
"""


def test_2d_sigkill_right_after_make_checkpoint_then_resume(tmp_path):
    """A 2D training process SIGKILLed right after make_checkpoint restarts
    onto its last committed step (1 or 2), bit-equal to an uninterrupted
    control at that step, and a continued step is bit-equal to the
    control's (tests/test_crash_resume.py's shapes: B=2, 74^2, wf=32)."""
    root = tmp_path / "crashed"
    root.mkdir()
    worker = tmp_path / "worker.py"
    worker.write_text(WORKER.format(repo=REPO))
    p = subprocess.run([sys.executable, str(worker), str(root)], cwd=REPO,
                       capture_output=True, text=True, timeout=600)
    assert p.returncode == -signal.SIGKILL, (p.returncode, p.stderr[-2000:])

    rng = np.random.default_rng(5)
    bats = [[_t(rng.normal(0, 0.3, (2, 74, 74, 1)).astype(np.float32))
             for _ in range(2)] for _ in range(3)]
    ctrl = _model(tmp_path / "ctrl", name="crash", seed=0)
    ctrl.train_step(*bats[0])
    ctrl.make_checkpoint(1)
    ctrl.train_step(*bats[1])
    ctrl.make_checkpoint(2)
    ctrl.wait_until_finished()

    resumed = _model(root, name="crash", seed=0)
    latest = resumed._ckpt.latest_step()
    assert latest in (1, 2)
    ctrl_at = _model(tmp_path / "ctrl_at", name="crash", seed=0,
                     ckpt_restore=os.path.join(ctrl.checkpoint_path,
                                               str(latest)))
    _assert_states_equal(resumed.state, ctrl_at.state)
    assert torch.equal(resumed.train_step(*bats[latest]),
                       ctrl_at.train_step(*bats[latest]))
    _assert_states_equal(resumed.state, ctrl_at.state)


# -- export, load and the fused tile step on 2D tiles -------------------------------

def _trained_export(tmp_path, fmt):
    """A scrambled 2D train state checkpointed, exported by save_model (npz
    through the CLI with is3d 0, or msgpack) -> (model, export dir)."""
    model = _model(tmp_path, name="exp")
    rng = np.random.default_rng(3)
    with torch.no_grad():
        for p in model.state.gg.parameters():
            p.copy_(_t(rng.normal(0, float(np.prod(p.shape[:-1])) ** -0.5,
                                  tuple(p.shape)).astype(np.float32)))
    model.make_checkpoint(1)
    model.wait_until_finished()
    out = str(tmp_path / f"export_{fmt}")
    ckpt = os.path.join(model.checkpoint_path, "1")
    if fmt == "npz":
        from transfer_em_tpu_torch.cli.save_model import main
        assert main([out, ckpt, "0.1", "0.9", "-0.2", "0.7", "74", "0", "32",
                     "--device=cpu"]) == 0
    else:
        save_model(out, ckpt, (0.1, 0.9), (-0.2, 0.7), 74, is3d=False, wf=32,
                   device="cpu", fmt="msgpack")
    return model, out


@pytest.mark.parametrize("fmt", ["npz", "msgpack"])
def test_2d_export_load_and_tile_step_match_jax(tmp_path, fmt):
    """save_model(is3d=False) -> load_generator gives a 2D generator that
    predicts what EM2EM.predict does (bit-equal); the msgpack export loads
    in the JAX package too.  The port's make_tile_step on (B, 74, 74) uint8
    tiles with tpad 2 -> (B, 36, 36), within one grey level of JAX's
    make_tile_step on the same weights, on at most 1e-3 of the pixels."""
    model, out = _trained_export(tmp_path, fmt)
    assert os.path.exists(os.path.join(out, f"generator.{fmt}"))
    gen, meta = load_generator(out, device="cpu")
    assert not gen.is3d and not meta.is3d
    assert (meta.buffer, meta.outdimsize, meta.wf) == (17, 40, 32)
    assert meta.meanstd_x == (0.1, 0.9) and meta.meanstd_y == (-0.2, 0.7)
    x = _t(np.random.default_rng(6).normal(size=(1, 74, 74, 1))
           .astype(np.float32))
    with torch.no_grad():
        assert torch.equal(gen(x), model.predict(x))

    if fmt == "msgpack":
        jgen, jparams, _ = jax_load(out)
    else:  # the same weights through the JAX package's own export
        jparams = jax.tree.map(jnp.asarray,
                               params_to_jax(gen.state_dict()))
        jdir = str(tmp_path / "jax_export")
        jax_export(jparams, JaxMeta(**meta.__dict__), jdir)
        jgen, jparams, _ = jax_load(jdir)
        gen2, _ = load_generator(jdir, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(
            gen2.state_dict().values(), gen.state_dict().values()))
    tiles = _u8(7, (4, 74, 74), 20, 236)
    got = make_tile_step(gen, meta.meanstd_x, meta.meanstd_y, 2,
                         device="cpu")(tiles)
    want = np.asarray(jax_tile_step(jgen.apply, jparams, meta.meanstd_x,
                                    meta.meanstd_y, 2)(jnp.asarray(tiles)))
    assert got.shape == want.shape == (4, 36, 36) and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1 and (diff > 0).mean() <= 1e-3
    assert got.std() > 5  # the weights give a spread of grey levels


def test_2d_tiled_stitching_matches_whole(tmp_path):
    """A 72^2 region predicted in four 74^2 -> 36^2 tiles (tpad 2 trimmed
    by the tile step) equals one whole-image forward over the region and
    its halo, trimmed by tpad: exactly (JAX tests/test_tiling.py:69-110)."""
    gen = UNetGenerator(wf=32, is3d=False)
    rng = np.random.default_rng(1)
    with torch.no_grad():
        for p in gen.parameters():
            p.copy_(_t(rng.normal(0, float(np.prod(p.shape[:-1])) ** -0.5,
                                  tuple(p.shape)).astype(np.float32)))
    gen.eval()
    shp = generator_shapes(74)
    big = rng.integers(0, 255, size=(256, 256), dtype=np.uint8)
    meanstd = (0.05, 0.8)
    plan = plan_tiles((64, 64, 0), (72, 72, 1), shp.out, shp.buffer)
    assert plan.outdimsize == 36 and plan.insize == 74
    step = make_tile_step(gen, meanstd, meanstd, plan.tpad, device="cpu")
    out_tiled = np.zeros((72, 72), np.uint8)
    for (cx, cy, cz), (ix, iy, _) in zip(plan.corners, plan.indices):
        if cz != -plan.buffer:  # one z layer in 2D
            continue
        out_tiled[iy:iy + 36, ix:ix + 36] = step(
            big[None, cy:cy + 74, cx:cx + 74])[0]
    b, t = plan.buffer, plan.tpad
    whole_in = big[64 - b:64 + 72 + b, 64 - b:64 + 72 + b]
    whole = step(whole_in[None])[0]
    assert whole.shape == (72, 72)
    np.testing.assert_array_equal(out_tiled, whole)
    with torch.no_grad():
        y = gen(normalize.preprocess_u8(_t(whole_in[None]), meanstd))
    assert y.shape == (1, 72 + 2 * t, 72 + 2 * t, 1)


def test_2d_prior_matches_jax(tmp_path):
    """create_prior_helper on a 2D export (the port's npz) taps the same
    features as the JAX package's on the same weights (its msgpack): 1e-5;
    a 2D discriminator takes it on down2's 17^2 grid."""
    from transfer_em_tpu.models.generator import UNetGenerator as JaxUNet
    from transfer_em_tpu_torch.models import Discriminator

    x = np.random.default_rng(8).normal(size=(2, 40, 40, 1)).astype(
        np.float32)
    params = jax.tree.map(np.asarray, JaxUNet(wf=32).init(
        jax.random.PRNGKey(3), jnp.asarray(x)))
    meta = ExportMeta(buffer=17, outdimsize=40, meanstd_x=(0.0, 1.0),
                      meanstd_y=(0.0, 1.0), is3d=False, wf=32)
    jdir = str(tmp_path / "jax")
    jax_export(params, JaxMeta(**meta.__dict__), jdir)
    want = np.asarray(jax_prior(jdir, "down1")(jnp.asarray(x)))
    g = UNetGenerator(wf=32, is3d=False)
    g.load_state_dict(params_from_jax(params))
    export_generator(g, meta, str(tmp_path / "port"))
    prior = create_prior_helper(str(tmp_path / "port"), "down1",
                                device="cpu")
    with torch.no_grad():
        got = prior(_t(x)).numpy()
    assert got.shape == want.shape == (2, 17, 17, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    disc = Discriminator(wf=32, is3d=False, disc_prior=prior,
                         prior_channels=prior.channels)
    with torch.no_grad():
        assert disc(_t(x)).shape == (2, 6, 6, 1)


# -- the 3D tile grid refuses a 2D generator ------------------------------------------

def test_tile_grid_entry_points_reject_a_2d_generator(tmp_path):
    """predict_tiled, device_predict_tiled, slab_predict,
    predict_volume_streaming, predict_volume (every mode) and ModelService
    (its model cache) raise ValueError on a 2D generator: the JAX
    package's plan_tiles is 3D."""
    from transfer_em_tpu_torch.serve import ModelService

    gen = UNetGenerator(wf=32, is3d=False)
    vol = np.zeros((80, 80, 80), np.uint8)
    region = ((0, 0, 0), (36, 36, 36))
    calls = {
        "predict_tiled": lambda: predict_tiled(
            lambda c, s: np.zeros((s,) * 3, np.uint8), gen, *region, 40, 17,
            None, None, device="cpu"),
        "device_predict_tiled": lambda: device_predict_tiled(
            vol, gen, *region, 40, 17, None, None, device="cpu"),
        "slab_predict": lambda: slab_predict(vol, gen, *region, None, None,
                                             device="cpu"),
        "predict_volume_streaming": lambda: predict_volume_streaming(
            vol, gen, *region, None, None, device="cpu"),
    }
    calls.update({f"predict_volume[{m}]": (
        lambda m=m: predict_volume(vol, gen, *region, None, None, mode=m,
                                   device="cpu"))
        for m in ("device", "slab", "stream", "tiles", "auto")})
    for name, call in calls.items():
        with pytest.raises(ValueError, match="2D generator"):
            call()
    meta = ExportMeta(buffer=17, outdimsize=40, meanstd_x=(0.0, 1.0),
                      meanstd_y=(0.0, 1.0), is3d=False, wf=32)
    export_generator(gen, meta, str(tmp_path / "m2d"))
    svc = ModelService(model_root=str(tmp_path), device="cpu")
    try:
        with pytest.raises(ValueError, match="2D generator"):
            svc.cache.get("m2d")
    finally:
        svc.stop()
