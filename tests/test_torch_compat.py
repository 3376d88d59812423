"""The port's TF/Keras interop (``transfer_em_tpu_torch.compat``) against
the JAX package's ``compat`` on the CPU.

The reference tree is not installed here, so the test makes the assets a
reference user owns: Keras generators in the reference's build order
(``compat.keras_generator``, which ``export_tf_savedmodel`` also builds)
and Keras discriminators (built below, the reference's layers in its
order), saved as ``.h5`` files and exported SavedModels, and reference
``tf.train.Checkpoint``s of the four networks and their four Keras Adams
after one ``apply_gradients``, in the Keras 3 layout and (written with
``tf.raw_ops.SaveV2`` as tests/test_tf_parity.py does) the Keras-2-era one.
The JAX package's ``compat`` reading the same asset is the judge: a wrong
build order fails its shape checks.  Weights are drawn from numpy seeds
with std 1/sqrt(fan-in).  Bit-equal means exactly equal float32 values;
forwards are held within 1e-5 (the same weights through two conv
implementations)."""

import importlib.util
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transfer_em_tpu import compat as jcompat
from transfer_em_tpu.infer.export import load_generator as jax_load
from transfer_em_tpu.train import EM2EM as JaxEM2EM
from transfer_em_tpu.train.cgan import build_step_fn as jax_step_fn
from transfer_em_tpu.train.cgan import create_prior_helper as jax_prior_helper
from transfer_em_tpu_torch import compat
from transfer_em_tpu_torch.cli import save_model as save_model_cli
from transfer_em_tpu_torch.config import ExportMeta
from transfer_em_tpu_torch.infer import export_generator, load_generator
from transfer_em_tpu_torch.models.convert import (TREES, params_to_jax,
                                                  state_to_jax)
from transfer_em_tpu_torch.train import (EM2EM, build_step_fn,
                                         create_prior_helper)

pytestmark = pytest.mark.skipif(
    importlib.util.find_spec("tensorflow") is None,
    reason="TensorFlow is not installed")
torch.set_num_threads(1)
FWD_TOL = 1e-5
# TensorFlow and its Keras layers, imported when the first test here runs,
# not when the file is collected (every xdist worker collects every file)
tf = L = None


@pytest.fixture(scope="module", autouse=True)
def tensorflow():
    global tf, L
    import tensorflow
    tf, L = tensorflow, tensorflow.keras.layers


def _draw(model, seed):
    """Every weight of ``model`` from a numpy seed: kernels N(0, 1/fan-in),
    biases N(0, 0.1^2)."""
    rng = np.random.default_rng(seed)
    for layer in model.layers:
        ws = layer.get_weights()
        if ws:
            layer.set_weights([rng.normal(
                0, 0.1 if w.ndim == 1 else float(np.prod(w.shape[:-1])) ** -0.5,
                w.shape).astype(np.float32) for w in ws])
    return model


def keras_generator(wf, is3d, seed):
    model, _ = compat.keras_generator(wf, is3d, 74)
    return _draw(model, seed)


def _act(x):
    return L.LeakyReLU(negative_slope=0.3)(x)


def keras_discriminator(wf, is3d, seed, prior=None):
    """The reference discriminator (models/discriminator.py:14-106): 3D
    down1 -> hack -> down2 -> [concat prior] -> down3 -> LeakyReLU again ->
    1x1 head -> 1x1 out with the only bias; 2D has no down1 (the HACK
    path)."""
    n = 3 if is3d else 2
    conv = L.Conv3D if is3d else L.Conv2D
    c1, c4 = 64 // wf, 256 // wf
    inp = tf.keras.Input((40,) * n + (1,))

    def down(x, f):
        x = _act(conv(f, 3, use_bias=False)(x))
        return _act(conv(f, 4, strides=2, use_bias=False)(x))

    x = down(inp, c1) if is3d else inp
    x = _act(conv(16, 3, use_bias=False)(x))
    x = down(x, c4)
    if prior is not None:
        x = L.Concatenate()([x, prior(inp)])
    x = _act(down(x, 32))
    x = _act(conv(c4, 1, use_bias=False)(x))
    model = tf.keras.Model(inp, conv(1, 1)(x))
    if prior is not None:
        rng = np.random.default_rng(seed)
        for layer in model.layers:  # the frozen prior keeps its weights
            ws = layer.get_weights()
            if ws and not isinstance(layer, tf.keras.Model):
                layer.set_weights([rng.normal(
                    0, 0.1 if w.ndim == 1
                    else float(np.prod(w.shape[:-1])) ** -0.5,
                    w.shape).astype(np.float32) for w in ws])
        return model
    return _draw(model, seed)


def keras_prior(gen):
    """The reference's create_prior_helper tap of a 2D Keras generator at
    down1 (stem conv, down1's conv and down conv, each with its
    LeakyReLU), frozen, on any spatial size: the same layer objects called
    again (tests/test_tf_parity.py _make_ref_prior)."""
    inp = tf.keras.Input([None, None, 1])
    x = inp
    for name in ("stem", "down1_conv", "down1_down"):
        x = _act(gen.get_layer(name)(x))
    prior = tf.keras.Model(inp, x)
    prior.trainable = False
    return prior


def _same_tree(a, b):
    la, lb = jax.tree.leaves(a), jax.tree.leaves(b)
    assert jax.tree.structure(a) == jax.tree.structure(b)
    return all(np.array_equal(np.asarray(x), np.asarray(y))
               for x, y in zip(la, lb))


def _x(seed, side, is3d, batch=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(-1, 1, (batch,) + (side,) * (3 if is3d else 2)
                       + (1,)).astype(np.float32)


def _port(module, x):
    with torch.no_grad():
        return module(torch.from_numpy(x)).numpy()


@pytest.fixture(scope="module")
def assets(tensorflow, tmp_path_factory):
    """Keras generators (2D wf=8, 3D wf=32) and discriminators (2D wf=8,
    3D wf=32), each as .h5 and as an exported SavedModel; a 2D wf=2
    generator as a prior's .h5, and a 2D wf=8 discriminator built with
    that prior."""
    root = tmp_path_factory.mktemp("keras_assets")
    out = {}
    for kind, build, geoms in (("gen", keras_generator,
                                ((False, 8), (True, 32))),
                               ("disc", keras_discriminator,
                                ((False, 8), (True, 32)))):
        for seed, (is3d, wf) in enumerate(geoms):
            model = build(wf, is3d, 10 * seed + len(out))
            name = f"{kind}_{'3d' if is3d else '2d'}"
            h5 = str(root / f"{name}.h5")
            model.save(h5)
            sm = str(root / f"{name}_sm")
            model.export(sm, verbose=False)
            out[name] = {"model": model, "h5": h5, "sm": sm, "is3d": is3d,
                         "wf": wf}
    prior_gen = keras_generator(2, False, 7)
    out["prior_h5"] = str(root / "prior.h5")
    prior_gen.save(out["prior_h5"])
    disc_p = keras_discriminator(8, False, 8, prior=keras_prior(prior_gen))
    out["disc_prior"] = {"model": disc_p, "h5": str(root / "disc_p.h5")}
    disc_p.save(out["disc_prior"]["h5"])
    return out


@pytest.mark.parametrize("fmt", ["h5", "sm"])
@pytest.mark.parametrize("geom", ["2d", "3d"])
def test_load_tf_generator_matches_jax(assets, geom, fmt):
    """The same arrays as JAX's load_tf_generator; the port's forward
    within 1e-5 of JAX's and of the Keras model's."""
    a = assets["gen_" + geom]
    gen, params = compat.load_tf_generator(a[fmt], device="cpu")
    jgen, jparams = jcompat.load_tf_generator(a[fmt])
    assert (gen.wf, gen.is3d) == (a["wf"], a["is3d"]) == (jgen.wf, a["is3d"])
    assert _same_tree(params_to_jax(params), jparams)
    assert compat.params_geometry(params) == jcompat.params_geometry(jparams)
    x = _x(1, 74, a["is3d"])
    got = _port(gen, x)
    np.testing.assert_allclose(got, np.asarray(jgen.apply(jparams, x)),
                               atol=FWD_TOL)
    np.testing.assert_allclose(got, a["model"](x, training=False).numpy(),
                               atol=FWD_TOL)


@pytest.mark.parametrize("fmt", ["h5", "sm"])
@pytest.mark.parametrize("geom", ["2d", "3d"])
def test_load_tf_discriminator_matches_jax(assets, geom, fmt):
    """wf and 2D/3D from the weights alone (3D: 9 groups from down1, 2D: 7
    from the hack conv), the same arrays as JAX's (the out layer's bias
    included), forwards within 1e-5."""
    a = assets["disc_" + geom]
    disc, params = compat.load_tf_discriminator(a[fmt], device="cpu")
    jdisc, jparams = jcompat.load_tf_discriminator(a[fmt])
    assert disc.is3d == jdisc.is3d == a["is3d"]
    assert _same_tree(params_to_jax(params), jparams)
    assert float(np.abs(params["out.bias"].numpy()).max()) > 0
    x = _x(2, 40, a["is3d"], batch=2)
    got = _port(disc, x)
    np.testing.assert_allclose(got, np.asarray(jdisc.apply(jparams, x)),
                               atol=FWD_TOL)
    np.testing.assert_allclose(got, a["model"](x, training=False).numpy(),
                               atol=FWD_TOL)


def test_discriminator_with_prior_and_prior_helper_match_jax(assets):
    """create_prior_helper(.h5, "down1") taps the same features as JAX's
    (within 1e-5); a discriminator built WITH that frozen prior converts
    when the prior is passed (its weights left out of the mapping, down3
    widened), as JAX's does, within 1e-5 of JAX's and the Keras model's
    forwards; without the prior, or from a SavedModel, both refuse."""
    prior = create_prior_helper(assets["prior_h5"], "down1", device="cpu")
    jprior = jax_prior_helper(assets["prior_h5"], "down1")
    x = _x(3, 40, False, batch=2)
    with torch.no_grad():
        feats = prior(torch.from_numpy(x)).numpy()
    assert feats.shape == (2, 17, 17, 32) and prior.channels == 32
    np.testing.assert_allclose(feats, np.asarray(jprior(x)), atol=FWD_TOL)

    path = assets["disc_prior"]["h5"]
    disc, params = compat.load_tf_discriminator(path, disc_prior=prior,
                                                device="cpu")
    jdisc, jparams = jcompat.load_tf_discriminator(path, disc_prior=jprior)
    assert _same_tree(params_to_jax(params), jparams)
    assert params["down3.conv.kernel"].shape[-2] == 64
    got = _port(disc, x)
    np.testing.assert_allclose(got, np.asarray(jdisc.apply(jparams, x)),
                               atol=FWD_TOL)
    np.testing.assert_allclose(
        got, assets["disc_prior"]["model"](x, training=False).numpy(),
        atol=FWD_TOL)
    for load, kw in ((compat.load_tf_discriminator, {"device": "cpu"}),
                     (jcompat.load_tf_discriminator, {})):
        with pytest.raises(ValueError):
            load(path, **kw)
    with pytest.raises(ValueError, match="prior-carrying"):
        compat.load_tf_discriminator(assets["disc_2d"]["sm"],
                                     disc_prior=prior, device="cpu")


def test_savedmodel_orphan_bias_refused(tmp_path):
    """A bias with no conv kernel before it (a Dense layer's 2-D kernel is
    skipped) is refused, not dropped, as by JAX's reader."""
    inp = tf.keras.Input((3,))
    out = str(tmp_path / "biasonly")
    tf.keras.Model(inp, L.Dense(4)(inp)).export(out, verbose=False)
    for read in (compat.savedmodel_conv_weights,
                 jcompat.savedmodel_conv_weights):
        with pytest.raises(ValueError, match="no preceding kernel"):
            read(out)


# -- reference checkpoints ----------------------------------------------------

def reference_checkpoint(root, seed, wf=32, prior=None):
    """A reference run's tf.train.Checkpoint (reference cgan.py:86-95): 2D
    generators G, F and discriminators Dx, Dy (Dy with ``prior``), each
    with a Keras Adam(2e-4, beta_1=0.5) after one apply_gradients of
    seeded gradients, saved by a CheckpointManager (Keras 3 layout)."""
    nets = {"generator_g": keras_generator(wf, False, seed),
            "generator_f": keras_generator(wf, False, seed + 1),
            "discriminator_x": keras_discriminator(wf, False, seed + 2),
            "discriminator_y": keras_discriminator(wf, False, seed + 3,
                                                   prior=prior)}
    rng = np.random.default_rng(seed + 4)
    opts = {}
    for name, net in nets.items():
        opt = tf.keras.optimizers.Adam(2e-4, beta_1=0.5)
        grads = [tf.constant(rng.normal(0, 1e-2, v.shape).astype(np.float32))
                 for v in net.trainable_variables]
        opt.apply_gradients(zip(grads, net.trainable_variables))
        opts[name + "_optimizer"] = opt
    ckpt = tf.train.Checkpoint(**nets, **opts)
    tf.train.CheckpointManager(ckpt, str(root), max_to_keep=5).save()
    return nets, str(root)


def write_legacy(rd_path, prefix, extra=()):
    """The Keras-2-era layout of the same trained state (object-graph
    paths with nested layer_with_weights indices, .OPTIMIZER_SLOT m / v,
    iter), written with tf.raw_ops.SaveV2 (tests/test_tf_parity.py:
    809-900); ``extra`` adds (name, array) entries."""
    rd = tf.train.load_checkpoint(rd_path)
    keys = sorted(rd.get_variable_to_shape_map())
    names, tensors = [], []
    suffix = "/.ATTRIBUTES/VARIABLE_VALUE"
    for name in compat.NETWORKS:
        ws, ms, vs, it = compat._ckpt_modern(rd, keys, name)
        for i, (w, m, v) in enumerate(zip(ws, ms, vs)):
            base = (f"{name}/layer_with_weights-{i}/layer_with_weights-0"
                    if i % 3 == 1 else f"{name}/layer_with_weights-{i}")
            kind = "kernel" if w.ndim >= 4 else "bias"
            names += [f"{base}/{kind}{suffix}",
                      f"{base}/{kind}/.OPTIMIZER_SLOT/{name}_optimizer/m"
                      f"{suffix}",
                      f"{base}/{kind}/.OPTIMIZER_SLOT/{name}_optimizer/v"
                      f"{suffix}"]
            tensors += [w, m, v]
        names.append(f"{name}_optimizer/iter{suffix}")
        tensors.append(np.asarray(it, np.int64))
    for n, t in extra:
        names.append(n)
        tensors.append(t)
    os.makedirs(os.path.dirname(prefix), exist_ok=True)
    tf.raw_ops.SaveV2(prefix=prefix, tensor_names=names,
                      shape_and_slices=[""] * len(names),
                      tensors=[tf.constant(t) for t in tensors])
    return names, tensors


def _assert_state_equals_jax(state, jstate):
    """Step, every network's parameters and every Adam's count, m and v,
    bit for bit."""
    ours = state_to_jax(state)
    assert int(ours["step"]) == int(jstate.step)
    for t in TREES:
        assert _same_tree(ours[t], getattr(jstate, t)), t
        jopt = getattr(jstate, "opt_" + t)
        assert int(ours["opt_" + t]["count"]) == int(jopt.count), t
        assert _same_tree(ours["opt_" + t]["mu"], jopt.mu), t
        assert _same_tree(ours["opt_" + t]["nu"], jopt.nu), t


@pytest.fixture(scope="module")
def checkpoint(tensorflow, tmp_path_factory):
    root = tmp_path_factory.mktemp("ref_ckpt")
    nets, ckdir = reference_checkpoint(root / "train_ref", 20)
    legacy = str(root / "legacy" / "ckpt-1")
    names, tensors = write_legacy(tf.train.latest_checkpoint(ckdir), legacy)
    return {"nets": nets, "dir": ckdir, "legacy": legacy, "root": root,
            "names": names, "tensors": tensors}


@pytest.mark.parametrize("layout", ["keras3", "legacy"])
def test_reference_checkpoint_matches_jax(checkpoint, layout):
    """load_reference_checkpoint in both layouts: wf / 2D from the weights,
    params and each Adam's count, m and v bit-equal to JAX's reading (m
    signed, v the non-negative second moment)."""
    path = checkpoint["dir"] if layout == "keras3" else checkpoint["legacy"]
    state, wf, is3d = compat.load_reference_checkpoint(path, device="cpu")
    jstate, jwf, jis3d = jcompat.load_reference_checkpoint(path)
    assert (wf, is3d) == (jwf, jis3d) == (32, False)
    assert state.step == 1 and state.opt_gg.count == 1
    _assert_state_equals_jax(state, jstate)
    assert all(float(v.min()) >= 0 for v in state.opt_dx.nu.values())
    assert any(float(m.min()) < 0 for m in state.opt_dx.mu.values())


def test_reference_checkpoint_refusals(checkpoint, tmp_path):
    """As in JAX's reader: a slot-less weight under discriminator_y (a
    frozen prior's) without disc_prior, a Keras-2-era checkpoint saved
    before any step, and a Keras 3 one with no optimizer, each refused
    with its diagnosis, by both packages."""
    suffix = "/.ATTRIBUTES/VARIABLE_VALUE"
    prior_w = ("discriminator_y/layer_with_weights-2/layer_with_weights-0/"
               f"kernel{suffix}", np.full((3, 3, 1, 16), 7.0, np.float32))
    rd_path = tf.train.latest_checkpoint(checkpoint["dir"])
    p2 = str(tmp_path / "legacy_prior" / "ckpt-1")
    write_legacy(rd_path, p2, extra=[prior_w])
    p3 = str(tmp_path / "legacy_prestep" / "ckpt-1")
    os.makedirs(os.path.dirname(p3))
    pre = [(n, t) for n, t in zip(checkpoint["names"],
                                  checkpoint["tensors"])
           if ".OPTIMIZER_SLOT" not in n and "_optimizer/" not in n]
    tf.raw_ops.SaveV2(prefix=p3, tensor_names=[n for n, _ in pre],
                      shape_and_slices=[""] * len(pre),
                      tensors=[tf.constant(t) for _, t in pre])
    p4 = str(tmp_path / "modern_prebuild" / "ckpt-1")
    os.makedirs(os.path.dirname(p4))
    tf.raw_ops.SaveV2(
        prefix=p4, tensor_names=[f"generator_g/_operations/0/_kernel{suffix}"],
        shape_and_slices=[""],
        tensors=[tf.constant(np.zeros((3, 3, 1, 8), np.float32))])
    for path, match in ((p2, "disc_prior"), (p3, "before any training step"),
                        (p4, "no optimizer variables"),
                        (str(tmp_path), "no TF checkpoint")):
        with pytest.raises(ValueError, match=match):
            compat.load_reference_checkpoint(path, device="cpu")
        with pytest.raises(ValueError, match=match):
            jcompat.load_reference_checkpoint(path)


def test_reference_checkpoint_with_prior_matches_jax(assets, tmp_path):
    """A run trained WITH a frozen prior on Dy: refused without the prior
    and with a wrong prior of the right architecture (held against the
    prior weights the checkpoint stores), read with the right one as JAX
    reads it, bit for bit; Dy's forward within 1e-5 of JAX's."""
    prior_gen = keras_generator(2, False, 7)  # assets["prior_h5"]'s weights
    nets, ckdir = reference_checkpoint(tmp_path / "train_p", 30,
                                       prior=keras_prior(prior_gen))
    with pytest.raises(ValueError, match="disc_prior"):
        compat.load_reference_checkpoint(ckdir, device="cpu")
    wrong = str(tmp_path / "wrong.h5")
    keras_generator(2, False, 99).save(wrong)
    with pytest.raises(ValueError, match="disc_prior mismatch"):
        compat.load_reference_checkpoint(
            ckdir, create_prior_helper(wrong, "down1", device="cpu"),
            device="cpu")
    prior = create_prior_helper(assets["prior_h5"], "down1", device="cpu")
    jprior = jax_prior_helper(assets["prior_h5"], "down1")
    state, _, _ = compat.load_reference_checkpoint(ckdir, prior,
                                                   device="cpu")
    jstate, _, _ = jcompat.load_reference_checkpoint(ckdir, jprior)
    _assert_state_equals_jax(state, jstate)
    from transfer_em_tpu.models import Discriminator as JaxDisc
    x = _x(4, 40, False, batch=2)
    np.testing.assert_allclose(
        _port(state.dy, x),
        np.asarray(JaxDisc(is3d=False, wf=32, disc_prior=jprior).apply(
            jstate.dy, x)), atol=FWD_TOL)
    np.testing.assert_allclose(
        _port(state.dy, x),
        nets["discriminator_y"](x, training=False).numpy(), atol=FWD_TOL)


def test_from_reference_checkpoint_then_step_matches_jax(checkpoint,
                                                         tmp_path):
    """EM2EM.from_reference_checkpoint in both packages, then one step each
    on the same batch (dropout off): the 7-loss vectors within rtol 1e-4,
    each network's updated parameters within 1e-5 of its largest value,
    step and Adam counts 2; an experiment with checkpoints is refused."""
    model = EM2EM.from_reference_checkpoint(
        checkpoint["dir"], "migrated", checkpoint_root=str(tmp_path / "ours"),
        device="cpu")
    jmodel = JaxEM2EM.from_reference_checkpoint(
        checkpoint["dir"], "migrated", checkpoint_root=str(tmp_path / "jax"))
    assert (model.config.wf, model.is3d) == (32, False)
    _assert_state_equals_jax(model.state, jmodel.state)

    rng = np.random.default_rng(5)
    x, y = ((0.3 * rng.normal(size=(2, 74, 74, 1))).astype(np.float32)
            for _ in range(2))
    jstate, jloss = jax.jit(jax_step_fn(jmodel.config, deterministic=True))(
        jmodel.state, jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
    loss = build_step_fn(model.config, deterministic=True)(
        model.state, torch.from_numpy(x), torch.from_numpy(y), 0)
    np.testing.assert_allclose(loss.numpy(), np.asarray(jloss), rtol=1e-4)
    assert model.state.step == 2 and model.state.opt_dy.count == 2
    ours = state_to_jax(model.state)
    for t in TREES:
        want = jax.tree.leaves(getattr(jstate, t))
        got = jax.tree.leaves(ours[t])
        scale = max(float(np.abs(np.asarray(w)).max()) for w in want)
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, np.asarray(w), atol=1e-5 * scale,
                                       rtol=0)

    model.make_checkpoint(1)
    model.wait_until_finished()
    with pytest.raises(ValueError, match="already has checkpoints"):
        EM2EM.from_reference_checkpoint(
            checkpoint["dir"], "migrated",
            checkpoint_root=str(tmp_path / "ours"), device="cpu")


# -- exports ------------------------------------------------------------------

def test_load_generator_of_reference_exports_matches_jax(assets, tmp_path):
    """load_generator of a reference export, a Keras SavedModel directory
    and an .h5 file with the reference's 4-key meta.json beside it: wf and
    2D/3D from the weights, the meta's keys kept, the forward within 1e-5
    of JAX's load_generator's; a directory with neither format raises
    FileNotFoundError."""
    a = assets["gen_2d"]
    ref_meta = {"buffer": 17, "outdimsize": 40, "meanstd_x": [0.1, 0.9],
                "meanstd_y": [0.2, 1.1]}
    sm = tmp_path / "ref_model"
    a["model"].export(str(sm), verbose=False)
    (sm / "meta.json").write_text(json.dumps(ref_meta))
    h5 = tmp_path / "gen.h5"
    a["model"].save(str(h5))
    (tmp_path / "meta.json").write_text(json.dumps(ref_meta))
    x = _x(6, 74, False)
    for src in (str(sm), str(h5)):
        gen, meta = load_generator(src, device="cpu")
        jgen, jparams, jmeta = jax_load(src)
        assert (meta.wf, meta.is3d) == (jmeta.wf, jmeta.is3d) == (8, False)
        assert meta.buffer == 17 and meta.meanstd_x == (0.1, 0.9)
        np.testing.assert_allclose(_port(gen, x),
                                   np.asarray(jgen.apply(jparams, x)),
                                   atol=FWD_TOL)
    empty = tmp_path / "empty"
    empty.mkdir()
    (empty / "meta.json").write_text(json.dumps(ref_meta))
    with pytest.raises(FileNotFoundError, match="saved_model.pb"):
        load_generator(str(empty), device="cpu")


def _check_tf_export(dst, gen, is3d):
    """The SavedModel at ``dst`` against the port's generator: JAX's
    load_tf_generator reads the port's weights back bit for bit; the
    restored ``predict`` and ``serving_default`` within 1e-4 of the port's
    forward, batch-polymorphic."""
    jgen, jparams = jcompat.load_tf_generator(dst)
    assert _same_tree(params_to_jax(gen.state_dict()), jparams)
    x = _x(8, 74, is3d, batch=2)
    want = _port(gen, x)
    loaded = tf.saved_model.load(dst)
    got = loaded.predict(tf.constant(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-4)
    sig = loaded.signatures["serving_default"]
    got_sig = list(sig(tf.constant(x[:1])).values())[0].numpy()
    np.testing.assert_allclose(got_sig, want[:1], atol=1e-4)


@pytest.mark.parametrize("is3d", [False, True])
def test_export_tf_savedmodel_roundtrip(tmp_path, is3d):
    """export_tf_savedmodel of the port's export (npz): a reference-
    architecture SavedModel that JAX's compat reads back bit for bit, whose
    predict / serving_default match the port within 1e-4, with meta.json
    beside it."""
    from transfer_em_tpu_torch.models import UNetGenerator
    wf = 32 if is3d else 64
    gen = UNetGenerator(wf=wf, is3d=is3d,
                        generator=torch.Generator().manual_seed(3))
    meta = ExportMeta(buffer=17, outdimsize=40, meanstd_x=(0.1, 0.9),
                      meanstd_y=(0.2, 0.8), dimsize=74, is3d=is3d, wf=wf)
    src, dst = str(tmp_path / "ours"), str(tmp_path / "tf")
    export_generator(gen, meta, src)
    compat.export_tf_savedmodel(src, dst)
    _check_tf_export(dst, gen.eval(), is3d)
    m = json.load(open(os.path.join(dst, "meta.json")))
    assert m["buffer"] == 17 and tuple(m["meanstd_x"]) == (0.1, 0.9)


def test_save_model_cli_writes_tf_savedmodel(tmp_path, monkeypatch):
    """``save_model ... --tf=DIR`` exports generator G of a checkpoint as
    the port's export and, beside it, the TF SavedModel."""
    monkeypatch.chdir(tmp_path)
    model = EM2EM(74, "cli", is3d=False, wf=32, checkpoint_root="ckpts",
                  device="cpu")
    model.make_checkpoint(1)
    model.wait_until_finished()
    rc = save_model_cli.main(["exported", "ckpts/train_cli/1", "0.1", "0.9",
                              "0.2", "0.8", "74", "0", "32", "--device=cpu",
                              "--tf=exported_tf"])
    assert rc == 0
    gen, meta = load_generator("exported", device="cpu")
    assert os.path.exists("exported_tf/saved_model.pb")
    assert json.load(open("exported_tf/meta.json"))["wf"] == 32
    _check_tf_export("exported_tf", gen, False)
