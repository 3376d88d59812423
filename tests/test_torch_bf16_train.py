"""The port's bf16 train step (``compute_dtype="bfloat16"``) on the CPU
against the JAX package's: the same state (the JAX state converted, the
parameters redrawn to O(1) as chip_smoke.py's ``redraw`` does) and the same
numpy-seeded N(0, 0.3^2) batches, dropout off.

The yardstick is JAX's own bf16-to-f32 gap at the same inputs.  For each
network, gap(a, b) = max over parameters of max |a - b| / max over
parameters of max |b|; the port's gap to JAX's bf16 gradients must be under
half of JAX's f32 gradients' gap to them, so a port that computed in f32
would fail.  The JAX steps are compiled with ``xla_allow_excess_precision``
off, so that every bf16 operation rounds where the code writes it (XLA's CPU
backend otherwise keeps some fused intermediates in f32).

One parameter is held apart: each discriminator's ``out.bias``.  Its
gradient sums the bias cotangent over the batch, and XLA's CPU backend sums
a bf16 cotangent in bf16 (pairwise partial sums each rounded), which the
port, like JAX's f32 step, sums in f32 and rounds once; there the port must
be nearer JAX's bf16 value, or JAX's f32 one, than half their distance.

Measured on the CPU (gap of the port / of JAX's f32 step), 2D wf=8 B=2:
gg 0.015 / 0.071, gf 0.012 / 0.068, dx 0.0010 / 0.0064, dy 0.0014 / 0.011;
3D wf=32 B=1: gg 0.0045 / 0.10, gf 0.0039 / 0.078, dx 0.0049 / 0.074, dy
0.0031 / 0.040; the losses within 2e-5 of JAX's bf16 ones (JAX's f32
losses: 1.7e-4 and 3.6e-4).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transfer_em_tpu.config import CycleGANConfig as JaxConfig
from transfer_em_tpu.shapes import generator_shapes
from transfer_em_tpu.train import create_state as jax_create_state
from transfer_em_tpu.train.cgan import build_models as jax_build_models
from transfer_em_tpu.train.cgan import build_step_fn as jax_build_step_fn
from transfer_em_tpu.train.cgan import cyclegan_losses as jax_losses
from transfer_em_tpu_torch.config import CycleGANConfig
from transfer_em_tpu_torch.models import Discriminator, UNetGenerator
from transfer_em_tpu_torch.models.blocks import ConvND, ConvTransposeND
from transfer_em_tpu_torch.models.convert import (TREES, load_jax_state,
                                                  params_from_jax)
from transfer_em_tpu_torch.ops import cuda_conv
from transfer_em_tpu_torch.ops.cuda_kernels import slope_in
from transfer_em_tpu_torch.train import (EM2EM, build_step_fn, create_state,
                                         cyclegan_losses)
from test_torch_train_step import redrawn

torch.set_num_threads(1)

BUFFER = generator_shapes(74).buffer
EXACT = {"xla_allow_excess_precision": False}
# (is3d, wf, batch): the two shapes the step is held at
SHAPES = {"2d": (False, 8, 2), "3d": (True, 32, 1)}


def _cfgs(is3d, wf, **kw):
    jax_cfg = {d: JaxConfig(dimsize=74, is3d=is3d, wf=wf, compute_dtype=d,
                            **kw) for d in ("float32", "bfloat16")}
    port_cfg = CycleGANConfig(dimsize=74, is3d=is3d, wf=wf,
                              compute_dtype="bfloat16", **kw)
    return jax_cfg, port_cfg


def _batches(is3d, n, seed=42):
    rng = np.random.default_rng(seed)
    shape = (n,) + (74,) * (3 if is3d else 2) + (1,)
    return [(0.3 * rng.normal(size=shape)).astype(np.float32)
            for _ in range(2)]


def _jax_grads(cfg, jstate, x, y, opts=EXACT):
    """JAX's gradients (as the port's {name: array} per network) and loss
    vector, the step compiled with ``opts`` (default: excess precision
    off)."""
    gen, disc_x, disc_y = jax_build_models(cfg)
    fn = jax.jit(jax.grad(
        lambda gg, gf, dx, dy: jax_losses(
            gen, disc_x, disc_y, BUFFER, 2.0, gg, gf, dx, dy,
            jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0),
            deterministic=True),
        argnums=(0, 1, 2, 3), has_aux=True))
    args = (jstate.gg, jstate.gf, jstate.dx, jstate.dy)
    grads, vec = fn.lower(*args).compile(opts)(*args)
    return ([{k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, g)).items()} for g in grads],
            np.asarray(vec))


def _port_grads(cfg, jstate_np, x, y):
    state = create_state(cfg, 0, device="cpu")
    load_jax_state(state, jstate_np)
    nets = [getattr(state, t) for t in TREES]
    combined, vec = cyclegan_losses(*nets, BUFFER, 2.0, torch.from_numpy(x),
                                    torch.from_numpy(y), deterministic=True)
    combined.backward()
    return ([{k: p.grad.numpy() for k, p in n.named_parameters()}
             for n in nets], vec.numpy())


def gap(got, want, skip=()):
    keys = [k for k in want if k not in skip]
    return (max(float(np.abs(got[k] - want[k]).max()) for k in keys)
            / max(float(np.abs(want[k]).max()) for k in keys))


def l2_gap(got, want):
    return float(np.sqrt(sum(((got[k] - want[k]) ** 2).sum() for k in want)
                         / sum((want[k] ** 2).sum() for k in want)))


def assert_matches_jax_bf16(port, j16, j32):
    """port, j16, j32: per-network {name: gradient}; see the module
    docstring."""
    gaps = {}
    for t, p, b, f in zip(TREES, port, j16, j32):
        skip = ("out.bias",) if "out.bias" in b else ()
        gaps[t] = (gap(p, b, skip), gap(f, b, skip))
        assert gaps[t][0] < 0.5 * gaps[t][1], (t, gaps[t])
        if skip:
            d = abs(float(b["out.bias"][0]) - float(f["out.bias"][0]))
            near = min(abs(float(p["out.bias"][0]) - float(b["out.bias"][0])),
                       abs(float(p["out.bias"][0]) - float(f["out.bias"][0])))
            assert near <= 0.5 * d, (t, p["out.bias"], b["out.bias"],
                                     f["out.bias"])
    return gaps


@pytest.mark.parametrize("shape", list(SHAPES))
def test_bf16_step_matches_jax(shape):
    """The 7 losses within rtol 1e-3 of JAX's bf16 step, and every
    network's gradients under half of JAX's own bf16-to-f32 gap."""
    is3d, wf, n = SHAPES[shape]
    jcfg, _ = _cfgs(is3d, wf)
    _, cfg = _cfgs(is3d, wf)
    jstate = redrawn(jax_create_state(jcfg["float32"],
                                      jax.random.PRNGKey(0)), 1)
    x, y = _batches(is3d, n)
    j16, v16 = _jax_grads(jcfg["bfloat16"], jstate, x, y)
    j32, v32 = _jax_grads(jcfg["float32"], jstate, x, y)
    port, vec = _port_grads(cfg, jax.tree.map(np.asarray, jstate), x, y)
    np.testing.assert_allclose(vec, v16, rtol=1e-3)
    assert not np.array_equal(v16, v32)
    assert_matches_jax_bf16(port, j16, j32)


def _params(state):
    """Per network {name: array} of a port state's parameters."""
    return [{k: p.detach().numpy() for k, p in
             getattr(state, t).named_parameters()} for t in TREES]


def test_bf16_two_steps_match_jax():
    """2D wf=8 B=2: two bf16 steps (both Keras-Adam updates) of the port
    and of the JAX package from one state.  Both steps' losses within rtol
    1e-3.  The parameters after both updates: each network's L2 distance
    to JAX's bf16 ones under half of the distance of JAX's f32 step's
    (an update moves a parameter by about lr = 2e-4 whatever its gradient's
    size, so a gradient at rounding level that flips sign moves it by 2 lr;
    the gradients themselves are held at one state above).  Measured: L2
    0.0023 / 0.0051, 0.0022 / 0.0068, 0.0025 / 0.0081, 0.0029 / 0.0100
    (port / JAX f32, gg gf dx dy); parameters off by more than lr / 2: 48,
    39, 136 and 179 of 38,040-47,793 (JAX f32: 459, 891, 1041, 1556)."""
    is3d, wf, n = SHAPES["2d"]
    jcfg, cfg = _cfgs(is3d, wf)
    jstate = redrawn(jax_create_state(jcfg["float32"],
                                      jax.random.PRNGKey(0)), 1)
    x, y = _batches(is3d, n)
    args = (jnp.asarray(x), jnp.asarray(y), jax.random.PRNGKey(0))
    jparams, jlosses = {}, None
    for d in ("bfloat16", "float32"):
        jstep = jax.jit(jax_build_step_fn(jcfg[d], deterministic=True))
        jstep = jstep.lower(jstate, *args).compile(EXACT)
        js1, jl1 = jstep(jstate, *args)
        js2, jl2 = jstep(js1, *args)
        if d == "bfloat16":
            jlosses = (np.asarray(jl1), np.asarray(jl2))
        jparams[d] = [{k: v.numpy() for k, v in params_from_jax(
            jax.tree.map(np.asarray, getattr(js2, t))).items()}
            for t in TREES]

    state = create_state(cfg, 0, device="cpu")
    load_jax_state(state, jax.tree.map(np.asarray, jstate))
    step = build_step_fn(cfg, deterministic=True)
    l1 = step(state, torch.from_numpy(x), torch.from_numpy(y), 0)
    l2 = step(state, torch.from_numpy(x), torch.from_numpy(y), 0)
    assert state.step == 2 and state.opt_gg.count == 2
    np.testing.assert_allclose(l1.numpy(), jlosses[0], rtol=1e-3)
    np.testing.assert_allclose(l2.numpy(), jlosses[1], rtol=1e-3)
    assert not np.allclose(l1.numpy(), l2.numpy(), rtol=1e-6, atol=0)
    for t, p, b, f in zip(TREES, _params(state), jparams["bfloat16"],
                          jparams["float32"]):
        dist = {name: float(np.sqrt(sum(((a[k] - b[k]) ** 2).sum()
                                        for k in b)))
                for name, a in (("port", p), ("jax_f32", f))}
        assert dist["port"] < 0.5 * dist["jax_f32"], (t, dist)


def test_bf16_use_norm_matches_jax():
    """use_norm=True in bf16, 2D wf=8 B=2: the losses within rtol 1e-3 of
    JAX's bf16 step; each network's gradients, by the L2 gap
    (||a - b|| / ||b|| over all its parameters), under 0.75 of JAX's own
    bf16-to-f32 gap and under the gap between JAX's bf16 step and the same
    step compiled with excess precision on (XLA then keeps some fused
    intermediates in f32: the same function, rounded elsewhere).

    The module docstring's bound (the max-based gap under half of JAX's
    f32 one) does not hold here for any summation order: InstanceNorm's
    gradient in bf16 over small extents moves by whole bf16 steps with where
    it rounds (test_bf16_instance_norm_backward_against_f64), and JAX's
    step against itself, excess precision on against off, reads a
    max-based gap of 0.18, 0.20, 0.041 and 0.034 (gg gf dx dy) where its
    f32 step reads 0.19, 0.18, 0.057 and 0.033.  Measured, L2 gap (port /
    JAX excess precision on / JAX f32): gg 0.068 / 0.19 / 0.18, gf 0.078 /
    0.15 / 0.17, dx 0.047 / 0.075 / 0.10, dy 0.059 / 0.097 / 0.095; the
    port's max-based gap 0.066, 0.089, 0.032, 0.034."""
    is3d, wf, n = SHAPES["2d"]
    jcfg, cfg = _cfgs(is3d, wf, use_norm=True)
    jstate = redrawn(jax_create_state(jcfg["float32"],
                                      jax.random.PRNGKey(0)), 1)
    x, y = _batches(is3d, n)
    j16, v16 = _jax_grads(jcfg["bfloat16"], jstate, x, y)
    j16_fused, _ = _jax_grads(jcfg["bfloat16"], jstate, x, y, opts={})
    j32, _ = _jax_grads(jcfg["float32"], jstate, x, y)
    port, vec = _port_grads(cfg, jax.tree.map(np.asarray, jstate), x, y)
    np.testing.assert_allclose(vec, v16, rtol=1e-3)
    for t, p, b, e, f in zip(TREES, port, j16, j16_fused, j32):
        gaps = (l2_gap(p, b), l2_gap(e, b), l2_gap(f, b))
        assert gaps[0] < 0.75 * gaps[2] and gaps[0] < gaps[1], (t, gaps)


def test_bf16_instance_norm_backward_against_f64():
    """InstanceNorm alone on a bf16 x (2, 36, 36, 16), scale and offset
    drawn, an f32 cotangent: the port's and JAX's output and dx against the
    same expression evaluated in float64 on the same bf16 values.  Both are
    as near the exact values as each other, and the port's gap to JAX's is
    no larger than their distance to the exact values: the two differ by
    where they round, not by what they compute.  Measured (largest error in
    bf16 steps at the largest |dx|, L2 gap): JAX 1.46, 0.0034; port 1.28,
    0.0029; port to JAX L2 0.0029; the outputs within 2^-20 of the largest
    (XLA's CPU backend contracts a multiply and an add into one FMA)."""
    from transfer_em_tpu.models.blocks import InstanceNorm as JaxNorm
    from transfer_em_tpu_torch.models.blocks import InstanceNorm

    rng = np.random.default_rng(0)
    x = (0.7 * rng.normal(size=(2, 36, 36, 16)) + 0.2).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    scale, offset = (0.1 * rng.normal(size=(2, 16))).astype(np.float32)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    x16 = np.asarray(xb, np.float32)  # x's bf16 values

    def vjp(p, xb, g):
        y, pull = jax.vjp(lambda xb: JaxNorm().apply(p, xb), xb)
        return y, pull(g)[0]

    p = {"params": {"scale": jnp.asarray(scale),
                    "offset": jnp.asarray(offset)}}
    jy, jdx = jax.jit(vjp).lower(p, xb, g).compile(EXACT)(p, xb, g)
    jy, jdx = np.asarray(jy), np.asarray(jdx, np.float32)

    norm = InstanceNorm(16)
    with torch.no_grad():
        norm.scale.copy_(torch.from_numpy(scale))
        norm.offset.copy_(torch.from_numpy(offset))
    xt = torch.from_numpy(x16).to(torch.bfloat16).requires_grad_(True)
    ty = norm(xt)
    ty.backward(torch.from_numpy(g))
    assert ty.dtype == torch.float32 and xt.grad.dtype == torch.bfloat16
    ty, tdx = ty.detach().numpy(), xt.grad.float().numpy()

    x64 = torch.from_numpy(x16).double().requires_grad_(True)
    mean = x64.mean(dim=(1, 2), keepdim=True)
    var = x64.var(dim=(1, 2), correction=0, keepdim=True)
    y64 = ((torch.from_numpy(scale).double() + 1) * (x64 - mean)
           * torch.rsqrt(var + 1e-5) + torch.from_numpy(offset).double())
    y64.backward(torch.from_numpy(g).double())
    dx64 = x64.grad.numpy()

    def steps(a, ref):
        ulp = 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7)
        return float(np.abs(a - ref).max() / ulp)

    def l2(a, ref):
        return float(np.sqrt(((a - ref) ** 2).sum() / (ref ** 2).sum()))

    assert np.abs(ty - jy).max() <= 2.0 ** -20 * np.abs(jy).max()
    jax_err, port_err = l2(jdx, dx64), l2(tdx, dx64)
    assert port_err <= jax_err and steps(tdx, dx64) <= steps(jdx, dx64)
    assert l2(tdx, jdx) <= max(jax_err, port_err)
    # both at bf16's rounding level (one rounding: L2 about 2^-9)
    assert max(jax_err, port_err) < 2.0 ** -7


def test_bf16_dtypes():
    """In the bf16 step every conv's input is bf16 (conv3, the k4, 1x1 and
    transposed convs, use_norm's f32 InstanceNorm outputs and skips cast
    back at the next conv), the networks' outputs float32, and the
    parameters, their gradients and the Adam moments float32."""
    cfg = CycleGANConfig(dimsize=74, is3d=True, wf=32,
                         compute_dtype="bfloat16", use_norm=True)
    state = create_state(cfg, 0, device="cpu")
    seen, outs = [], []
    for t in TREES:
        net = getattr(state, t)
        for m in net.modules():
            if isinstance(m, (ConvND, ConvTransposeND)):
                m.register_forward_hook(
                    lambda mod, inp, out: seen.append(
                        (inp[0].dtype, out.dtype)))
        net.register_forward_hook(lambda mod, inp, out: outs.append(
            out.dtype))
    x, y = (torch.from_numpy(b) for b in _batches(True, 1))
    build_step_fn(cfg)(state, x, y, 0)
    assert seen and outs
    assert all(d == torch.float32 for d in outs)
    # the module's input may be f32 (InstanceNorm's output): the conv casts
    # it, and its output is bf16
    assert all(o == torch.bfloat16 for _, o in seen)
    assert any(i == torch.float32 for i, _ in seen)  # use_norm's f32 skips
    for t in TREES:
        net = getattr(state, t)
        for p in net.parameters():
            assert p.dtype == p.grad.dtype == torch.float32
        opt = getattr(state, "opt_" + t)
        assert all(v.dtype == torch.float32 for v in opt.mu.values())
        assert all(v.dtype == torch.float32 for v in opt.nu.values())


def test_bf16_conv_inputs_are_bf16():
    """Every conv3 and cuDNN conv call of a bf16 forward gets a bf16 x (the
    blocks cast at entry), with the f32 parameter for conv3."""
    from transfer_em_tpu_torch.models import blocks
    from transfer_em_tpu_torch.ops import convs

    calls = []
    saved = (convs.conv3, blocks.conv_nd, convs.conv_transpose_nd)

    def rec(name, f):
        def wrapped(x, w, *a, **k):
            calls.append((name, x.dtype, w.dtype))
            return f(x, w, *a, **k)
        return wrapped

    convs.conv3 = rec("conv3", saved[0])
    blocks.conv_nd = rec("conv_nd", saved[1])
    blocks.conv_transpose_nd = rec("conv_transpose_nd", saved[2])
    try:
        for net in (UNetGenerator(wf=32, compute_dtype="bfloat16",
                                  use_norm=True),
                    Discriminator(wf=32, compute_dtype="bfloat16",
                                  use_norm=True)):
            side = 74 if isinstance(net, UNetGenerator) else 40
            out = net(torch.zeros((1, side, side, side, 1)))
            assert out.dtype == torch.float32
    finally:
        convs.conv3, blocks.conv_nd, blocks.conv_transpose_nd = saved
    assert {n for n, _, _ in calls} == {"conv3", "conv_nd",
                                        "conv_transpose_nd"}
    assert all(xd == torch.bfloat16 and wd == torch.float32
               for _, xd, wd in calls)


def test_bf16_with_prior_raises_type_error_in_both_packages():
    """bf16 with a disc_prior: JAX raises TypeError (the bf16 discriminator
    input meets the prior's f32 kernels) when its create_state initialises
    the discriminator, and the port at create_state, naming both."""
    from transfer_em_tpu.models import UNetGenerator as JaxUNet
    from transfer_em_tpu.train.cgan import _tap_prior as jax_tap_prior
    from transfer_em_tpu_torch.train.cgan import _tap_prior

    jgen = JaxUNet(wf=32)
    gparams = jgen.init(jax.random.PRNGKey(0),
                        jnp.zeros((1, 74, 74, 1), jnp.float32))
    jprior = jax_tap_prior(jgen, gparams, "down1")
    jcfg = JaxConfig(dimsize=74, is3d=False, wf=32,
                     compute_dtype="bfloat16")
    x = jnp.zeros((1, 74, 74, 1), jnp.float32)
    with pytest.raises(TypeError, match="bfloat16, float32"):
        # its create_state already traces the discriminator with the prior
        jstate = jax_create_state(jcfg, jax.random.PRNGKey(1),
                                  disc_prior=jprior)
        jax_build_step_fn(jcfg, jprior, deterministic=True)(
            jstate, x, x, jax.random.PRNGKey(0))

    prior = _tap_prior(UNetGenerator(wf=32, is3d=False), "down1")
    cfg = CycleGANConfig(dimsize=74, is3d=False, wf=32,
                         compute_dtype="bfloat16")
    with pytest.raises(TypeError, match="bfloat16.*disc_prior"):
        create_state(cfg, 0, device="cpu", disc_prior=prior)
    # float32 with the prior, and bf16 without it, build
    create_state(dataclasses.replace(cfg, compute_dtype="float32"), 0,
                 device="cpu", disc_prior=prior)
    create_state(cfg, 0, device="cpu")


def _em2em(root, name, dtype, **kw):
    return EM2EM(74, name, is3d=False, wf=32, compute_dtype=dtype,
                 checkpoint_root=str(root), device="cpu", **kw)


def _tensors(state):
    out = []
    for t in TREES:
        out += list(getattr(state, t).parameters())
        opt = getattr(state, "opt_" + t)
        out += [opt.mu[k] for k in sorted(opt.mu)]
        out += [opt.nu[k] for k in sorted(opt.nu)]
    return out


@pytest.mark.parametrize("src,dst", [("bfloat16", "float32"),
                                     ("float32", "bfloat16")])
def test_checkpoints_cross_dtypes(tmp_path, src, dst):
    """A checkpoint of a run in one dtype restores, bit for bit, into an
    EM2EM of the other (the state is float32 in both)."""
    rng = np.random.default_rng(3)
    xs = [(0.3 * rng.normal(size=(2, 74, 74, 1))).astype(np.float32)
          for _ in range(4)]
    a = _em2em(tmp_path, "run", src)
    a.train(xs[:2], xs[2:], epochs=1)
    assert a.state.step == 2
    b = _em2em(tmp_path, "run", dst)  # auto-restores epoch 1
    assert b.config.compute_dtype == dst and b.state.step == 2
    assert all(torch.equal(p, q) and q.dtype == torch.float32
               for p, q in zip(_tensors(a.state), _tensors(b.state)))
    # the restored bf16 (or f32) model predicts in its own dtype
    x = torch.from_numpy(xs[0][:1])
    want = UNetGenerator(wf=32, is3d=False, compute_dtype=dst)
    want.load_state_dict(a.state.gg.state_dict())
    with torch.no_grad():
        assert torch.equal(b.predict(x), want(x))


def test_em2em_bf16_predicts_with_the_bf16_networks(tmp_path):
    """EM2EM(compute_dtype="bfloat16"): predict, predict_f and the bound
    discriminators run the bf16 networks (float32 out, not the f32
    networks' values); save_model exports the float32 parameters."""
    from transfer_em_tpu_torch.infer import load_generator, save_model

    m = _em2em(tmp_path, "pred", "bfloat16")
    x = torch.from_numpy((0.3 * np.random.default_rng(4).normal(
        size=(1, 74, 74, 1))).astype(np.float32))
    f32 = UNetGenerator(wf=32, is3d=False)
    with torch.no_grad():
        for got, net in ((m.predict(x), m.state.gg),
                         (m.predict_f(x), m.state.gf)):
            f32.load_state_dict(net.state_dict())
            assert got.dtype == torch.float32
            assert torch.equal(got, net(x))
            assert not torch.equal(got, f32(x))
        d = m.discriminator_x(torch.zeros((1, 40, 40, 1)))
    assert d.dtype == torch.float32
    m.make_checkpoint(1)
    m.wait_until_finished()
    save_model(str(tmp_path / "export"), f"{m.checkpoint_path}/1",
               (0.0, 1.0), (0.0, 1.0), 74, False, 32, device="cpu")
    gen, _ = load_generator(str(tmp_path / "export"), device="cpu")
    for (k, p), q in zip(gen.named_parameters(), m.state.gg.parameters()):
        assert p.dtype == torch.float32 and torch.equal(p, q), k


def test_conv3_bf16_gradients_in_f32_math_rounded():
    """conv3's bf16 backward is convolution_backward in float32 on the bf16
    values, dx and dw rounded to bf16 (dx returned in bf16, dw in the
    parameter's f32): bit for bit on the CPU.  The f32 backward is the
    float32 convolution_backward itself."""
    rng = np.random.default_rng(6)
    f, bf = torch.float32, torch.bfloat16
    x = torch.from_numpy(rng.normal(size=(2, 9, 10, 11, 8)).astype(
        np.float32)).to(bf).requires_grad_(True)
    w = torch.nn.Parameter(torch.from_numpy(
        (rng.normal(size=(3, 3, 3, 8, 16)) / 12).astype(np.float32)))
    g = torch.from_numpy(rng.normal(size=(2, 7, 8, 9, 16)).astype(
        np.float32)).to(bf)

    def f32_grads(x, w, g):
        dx, dw, _ = torch.ops.aten.convolution_backward(
            g.to(f).permute(0, 4, 1, 2, 3), x.to(f).permute(0, 4, 1, 2, 3),
            w.to(f).permute(4, 3, 0, 1, 2), None, [1, 1, 1], [0, 0, 0],
            [1, 1, 1], False, [0, 0, 0], 1, [True, True, False])
        return dx.permute(0, 2, 3, 4, 1), dw.permute(2, 3, 4, 1, 0)

    cuda_conv.conv3(x, w).backward(g)
    assert x.grad.dtype == bf and w.grad.dtype == f
    rx, rw = f32_grads(x.detach(), w.detach().to(bf), g)
    assert torch.equal(x.grad, rx.to(bf))
    assert torch.equal(w.grad, rw.to(bf).to(f))
    # float32: no rounding
    xf = x.detach().float().requires_grad_(True)
    wf = torch.nn.Parameter(w.detach().clone())
    cuda_conv.conv3(xf, wf).backward(g.float())
    rx, rw = f32_grads(xf.detach(), wf.detach(), g)
    assert torch.equal(xf.grad, rx) and torch.equal(wf.grad, rw)


def test_bf16_leaky_slope_and_epilogue():
    """bf16 activations take the slope rounded to bf16 (0.30078125), as
    JAX's nn.leaky_relu rounds its weak-typed 0.3, and float32 keeps 0.3;
    conv3's bf16 epilogue rounds the sum to bf16 before the activation, as
    a bf16 conv followed by a bf16 LeakyReLU computes: the JAX package's
    default path (the activation bit for bit)."""
    from transfer_em_tpu.models.blocks import leaky_relu as jax_leaky
    from transfer_em_tpu.ops.convs import conv_nd as jax_conv_nd
    from transfer_em_tpu_torch.models.blocks import leaky

    assert slope_in(torch.bfloat16) == 0.30078125
    assert np.float32(slope_in(torch.float32)) == np.float32(0.3)
    rng = np.random.default_rng(7)
    v = rng.normal(size=(4, 1000)).astype(np.float32)
    vb = jnp.asarray(v).astype(jnp.bfloat16)
    got = leaky(torch.from_numpy(v).to(torch.bfloat16))
    assert np.array_equal(got.float().numpy(),
                          np.asarray(jax_leaky(vb), np.float32))
    x = rng.normal(size=(1, 8, 9, 10, 4)).astype(np.float32)
    w = (rng.normal(size=(3, 3, 3, 4, 8)) / 10).astype(np.float32)
    xb, wt, s16 = (torch.from_numpy(x).to(torch.bfloat16),
                   torch.from_numpy(w), slope_in(torch.bfloat16))
    got = cuda_conv.conv3(xb, wt, s16)
    # the epilogue is the bf16 conv, then the bf16 activation
    assert torch.equal(got, leaky(cuda_conv.conv3(xb, wt)))
    want = np.asarray(jax_leaky(jax_conv_nd(jnp.asarray(x), jnp.asarray(w),
                                            compute_dtype=jnp.bfloat16)),
                      np.float32)
    # against JAX's ops: the f32 sums differ in order only, so a value
    # differs by at most one bf16 step, and seldom
    diff = np.abs(got.float().numpy() - want)
    step = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)
    assert np.all(diff <= step) and (diff > 0).mean() < 1e-2


def test_bf16_epilogue_follows_the_default_path_not_the_pallas_kernel():
    """Which JAX function conv3's bf16 epilogue matches: the JAX package's
    default path (fast_conv off: lax.conv in bf16, then nn.leaky_relu in
    bf16, which rounds the sum and then its product with bf16(0.3)), not
    the Pallas kernel ``_tconv3_kernel`` that fast_conv runs (LeakyReLU(0.3)
    on the f32 sums, rounded once; run here in interpret mode).  The port
    equals the default path but for the f32 summation order, and differs
    from the kernel on about half of the negative outputs, nowhere else.
    Measured: 1.2e-4 of the values differ from the default path; 0.48 of
    the negative ones and none of the others from the kernel's."""
    from transfer_em_tpu.models.blocks import leaky_relu as jax_leaky
    from transfer_em_tpu.ops.convs import conv_nd as jax_conv_nd
    from transfer_em_tpu.ops.pallas_conv import tconv3

    rng = np.random.default_rng(8)
    x = rng.normal(size=(1, 10, 10, 18, 8)).astype(np.float32)
    w = (0.3 * rng.normal(size=(3, 3, 3, 8, 8))).astype(np.float32)
    xb, wj = jnp.asarray(x).astype(jnp.bfloat16), jnp.asarray(w)
    kernel = np.asarray(tconv3(xb, wj, leaky=0.3), np.float32)
    default = np.asarray(jax_leaky(jax_conv_nd(
        xb, wj, compute_dtype=jnp.bfloat16)), np.float32)
    port = cuda_conv.conv3(
        torch.from_numpy(np.asarray(xb, np.float32)).to(torch.bfloat16),
        torch.from_numpy(w), slope_in(torch.bfloat16)).float().numpy()
    neg = default < 0
    assert (port != default).mean() < 1e-3
    assert (port != kernel)[neg].mean() > 0.3
    assert not (port != kernel)[~neg].any()
