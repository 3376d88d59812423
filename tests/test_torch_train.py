"""The train step's parts against the JAX package, on the CPU: the conv3 and
LeakyReLU gradients, the Keras-exact Adam, the train-state conversion, and
conv3's packed-weight cache under training (optimizer updates, detached
aliases).  Inputs come from a numpy seed."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transfer_em_tpu.config import CycleGANConfig as JaxConfig
from transfer_em_tpu.ops import pallas_conv
from transfer_em_tpu.train import create_state as jax_create_state
from transfer_em_tpu.train.state import make_optimizer as jax_make_optimizer
from transfer_em_tpu_torch.config import CycleGANConfig
from transfer_em_tpu_torch.models.blocks import ConvND
from transfer_em_tpu_torch.models.convert import (TREES, load_jax_state,
                                                  state_to_jax)
from transfer_em_tpu_torch.ops import cuda_conv
from transfer_em_tpu_torch.ops.counts import read_counts
from transfer_em_tpu_torch.ops.cuda_kernels import leaky_relu
from transfer_em_tpu_torch.train import create_state, make_optimizer

torch.set_num_threads(1)


def _np(seed, shape, std=1.0):
    return np.random.default_rng(seed).normal(0, std, shape).astype(
        np.float32)


# -- conv3 and LeakyReLU gradients ------------------------------------------

@pytest.mark.parametrize("act", [False, True], ids=["conv3", "conv3_act"])
def test_conv3_backward_matches_jax_vjp(act):
    """dx, dw of conv3 / conv3_act for one cotangent against jax.vjp of the
    Pallas op (interpret mode here, as tests/test_pallas_conv.py runs it),
    whose backward is lax.conv's in f32: atol 1e-4."""
    x = _np(1, (1, 10, 10, 18, 8))
    w = _np(2, (3, 3, 3, 8, 8), 0.1)
    g = _np(3, (1, 8, 8, 16, 8))
    assert pallas_conv.supported(x.shape, w.shape)
    op = pallas_conv.tconv3_act_op if act else pallas_conv.tconv3_op
    _, vjp = jax.vjp(op, jnp.asarray(x), jnp.asarray(w))
    want_dx, want_dw = (np.asarray(a) for a in vjp(jnp.asarray(g)))

    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = (cuda_conv.conv3_act if act else cuda_conv.conv3)(xt, wt)
    y.backward(torch.from_numpy(g))
    np.testing.assert_allclose(xt.grad.numpy(), want_dx, rtol=0, atol=1e-4)
    np.testing.assert_allclose(wt.grad.numpy(), want_dw, rtol=0, atol=1e-4)


def test_conv3_backward_only_what_is_needed():
    """A detached weight (the frozen discriminators) gets no gradient and
    the input's still flows."""
    x = torch.from_numpy(_np(4, (1, 6, 6, 6, 4))).requires_grad_()
    w = torch.nn.Parameter(torch.from_numpy(_np(5, (3, 3, 3, 4, 8), 0.1)))
    cuda_conv.conv3_act(x, w.detach()).sum().backward()
    assert w.grad is None and x.grad is not None
    assert x.grad.abs().max() > 0


def test_leaky_relu_backward_matches_jax():
    """where(x >= 0, g, 0.3 g), exact zeros included (JAX's where takes
    the first branch at 0)."""
    x = _np(6, (4, 5, 6, 3))
    x.flat[:5] = 0.0
    g = _np(7, x.shape)
    want = np.asarray(jax.grad(lambda v: jnp.sum(
        jax.nn.leaky_relu(v, 0.3) * jnp.asarray(g)))(jnp.asarray(x)))
    xt = torch.from_numpy(x).requires_grad_()
    leaky_relu(xt).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), want)


# -- Keras Adam ---------------------------------------------------------------

@pytest.mark.parametrize("scale", [1.0, 3e-6], ids=["g~1", "sqrt(v)~eps"])
def test_keras_adam_matches_make_optimizer(scale):
    """Three updates from the same gradients: parameters and moments,
    rtol 1e-6.  At g ~ 3e-6, sqrt(v) is of the order of eps = 1e-7, where
    the Keras placement of eps differs from torch.optim.Adam's."""
    shapes = {"a": (5, 7), "b": (3,)}
    params = {k: _np(10 + i, s) for i, (k, s) in enumerate(shapes.items())}
    grads = [{k: _np(20 + 3 * i + j, s, scale)
              for j, (k, s) in enumerate(shapes.items())} for i in range(3)]

    jopt = jax_make_optimizer(2e-4, 0.5)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    jst = jopt.init(jp)
    opt = make_optimizer(2e-4, 0.5)
    tp = {k: torch.from_numpy(v.copy()) for k, v in params.items()}
    st = opt.init(tp)
    for g in grads:
        up, jst = jopt.update({k: jnp.asarray(v) for k, v in g.items()},
                              jst, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, up)
        opt.update(tp, {k: torch.from_numpy(v) for k, v in g.items()}, st)
        for k in shapes:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=0)
            np.testing.assert_allclose(st.mu[k].numpy(),
                                       np.asarray(jst.mu[k]), rtol=1e-6)
            np.testing.assert_allclose(st.nu[k].numpy(),
                                       np.asarray(jst.nu[k]), rtol=1e-6)
    assert st.count == int(jst.count) == 3


def test_keras_adam_is_not_torch_adam():
    """Near sqrt(v) ~ eps the two placements of eps give visibly different
    steps: the reason for KerasAdam."""
    p = torch.zeros(4)
    g = torch.full((4,), 3e-6)
    opt = make_optimizer()
    opt.update({"p": p}, {"p": g}, opt.init({"p": p}))
    q = torch.zeros(4, requires_grad=True)
    ref = torch.optim.Adam([q], lr=2e-4, betas=(0.5, 0.999), eps=1e-7)
    q.grad = g.clone()
    ref.step()
    assert not torch.allclose(p, q.detach(), rtol=1e-3)


# -- the train state ----------------------------------------------------------

def test_config_reads_the_jax_packages_json():
    """The port's CycleGANConfig reads the JAX package's JSON: the fields
    the port has keep their values (the dataset's among them), the
    JAX-only ones (which select nothing in the port) are dropped."""
    jax_cfg = JaxConfig(wf=16, focal_gamma=1.5, accum_steps=2, batch_size=8,
                        fast_conv=True, dropout_impl="ref", epoch_size=16)
    assert CycleGANConfig.from_json(jax_cfg.to_json()) == CycleGANConfig(
        wf=16, focal_gamma=1.5, accum_steps=2, batch_size=8, epoch_size=16)


def test_state_conversion_roundtrip():
    """The JAX CycleGANState (3D, wf=32; moments and counts made non-zero)
    -> the port's state -> numpy trees equal to the JAX leaves, exactly."""
    jstate = jax.tree.map(np.asarray, jax_create_state(
        JaxConfig(dimsize=74, is3d=True, wf=32), jax.random.PRNGKey(0)))
    rng = np.random.default_rng(30)
    noisy = lambda t: jax.tree.map(
        lambda a: rng.normal(0, 1, a.shape).astype(a.dtype), t)
    jstate = dataclasses.replace(
        jstate, step=np.int32(5),
        **{"opt_" + t: getattr(jstate, "opt_" + t)._replace(
            count=np.int32(5), mu=noisy(getattr(jstate, "opt_" + t).mu),
            nu=noisy(getattr(jstate, "opt_" + t).nu)) for t in TREES})

    state = create_state(CycleGANConfig(dimsize=74, wf=32), 0, device="cpu")
    load_jax_state(state, jstate)
    back = state_to_jax(state)
    assert back["step"] == 5 and state.step == 5
    for t in TREES:
        pairs = [(back[t], getattr(jstate, t))]
        jopt, bopt = getattr(jstate, "opt_" + t), back["opt_" + t]
        assert bopt["count"] == jopt.count == 5
        pairs += [(bopt["mu"], jopt.mu), (bopt["nu"], jopt.nu)]
        for mine, theirs in pairs:
            assert jax.tree.structure(mine) == jax.tree.structure(theirs)
            for a, b in zip(jax.tree.leaves(mine), jax.tree.leaves(theirs)):
                assert a.dtype == b.dtype and np.array_equal(a, b)


# -- conv3's packed-weight cache under training --------------------------------

def test_pack_cache_repacks_after_update_and_hits_aliases():
    """An optimizer update (in place under no_grad) repacks the parameter;
    a .detach() alias, as the frozen discriminators pass it, hits the
    parameter's pack.  packed_weights is plain torch, so this runs here."""
    conv = ConvND(8, 16, 3, generator=torch.Generator().manual_seed(0))
    p = conv.kernel
    assert cuda_conv.conv3_path(8, 16) == "tc"
    before = read_counts()["conv3_weight_packs"]
    p1 = cuda_conv.packed_weights(p)
    assert cuda_conv.packed_weights(p.detach()) is p1
    assert cuda_conv.packed_weights(p) is p1
    assert read_counts()["conv3_weight_packs"] == before + 1

    opt = make_optimizer()
    opt.update({"kernel": p}, {"kernel": torch.ones_like(p)},
               opt.init({"kernel": p}))
    p2 = cuda_conv.packed_weights(p.detach())
    assert p2 is not p1
    assert read_counts()["conv3_weight_packs"] == before + 2
    assert torch.equal(p2, cuda_conv.pack_conv3_weights(p.detach(),
                                                        torch.float32))
    assert cuda_conv.packed_weights(p) is p2
    assert read_counts()["conv3_weight_packs"] == before + 2
