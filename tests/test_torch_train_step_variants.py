"""Variants of the port's train step on the CPU at 3D, wf=32, 74^3, dropout
off: gradient accumulation, the reference's six separate generator
applications, the disc_prior's gradient routing (against the JAX package),
and the dropout masks' seeding."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from transfer_em_tpu.config import CycleGANConfig as JaxConfig
from transfer_em_tpu.models import UNetGenerator as JaxUNet
from transfer_em_tpu.shapes import generator_shapes
from transfer_em_tpu.train import create_state as jax_create_state
from transfer_em_tpu.train.cgan import _tap_prior as jax_tap_prior
from transfer_em_tpu.train.cgan import build_models as jax_build_models
from transfer_em_tpu.train.cgan import cyclegan_losses as jax_losses
from transfer_em_tpu_torch.config import CycleGANConfig
from transfer_em_tpu_torch.models import UNetGenerator
from transfer_em_tpu_torch.models.convert import (TREES, load_jax_state,
                                                  params_from_jax)
from transfer_em_tpu_torch.train import (build_step_fn, create_state,
                                         cyclegan_losses)
from transfer_em_tpu_torch.train.cgan import _tap_prior
from test_torch_train_step import (assert_grads_close, batches, redraw_port,
                                   redrawn)

torch.set_num_threads(1)

BUFFER = generator_shapes(74).buffer
CFG = CycleGANConfig(dimsize=74, wf=32, batch_size=2)


def _batches(seed, n):
    return [torch.from_numpy(b) for b in batches(seed, n)]


def _params(state):
    return [p.detach().clone() for t in TREES
            for p in getattr(state, t).parameters()]


def test_accum_steps_equals_full_batch():
    """accum_steps=2 at B=2 (two microbatches of 1, one update) == the
    full-batch step: losses rtol 2e-5, updated parameters rtol 1e-4, atol
    1e-5 (a gradient at rounding level can flip through Adam's eps)."""
    x, y = _batches(1, 2)
    full, acc = (redraw_port(create_state(CFG, 0, "cpu"), 1)
                 for _ in range(2))
    l_full = build_step_fn(CFG, deterministic=True)(full, x, y, 0)
    l_acc = build_step_fn(dataclasses.replace(CFG, accum_steps=2),
                          deterministic=True)(acc, x, y, 0)
    np.testing.assert_allclose(l_acc.numpy(), l_full.numpy(), rtol=2e-5,
                               atol=2e-6)
    for a, b in zip(_params(acc), _params(full)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4,
                                   atol=1e-5)


def test_batched_apps_equals_separate_apps():
    """Round 1 at 2B and round 2 (batched_apps) == the reference's six
    separate generator applications: losses and every gradient."""
    x, y = _batches(2, 1)
    out = []
    for batched in (True, False):
        state = redraw_port(create_state(CFG, 0, "cpu"), 2)
        nets = [getattr(state, t) for t in TREES]
        combined, vec = cyclegan_losses(*nets, BUFFER, 2.0, x, y,
                                        batched_apps=batched,
                                        deterministic=True)
        combined.backward()
        out.append((vec, [{k: p.grad.numpy() for k, p in
                           n.named_parameters()} for n in nets]))
    (vb, gb), (vs, gs) = out
    np.testing.assert_allclose(vb.numpy(), vs.numpy(), rtol=1e-5, atol=1e-7)
    for t, a, b in zip(TREES, gb, gs):
        assert_grads_close(a, b, t)


def test_prior_frozen_weights_and_input_gradient():
    """disc_y with a prior (a wf=32 generator tapped at down2): the losses
    and all four networks' gradients match JAX's _tap_prior routing (the
    prior's weights frozen, its input gradient flowing); the prior's own
    parameters get no gradient; and cutting the prior's input gradient
    changes G's gradient, so the path is really there."""
    rng = np.random.default_rng(3)
    pgen = UNetGenerator(wf=32)
    gparams = {"params": {}}
    for name, p in pgen.state_dict().items():
        node = gparams["params"]
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        node[leaf] = rng.normal(0, float(np.prod(p.shape[:-1])) ** -0.5,
                                tuple(p.shape)).astype(np.float32)
    pgen.load_state_dict(params_from_jax(gparams))
    prior = _tap_prior(pgen, "down2")
    jprior = jax_tap_prior(JaxUNet(wf=32), gparams, "down2")

    jcfg = JaxConfig(dimsize=74, is3d=True, wf=32)
    jstate = redrawn(jax_create_state(jcfg, jax.random.PRNGKey(1),
                                      disc_prior=jprior), 5)
    x, y = (t.numpy() for t in _batches(4, 1))
    gen, disc_x, disc_y = jax_build_models(jcfg, disc_prior=jprior)
    jgrads, jvec = jax.jit(jax.grad(
        lambda gg, gf, dx, dy: jax_losses(
            gen, disc_x, disc_y, BUFFER, 2.0, gg, gf, dx, dy, jnp.asarray(x),
            jnp.asarray(y), jax.random.PRNGKey(0), deterministic=True),
        argnums=(0, 1, 2, 3), has_aux=True))(
            jstate.gg, jstate.gf, jstate.dx, jstate.dy)

    state = create_state(CFG, 0, "cpu", disc_prior=prior)
    load_jax_state(state, jax.tree.map(np.asarray, jstate))

    def grads(dy_prior):
        state.dy.disc_prior = dy_prior
        nets = [getattr(state, t) for t in TREES]
        for n in nets:
            n.zero_grad(set_to_none=True)
        combined, vec = cyclegan_losses(*nets, BUFFER, 2.0,
                                        torch.from_numpy(x),
                                        torch.from_numpy(y),
                                        deterministic=True)
        combined.backward()
        return vec, [{k: p.grad.numpy().copy() for k, p in
                      n.named_parameters()} for n in nets]

    vec, got = grads(prior)
    np.testing.assert_allclose(vec.numpy(), np.asarray(jvec), rtol=1e-4)
    for t, g, jg in zip(TREES, got, jgrads):
        want = {k: v.numpy() for k, v in params_from_jax(
            jax.tree.map(np.asarray, jg)).items()}
        assert_grads_close(g, want, t)
    assert all(p.grad is None for p in pgen.parameters())

    def cut(x_):
        return prior(x_).detach()

    cut.channels = prior.channels
    _, no_flow = grads(cut)
    gg_diff = max(float(np.abs(got[0][k] - no_flow[0][k]).max())
                  for k in got[0])
    scale = max(float(np.abs(v).max()) for v in got[0].values())
    assert gg_diff > 1e-3 * scale
    for k in got[3]:  # dy's own gradient does not pass through its input
        np.testing.assert_array_equal(got[3][k], no_flow[3][k])


def test_dropout_masks_follow_seed_and_step():
    """With dropout on, the same (seed, step) gives the same losses, and
    another seed other masks."""
    x, y = _batches(5, 1)
    step = build_step_fn(CFG)
    runs = {}
    for name, seed in (("a", 0), ("b", 0), ("c", 1)):
        state = redraw_port(create_state(CFG, 0, "cpu"), 6)
        runs[name] = step(state, x, y, seed)
    assert torch.equal(runs["a"], runs["b"])
    assert not torch.equal(runs["a"], runs["c"])
