"""The port's train step at the model's full widths (wf=1: 64-256
channels) on the CPU, held against the JAX package: the 2D CycleGAN at
74^2, B=2, dropout off, with one update a step and with accum_steps=2.
(The 3D wf=1 step costs about 2.5 TFLOPs a tile pair, too much for a
CPU test; chip_smoke.py holds it on the card against the plain
versions.)  Inputs from numpy seeds; weights redrawn with std
1/sqrt(fan-in) so that every network's gradients are O(1)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transfer_em_tpu.config import CycleGANConfig as JaxConfig
from transfer_em_tpu.train import create_state as jax_create_state
from transfer_em_tpu.train.cgan import build_models as jax_build_models
from transfer_em_tpu.train.cgan import build_step_fn as jax_build_step_fn
from transfer_em_tpu.train.cgan import cyclegan_losses as jax_losses
from transfer_em_tpu_torch.config import CycleGANConfig
from transfer_em_tpu_torch.models.convert import (TREES, load_jax_state,
                                                  params_from_jax)
from transfer_em_tpu_torch.shapes import generator_shapes
from transfer_em_tpu_torch.train import (build_step_fn, create_state,
                                         cyclegan_losses)

torch.set_num_threads(1)
BUFFER = generator_shapes(74).buffer
# each network's gradients within GRAD_TOL of its own largest |g| (the
# port's CPU bar, tests/test_torch_2d_train.py); at wf=1 they read up to
# 1.9e-4 (F), the discriminators 2e-7 to 5e-7
GRAD_TOL = 1e-3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.fixture(scope="module")
def setup():
    """The JAX 2D wf=1 state with every parameter redrawn (kernels std
    1/sqrt(fan-in), 1-D params N(0, 0.1)), two (2, 74, 74, 1) batches of
    N(0, 0.3^2) (|real - cycled| stays far below 2, where the focal CE's
    clip makes the gradient jump), and JAX's full-batch gradients and
    7-loss vector of the combined loss."""
    cfg = JaxConfig(dimsize=74, is3d=False, wf=1)
    rng = np.random.default_rng(1)

    def draw(a):
        std = 0.1 if a.ndim == 1 else float(np.prod(a.shape[:-1])) ** -0.5
        return jnp.asarray(rng.normal(0, std, a.shape).astype(np.float32))

    jstate = jax_create_state(cfg, jax.random.PRNGKey(0))
    jstate = jstate.replace(**{t: jax.tree.map(draw, getattr(jstate, t))
                               for t in TREES})
    brng = np.random.default_rng(42)
    x, y = [(0.3 * brng.normal(size=(2, 74, 74, 1))).astype(np.float32)
            for _ in range(2)]
    gen, disc_x, disc_y = jax_build_models(cfg)
    jgrads, jvec = jax.jit(jax.grad(
        lambda gg, gf, dx, dy: jax_losses(
            gen, disc_x, disc_y, BUFFER, 2.0, gg, gf, dx, dy, jnp.asarray(x),
            jnp.asarray(y), jax.random.PRNGKey(0), deterministic=True),
        argnums=(0, 1, 2, 3), has_aux=True))(
            jstate.gg, jstate.gf, jstate.dx, jstate.dy)
    grads = [{k: v.numpy() for k, v in params_from_jax(
        jax.tree.map(np.asarray, g)).items()} for g in jgrads]
    return jstate, jax.tree.map(np.asarray, jstate), x, y, grads, \
        np.asarray(jvec)


def port_state(jnp_state, accum=1):
    state = create_state(CycleGANConfig(dimsize=74, is3d=False, wf=1,
                                        accum_steps=accum), 0, device="cpu")
    load_jax_state(state, jnp_state)
    return state


def _assert_grads(nets, jgrads):
    for t, net, want in zip(TREES, nets, jgrads):
        got = {k: p.grad.numpy() for k, p in net.named_parameters()}
        assert set(got) == set(want), t
        scale = max(float(np.abs(w).max()) for w in want.values())
        assert scale > 0, t
        for k in want:
            err = float(np.abs(got[k] - want[k]).max())
            assert err <= GRAD_TOL * scale, (t, k, err, scale)


def test_wf1_2d_losses_and_gradients_match_jax(setup):
    """2D wf=1, 74^2, B=2, dropout off: the port's combined loss (plain
    versions) against JAX's, the 7-loss vector within rtol 1e-4, each
    network's gradients within GRAD_TOL of its largest |g|."""
    _, jnp_state, x, y, jgrads, jvec = setup
    state = port_state(jnp_state)
    nets = [getattr(state, t) for t in TREES]
    combined, vec = cyclegan_losses(*nets, BUFFER, 2.0, _t(x), _t(y),
                                    deterministic=True)
    combined.backward()
    np.testing.assert_allclose(vec.numpy(), jvec, rtol=1e-4)
    _assert_grads(nets, jgrads)


def test_wf1_2d_accum_steps_match_jax(setup):
    """accum_steps=2 (two microbatches of one, one update): two steps of
    the port's step against two of the JAX package's jitted step with
    accum_steps=2, each 7-loss vector within rtol 1e-4; the gradients the
    port's first step averaged and applied within GRAD_TOL of JAX's
    full-batch gradients (every loss is a per-sample mean, so the two are
    one function)."""
    jstate, jnp_state, x, y, jgrads, _ = setup
    jstep = jax.jit(jax_build_step_fn(
        JaxConfig(dimsize=74, is3d=False, wf=1, accum_steps=2),
        deterministic=True))
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    js1, jl1 = jstep(jstate, jx, jy, jax.random.PRNGKey(0))
    _, jl2 = jstep(js1, jx, jy, jax.random.PRNGKey(0))

    state = port_state(jnp_state, accum=2)
    step = build_step_fn(CycleGANConfig(dimsize=74, is3d=False, wf=1,
                                        accum_steps=2), deterministic=True)
    l1 = step(state, _t(x), _t(y), 0)
    _assert_grads([getattr(state, t) for t in TREES], jgrads)
    l2 = step(state, _t(x), _t(y), 0)
    assert state.step == 2
    np.testing.assert_allclose(l1.numpy(), np.asarray(jl1), rtol=1e-4)
    np.testing.assert_allclose(l2.numpy(), np.asarray(jl2), rtol=1e-4)
