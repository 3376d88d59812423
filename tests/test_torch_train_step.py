"""The port's 3D CycleGAN train step against the JAX package's, on the CPU at
3D, wf=32, 74^3, B=1, dropout off: the same state (the JAX state converted)
and the same numpy-seeded batches.  Tolerances: the 7-loss vector rtol 1e-4,
each network's gradients within 1e-3 of its largest |g| (float32 sums in
other orders through ~30 convs)."""

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
from transfer_em_tpu_torch.models.convert import (TREES, load_jax_state,
                                                  params_from_jax)
from transfer_em_tpu_torch.train import (build_step_fn, create_state,
                                         cyclegan_losses)

torch.set_num_threads(1)

BUFFER = generator_shapes(74).buffer
JAX_CFG = JaxConfig(dimsize=74, is3d=True, wf=32, batch_size=1)
CFG = CycleGANConfig(dimsize=74, wf=32, batch_size=1)


def redrawn(jstate, seed):
    """jstate with every network's parameters redrawn from a numpy seed:
    kernels with std 1/sqrt(fan-in), 1-D params N(0, 0.1).  The outputs and
    gradients of all four networks are then O(1); at the N(0, 0.02) init
    the discriminators' gradients sit at float32 rounding level."""
    rng = np.random.default_rng(seed)

    def draw(a):
        std = 0.1 if a.ndim == 1 else float(np.prod(a.shape[:-1])) ** -0.5
        return jnp.asarray(rng.normal(0, std, a.shape).astype(np.float32))

    return jstate.replace(**{t: jax.tree.map(draw, getattr(jstate, t))
                             for t in TREES})


def redraw_port(state, seed):
    """The same redraw for a port state, in place."""
    rng = np.random.default_rng(seed)
    with torch.no_grad():
        for t in TREES:
            for p in getattr(state, t).parameters():
                std = (0.1 if p.dim() == 1
                       else float(np.prod(p.shape[:-1])) ** -0.5)
                p.copy_(torch.from_numpy(rng.normal(0, std, tuple(
                    p.shape)).astype(np.float32)))
    return state


def batches(seed, n):
    """Two (n, 74, 74, 74, 1) image batches, N(0, 0.3^2).  The generators
    carry no bias, so their outputs scale with the input: at this scale
    |real - cycled| stays far below 2, where tconf meets the lower clip
    bound of the focal CE and the gradient jumps (by ~1/eps per voxel), so
    float32 rounding cannot move a voxel across that kink."""
    rng = np.random.default_rng(seed)
    return [(0.3 * rng.normal(size=(n, 74, 74, 74, 1))).astype(np.float32)
            for _ in range(2)]


@pytest.fixture(scope="module")
def setup():
    jstate = redrawn(jax_create_state(JAX_CFG, jax.random.PRNGKey(0)), 1)
    x, y = batches(42, 1)
    return jstate, jax.tree.map(np.asarray, jstate), x, y


def port_state(jstate_np):
    state = create_state(CFG, 0, device="cpu")
    load_jax_state(state, jstate_np)
    return state


def assert_grads_close(got, want, name):
    """got, want: {param name: array} of one network; 1e-3 * max|want|."""
    assert set(got) == set(want), name
    scale = max(float(np.abs(w).max()) for w in want.values())
    assert scale > 0, name
    for k in want:
        err = float(np.abs(got[k] - want[k]).max())
        assert err <= 1e-3 * scale, (name, k, err, scale)


def test_losses_and_gradients_match_jax(setup):
    jstate, jnp_state, x, y = setup
    gen, disc_x, disc_y = jax_build_models(JAX_CFG)
    (jgrads, jvec) = jax.jit(jax.grad(
        lambda gg, gf, dx, dy: jax_losses(
            gen, disc_x, disc_y, BUFFER, 2.0, gg, gf, dx, dy, jnp.asarray(x),
            jnp.asarray(y), jax.random.PRNGKey(0), deterministic=True),
        argnums=(0, 1, 2, 3), has_aux=True))(
            jstate.gg, jstate.gf, jstate.dx, jstate.dy)

    state = port_state(jnp_state)
    nets = [getattr(state, t) for t in TREES]
    combined, vec = cyclegan_losses(*nets, BUFFER, 2.0, torch.from_numpy(x),
                                    torch.from_numpy(y), deterministic=True)
    combined.backward()
    v = np.asarray(jvec)
    np.testing.assert_allclose(vec.numpy(), v, rtol=1e-4)
    # combined = both generator totals (the cycle counted once) + both
    # discriminator losses
    assert float(combined.detach()) == pytest.approx(v[0] + v[1] - v[6] + v[2] + v[3],
                                            rel=1e-5)
    for t, net, jg in zip(TREES, nets, jgrads):
        want = {k: v.numpy() for k, v in params_from_jax(
            jax.tree.map(np.asarray, jg)).items()}
        got = {k: p.grad.numpy() for k, p in net.named_parameters()}
        assert_grads_close(got, want, t)


def test_two_steps_match_jax(setup):
    """Step 1's and step 2's loss vectors (step 2 after one Keras-Adam
    update of all four networks): rtol 1e-4."""
    jstate, jnp_state, x, y = setup
    jstep = jax.jit(jax_build_step_fn(JAX_CFG, deterministic=True))
    jx, jy = jnp.asarray(x), jnp.asarray(y)
    js1, jl1 = jstep(jstate, jx, jy, jax.random.PRNGKey(0))
    _, jl2 = jstep(js1, jx, jy, jax.random.PRNGKey(0))

    state = port_state(jnp_state)
    step = build_step_fn(CFG, deterministic=True)
    tx, ty = torch.from_numpy(x), torch.from_numpy(y)
    l1 = step(state, tx, ty, 0)
    l2 = step(state, tx, ty, 0)
    assert state.step == 2 and state.opt_gg.count == 2
    np.testing.assert_allclose(l1.numpy(), np.asarray(jl1), rtol=1e-4)
    np.testing.assert_allclose(l2.numpy(), np.asarray(jl2), rtol=1e-4)
    assert not np.allclose(l1.numpy(), l2.numpy(), rtol=1e-7, atol=0)
