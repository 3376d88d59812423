"""The port's CycleGAN losses against transfer_em_tpu.ops.losses: values and
gradients (jax.grad against autograd) on the same numpy-seeded inputs,
rtol 1e-6 (float32; the two frameworks reduce in different orders)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transfer_em_tpu.ops import losses as JL
from transfer_em_tpu_torch.ops import losses as TL

torch.set_num_threads(1)
RTOL = 1e-6


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=RTOL,
                               atol=1e-7 * max(1.0, float(np.abs(want).max())))


def _check(jfn, tfn, *arrays):
    """Value and the gradient w.r.t. every argument."""
    jargs = [jnp.asarray(a) for a in arrays]
    targs = [torch.from_numpy(a.copy()).requires_grad_() for a in arrays]
    want, jgrads = jax.value_and_grad(jfn, argnums=tuple(
        range(len(arrays))))(*jargs)
    got = tfn(*targs)
    got.backward()
    _close(got.detach().numpy(), want)
    for t, g in zip(targs, jgrads):
        _close(t.grad.numpy(), g)


def _logits(seed, shape=(3, 5, 4, 6, 1), scale=3.0):
    return (np.random.default_rng(seed).normal(0, scale, shape)
            .astype(np.float32))


@pytest.mark.parametrize("gamma", [2.0, 0.5])
def test_focal_logit_branch(gamma):
    rng = np.random.default_rng(1)
    labels = (rng.random((3, 5, 4, 6, 2)) > 0.5).astype(np.float32)
    preds = _logits(2, labels.shape)
    preds.flat[:3] = 0.0  # ties of max(x, 0) and |x|
    _check(lambda p: JL.sigmoid_focal_ce(jnp.asarray(labels), p, gamma=gamma),
           lambda p: TL.sigmoid_focal_ce(torch.from_numpy(labels), p,
                                         gamma=gamma), preds)


def test_focal_probability_branch_out_of_range():
    """Probabilities inside (0, 1), on the clip bounds and outside [0, 1]:
    the CE term sees the clipped values, p_t the raw ones."""
    rng = np.random.default_rng(3)
    preds = rng.uniform(-0.5, 1.5, (2, 6, 5, 4, 1)).astype(np.float32)
    preds.flat[:4] = [np.float32(1e-7), np.float32(1 - 1e-7), 0.0, 1.0]
    labels = np.ones_like(preds)
    labels[0] = 0.0
    _check(lambda p: JL.sigmoid_focal_ce(jnp.asarray(labels), p,
                                         from_logits=False),
           lambda p: TL.sigmoid_focal_ce(torch.from_numpy(labels), p,
                                         from_logits=False), preds)


def test_generator_adv_loss():
    _check(lambda d: JL.generator_adv_loss(d),
           lambda d: TL.generator_adv_loss(d), _logits(4))


def test_discriminator_loss():
    _check(lambda r, f: JL.discriminator_loss(r, f, gamma=2.0),
           lambda r, f: TL.discriminator_loss(r, f, gamma=2.0),
           _logits(5), _logits(6))


@pytest.mark.parametrize("name", ["cycle_loss", "identity_loss"])
def test_tconf_losses(name):
    """Images in [-1, 1] and beyond it (a diverged generator), so tconf
    leaves [0, 1] for some voxels."""
    rng = np.random.default_rng(7)
    real = np.clip(rng.normal(0, 0.6, (2, 8, 8, 8, 1)), -1, 1).astype(
        np.float32)
    other = rng.normal(0, 1.5, real.shape).astype(np.float32)
    other.flat[:2] = real.flat[:2]  # tconf exactly 1
    _check(lambda a, b: getattr(JL, name)(a, b, gamma=2.0),
           lambda a, b: getattr(TL, name)(a, b, gamma=2.0), real, other)
