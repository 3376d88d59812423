"""The port's 3D discriminator, InstanceNorm and dropout against the JAX
package (same numpy-seeded weights and inputs) and the frozen TF golden."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_utils import GOLDEN_DIR, psnr
from transfer_em_tpu.models import Discriminator as JaxDisc
from transfer_em_tpu.models import UNetGenerator as JaxUNet
from transfer_em_tpu.models.blocks import InstanceNorm as JaxNorm
from transfer_em_tpu.train.cgan import _tap_prior as jax_tap_prior
from transfer_em_tpu_torch.models import Discriminator, UNetGenerator
from transfer_em_tpu_torch.models.blocks import (InstanceNorm, UpBlock,
                                                 dropout_half)
from transfer_em_tpu_torch.models.convert import (DISC_ORDER_3D,
                                                  params_from_jax,
                                                  params_from_tf_order)
from transfer_em_tpu_torch.train.cgan import _tap_prior

torch.set_num_threads(1)


def numpy_tree(module, seed):
    """A flax-shaped param tree for ``module``'s state_dict: kernels with
    std 1/sqrt(fan-in) (activations stay O(1)), 1-D params N(0, 0.1)."""
    rng = np.random.default_rng(seed)
    tree = {}
    for name, p in module.state_dict().items():
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        std = (0.1 if p.dim() == 1
               else float(np.prod(p.shape[:-1])) ** -0.5)
        node[leaf] = rng.normal(0, std, tuple(p.shape)).astype(np.float32)
    return {"params": tree}


def _port(module, params):
    module.load_state_dict(params_from_jax(params))
    return module.eval()


def _input(seed, shape):
    return np.random.default_rng(seed).normal(0, 1, shape).astype(np.float32)


def test_discriminator_matches_jax():
    """40^3, wf=8, f32: atol 1e-4."""
    disc = Discriminator(wf=8)
    params = numpy_tree(disc, seed=1)
    x = _input(2, (2, 40, 40, 40, 1))
    want = np.asarray(jax.jit(JaxDisc(is3d=True, wf=8).apply)(
        params, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(disc, params)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 1, 1, 1, 1)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_discriminator_with_prior_matches_jax():
    """disc_prior: a wf=8 generator tapped at down2 (6^3 x 16 on a 40^3
    input), concatenated before down3 (discriminator.py:67-69)."""
    gen = UNetGenerator(wf=8)
    gparams = numpy_tree(gen, seed=3)
    prior = _tap_prior(_port(gen, gparams), "down2")
    assert prior.channels == 16
    disc = Discriminator(wf=8, disc_prior=prior, prior_channels=16)
    params = numpy_tree(disc, seed=4)
    assert params["params"]["down3"]["conv"]["kernel"].shape == (
        3, 3, 3, 32 + 16, 32)
    jprior = jax_tap_prior(JaxUNet(wf=8), gparams, "down2")
    x = _input(5, (2, 40, 40, 40, 1))
    want = np.asarray(JaxDisc(is3d=True, wf=8, disc_prior=jprior).apply(
        params, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(disc, params)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_disc_golden_3d():
    """wf=8, 40^3 against the frozen TF reference output (the JAX
    package's bar: allclose 1e-3 and PSNR >= 40 dB)."""
    data = np.load(os.path.join(GOLDEN_DIR, "disc_3d.npz"))
    disc = Discriminator(wf=8)
    disc.load_state_dict(params_from_tf_order(data, DISC_ORDER_3D))
    with torch.no_grad():
        got = disc.eval()(torch.from_numpy(data["x"])).numpy()
    np.testing.assert_allclose(got, data["y"], atol=1e-3, rtol=1e-3)
    assert psnr(got, data["y"]) >= 40


def test_instance_norm_matches_jax():
    norm = InstanceNorm(6)
    params = numpy_tree(norm, seed=6)
    x = _input(7, (2, 5, 6, 7, 6)) * 3 + 1
    want = np.asarray(JaxNorm().apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(norm, params)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_generator_use_norm_matches_jax():
    """use_norm puts InstanceNorm in down2, up1 and up0 (as the JAX
    module): wf=32, 74^3, atol 1e-4."""
    gen = UNetGenerator(wf=32, use_norm=True)
    params = numpy_tree(gen, seed=8)
    assert "norm2" in params["params"]["down2"]
    assert "norm1" in params["params"]["up0"]
    x = _input(9, (1, 74, 74, 74, 1))
    want = np.asarray(jax.jit(JaxUNet(wf=32, use_norm=True).apply)(
        params, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(gen, params)(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_dropout_mask_statistics():
    """Bernoulli(0.5) keep mask, kept values x2 (1/keep)."""
    y = torch.ones(1_000_000)
    out = dropout_half(y, torch.Generator().manual_seed(0))
    assert set(torch.unique(out).tolist()) == {0.0, 2.0}
    assert abs((out > 0).float().mean().item() - 0.5) < 0.01
    assert abs(out.mean().item() - 1.0) < 0.02
    other = dropout_half(y, torch.Generator().manual_seed(1))
    assert not torch.equal(out, other)
    again = dropout_half(y, torch.Generator().manual_seed(0))
    assert torch.equal(out, again)


def test_dropout_identity_when_deterministic():
    block = UpBlock(8, 4, generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_input(10, (1, 7, 7, 7, 8)))
    with torch.no_grad():
        a = block(x)
        b = block(x, deterministic=True,
                  dropout_generator=torch.Generator().manual_seed(1))
        c = block(x, deterministic=False,
                  dropout_generator=torch.Generator().manual_seed(1))
    assert torch.equal(a, b) and not torch.equal(a, c)
    with pytest.raises(ValueError, match="dropout_generator"):
        block(x, deterministic=False)
