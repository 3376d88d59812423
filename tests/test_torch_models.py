"""The port's generator against the JAX UNetGenerator (same numpy-seeded
weights and inputs), the frozen TF golden, and the weight converters."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_utils import GOLDEN_DIR, psnr
from transfer_em_tpu.models import UNetGenerator as JaxUNet
from transfer_em_tpu_torch.models import UNetGenerator
from transfer_em_tpu_torch.models.convert import (params_from_jax,
                                                  params_from_tf_order,
                                                  params_to_jax)

torch.set_num_threads(1)


def numpy_params(wf, seed):
    """A flax-shaped param tree of numpy weights, std 1/sqrt(fan-in) so
    activations stay O(1) through the net."""
    rng = np.random.default_rng(seed)
    tree = {}
    for name, p in UNetGenerator(wf=wf).state_dict().items():
        node = tree
        *path, leaf = name.split(".")
        for k in path:
            node = node.setdefault(k, {})
        fan_in = int(np.prod(p.shape[:-1]))
        node[leaf] = rng.normal(0, fan_in ** -0.5, tuple(p.shape)).astype(
            np.float32)
    return {"params": tree}


@pytest.mark.parametrize("wf,size", [(8, 42), (32, 74)])
def test_generator_matches_jax(wf, size):
    """f32, atol 1e-4 (the two frameworks sum in different orders)."""
    params = numpy_params(wf, seed=wf)
    x = np.random.default_rng(size).normal(
        0, 1, (2, size, size, size, 1)).astype(np.float32)
    want = np.asarray(jax.jit(JaxUNet(wf=wf).apply)(params, jnp.asarray(x)))

    gen = UNetGenerator(wf=wf)
    gen.load_state_dict(params_from_jax(params))
    with torch.inference_mode():
        got = gen.eval()(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    assert np.abs(want).max() > 0.05  # a meaningful signal
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def _golden():
    data = np.load(os.path.join(GOLDEN_DIR, "gen_3d.npz"))
    return data["x"], data["y"], data


def test_golden_gen_3d():
    """wf=8, 74^3 -> 40^3 against the frozen TF reference output: the
    repo's fidelity bar (PSNR >= 40 dB, allclose 1e-3)."""
    x, want, data = _golden()
    gen = UNetGenerator(wf=8)
    gen.load_state_dict(params_from_tf_order(data))
    with torch.inference_mode():
        got = gen.eval()(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)
    assert psnr(got, want) >= 40


def test_bf16_keeps_activations_bf16():
    """compute_dtype=bfloat16 casts at entry, keeps every activation bf16,
    returns float32 close to the f32 model."""
    x, want, data = _golden()
    sd = params_from_tf_order(data)
    gen = UNetGenerator(wf=8, compute_dtype="bfloat16")
    gen.load_state_dict(sd)
    seen = []
    for name, mod in gen.named_modules():
        if name and "." not in name:
            mod.register_forward_hook(
                lambda m, i, o: seen.extend(
                    t.dtype for t in (o if isinstance(o, tuple) else (o,))))
    with torch.inference_mode():
        got = gen.eval()(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    assert seen and all(d == torch.bfloat16 for d in seen)
    assert psnr(got, want) >= 40


def test_params_roundtrip_exact():
    p = numpy_params(8, seed=0)
    back = params_to_jax(params_from_jax(p))
    assert (jax.tree.structure(back) == jax.tree.structure(p))
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(p)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_tf_order_matches_flax_assign():
    """params_from_tf_order == the JAX tests' assign_weights (GEN_ORDER,
    transposed kernels swapped), read through params_from_jax."""
    from golden_utils import GEN_ORDER, assign_weights, load_golden
    from transfer_em_tpu_torch.models.convert import GEN_ORDER as PORT_ORDER

    assert PORT_ORDER == GEN_ORDER
    _, _, weights = load_golden("gen_3d")
    template = {"params": jax.tree.map(
        np.zeros_like, numpy_params(8, seed=0)["params"])}
    flax_tree = assign_weights(template, GEN_ORDER, weights)
    _, _, data = _golden()
    ours = params_from_tf_order(data)
    theirs = params_from_jax(jax.tree.map(np.asarray, flax_tree))
    assert set(ours) == set(theirs)
    for k in ours:
        assert torch.equal(ours[k], theirs[k]), k
