"""The port's normalization, warp and augmentation against the JAX package,
on the CPU.  Inputs come from numpy seeds; each test states its tolerance."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transfer_em_tpu.ops import normalize as jnorm
from transfer_em_tpu.ops import warp as jwarp
from transfer_em_tpu.ops.augment import augment as jax_augment
from transfer_em_tpu.ops.convs import conv_nd as jax_conv_nd
from transfer_em_tpu_torch.ops import normalize
from transfer_em_tpu_torch.ops.augment import (apply_augment, augment,
                                               augment_params, batch_augment)
from transfer_em_tpu_torch.ops.convs import conv_nd
from transfer_em_tpu_torch.ops.warp import (HOLE_RATE, _box_filter,
                                            batch_warp, hole_mask,
                                            make_warp_map, warp,
                                            warp_with_mask)

torch.set_num_threads(1)


def _u8(seed, shape, lo=0, hi=256):
    return np.random.default_rng(seed).integers(lo, hi, shape, dtype=np.uint8)


# -- normalization ------------------------------------------------------------

def test_scale_standardize_unscale_match_jax():
    """scale_tensor and standardize_population to 1e-6 relative (atol
    1e-7 near 0); unstandardize inverts; unscale_to_uint8 exact."""
    x = _u8(0, (3, 9, 10, 11))
    want = np.asarray(jnorm.scale_tensor(jnp.asarray(x)))
    got = normalize.scale_tensor(torch.from_numpy(x))
    assert got.shape == want.shape == (3, 9, 10, 11, 1)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)

    ms = (0.0731, 0.5212)
    want_s = np.asarray(jnorm.standardize_population(jnp.asarray(want), ms))
    got_s = normalize.standardize_population(got, ms)
    np.testing.assert_allclose(got_s.numpy(), want_s, rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        normalize.unstandardize_population(got_s, ms).numpy(), want,
        rtol=0, atol=1e-6)

    y = np.random.default_rng(1).uniform(-1.2, 1.2, (500,)).astype(np.float32)
    y[:4] = [-1.0, 1.0, 1 / 127.5 - 1.0, 0.5 / 127.5 - 1.0]  # .5 tie
    np.testing.assert_array_equal(
        normalize.unscale_to_uint8(torch.from_numpy(y)).numpy(),
        np.asarray(jnorm.unscale_to_uint8(jnp.asarray(y))))


def _meanstd64(els):
    """get_meanstd's definition in float64 over the float32 scaled
    elements."""
    xs = [(e.astype(np.float32) / np.float32(127.5) - np.float32(1.0))
          .astype(np.float64) for e in els]
    return (np.mean([x.mean() for x in xs]),
            np.sqrt(np.mean([x.var() for x in xs])))


def test_get_meanstd_matches_jax():
    """Mean of the element means, sqrt of the mean of the element variances
    (not the pooled std): to 1e-6 relative of the definition in float64.
    Against the JAX package to 5e-5 relative: its float32 jnp.mean on the
    CPU sums in order and is itself off by up to ~1.3e-5 relative at 20^3
    (torch's cascade sum by ~1e-7).  Elements of differing spread make the
    pooled std differ."""
    els = [_u8(10 + i, (20, 20, 20), lo=40 * i, hi=100 + 30 * i)
           for i in range(4)]
    want = jnorm.get_meanstd(jnorm.scale_tensor(jnp.asarray(e)) for e in els)
    got = normalize.get_meanstd(
        normalize.scale_tensor(torch.from_numpy(e)) for e in els)
    np.testing.assert_allclose(got, _meanstd64(els), rtol=1e-6)
    np.testing.assert_allclose(got, want, rtol=5e-5)
    pooled = float(np.std(np.stack([e / 127.5 - 1 for e in els])))
    assert abs(got[1] - pooled) > 1e-3
    with pytest.raises(ValueError, match="empty"):
        normalize.get_meanstd([])


# -- warp ---------------------------------------------------------------------

def _jax_warp_with_mask(x, mask):
    """The warp's deterministic part composed from the JAX package's
    conv_nd SAME and _box_filter (ops/warp.py:45-59)."""
    xb = jax_conv_nd(x[None], jwarp._box_filter(3, 3, True), padding="SAME")
    holes = jax_conv_nd(mask[None], jwarp._box_filter(3, 4, False),
                        padding="SAME")
    return jnp.where(holes > 0, jnp.mean(xb), xb)[0], holes[0]


def test_warp_deterministic_part_matches_jax():
    """Given the same hole mask: blur, dilation and fill to 1e-6; the
    dilated mask exactly, holes planted at the low and high faces so the
    even kernel's (1, 2) SAME padding is pinned (a (2, 1) padding would
    move every dilated block by one voxel)."""
    x = (_u8(20, (14, 15, 16)).astype(np.float32) / 127.5 - 1)[..., None]
    mask = np.zeros((14, 15, 16, 1), np.float32)
    for z, y, w in [(0, 0, 0), (13, 14, 15), (0, 7, 15), (6, 14, 0),
                    (7, 3, 9)]:
        mask[z, y, w] = 1.0
    want, want_holes = _jax_warp_with_mask(jnp.asarray(x), jnp.asarray(mask))

    xt, mt = torch.from_numpy(x), torch.from_numpy(mask)
    holes = conv_nd(mt[None], _box_filter(4, False, "cpu"), padding="SAME")[0]
    np.testing.assert_array_equal(holes.numpy(), np.asarray(want_holes))
    got = warp_with_mask(xt[None], mt[None])[0]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    # the hole at the origin dilates over [0, 1] per axis: lo pad 1 (the
    # window reaches 1 back, 2 forward), so voxel 2 is outside
    assert holes[1, 1, 1, 0] > 0 and holes[2, 0, 0, 0] == 0


def test_warp_is_a_pure_function_of_its_key():
    """Same key, same warp; other keys, other holes; batch_warp's element i
    is warp with derive_seed(key, i) (to 1e-6: the batched conv may round
    differently from the single one); make_warp_map mixes its seed in."""
    from transfer_em_tpu_torch.rng import derive_seed

    x = torch.from_numpy(
        (_u8(21, (2, 24, 24, 24)).astype(np.float32) / 127.5 - 1)[..., None])
    a, b, c = warp(x[0], 5), warp(x[0], 5), warp(x[0], 6)
    assert torch.equal(a, b) and not torch.equal(a, c)
    bw = batch_warp(x, 9)
    for i in range(2):
        torch.testing.assert_close(bw[i], warp(x[i], derive_seed(9, i)),
                                   rtol=0, atol=1e-6)
    m = make_warp_map(3)
    assert torch.equal(m(x[0], 4), warp(x[0], derive_seed(3, 4)))
    assert not torch.equal(m(x[0], 4), make_warp_map(2)(x[0], 4))


def test_warp_statistics_match_jax():
    """Over 200 draws at 24^3: the hole seeds' rate within 15% of
    HOLE_RATE and the dilated hole fraction within 15% of the JAX warp's
    (each has ~3% relative standard error here); the filled value is the
    blurred element's mean."""
    shape, n = (24, 24, 24, 1), 200
    seeds, frac = 0.0, 0.0
    for i in range(n):
        m = hole_mask(shape, 1000 + i, "cpu")
        seeds += float(m.mean())
        d = conv_nd(m[None], _box_filter(4, False, "cpu"), padding="SAME")
        frac += float((d > 0).float().mean())
    seeds, frac = seeds / n, frac / n

    @jax.jit
    def jax_frac(key):
        u = jax.random.uniform(key, (1,) + shape)
        mask = (u < jwarp.HOLE_RATE).astype(jnp.float32)
        d = jax_conv_nd(mask, jwarp._box_filter(3, 4, False), padding="SAME")
        return jnp.mean((d > 0).astype(jnp.float32))

    keys = jax.random.split(jax.random.PRNGKey(0), n)
    jfrac = float(np.mean([float(jax_frac(k)) for k in keys]))
    assert HOLE_RATE == jwarp.HOLE_RATE
    assert abs(seeds / HOLE_RATE - 1) < 0.15, seeds
    assert abs(frac / jfrac - 1) < 0.15, (frac, jfrac)

    x = torch.full((1,) + shape, 0.25)
    x[0, :12] = -0.5
    mask = torch.zeros_like(x)
    mask[0, 5, 5, 5, 0] = 1
    got = warp_with_mask(x, mask)
    blurred_mean = conv_nd(x, _box_filter(3, True, "cpu"),
                           padding="SAME").mean()
    assert torch.allclose(got[0, 5, 5, 5], blurred_mean, atol=1e-7)
    assert not torch.allclose(blurred_mean, x.mean())


# -- augment ------------------------------------------------------------------

PERMS = list(itertools.permutations(range(3)))
FLIPS = list(itertools.product([False, True], repeat=3))


@pytest.mark.parametrize("flips", FLIPS, ids=lambda f: "".join(
    "f" if v else "-" for v in f))
@pytest.mark.parametrize("perm", range(len(PERMS)),
                         ids=lambda i: str(PERMS[i]))
def test_augment_matches_jax_composition(perm, flips):
    """Each permutation index x flip pattern, with a jitter, against
    jnp.transpose then jnp.flip of the transposed axes then x * v + m
    (ops/augment.py:36-47): exact."""
    x = np.random.default_rng(30).normal(size=(4, 5, 6, 1)).astype(np.float32)
    v, m = np.float32(1.0312), np.float32(-0.0271)
    want = jnp.transpose(jnp.asarray(x), PERMS[perm] + (3,))
    for d in range(3):
        if flips[d]:
            want = jnp.flip(want, axis=d)
    want = want * v + m
    got = apply_augment(torch.from_numpy(x), (perm, flips, float(m), float(v)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_augment_draw_statistics_match_jax():
    """Over 400 draws: the jitter inside U(1, 1.05) x U(-0.05, 0.05), each
    mean within 0.005 of the JAX augment's (standard error ~0.0007), every
    permutation index and flip drawn with frequency within 0.08 of JAX's;
    augment and batch_augment are pure functions of their keys."""
    n = 400
    params = [augment_params(k, 3) for k in range(n)]
    var = np.array([p[3] for p in params])
    mean = np.array([p[2] for p in params])
    assert var.min() >= 1.0 and var.max() <= 1.05
    assert mean.min() >= -0.05 and mean.max() <= 0.05

    # the JAX augment of a constant 1 element: x * var + mean = var + mean;
    # of a zero element: mean
    one = jnp.ones((2, 2, 2, 1), jnp.float32)
    jaug = jax.jit(jax.vmap(jax_augment))
    keys = jax.random.split(jax.random.PRNGKey(1), n)
    jmean = np.asarray(jaug(jnp.zeros_like(one)[None].repeat(n, 0), keys))
    jmean = jmean.reshape(n, -1)[:, 0]
    jvar = np.asarray(jaug(one[None].repeat(n, 0), keys)).reshape(n, -1)[:, 0]
    jvar = jvar - jmean
    assert abs(var.mean() - jvar.mean()) < 0.005
    assert abs(mean.mean() - jmean.mean()) < 0.005

    idx = np.bincount([p[0] for p in params], minlength=6) / n
    flips = np.mean([p[1] for p in params], axis=0)
    jidx, jflips = [], []
    for k in keys:
        k_perm, k_flip, _, _ = jax.random.split(k, 4)
        jidx.append(int(jax.random.randint(k_perm, (), 0, 6)))
        jflips.append(np.asarray(jax.random.uniform(k_flip, (3,)) < 0.5))
    jidx = np.bincount(jidx, minlength=6) / n
    assert np.all(np.abs(idx - jidx) < 0.08), (idx, jidx)
    assert np.all(np.abs(flips - np.mean(jflips, axis=0)) < 0.08)

    x = torch.from_numpy(np.random.default_rng(31).normal(
        size=(2, 6, 6, 6, 1)).astype(np.float32))
    from transfer_em_tpu_torch.rng import derive_seed
    b = batch_augment(x, 7)
    for i in range(2):
        assert torch.equal(b[i], augment(x[i], derive_seed(7, i)))
    assert torch.equal(batch_augment(x, 7), b)
