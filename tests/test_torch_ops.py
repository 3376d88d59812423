"""The port's kernel modules (plain PyTorch versions, CPU) against the JAX
package: normalize / pallas_kernels (interpret mode off the TPU), conv_nd,
conv_transpose_nd and pallas_conv.tconv3 (interpret mode).

Inputs come from a numpy seed and go through both packages unchanged.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transfer_em_tpu.ops import convs as jconvs
from transfer_em_tpu.ops import normalize as jnorm
from transfer_em_tpu.ops import pallas_kernels as pk
from transfer_em_tpu.ops.pallas_conv import tconv3
from transfer_em_tpu_torch.ops import convs, cuda_conv, cuda_kernels

torch.set_num_threads(1)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


@pytest.mark.parametrize("meanstd", [(0.17, 0.83), None])
def test_preprocess_matches_jax(meanstd):
    rng = np.random.default_rng(1)
    x = rng.integers(0, 256, size=(3, 33, 41), dtype=np.uint8)
    got = cuda_kernels.preprocess_u8(_t(x), meanstd).numpy()
    assert got.shape == (3, 33, 41, 1) and got.dtype == np.float32
    for want in (jnorm.preprocess_u8(jnp.asarray(x), meanstd),
                 pk.preprocess_u8(jnp.asarray(x), meanstd)):
        np.testing.assert_allclose(got, np.asarray(want), rtol=0, atol=1e-6)


def _tie_voxels(y, meanstd, tpad):
    """Voxels whose scaled value lies within 1e-6 of a .5 tie (float64):
    float32 rounding order may move these by one level."""
    y = np.asarray(y, np.float64)
    if tpad:
        t = slice(tpad, -tpad)
        y = y[:, t, t, t]
    y = y[..., 0]
    if meanstd is not None:
        y = y * meanstd[1] + meanstd[0]
    z = (y + 1.0) * 127.5
    return np.abs(z - np.floor(z) - 0.5) < 1e-6


@pytest.mark.parametrize("meanstd,tpad", [((0.05, 1.2), 0), (None, 0),
                                          ((0.05, 1.2), 2)])
def test_postprocess_matches_jax(meanstd, tpad):
    """Exact against the main path's order (normalize.py:94-102), except
    documented tie voxels; the tpad trim is read in place."""
    rng = np.random.default_rng(2)
    y = rng.normal(size=(2, 40, 40, 40, 1)).astype(np.float32)
    y[0, 5, 5, 5:9, 0] = [-1.0, 1.0, 3.0, -5.0]  # clip edges and exact levels
    got = cuda_kernels.postprocess_u8(_t(y), meanstd, tpad).numpy()
    ys = y[:, tpad:40 - tpad, tpad:40 - tpad, tpad:40 - tpad]
    want = np.asarray(jnorm.postprocess_to_u8(jnp.asarray(ys), meanstd))[..., 0]
    assert got.shape == want.shape and got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    ties = _tie_voxels(y, meanstd, tpad)
    assert diff[~ties].max() == 0
    assert diff.max() <= 1
    if tpad == 0:  # the Pallas kernel (folded affine): at most one level off
        pw = np.asarray(pk.postprocess_u8(jnp.asarray(y), meanstd))[..., 0]
        d = np.abs(got.astype(int) - pw.astype(int))
        assert d.max() <= 1 and (d > 0).mean() < 1e-3


def test_leaky_relu_matches_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(size=(11, 130)).astype(np.float32)
    got = cuda_kernels.leaky_relu(_t(x)).numpy()
    want = np.asarray(pk.leaky_relu_kernel_call(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-7)
    # bf16: computed in f32, rounded once, dtype kept
    xb = _t(x).to(torch.bfloat16)
    gb = cuda_kernels.leaky_relu(xb)
    assert gb.dtype == torch.bfloat16
    ref = torch.where(xb.float() >= 0, xb.float(), xb.float() * 0.3)
    assert torch.equal(gb, ref.to(torch.bfloat16))


@pytest.mark.parametrize("leaky", [None, 0.3])
def test_conv3_f32_matches_conv_nd(leaky):
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 10, 11, 12, 8)).astype(np.float32)
    w = rng.normal(0, 0.1, (3, 3, 3, 8, 16)).astype(np.float32)
    got = cuda_conv.conv3(_t(x), _t(w), leaky=leaky).numpy()
    want = np.asarray(jconvs.conv_nd(jnp.asarray(x), jnp.asarray(w)))
    if leaky is not None:
        want = np.where(want >= 0, want, want * leaky)
    assert got.shape == (2, 8, 9, 10, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("leaky", [-1.0, 0.3])
def test_conv3_bf16_matches_tconv3(leaky):
    """bf16 in, f32 sums, bf16 out, against the Pallas kernel in interpret
    mode at the bar of tests/test_pallas_conv.py (rel 1e-2)."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (1, 18, 18, 18, 8)).astype(np.float32)
    w = rng.normal(0, 0.1, (3, 3, 3, 8, 8)).astype(np.float32)
    got = cuda_conv.conv3(_t(x).to(torch.bfloat16), _t(w).to(torch.bfloat16),
                          leaky=None if leaky < 0 else leaky)
    assert got.dtype == torch.bfloat16
    got = got.float().numpy()
    want = np.asarray(tconv3(jnp.asarray(x), jnp.asarray(w), leaky=leaky),
                      np.float32)
    assert got.shape == want.shape == (1, 16, 16, 16, 8)
    rel = np.max(np.abs(got - want)) / np.max(np.abs(want))
    assert rel < 1e-2, rel


def test_conv3_act_is_conv3_with_epilogue():
    rng = np.random.default_rng(6)
    x = _t(rng.normal(0, 1, (1, 6, 6, 6, 2)).astype(np.float32))
    w = _t(rng.normal(0, 0.3, (3, 3, 3, 2, 4)).astype(np.float32))
    assert torch.equal(cuda_conv.conv3_act(x, w),
                       cuda_conv.conv3(x, w, leaky=0.3))


def test_down_conv_matches_conv_nd():
    """k4 stride-2 VALID conv: pins the DHWIO -> OIDHW weight layout."""
    rng = np.random.default_rng(7)
    x = rng.normal(0, 1, (2, 10, 11, 12, 8)).astype(np.float32)
    w = rng.normal(0, 0.1, (4, 4, 4, 8, 16)).astype(np.float32)
    got = convs.conv_nd(_t(x), _t(w), stride=2).numpy()
    want = np.asarray(jconvs.conv_nd(jnp.asarray(x), jnp.asarray(w),
                                     stride=2))
    assert got.shape == want.shape == (2, 4, 4, 5, 16)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_conv_transpose_matches_jax():
    """TF-SAME k4 s2 transposed conv: conv_transpose3d(padding=1) with the
    (k,k,k,Cin,Cout) kernel permuted (3,4,0,1,2) and NO spatial flip."""
    rng = np.random.default_rng(8)
    x = rng.normal(0, 1, (1, 5, 6, 7, 3)).astype(np.float32)
    w = rng.normal(0, 0.3, (4, 4, 4, 3, 2)).astype(np.float32)
    got = convs.conv_transpose_nd(_t(x), _t(w)).numpy()
    want = np.asarray(jconvs.conv_transpose_nd(jnp.asarray(x),
                                               jnp.asarray(w)))
    assert got.shape == want.shape == (1, 10, 12, 14, 2)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


@pytest.mark.parametrize("target", [7, (6, 5, 4)])
def test_crops_match_jax(target):
    """asymmetric_center_crop puts an odd leftover on the HIGH side."""
    x = np.arange(2 * 10 * 9 * 8 * 3, dtype=np.float32).reshape(2, 10, 9, 8, 3)
    got = convs.asymmetric_center_crop(_t(x), target).numpy()
    want = np.asarray(jconvs.asymmetric_center_crop(x, target))
    np.testing.assert_array_equal(got, want)
    ref = np.zeros((1, 4, 3, 2, 1))
    np.testing.assert_array_equal(
        convs.crop_to_match(_t(x), _t(ref)).numpy(),
        np.asarray(jconvs.crop_to_match(x, ref)))
