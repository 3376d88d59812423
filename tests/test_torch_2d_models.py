"""The port's 2D models and ops against the JAX package, on the CPU: the 2D
generator and discriminator (the HACK path, no ``down1``), the 2D convs,
``discriminator_shapes``, the uint8 edges of the tile step on rank-4
batches, the reference-named constructors and the weight converters.
Weights and inputs come from numpy seeds and go through both packages
unchanged; each test states its tolerance."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from golden_utils import DISC_ORDER_2D, GOLDEN_DIR, psnr
from transfer_em_tpu import shapes as jshapes
from transfer_em_tpu.compat import params_geometry as jax_params_geometry
from transfer_em_tpu.models import Discriminator as JaxDisc
from transfer_em_tpu.models import UNetGenerator as JaxUNet
from transfer_em_tpu.models import utils as jutils
from transfer_em_tpu.ops import convs as jconvs
from transfer_em_tpu.ops import normalize as jnorm
from transfer_em_tpu.train.cgan import _tap_prior as jax_tap_prior
from transfer_em_tpu_torch import shapes
from transfer_em_tpu_torch.models import (Discriminator, UNetGenerator,
                                          build_discriminator,
                                          build_generator, unet_generator)
from transfer_em_tpu_torch.models import utils as mutils
from transfer_em_tpu_torch.models.convert import (DISC_ORDER_2D as PORT_ORDER,
                                                  params_from_jax,
                                                  params_from_tf_order,
                                                  params_geometry)
from transfer_em_tpu_torch.models.blocks import ConvND
from transfer_em_tpu_torch.models.discriminator import discriminator
from transfer_em_tpu_torch.ops import convs, cuda_kernels
from transfer_em_tpu_torch.train.cgan import _tap_prior

torch.set_num_threads(1)

TOL = 1e-5  # rtol and atol, f32: the 2D nets are ~20 small convs deep


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


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


# -- models -------------------------------------------------------------------

@pytest.mark.parametrize("wf", [8, 32])
def test_generator_2d_matches_jax(wf):
    """74^2 -> 40^2, B=2, f32: rtol/atol 1e-5; every kernel rank 4."""
    gen = UNetGenerator(wf=wf, is3d=False)
    assert all(p.dim() == 4 for p in gen.parameters())
    params = numpy_tree(gen, seed=wf)
    x = _input(wf + 1, (2, 74, 74, 1))
    want = np.asarray(jax.jit(JaxUNet(wf=wf).apply)(params, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(gen, params)(_t(x)).numpy()
    assert got.shape == want.shape == (2, 40, 40, 1)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_golden_gen_2d():
    """wf=8, 74^2 -> 40^2 against the frozen TF reference output
    (gen_2d.npz): allclose 1e-3 and PSNR >= 40 dB."""
    data = np.load(os.path.join(GOLDEN_DIR, "gen_2d.npz"))
    gen = UNetGenerator(wf=8, is3d=False)
    gen.load_state_dict(params_from_tf_order(data))
    with torch.no_grad():
        got = gen.eval()(_t(data["x"])).numpy()
    np.testing.assert_allclose(got, data["y"], atol=1e-3, rtol=1e-3)
    assert psnr(got, data["y"]) >= 40


def _disc_case(case):
    """(port disc, JAX disc, param tree) for a case: plain, a disc_prior
    (a wf=8 2D generator tapped at down1: 17^2 x 8 on a 40^2 input, down2's
    grid), or use_norm."""
    if case == "prior":
        gen = UNetGenerator(wf=8, is3d=False)
        gparams = numpy_tree(gen, seed=3)
        prior = _tap_prior(_port(gen, gparams), "down1")
        assert prior.channels == 8
        disc = Discriminator(wf=8, is3d=False, disc_prior=prior,
                             prior_channels=8)
        jdisc = JaxDisc(is3d=False, wf=8, disc_prior=jax_tap_prior(
            JaxUNet(wf=8), gparams, "down1"))
    else:
        norm = case == "use_norm"
        disc = Discriminator(wf=8, is3d=False, use_norm=norm)
        jdisc = JaxDisc(is3d=False, wf=8, use_norm=norm)
    return disc, jdisc, numpy_tree(disc, seed=4)


@pytest.mark.parametrize("case", ["plain", "prior", "use_norm"])
def test_discriminator_2d_matches_jax(case):
    """40^2 -> 6^2 logits, wf=8, B=2, f32: rtol/atol 1e-5."""
    disc, jdisc, params = _disc_case(case)
    x = _input(5, (2, 40, 40, 1))
    want = np.asarray(jdisc.apply(params, jnp.asarray(x)))
    with torch.no_grad():
        got = _port(disc, params)(_t(x)).numpy()
    assert got.shape == want.shape == (2, 6, 6, 1)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_disc_golden_2d():
    """wf=8, 40^2 against the frozen TF reference output (disc_2d.npz,
    loaded in DISC_ORDER_2D): allclose 1e-3 and PSNR >= 40 dB."""
    assert PORT_ORDER == DISC_ORDER_2D
    data = np.load(os.path.join(GOLDEN_DIR, "disc_2d.npz"))
    disc = Discriminator(wf=8, is3d=False)
    disc.load_state_dict(params_from_tf_order(data, PORT_ORDER))
    with torch.no_grad():
        got = disc.eval()(_t(data["x"])).numpy()
    np.testing.assert_allclose(got, data["y"], atol=1e-3, rtol=1e-3)
    assert psnr(got, data["y"]) >= 40


def test_disc_2d_tree_has_no_down1():
    """The 2D state_dict is the JAX 2D param tree, key for key: no down1
    (the HACK conv takes the raw input, 1 -> 16); the 3D one has it."""
    disc = Discriminator(wf=8, is3d=False)
    keys = set(disc.state_dict())
    assert not any(k.startswith("down1.") for k in keys)
    assert disc.hack.kernel.shape == (3, 3, 1, 16)
    jparams = JaxDisc(is3d=False, wf=8).init(jax.random.PRNGKey(0),
                                             jnp.zeros((1, 40, 40, 1)))
    assert keys == set(params_from_jax(jax.tree.map(np.asarray, jparams)))
    assert any(k.startswith("down1.")
               for k in Discriminator(wf=8).state_dict())


@pytest.mark.parametrize("is3d", [True, False])
@pytest.mark.parametrize("dimsize", [40, 56, 74])
def test_discriminator_shapes_match_jax(dimsize, is3d):
    """Every field, both ranks; the 2D net's output is that size."""
    want = jshapes.discriminator_shapes(dimsize, is3d)
    got = shapes.discriminator_shapes(dimsize, is3d)
    assert got.__dict__ == want.__dict__ and got.patches == want.patches
    if not is3d:
        with torch.no_grad():
            y = Discriminator(wf=32, is3d=False)(
                torch.zeros(1, dimsize, dimsize, 1))
        assert y.shape == (1, got.out, got.out, 1)
    for fn in (shapes.discriminator_shapes, jshapes.discriminator_shapes):
        with pytest.raises(ValueError, match="collapses"):
            fn(16, is3d)


def test_discriminator_shapes_at_40():
    """The HACK asymmetry at the default 40: 3D ends in one patch, 2D in
    hack 38 -> down2 17 -> down3 6."""
    assert shapes.discriminator_shapes(40).out == 1
    s = shapes.discriminator_shapes(40, is3d=False)
    assert (s.hack, s.down2, s.down3, s.out) == (38, 17, 6, 6)


def test_params_geometry_matches_jax():
    """(wf, is3d) from the stem kernel, as JAX's compat reads it."""
    for wf, is3d in ((8, False), (32, False), (8, True)):
        gen = UNetGenerator(wf=wf, is3d=is3d)
        params = numpy_tree(gen, seed=1)
        assert params_geometry(gen.state_dict()) == (wf, is3d)
        assert jax_params_geometry(params) == (wf, is3d)


# -- convs ----------------------------------------------------------------------

@pytest.mark.parametrize("k,stride,padding", [(3, 1, "VALID"),
                                              (4, 2, "VALID"),
                                              (1, 1, "VALID"),
                                              (3, 1, "SAME"),
                                              (4, 1, "SAME")])
def test_conv_nd_2d_matches_jax(k, stride, padding):
    """NHWC x HWIO, f32: rtol/atol 1e-5 (the even SAME kernel pads (1, 2),
    as XLA does)."""
    rng = np.random.default_rng(k * 10 + stride)
    x = rng.normal(0, 1, (2, 17, 19, 5)).astype(np.float32)
    w = rng.normal(0, 0.3, (k, k, 5, 6)).astype(np.float32)
    got = convs.conv_nd(_t(x), _t(w), stride=stride, padding=padding).numpy()
    want = np.asarray(jconvs.conv_nd(jnp.asarray(x), jnp.asarray(w),
                                     stride=stride, padding=padding))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n", [6, 13])
def test_conv_transpose_nd_2d_matches_jax(n):
    """TF-SAME k4 stride-2 transposed conv in 2D: F.conv_transpose2d with
    padding 1 and no spatial flip equals JAX's flipped, input-dilated
    forward conv (transfer_em_tpu/ops/convs.py:84-132); rtol/atol 1e-5."""
    rng = np.random.default_rng(n)
    x = rng.normal(0, 1, (2, n, n + 1, 6)).astype(np.float32)
    w = rng.normal(0, 0.3, (4, 4, 6, 3)).astype(np.float32)
    got = convs.conv_transpose_nd(_t(x), _t(w)).numpy()
    want = np.asarray(jconvs.conv_transpose_nd(jnp.asarray(x),
                                               jnp.asarray(w)))
    assert got.shape == want.shape == (2, 2 * n, 2 * n + 2, 3)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_convs_take_rank_4_and_5_only():
    w2, w3 = torch.zeros(3, 3, 1, 1), torch.zeros(3, 3, 3, 1, 1)
    for x, w in ((torch.zeros(1, 8, 1), torch.zeros(3, 1, 1)),
                 (torch.zeros(1, 8, 8, 1), w3),
                 (torch.zeros(1, 8, 8, 8, 1), w2)):
        with pytest.raises(ValueError, match="NHWC"):
            convs.conv_nd(x, w)
    with pytest.raises(ValueError, match="NHWC"):
        convs.conv_transpose_nd(torch.zeros(1, 4, 4, 1),
                                torch.zeros(4, 4, 4, 1, 1))


def _on_conv3(m):
    """Whether ``ops/convs.py`` runs ConvND ``m``'s float32 conv on conv3."""
    n = m.kernel.dim() - 2
    x = torch.empty((1,) + (8,) * n + (m.kernel.shape[-2],), device="meta")
    return convs.conv_form(x, m.kernel, m.stride, m.padding) == "conv3"


def test_2d_convs_stay_off_conv3():
    """A 2D 3x3 stride-1 conv is not conv3's (JAX gates its Pallas conv on
    ndim == 3): it goes to conv_nd, and ConvActND's LeakyReLU to the
    leaky_relu wrapper."""
    gen = UNetGenerator(wf=32, is3d=False)
    conv_modules = [m for m in gen.modules() if isinstance(m, ConvND)]
    assert conv_modules and not any(_on_conv3(m) for m in conv_modules)
    assert all(_on_conv3(m) for m in UNetGenerator(wf=32).modules()
               if isinstance(m, ConvND) and m.kernel.shape[0] == 3
               and m.stride == 1)


# -- the tile step's uint8 edges on rank-4 batches --------------------------------

def _tie_voxels_2d(y, meanstd):
    """Voxels within 1e-6 of a .5 tie (float64): float32 rounding order may
    move these by one level."""
    z = np.asarray(y, np.float64)[..., 0]
    if meanstd is not None:
        z = z * meanstd[1] + meanstd[0]
    z = (z + 1.0) * 127.5
    return np.abs(z - np.floor(z) - 0.5) < 1e-6


@pytest.mark.parametrize("meanstd,tpad", [((0.05, 1.2), 2), (None, 2),
                                          ((0.05, 1.2), 0), ((0.05, 1.2), 3)])
def test_postprocess_rank4_matches_jax(meanstd, tpad):
    """(B, 40, 40, 1) with tpad > 0 -> (B, 40 - 2t, 40 - 2t) uint8, equal to
    JAX's postprocess_to_u8 on the trimmed slice (tiling.py:112-119 trims
    every spatial axis) but at documented .5 ties (one level)."""
    rng = np.random.default_rng(12)
    y = rng.normal(size=(3, 40, 40, 1)).astype(np.float32)
    y[0, 5, 5:9, 0] = [-1.0, 1.0, 3.0, -5.0]  # clip edges and exact levels
    got = cuda_kernels.postprocess_u8_plain(_t(y), meanstd, tpad).numpy()
    ys = y[:, tpad:40 - tpad, tpad:40 - tpad] if tpad else y
    want = np.asarray(jnorm.postprocess_to_u8(jnp.asarray(ys),
                                              meanstd))[..., 0]
    assert got.shape == want.shape == (3, 40 - 2 * tpad, 40 - 2 * tpad)
    assert got.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    ties = _tie_voxels_2d(ys, meanstd)
    assert diff[~ties].max() == 0 and diff.max() <= 1
    # the wrapper takes the plain version on a CPU tensor
    assert np.array_equal(
        cuda_kernels.postprocess_u8(_t(y), meanstd, tpad).numpy(), got)


@pytest.mark.parametrize("meanstd", [(0.17, 0.83), None])
def test_preprocess_2d_tiles_match_jax(meanstd):
    """(B, 74, 74) uint8 -> (B, 74, 74, 1) float32 within 1e-6."""
    x = np.random.default_rng(13).integers(0, 256, (4, 74, 74), np.uint8)
    got = cuda_kernels.preprocess_u8(_t(x), meanstd).numpy()
    want = np.asarray(jnorm.preprocess_u8(jnp.asarray(x), meanstd))
    assert got.shape == want.shape == (4, 74, 74, 1)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


# -- reference-named constructors and the models.utils shim -----------------------

def test_reference_named_constructors():
    """build_generator / unet_generator -> (module of the asked rank, out
    size); an invalid size raises ValueError / RuntimeError as in JAX;
    build_discriminator and models.discriminator.discriminator build the
    asked rank."""
    gen, out = build_generator(74, is3d=False, wf=32)
    assert out == 40 and not gen.is3d and gen.stem.kernel.dim() == 4
    gen, out = unet_generator(74, False, "instancenorm", 32)
    assert out == 40 and gen.stem.kernel.shape == (3, 3, 1, 2)
    with pytest.raises(ValueError, match="valid convolutions"):
        build_generator(75)
    with pytest.raises(RuntimeError, match="valid convolutions"):
        unet_generator(75)
    from transfer_em_tpu.models.generator import unet_generator as jax_unet
    with pytest.raises(RuntimeError):
        jax_unet(75)
    d = build_discriminator(is3d=False, wf=32)
    assert not d.is3d and "down1.conv.kernel" not in d.state_dict()
    d = discriminator(False, "instancenorm", 32)
    assert d.hack.kernel.shape == (3, 3, 1, 16)
    assert "down1.conv.kernel" in discriminator(True, wf=32).state_dict()


@pytest.mark.parametrize("is3d", [False, True])
def test_models_utils_shim_matches_jax(is3d):
    """downsample / upsample / InstanceNormalization with the reference's
    signatures, 2D and 3D, against the JAX shim on the same weights:
    rtol/atol 1e-5 (dropout off)."""
    sp = (9, 10, 11) if is3d else (9, 10)
    x = _input(14, (2,) + sp + (4,))
    down = mutils.downsample("d", 4, 6, is3d=is3d)
    params = numpy_tree(down, seed=15)
    want = jutils.downsample("d", 4, 6, is3d=is3d).apply(params,
                                                         jnp.asarray(x))
    with torch.no_grad():
        got = _port(down, params)(_t(x))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=TOL,
                                   atol=TOL)

    up = mutils.upsample("u", 4, 3, is3d=is3d)
    params = numpy_tree(up, seed=16)
    want = jutils.upsample("u", 4, 3, is3d=is3d).apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = _port(up, params)(_t(x)).numpy()
    assert up.conv.kernel.dim() == len(sp) + 2
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)

    norm = mutils.InstanceNormalization(is3d, features=4)
    params = numpy_tree(norm, seed=17)
    want = jutils.InstanceNormalization(is3d).apply(params, jnp.asarray(x))
    with torch.no_grad():
        got = _port(norm, params)(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(want), rtol=TOL, atol=TOL)
    with pytest.raises(NotImplementedError, match="filter_size"):
        mutils.downsample("d", 4, 6, is3d=is3d, filter_size=3)
    assert not mutils.upsample("u", 4, 3, is3d=is3d,
                               apply_dropout=False).apply_dropout


def test_upsample_without_dropout_is_deterministic():
    """apply_dropout=False (the reference's upsample option): no mask even
    with deterministic=False, as the JAX UpBlock."""
    up = mutils.upsample("u", 4, 3, is3d=False, apply_dropout=False)
    x = _t(_input(18, (1, 7, 7, 4)))
    g = torch.Generator().manual_seed(0)
    with torch.no_grad():
        assert torch.equal(up(x), up(x, deterministic=False,
                                     dropout_generator=g))
