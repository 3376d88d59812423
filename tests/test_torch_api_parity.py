"""The port's public keywords that the JAX package's functions take, held
against JAX on the CPU: SAME convs at any stride, transposed convs at any
kernel and stride (float and int8), the blocks' ``padding`` /
``kernel_size`` / ``stride``, ``predict_tiled(fetch_threads=)``,
``default_batch_size(ceiling=, floor=)``, the batcher's ``min_bucket`` /
``bucket_granule`` and ``build_step_fn(config, disc_prior)`` (and that
the port's own callers of the step makers leave the prior slot to a
prior).

Float convs within rtol / atol 1e-5 (the frameworks sum in other orders);
the int8 convs bit-equal, as tests/test_torch_quant.py holds them."""

import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transfer_em_tpu.infer import batcher as jbatcher
from transfer_em_tpu.infer import tiling as jtiling
from transfer_em_tpu.models import blocks as jblocks
from transfer_em_tpu.ops import convs as jconvs
from transfer_em_tpu.ops import quant as jquant
from transfer_em_tpu_torch.config import CycleGANConfig
from transfer_em_tpu_torch.infer import batcher, tiling
from transfer_em_tpu_torch.models import UNetGenerator, blocks
from transfer_em_tpu_torch.native import gather_blocks
from transfer_em_tpu_torch.ops import convs, quant
from transfer_em_tpu_torch.train import cgan

torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parents[1]

SAME_CASES = [(nd, n, k, s) for nd in (2, 3) for n in (7, 8) for k in (3, 4)
              for s in (2, 3)]
TRANSPOSE_KS = [(1, 2), (2, 2), (3, 1), (3, 2), (4, 2), (4, 3), (5, 2)]
# (k, s) -> JAX's output extent on an 8^3 input (15 at k1 s2, not 16)
TRANSPOSE_EXTENT_8 = {(1, 2): 15, (2, 2): 16, (3, 1): 8, (3, 2): 16,
                      (4, 2): 16, (4, 3): 24, (5, 2): 16}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _draw(seed, x_shape, k_shape):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=x_shape).astype(np.float32),
            rng.normal(size=k_shape).astype(np.float32))


@pytest.mark.parametrize("nd,n,k,s", SAME_CASES)
def test_conv_nd_same_any_stride(nd, n, k, s):
    """XLA's SAME split (the odd voxel after) at stride 2 and 3."""
    x, w = _draw(n * 10 + k * 3 + s, (2,) + (n,) * nd + (3,),
                 (k,) * nd + (3, 5))
    want = np.asarray(jconvs.conv_nd(jnp.asarray(x), jnp.asarray(w),
                                     stride=s, padding="SAME"))
    got = convs.conv_nd(_t(x), _t(w), stride=s, padding="SAME").numpy()
    assert got.shape == want.shape == (2,) + (-(-n // s),) * nd + (5,)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("k,s", TRANSPOSE_KS)
def test_conv_transpose_nd_any_k_s(k, s, nd):
    """Shapes and values of JAX's input-dilated conv of the flipped kernel,
    k < s included (k1 s2: 2n - 1)."""
    x, w = _draw(k * 7 + s, (2,) + (8,) * nd + (3,), (k,) * nd + (3, 4))
    want = np.asarray(jconvs.conv_transpose_nd(jnp.asarray(x),
                                               jnp.asarray(w), stride=s))
    got = convs.conv_transpose_nd(_t(x), _t(w), stride=s).numpy()
    assert got.shape == want.shape
    assert got.shape[1:-1] == (TRANSPOSE_EXTENT_8[(k, s)],) * nd
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("k,s", [(k, s) for k in (3, 4) for s in (2, 3)])
def test_conv_nd_int8_same_any_stride(k, s, nd):
    """SAME at stride 2 and 3 in int8 (the phase plan: the codes padded and
    space-to-depth by the stride), bit-equal to JAX at n = 7 and 8 and on
    an input whose axes pad unequally; f32 and bf16 out."""
    for i, sp in enumerate(((7,) * nd, (8,) * nd, (7,) * (nd - 1) + (8,))):
        x, w = _draw(i * 31 + k * 5 + s, (2,) + sp + (3,),
                     (k,) * nd + (3, 5))
        for jd, td in ((None, None), (jnp.bfloat16, torch.bfloat16)):
            want = jquant.conv_nd_int8(jnp.asarray(x), jnp.asarray(w),
                                       stride=s, padding="SAME",
                                       out_dtype=jd)
            got = quant.conv_nd_int8(_t(x), _t(w), stride=s, padding="SAME",
                                     out_dtype=td)
            assert got.shape == want.shape
            np.testing.assert_array_equal(
                got.float().numpy(), np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize("nd", [2, 3])
@pytest.mark.parametrize("k,s", TRANSPOSE_KS)
def test_conv_transpose_nd_int8_any_k_s(k, s, nd):
    """The int8 transposed conv at every (k, s): JAX's shapes, bit-equal
    values; k4 s2 keeps the generator's phase epilogue, the rest the phase
    plan (at most 3 taps an axis)."""
    x, w = _draw(k * 11 + s, (2,) + (5,) * (nd - 1) + (6,) + (4,),
                 (k,) * nd + (4, 3))
    for jd, td in ((None, None), (jnp.bfloat16, torch.bfloat16)):
        want = jquant.conv_transpose_nd_int8(jnp.asarray(x), jnp.asarray(w),
                                             stride=s, out_dtype=jd)
        got = quant.conv_transpose_nd_int8(_t(x), _t(w), stride=s,
                                           out_dtype=td)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want.astype(jnp.float32)))
    if (k, s) != (4, 2):
        lo = convs.same_transpose_padding(k, s)[0]
        plans = quant.phase_plans(k, 1, s, [lo] * nd, True)
        assert max(p.taps for p in plans) <= 3


def _jax_block(module, x, kernel):
    params = module.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree.map(lambda a: a, params)
    params["params"]["kernel"] = jnp.asarray(kernel)
    return np.asarray(module.apply(params, jnp.asarray(x)).astype(
        jnp.float32))


BLOCK_CASES = {
    "ConvND_same_k3_3d": (lambda: blocks.ConvND(3, 4, 3, padding="SAME"),
                          lambda: jblocks.ConvND(4, 3, padding="SAME"), 3),
    "ConvND_same_k4_s2_3d": (
        lambda: blocks.ConvND(3, 4, 4, 2, padding="SAME"),
        lambda: jblocks.ConvND(4, 4, 2, padding="SAME"), 3),
    "ConvND_same_k3_2d": (
        lambda: blocks.ConvND(3, 4, 3, padding="SAME", ndim=2),
        lambda: jblocks.ConvND(4, 3, padding="SAME"), 2),
    "ConvActND_same_k3_3d": (
        lambda: blocks.ConvActND(3, 4, 3, padding="SAME"),
        lambda: jblocks.ConvActND(4, 3, padding="SAME"), 3),
    "ConvActND_same_k3_s3_2d": (
        lambda: blocks.ConvActND(3, 4, 3, 3, padding="SAME", ndim=2),
        lambda: jblocks.ConvActND(4, 3, 3, padding="SAME"), 2),
    "ConvTransposeND_k3_s2_3d": (
        lambda: blocks.ConvTransposeND(3, 4, 3, 2),
        lambda: jblocks.ConvTransposeND(4, 3, 2), 3),
    "ConvTransposeND_k2_s2_2d": (
        lambda: blocks.ConvTransposeND(3, 4, kernel_size=2, stride=2,
                                       ndim=2),
        lambda: jblocks.ConvTransposeND(4, kernel_size=2, stride=2), 2),
    "ConvTransposeND_default_k4_s2_3d": (
        lambda: blocks.ConvTransposeND(3, 4),
        lambda: jblocks.ConvTransposeND(4), 3),
}


@pytest.mark.parametrize("int8", [False, True])
@pytest.mark.parametrize("case", sorted(BLOCK_CASES))
def test_block_keywords_match_jax(case, int8):
    """Each block with JAX's keyword, its kernel carried into the JAX
    module's param tree: float within 1e-5, int8 bit-equal.  The kernel
    keeps its name and layout ((k,)*n, Cin, Cout)."""
    make, make_jax, nd = BLOCK_CASES[case]
    block = make()
    if int8:
        block.int8_conv = True
    kernel = np.random.default_rng(len(case)).normal(
        0, 0.3, tuple(block.kernel.shape)).astype(np.float32)
    with torch.no_grad():
        block.kernel.copy_(_t(kernel))
    assert [n for n, _ in block.named_parameters()] == ["kernel"]
    x = np.random.default_rng(7).normal(
        size=(2,) + (7,) * (nd - 1) + (8,) + (3,)).astype(np.float32)
    jmod = make_jax()
    if int8:
        jmod = jmod.clone(int8_conv=True)
    want = _jax_block(jmod, x, kernel)
    with torch.no_grad():
        got = block(_t(x)).numpy()
    assert got.shape == want.shape
    if int8:
        np.testing.assert_array_equal(got, want)
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def test_same_conv3_block_pads_then_keeps_the_kernel_route():
    """A 3D k3 s1 SAME block is a conv3 block (the kernel's route on the
    card) on x zero-padded by 1; VALID is unchanged."""
    same = blocks.ConvND(3, 4, 3, padding="SAME")
    valid = blocks.ConvND(3, 4, 3)
    x = torch.randn(1, 6, 6, 6, 3)
    assert convs.conv_form(x, same.kernel, 1, "SAME") == "conv3"
    assert convs.conv_form(x, valid.kernel, 1, "VALID") == "conv3"
    with torch.no_grad():
        valid.kernel.copy_(same.kernel)
        torch.testing.assert_close(same(x), valid(convs.zero_pad(x, 1)),
                                   rtol=0, atol=0)
    with pytest.raises(ValueError, match="VALID or SAME"):
        blocks.ConvND(3, 4, 3, padding="same")


@pytest.fixture(scope="module")
def tiled_case():
    gen = UNetGenerator(wf=32, generator=torch.Generator().manual_seed(0))
    gen.eval()
    vol = np.random.default_rng(0).integers(0, 255, (80, 80, 130), np.uint8)

    def fetch(corner, insize):
        return gather_blocks(vol, [corner], insize)[0]

    def run(**kw):
        return tiling.predict_tiled(fetch, gen, (0, 0, 0), (72, 36, 36), 40,
                                    17, (0.1, 0.9), (0.2, 1.1),
                                    batch_size=8, device="cpu", **kw)

    return run, run()


@pytest.mark.parametrize("threads", [1, 3])
def test_predict_tiled_fetch_threads(tiled_case, threads):
    """Any fetch_threads gives the default's bytes (the fetch order is
    kept; 1 fetches on the calling thread)."""
    run, want = tiled_case
    np.testing.assert_array_equal(run(fetch_threads=threads), want)


@pytest.mark.parametrize("wf", [1, 2, 4, 8])
def test_default_batch_size_ceiling_floor(wf):
    """JAX's rule over the same kernel widths, at the defaults and at other
    ceilings and floors."""
    gen = UNetGenerator(wf=wf).to("meta")
    tree = {name: np.zeros((1,) * (p.dim() - 1) + (p.shape[-1],),
                           np.float32)
            for name, p in gen.named_parameters()}
    for kw in ({}, {"ceiling": 256}, {"ceiling": 64, "floor": 4},
               {"ceiling": 512, "floor": 32}, {"floor": 24}):
        assert (tiling.default_batch_size(gen, **kw)
                == jtiling.default_batch_size(tree, **kw)), kw


@pytest.mark.parametrize("min_bucket,granule,max_batch,multiple",
                         [(8, 8, 128, 1), (1, 1, 128, 1), (16, 8, 128, 1),
                          (4, 6, 32, 1), (8, 8, 20, 1), (8, 8, 128, 3),
                          (2, 5, 64, 2)])
def test_batcher_buckets_match_jax(min_bucket, granule, max_batch, multiple):
    """The padded batch of every k up to past max_batch, through both
    make_tile_batcher signatures' keywords."""
    step = lambda arr: arr  # noqa: E731
    mine = batcher.TileBatcher(step, max_batch=max_batch,
                               min_bucket=min_bucket,
                               bucket_granule=granule, multiple=multiple)
    theirs = jbatcher.TileBatcher(step, max_batch=max_batch,
                                  min_bucket=min_bucket,
                                  bucket_granule=granule, multiple=multiple)
    try:
        for k in range(1, max_batch + 10):
            assert mine._bucket(k) == theirs._bucket(k), k
    finally:
        mine.close()
        theirs.close()


def test_make_tile_batcher_bucket_keywords():
    gen = UNetGenerator(wf=32).eval()
    b = batcher.make_tile_batcher(gen, (0.1, 0.9), (0.2, 1.1), 40, 17,
                                  device="cpu", max_batch=64, min_bucket=16,
                                  bucket_granule=4)
    try:
        assert [b._bucket(k) for k in (1, 15, 17, 18, 70)] == [16, 16, 20,
                                                               20, 70]
        tile = np.zeros((74,) * 3, np.uint8)
        assert b.submit(tile).result(timeout=120).shape == (36,) * 3
        assert b.stats()["padded"] == 15
    finally:
        b.close()


CFG2 = CycleGANConfig(dimsize=74, is3d=False, wf=32)


def _prior(seed=5):
    gen = UNetGenerator(wf=8, is3d=False,
                        generator=torch.Generator().manual_seed(seed))
    return cgan._tap_prior(gen.eval(), "down1")


def test_build_step_fn_binds_disc_prior():
    """``build_step_fn(cfg, prior)`` binds JAX's second positional
    parameter, ``disc_prior``; the step runs a state made with that prior
    and equals the step built without it (the prior rides in the state)."""
    prior = _prior()
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 0.3, (1, 74, 74, 1)).astype(np.float32))
    y = torch.from_numpy(np.random.default_rng(2).normal(
        0, 0.3, (1, 74, 74, 1)).astype(np.float32))
    losses = []
    for with_prior in (True, False):
        state = cgan.create_state(CFG2, 0, device="cpu", disc_prior=prior)
        step = cgan.build_step_fn(CFG2, prior if with_prior else None,
                                  deterministic=True)
        losses.append(step(state, x, y, 0))
    torch.testing.assert_close(losses[0], losses[1], rtol=0, atol=0)
    plain = cgan.create_state(CFG2, 0, device="cpu")
    with pytest.raises(ValueError, match="without one"):
        cgan.build_step_fn(CFG2, prior)(plain, x, y, 0)


def test_build_step_fn_options_are_keyword_only():
    """A positional ``batched_apps`` (the port's old second parameter) or
    a device in make_train_step's prior slot raises."""
    with pytest.raises(TypeError, match="disc_prior"):
        cgan.build_step_fn(CFG2, True)
    with pytest.raises(TypeError):
        cgan.build_step_fn(CFG2, None, True)
    with pytest.raises(TypeError, match="disc_prior"):
        cgan.make_train_step(CFG2, "cpu")
    with pytest.raises(TypeError, match="bfloat16"):
        cgan.build_step_fn(CycleGANConfig(dimsize=74, is3d=False, wf=32,
                                          compute_dtype="bfloat16"),
                           _prior())
    assert callable(cgan.make_train_step(CFG2, device="cpu"))


@pytest.mark.parametrize("maker", ["build_step_fn", "make_train_step",
                                   "make_scan_train_step",
                                   "make_scan_train_step_mesh"])
def test_step_refuses_a_state_with_another_prior(maker):
    """A step given ``disc_prior`` trains with that prior or not at all:
    a state made with another prior (other weights) is refused, one made
    with a tap of equal weights is taken, by every step maker."""
    from transfer_em_tpu_torch.parallel import make_mesh

    prior, other, same = _prior(5), _prior(6), _prior(5)
    x = torch.from_numpy(np.random.default_rng(1).normal(
        0, 0.3, (1, 1, 74, 74, 1)).astype(np.float32))
    y = torch.from_numpy(np.random.default_rng(2).normal(
        0, 0.3, (1, 1, 74, 74, 1)).astype(np.float32))
    if maker == "build_step_fn":
        step = cgan.build_step_fn(CFG2, prior, deterministic=True)
    elif maker == "make_train_step":
        step = cgan.make_train_step(CFG2, prior, device="cpu")
    elif maker == "make_scan_train_step":
        step = cgan.make_scan_train_step(CFG2, 1, prior, device="cpu")
    else:
        step = cgan.make_scan_train_step(
            CFG2, 1, prior, mesh=make_mesh(devices=["cpu"]))
    args = (x, y, 0) if maker.startswith("make_scan") else (x[0], y[0], 0)
    with pytest.raises(ValueError, match="not the one"):
        step(cgan.create_state(CFG2, 0, device="cpu", disc_prior=other),
             *args)
    with pytest.raises(ValueError, match="without one"):
        step(cgan.create_state(CFG2, 0, device="cpu"), *args)
    loss = step(cgan.create_state(CFG2, 0, device="cpu", disc_prior=same),
                *args)
    assert torch.isfinite(loss).all()


# the port's own callers of the step makers: its package, its tools, its
# recipes and chip_smoke.py (the tests pass wrong arguments on purpose)
_CALLER_FILES = sorted(
    [p for d in ("transfer_em_tpu_torch", "tools", "examples/torch")
     for p in (ROOT / d).rglob("*.py")] + [ROOT / "chip_smoke.py"])
# each maker's position of disc_prior, and how many positional arguments
# it takes
_PRIOR_SLOT = {"build_step_fn": (1, 2), "make_train_step": (1, 2),
               "make_scan_train_step": (2, 5)}


@pytest.mark.parametrize("maker", sorted(_PRIOR_SLOT))
def test_no_caller_binds_an_option_to_the_prior_slot(maker):
    """Every call of a step maker in the port's own code passes at most
    the positional arguments the maker takes, and what it passes in the
    ``disc_prior`` slot is named as a prior (``prior``, ``disc_prior``):
    a device or a flag there is a positional slip (the JAX signature's
    second parameter is the prior)."""
    import ast

    slot, most = _PRIOR_SLOT[maker]
    found, bad = 0, []
    for path in _CALLER_FILES:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if not isinstance(node, ast.Call):
                continue
            f = node.func
            name = f.id if isinstance(f, ast.Name) else getattr(f, "attr",
                                                                None)
            if name != maker:
                continue
            found += 1
            where = f"{path.relative_to(ROOT)}:{node.lineno}"
            if len(node.args) > most:
                bad.append(where)
            elif len(node.args) > slot and "prior" not in ast.unparse(
                    node.args[slot]):
                bad.append(where)
    assert found, f"no caller of {maker} found"
    assert not bad, f"{maker} called with an option in the prior slot: {bad}"
