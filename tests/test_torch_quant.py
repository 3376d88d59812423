"""The port's int8 serving path and phase-decomposed transposed conv on the
CPU against the JAX package (transfer_em_tpu/ops/quant.py, ops/convs.py,
UNetGenerator(int8_conv=True)), from seeded numpy inputs.

On the CPU ``ops/cuda_int8.conv_int8`` runs its plain version, the exact
integer conv (in float64) and the kernel's dequantizing epilogue.  The
int8 convs reduce every conv to a stride-1 VALID one (space-to-depth, the
phase decomposition); integer sums are exact, so the port's outputs are
held bit-equal to JAX's (tolerance 0), in float32 and bfloat16.  The phase
conv in float sums in another order than the dilated conv: rtol 1e-5.
The kernel's packed weights and its table of input offsets are walked here
as the kernel walks them (the arithmetic itself runs only on the card,
chip_smoke.py ``int8``); tests/test_torch_quant_kernels.py holds the
quantize pass's layouts and the weight cache."""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transfer_em_tpu.models import UNetGenerator as JaxGenerator
from transfer_em_tpu.ops import quant as jquant
from transfer_em_tpu.ops.convs import conv_transpose_nd as jax_conv_t
from transfer_em_tpu_torch.infer import make_tile_step
from transfer_em_tpu_torch.models import UNetGenerator
from transfer_em_tpu_torch.models.blocks import DownBlock, leaky
from transfer_em_tpu_torch.models.convert import (params_from_tf_order,
                                                  params_to_jax)
from transfer_em_tpu_torch.ops import cuda_int8, quant
from transfer_em_tpu_torch.ops.convs import (conv_transpose_nd,
                                             interleave_phases)
from transfer_em_tpu_torch.ops.cuda_kernels import postprocess_u8_plain

torch.set_num_threads(1)
GOLDENS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "goldens")
DTYPES = {"float32": (None, None), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _np(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _psnr(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    mse = np.mean((got - want) ** 2)
    peak = max(want.max() - want.min(), 1e-6)
    return 10 * np.log10(peak ** 2 / max(mse, 1e-20))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("axes", [(0, 1, 2, 3, 4), (0, 1, 2, 3)])
def test_quantize_sym_matches_jax(axes, dtype):
    """The same int8 codes and scales, exactly: per tensor (activations)
    and per last-axis channel (weights), from float32 and bfloat16 (cast to
    float32 first in both)."""
    jd, td = DTYPES[dtype]
    a = np.random.default_rng(0).normal(size=(2, 5, 6, 7, 3)).astype(
        np.float32)
    a[0, 0, 0, 0] = 0.5 / 127 * 3  # ties of round-half-to-even nearby
    jq, js = jquant.quantize_sym(jnp.asarray(a, jd), axes)
    q, s = quant.quantize_sym(torch.from_numpy(a).to(td or torch.float32),
                              axes)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))


CONV_CASES = [(3, 1, "VALID", 9), (4, 2, "VALID", 10), (4, 2, "VALID", 11),
              (3, 1, "SAME", 7), (1, 1, "VALID", 5)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ndim", [2, 3])
def test_conv_nd_int8_matches_jax(ndim, dtype):
    """conv_nd_int8 at k3 stride 1, k4 stride 2 (even and odd extents, the
    space-to-depth route), k3 SAME and k1, with and without the fused
    LeakyReLU against JAX's conv then ``nn.leaky_relu``: bit-equal."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(1)
    for k, s, pad, side in CONV_CASES:
        x = rng.normal(size=(2,) + (side,) * ndim + (5,)).astype(np.float32)
        w = rng.normal(size=(k,) * ndim + (5, 6)).astype(np.float32)
        want = jquant.conv_nd_int8(jnp.asarray(x), jnp.asarray(w), stride=s,
                                   padding=pad, out_dtype=jd)
        got = quant.conv_nd_int8(torch.from_numpy(x), torch.from_numpy(w),
                                 stride=s, padding=pad, out_dtype=td)
        assert got.dtype == (td or torch.float32)
        np.testing.assert_array_equal(got.float().numpy(), _np(want))
        slope = float(jnp.asarray(0.3, jd or jnp.float32))
        got = quant.conv_nd_int8(torch.from_numpy(x), torch.from_numpy(w),
                                 stride=s, padding=pad, out_dtype=td,
                                 leaky=slope)
        np.testing.assert_array_equal(
            got.float().numpy(), _np(jax.nn.leaky_relu(want, 0.3)))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ndim", [2, 3])
def test_conv_transpose_nd_int8_matches_jax(ndim, dtype):
    """The TF-SAME stride-2 k4 transposed conv in int8: the port's phase
    decomposition of the codes against JAX's input-dilated conv of its
    flipped kernel's codes, bit-equal; a k3 kernel (once refused) takes the
    general phase plan and matches JAX too."""
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(2)
    for side, cin, cout in ((5, 6, 3), (7, 4, 8)):
        x = rng.normal(size=(2,) + (side,) * ndim + (cin,)).astype(
            np.float32)
        w = rng.normal(size=(4,) * ndim + (cin, cout)).astype(np.float32)
        want = jquant.conv_transpose_nd_int8(jnp.asarray(x), jnp.asarray(w),
                                             out_dtype=jd)
        got = quant.conv_transpose_nd_int8(
            torch.from_numpy(x), torch.from_numpy(w), out_dtype=td)
        assert got.shape == want.shape
        np.testing.assert_array_equal(got.float().numpy(), _np(want))
    w3 = w[(slice(0, 3),) * ndim]
    want = jquant.conv_transpose_nd_int8(jnp.asarray(x), jnp.asarray(w3),
                                         out_dtype=jd)
    got = quant.conv_transpose_nd_int8(torch.from_numpy(x),
                                       torch.from_numpy(w3), out_dtype=td)
    assert got.shape == want.shape
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


@pytest.mark.parametrize("ndim", [2, 3])
def test_phase_decomposed_conv_transpose_matches_jax(ndim):
    """conv_transpose_nd(phase_decompose=True) against JAX's phase conv and
    both against the default (dilated / adjoint) conv: rtol 1e-5 in f32;
    stride != 2 or k != 4 raises ValueError in both packages."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2,) + (6,) * ndim + (5,)).astype(np.float32)
    w = rng.normal(size=(4,) * ndim + (5, 7)).astype(np.float32)
    want = np.asarray(jax_conv_t(jnp.asarray(x), jnp.asarray(w),
                                 phase_decompose=True))
    got = conv_transpose_nd(torch.from_numpy(x), torch.from_numpy(w),
                            phase_decompose=True).numpy()
    default = conv_transpose_nd(torch.from_numpy(x),
                                torch.from_numpy(w)).numpy()
    assert got.shape == (2,) + (12,) * ndim + (7,)
    scale = float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * scale)
    np.testing.assert_allclose(got, default, rtol=1e-5, atol=1e-5 * scale)
    w3 = np.ascontiguousarray(w[(slice(0, 3),) * ndim])
    for conv_t, to in ((jax_conv_t, jnp.asarray),
                       (conv_transpose_nd, torch.from_numpy)):
        with pytest.raises(ValueError, match="phase_decompose"):
            conv_t(to(x), to(w3), phase_decompose=True)
        with pytest.raises(ValueError, match="phase_decompose"):
            conv_t(to(x), to(w), stride=1, phase_decompose=True)


@pytest.mark.parametrize("golden,cd", [("gen_3d", None), ("gen_2d", None),
                                       ("gen_2d", "bfloat16")])
def test_int8_generator_matches_jax_and_goldens(golden, cd):
    """UNetGenerator(wf=8, int8_conv=True) with the golden's weights, 3D
    and 2D: within 1e-5 of the JAX package's int8 output (measured: equal)
    and >= 40 dB against the frozen TF output, as tests/test_quant.py holds
    the JAX one."""
    data = np.load(os.path.join(GOLDENS, golden + ".npz"))
    sd = params_from_tf_order(data)
    is3d = golden == "gen_3d"
    gen = UNetGenerator(wf=8, is3d=is3d, int8_conv=True, compute_dtype=cd)
    gen.load_state_dict(sd)
    with torch.no_grad():
        got = gen.eval()(torch.from_numpy(data["x"])).numpy()
    jgen = JaxGenerator(wf=8, int8_conv=True,
                        compute_dtype=jnp.bfloat16 if cd else None)
    want = np.asarray(jgen.apply(params_to_jax(sd), jnp.asarray(data["x"])))
    assert got.dtype == np.float32 and got.shape == data["y"].shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)
    assert _psnr(got, data["y"]) >= 40


@pytest.mark.parametrize("ndim", [3, 2])
@pytest.mark.parametrize("cd", [None, torch.bfloat16], ids=["f32", "bf16"])
def test_int8_down_conv_fuses_its_leaky_bit_equal(ndim, cd):
    """DownBlock's int8 down conv passes its LeakyReLU to the int8 conv's
    epilogue: bit-equal to the LeakyReLU run after the conv."""
    block = DownBlock(4, 8, ndim=ndim, compute_dtype=cd, int8_conv=True,
                      generator=torch.Generator().manual_seed(5))
    x = torch.randn((2,) + (20,) * ndim + (4,),
                    generator=torch.Generator().manual_seed(6))
    with torch.no_grad():
        down, skip = block(x)
        after = leaky(block.down(skip))
    assert bool((after < 0).any()) and after.dtype == (cd or torch.float32)
    assert torch.equal(down, after)


def test_int8_tile_step_on_a_2d_batch():
    """make_tile_step serves an int8 generator unchanged: its uint8 output
    is the postprocess of the int8 forward on the same batch (the
    activation scale spans the batch, so the batch is the unit)."""
    data = np.load(os.path.join(GOLDENS, "gen_2d.npz"))
    gen = UNetGenerator(wf=8, is3d=False, int8_conv=True)
    gen.load_state_dict(params_from_tf_order(data))
    gen.eval()
    tiles = np.random.default_rng(4).integers(0, 256, (3, 74, 74),
                                              dtype=np.uint8)
    ms_x, ms_y = (0.1, 0.8), (0.05, 0.6)
    got = make_tile_step(gen, ms_x, ms_y, 2, device="cpu")(tiles)
    x = (torch.from_numpy(tiles).float() * (1 / (127.5 * 0.8))
         + (-1.0 - 0.1) / 0.8).unsqueeze(-1)
    with torch.no_grad():
        y = gen(x)
    want = postprocess_u8_plain(y, ms_y, 2).numpy()
    assert got.shape == (3, 36, 36) and got.dtype == np.uint8
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_conv_int8_plain_is_exact_at_the_widest_reduction():
    """wf=1's widest reduction, 27 * 256 taps: all codes 127 sum to
    6,912 * 127^2 = 111,483,648 (above float32's 2^24), and random codes
    give numpy's int64 sum exactly; the dequantized value is float(acc) *
    (sx * sk), the scale product first in float32."""
    c = 256
    qx = torch.full((1, 3, 3, 3, c), 127, dtype=torch.int8)
    qk = torch.full((3, 3, 3, c, 2), 127, dtype=torch.int8)
    qk[..., 1] = -127
    one = torch.ones(1)
    acc = cuda_int8.conv_int8_plain(qx, qk, one, torch.ones(2), torch.int32)
    assert acc.dtype == torch.int32
    assert acc.flatten().tolist() == [111_483_648, -111_483_648]
    rng = np.random.default_rng(5)
    xs = rng.integers(-127, 128, (2, 4, 3, 5, c), dtype=np.int8)
    ks = rng.integers(-127, 128, (3, 3, 3, c, 3), dtype=np.int8)
    acc = cuda_int8.conv_int8(torch.from_numpy(xs), torch.from_numpy(ks),
                              one, torch.ones(3), torch.int32).numpy()
    want = np.zeros((2, 2, 1, 3, 3), np.int64)
    for d in range(2):
        for w in range(3):
            patch = xs[:, d:d + 3, 0:3, w:w + 3].astype(np.int64)
            want[:, d, 0, w] = np.einsum("bxyzc,xyzco->bo", patch,
                                         ks.astype(np.int64))
    np.testing.assert_array_equal(acc, want)
    sx, sk = torch.tensor([0.0123]), torch.tensor([0.5, 0.031, 7.0])
    y = cuda_int8.conv_int8(torch.from_numpy(xs), torch.from_numpy(ks), sx,
                            sk, torch.float32)
    scale = (sx * sk).numpy()
    np.testing.assert_array_equal(
        y.numpy(), (want.astype(np.float32) * scale).astype(np.float32))


def walk_plan(qk, nc, p, cb, vs=None):
    """A block plan (``cuda_int8.Int8Plan``) for :func:`kernel_walk`:
    ``nc`` outputs of ``p`` planes a block, ``cb`` bytes a channel block at
    voxel pitch ``vs`` (``cb`` if None); the copy unit and shared memory,
    which the walk does not read, left 4 and 0."""
    k5 = qk if qk.dim() == 5 else qk.unsqueeze(0)
    ksteps = -(-int(np.prod(k5.shape[:3])) * cb // 32)
    return cuda_int8.Int8Plan(nc, p, cb, vs or cb, 4, ksteps, 0)


def kernel_walk(qx, qk, plan, phases=False):
    """The int32 accumulators as csrc/conv_int8.cu computes them for block
    plan ``plan`` (:func:`walk_plan`), from codes in the conv's layout (C %
    4 == 0): per tile (an 8x8 patch of ``p`` output planes, one O chunk),
    per channel block the input patch with its halo staged as in shared
    memory (10 rows a plane, 10 voxels a row at pitch ``vs``, rows of
    ``10 * vs`` bytes rounded up to 16, zero past the volume and C), each K
    word's offset from
    the kernel's table (-1 past the taps), A gathered for each of the
    warpgroup's 64 rows a plane from its voxel's base offset, B from the
    packed operand (pack_int8_weights), then stored where the epilogue
    stores it (interleaved with ``phases``)."""
    x5 = qx.numpy().astype(np.int64)
    k5 = qk
    if x5.ndim == 4:
        x5, k5 = x5[:, None], qk.unsqueeze(0)
    bsz, d, h, w, c = x5.shape
    kd, kh, kw, _, o = k5.shape
    wp, plan = cuda_int8.pack_int8_weights(qk, plan)
    nc, p, cb, vs = plan.nc, plan.p, plan.cb, plan.vs
    wp = wp.numpy().astype(np.int64)
    n_ch, n_cb, ksteps = wp.shape[:3]
    # B[chunk][cbi][ks][n][kb], n = group * 8 + row, kb = half * 16 + byte
    b_op = wp.transpose(0, 1, 2, 3, 5, 4, 6).reshape(n_ch, n_cb, ksteps, nc,
                                                      32)
    rp = -(-10 * vs // 16) * 16  # bytes a brick row, 10 rows a plane
    off = np.full(ksteps * 8, -1, np.int64)
    for j in range(ksteps * 8):
        tap, cw = divmod(j, cb // 4)
        if tap < kd * kh * kw:
            td, rest = divmod(tap, kh * kw)
            th, tw = divmod(rest, kw)
            off[j] = (td * 10 + th) * rp + tw * vs + cw * 4
    od_, oh_, ow_ = d - kd + 1, h - kh + 1, w - kw + 1
    acc = np.zeros((bsz, od_, oh_, ow_, n_ch * nc), np.int64)
    rows = np.arange(64)
    warp, half, g = rows // 16, (rows % 16) // 8, rows % 8
    for b in range(bsz):
        for d0 in range(0, od_, p):
            for h0 in range(0, oh_, 8):
                for w0 in range(0, ow_, 8):
                    blk = np.zeros((p, 64, n_ch * nc), np.int64)
                    for cbi in range(n_cb):
                        patch = np.zeros((p + 2, 10, rp), np.int64)
                        src = x5[b, d0:d0 + p + kd - 1, h0:h0 + 8 + kh - 1,
                                 w0:w0 + 8 + kw - 1, cbi * cb:(cbi + 1) * cb]
                        vox = patch[:, :, :10 * vs].reshape(p + 2, 10, 10, vs)
                        vox[:src.shape[0], :src.shape[1], :src.shape[2],
                            :src.shape[3]] = src
                        flat = patch.reshape(-1)
                        for pl in range(p):
                            base = ((pl * 10 + 2 * warp + half) * rp
                                    + g * vs)
                            a = np.zeros((64, ksteps * 32), np.int64)
                            for j, o_ in enumerate(off):
                                if o_ >= 0:
                                    for e in range(4):
                                        a[:, 4 * j + e] = flat[base + o_ + e]
                            for ch in range(n_ch):
                                bw = b_op[ch, cbi].transpose(1, 0, 2).reshape(
                                    nc, ksteps * 32)
                                blk[pl, :, ch * nc:(ch + 1) * nc] += a @ bw.T
                    for pl in range(p):
                        for m in range(64):
                            i, j, k = (d0 + pl, h0 + 2 * warp[m] + half[m],
                                       w0 + g[m])
                            if i < od_ and j < oh_ and k < ow_:
                                acc[b, i, j, k] = blk[pl, m]
    acc = acc[..., :o]
    if qx.dim() == 4:
        acc = acc[:, 0]
    if phases:
        acc = interleave_phases(torch.from_numpy(acc)).numpy()
    return acc


# the plans (nc, p, cb) the kernel makes for these shapes
WALK_PLANS = {8: (8, 8, 4), 20: (32, 4, 8), 70: (64, 2, 8)}


@pytest.mark.parametrize("shape,k,o", [((2, 3, 4, 5, 1), (3, 3, 3), 8),
                                       ((1, 4, 3, 6, 6), (2, 2, 2), 20),
                                       ((2, 1, 5, 5, 8), (1, 3, 3), 70)])
def test_kernel_layout_walk_matches_plain(shape, k, o):
    """The packed weights (zeros past the taps, C and O; O in chunks of
    the wgmma N) and the offset table walked as the kernel walks them, on
    codes in the conv's layout, give the plain version's accumulators: the
    stem (C=1, its kw taps packed in the channel word), a space-to-depth
    k2 conv (C=6 padded to 8), a 2D-like conv as D=1 with O past 64."""
    rng = np.random.default_rng(6)
    qx = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))
    qk = torch.from_numpy(rng.integers(-127, 128, k + (shape[-1], o),
                                       dtype=np.int8))
    want = cuda_int8.conv_int8_plain(qx, qk, torch.ones(1), torch.ones(o),
                                     torch.int32).numpy()
    layout = quant.conv_layout(qx.shape, qk.shape, 1, "VALID")
    codes = quant.arrange(qx, layout)
    ukern, _ = quant._unit_kernel(qk, torch.ones(o), layout, False)
    assert codes.shape[-1] % 4 == 0 and ukern.shape[-2] == codes.shape[-1]
    assert (layout.wtaps, ukern.shape[:3]) == (
        (3, (3, 3, 1)) if shape[-1] == 1 else (1, k))
    plan = walk_plan(ukern, *WALK_PLANS[o])
    np.testing.assert_array_equal(kernel_walk(codes, ukern, plan), want)


def test_space_to_depth_pairs_with_kernel_to_depth():
    """A stride-2 k4 VALID conv equals the stride-1 k2 conv of the
    space-to-depth input and kernel (float64, exact on integers)."""
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.integers(-5, 6, (2, 8, 8, 8, 3)).astype(
        np.float64))
    w = torch.from_numpy(rng.integers(-5, 6, (4, 4, 4, 3, 2)).astype(
        np.float64))
    f = torch.nn.functional.conv3d
    want = f(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2), stride=2)
    xs, ws = quant.space_to_depth(x, 2), quant.kernel_to_depth(w, 2)
    assert xs.shape == (2, 4, 4, 4, 24) and ws.shape == (2, 2, 2, 24, 2)
    got = f(xs.permute(0, 4, 1, 2, 3), ws.permute(4, 3, 0, 1, 2))
    assert torch.equal(got, want)


def test_conv_int8_refuses_a_non_cpu_non_cuda_tensor():
    """Off the CPU the wrapper launches the kernel or raises: a tensor on
    any other device is refused before a launch (no fallback)."""
    qx = torch.zeros((1, 3, 3, 3, 4), dtype=torch.int8, device="meta")
    qk = torch.zeros((3, 3, 3, 4, 8), dtype=torch.int8)
    with pytest.raises(ValueError, match="CUDA tensor"):
        cuda_int8.conv_int8(qx, qk, torch.ones(1), torch.ones(8))
    with pytest.raises(ValueError, match="outside 1..3"):
        cuda_int8.conv_int8(torch.zeros((1, 5, 5, 5, 4), dtype=torch.int8),
                            torch.zeros((4, 3, 3, 4, 8), dtype=torch.int8),
                            torch.ones(1), torch.ones(8))
