"""The tensor-core conv3 design, held on the CPU against the JAX package.

The CUDA kernels (csrc/conv3_tc.cu, csrc/conv3_direct.cu) run only on the
card (chip_smoke.py checks them there).  What surrounds them is plain torch
and is checked here: the TF32 split, the 3xTF32 arithmetic (emulated), the
packed weight layout the kernel's wgmma descriptors read, the packed-weight
cache, and the rule that picks a kernel for every layer of UNetGenerator(wf).
Inputs come from a numpy seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from transfer_em_tpu.ops import convs as jconvs
from transfer_em_tpu_torch.models import UNetGenerator
from transfer_em_tpu_torch.models.blocks import ConvND
from transfer_em_tpu_torch.ops import convs, cuda_conv
from transfer_em_tpu_torch.ops.counts import read_counts
from transfer_em_tpu_torch.ops.cuda_kernels import slope_in

torch.set_num_threads(1)

# (C, O) of the 8 k3 convs at wf=8: stem, down1.conv, down2.conv, up1.conv,
# mid, up0.conv, head, out
WF8_PAIRS = [(1, 8), (8, 8), (8, 16), (16, 32), (32, 32), (32, 16), (16, 16),
             (16, 1)]
DTYPES = [torch.float32, torch.bfloat16]


def _bits(t):
    return t.contiguous().view(torch.int32)


def _trunc_tf32(t):
    """What the tensor core reads of an f32 register as a TF32 operand: the
    top 19 bits."""
    return (_bits(t) & ~0x1FFF).view(torch.float32)


def _conv(x, w):
    """Channels-last VALID conv in f32 on the CPU."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2))
    return y.permute(0, 2, 3, 4, 1)


# -- (1) split_tf32 -----------------------------------------------------------

def test_split_tf32_exact_and_ten_bit():
    rng = np.random.default_rng(10)
    w = torch.from_numpy(np.concatenate([
        rng.normal(0, 1, 4096), rng.normal(0, 1e-3, 1024),
        rng.normal(0, 1e4, 1024), [0.0, -0.0, 1.0, -2.5]]).astype(np.float32))
    hi, lo = cuda_conv.split_tf32(w)
    assert hi.dtype == lo.dtype == torch.float32
    assert (_bits(hi) & 0x1FFF).eq(0).all()          # <= 10 mantissa bits
    assert torch.equal(hi + lo, w)                   # exact in f32
    # nearest: |lo| is at most half a TF32 ulp of hi
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(hi)[1] - 11)
    assert (lo.abs() <= 0.5 * ulp).all()


def test_split_tf32_ties_to_even():
    one = 1.0
    cases = {  # value: TF32 hi, the 10-bit step at 1.0 is 2**-10
        one + 2 ** -11: one,                          # tie, 1.0 is even
        one + 3 * 2 ** -11: one + 2 ** -9,            # tie, rounds up to even
        one + 2 ** -11 + 2 ** -20: one + 2 ** -10,    # above the tie
        -(one + 2 ** -11): -one,
        -(one + 3 * 2 ** -11): -(one + 2 ** -9),
    }
    w = torch.tensor(list(cases), dtype=torch.float32)
    hi, lo = cuda_conv.split_tf32(w)
    assert hi.tolist() == list(cases.values())
    assert torch.equal(hi + lo, w)


# -- (2) 3xTF32 against the JAX conv -----------------------------------------

def _tf32x3_conv(x, w):
    """The tensor-core kernel's f32 arithmetic in plain torch: x_lo*w_hi +
    x_hi*w_lo + x_hi*w_hi, each lo read as TF32 by the tensor core.  The
    weights are split by split_tf32 (packed once); the kernel splits x in
    registers by truncation (one AND), x_lo = x - x_hi."""
    xh = _trunc_tf32(x)
    xl = x - xh
    wh, wl = cuda_conv.split_tf32(w)
    return (_conv(_trunc_tf32(xl), wh) + _conv(xh, _trunc_tf32(wl))
            + _conv(xh, wh))


def _inputs(c, o, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(0, 1, (2, 8, 8, 8, c)).astype(np.float32)
    w = (rng.normal(0, 1, (3, 3, 3, c, o)) / np.sqrt(27 * c)).astype(
        np.float32)
    ref = np.asarray(jconvs.conv_nd(jnp.asarray(x), jnp.asarray(w)))
    return torch.from_numpy(x), torch.from_numpy(w), ref


@pytest.mark.parametrize("c,o", WF8_PAIRS)
def test_tf32x3_matches_jax_conv(c, o):
    x, w, ref = _inputs(c, o, 11 + c + o)
    got = _tf32x3_conv(x, w).numpy()
    assert got.shape == ref.shape == (2, 6, 6, 6, o)
    tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
    assert np.abs(got - ref).max() <= tol


def test_single_tf32_misses_the_f32_bar():
    """One TF32 product (what TF32-on would give) misses the bar the
    3xTF32 sum meets: the reason for the split."""
    x, w, ref = _inputs(32, 32, 12)
    tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
    one = _conv(cuda_conv.split_tf32(x)[0], cuda_conv.split_tf32(w)[0])
    three = _tf32x3_conv(x, w)
    assert np.abs(one.numpy() - ref).max() > tol
    assert np.abs(three.numpy() - ref).max() <= tol


# -- (3) packed weights --------------------------------------------------------

def _unpack(packed, c, o, dtype, plan=None):
    """Inverse of pack_conv3_weights (f32: hi + lo), either form."""
    p = cuda_conv.conv3_plan(c, o, dtype) if plan is None else plan
    if p.kw:
        # (chunk, cb, kh, kd, k-step, part, J, h, row, kk/2), J = (kw, j)
        v = packed.sum(dim=5) if p.parts == 2 else packed.squeeze(5)
        v = v.reshape(v.shape[:5] + (3, p.nc // 8) + v.shape[6:-1]
                      + (4, p.kk // 8))
        # (chunk, cb, kh, kd, k-step, kw, j, h, row, a, r) -> (kd, kh, kw,
        # cb, k-step, a, h, r, chunk, j, row)
        v = v.permute(3, 2, 5, 1, 4, 9, 7, 10, 0, 6, 8)
    else:
        v = packed.sum(dim=6) if p.parts == 2 else packed.squeeze(6)
        v = v.reshape(v.shape[:-1] + (4, p.kk // 8))
        # (chunk, cb, kd, kh, kw, k-step, j, h, row, a, r) -> (kd, kh, kw,
        # cb, k-step, a, h, r, chunk, j, row)
        v = v.permute(2, 3, 4, 1, 5, 9, 7, 10, 0, 6, 8)
    v = v.reshape(3, 3, 3, p.n_cb * p.cb, p.n_chunks * p.nc)
    return v[:, :, :, :c, :o]


def _packed_shape(p):
    """The shape pack_conv3_weights gives for plan p."""
    if p.kw:
        return (p.n_chunks, p.n_cb, 3, 3, p.cb // p.kk, p.parts,
                3 * p.nc // 8, 2, 8, p.kk // 2)
    return (p.n_chunks, p.n_cb, 3, 3, 3, p.cb // p.kk, p.parts, p.nc // 8, 2,
            8, p.kk // 2)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("c", [1, 2, 4, 8, 16, 32, 64])
def test_pack_roundtrip(c, dtype):
    rng = np.random.default_rng(13 + c)
    for o in (1, 2, 4, 8, 16, 32, 64):
        w = torch.from_numpy(rng.normal(0, 1, (3, 3, 3, c, o)).astype(
            np.float32)).to(dtype)
        p = cuda_conv.conv3_plan(c, o, dtype)
        packed = cuda_conv.pack_conv3_weights(w, dtype)
        assert packed.dtype == dtype and packed.is_contiguous()
        assert tuple(packed.shape) == _packed_shape(p)
        assert torch.equal(_unpack(packed, c, o, dtype), w)
        if dtype == torch.float32:  # hi is TF32, hi + lo exact
            hi = packed.select(5 if p.kw else 6, 0)
            assert (_bits(hi) & 0x1FFF).eq(0).all()


def _k_perm(kk):
    """The channel that K index k of a k-step holds (h = k // (kk/2),
    e = k % (kk/2) = a * kk/8 + r -> channel a * kk/4 + h * kk/8 + r)."""
    perm = [(k % (kk // 2)) // (kk // 8) * (kk // 4)
            + k // (kk // 2) * (kk // 8) + k % (kk // 8) for k in range(kk)]
    assert sorted(perm) == list(range(kk))
    return perm


def _b_tile(tile, kk, n):
    """One k-step part (n/8 groups, K half, row, kk/2) as the wgmma
    descriptor reads it: core matrix (j, h) holds output columns 8j..8j+7
    at K h*kk/2 .. h*kk/2 + kk/2 - 1.  -> B[k, n]."""
    return tile.permute(1, 3, 0, 2).reshape(kk, n)


def _emulate_tc(x, packed, plan):
    """The tensor-core kernel's GEMM walked as the kernel walks it: for each
    output chunk, channel block, (kd, kh) stage, kw tap and k-step, the
    shifted input channels (in the kernel's K order) times the B tile read
    the way the wgmma descriptor reads it.  A kw-form plan is walked by
    :func:`_emulate_kw`."""
    if plan.kw:
        return _emulate_kw(x, packed, plan)
    b, d, h, w, c = x.shape
    xp = torch.zeros((b, d, h, w, plan.n_cb * plan.cb))
    xp[..., :c] = x.float()
    y = torch.zeros((b, d - 2, h - 2, w - 2, plan.n_chunks * plan.nc))
    kk = plan.kk
    perm = _k_perm(kk)
    for chunk in range(plan.n_chunks):
        for cbi in range(plan.n_cb):
            for kd in range(3):
                for kh in range(3):
                    for kw in range(3):
                        for cs in range(plan.cb // kk):
                            c0 = cbi * plan.cb + cs * kk
                            a = xp[:, kd:kd + d - 2, kh:kh + h - 2,
                                   kw:kw + w - 2, c0:c0 + kk][..., perm]
                            tile = packed[chunk, cbi, kd, kh, kw, cs].float()
                            # hi + lo (f32) or the one part
                            bmat = _b_tile(tile.sum(0), kk, plan.nc)
                            n0 = chunk * plan.nc
                            y[..., n0:n0 + plan.nc] += a @ bmat
    return y[..., :plan.o]


KW_TH, KW_IW, KW_OW = 4, 16, 14  # a kw tile: output rows, input columns


def _kw_epilogue(dt, nc, shifts=(1, 2)):
    """csrc/conv3_tc.cu's kw epilogue on one tile's D (..., 16 input
    columns, 3 nc), through the lanes: lane g holds column g (half 0) and
    g + 8 (half 1); for kw = 1, 2 it reads both halves of lane (g + kw) % 8
    at tap kw's columns and adds half 0 where g + kw < 8, else half 1, to
    its output column g, and half 1 to its output column g + 8 (``shifts``
    the kw taps added so; a fault leaves one out).  -> (..., 14 output
    columns, nc)."""
    regs = dt.reshape(dt.shape[:-2] + (2, 8, 3 * nc)).transpose(-3, -2)
    v = regs[..., :nc].clone()                # (..., g, half, nc), kw = 0
    g = torch.arange(8)
    for kw in shifts:
        got = regs[..., (g + kw) % 8, :, kw * nc:(kw + 1) * nc]
        low = (g + kw < 8).view(8, 1)
        v[..., 0, :] += torch.where(low, got[..., 0, :], got[..., 1, :])
        v[..., 1, :] += got[..., 1, :]
    # output column g + 8 * half, kept where it is under 14
    return v.transpose(-3, -2).reshape(dt.shape[:-2] + (16, nc))[
        ..., :KW_OW, :]


def _emulate_kw(x, packed, plan, tf32x3=False, shifts=(1, 2)):
    """The kw form's GEMM as csrc/conv3_tc.cu conv3_tc_kernel_kw tiles it
    (the kernel takes the same products in another order): tiles of 4
    output rows by 16 input columns (zero past the volume), for each
    channel block and (kh, kd) stage one k-step per kk channels, the
    (kd, kh)-shifted input (in the kernel's K order) times the B tile of
    N = 3 nc read as the wgmma descriptor reads it, then the tile's
    epilogue (:func:`_kw_epilogue`) and the ragged rows, columns and
    channels cut.  ``tf32x3``: the kernel's f32 arithmetic, x split by
    truncation in registers, each lo read as TF32, x_lo w_hi + x_hi w_lo +
    x_hi w_hi; else the exact hi + lo weights on the unsplit input."""
    b, d, h, w, c = x.shape
    od, oh, ow, nc, kk = d - 2, h - 2, w - 2, plan.nc, plan.kk
    nth, ntw = -(-oh // KW_TH), -(-ow // KW_OW)
    xp = torch.zeros((b, d, nth * KW_TH + 2, (ntw - 1) * KW_OW + KW_IW,
                      plan.n_cb * plan.cb))
    xp[:, :, :h, :w, :c] = x.float()
    perm = _k_perm(kk)
    y = torch.zeros((b, od, nth * KW_TH, ntw * KW_OW, nc))
    for th in range(nth):
        for tw in range(ntw):
            h0, w0 = th * KW_TH, tw * KW_OW
            xt = xp[:, :, h0:h0 + KW_TH + 2, w0:w0 + KW_IW]
            dt = torch.zeros((b, od, KW_TH, KW_IW, 3 * nc))
            for cbi in range(plan.n_cb):
                for kd in range(3):
                    for kh in range(3):
                        for cs in range(plan.cb // kk):
                            c0 = cbi * plan.cb + cs * kk
                            a = xt[:, kd:kd + od, kh:kh + KW_TH, :,
                                   c0:c0 + kk][..., perm]
                            tile = packed[0, cbi, kh, kd, cs].float()
                            if not tf32x3:
                                dt += a @ _b_tile(tile.sum(0), kk, 3 * nc)
                                continue
                            w_hi = _b_tile(tile[0], kk, 3 * nc)
                            w_lo = _trunc_tf32(_b_tile(tile[1], kk, 3 * nc))
                            a_hi = _trunc_tf32(a)
                            a_lo = _trunc_tf32(a - a_hi)
                            dt += a_lo @ w_hi
                            dt += a_hi @ w_lo
                            dt += a_hi @ w_hi
            y[:, :, h0:h0 + KW_TH, w0:w0 + KW_OW] = _kw_epilogue(dt, nc,
                                                                 shifts)
    return y[:, :, :oh, :ow, :plan.o]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("c,o", [(4, 8), (8, 16), (21, 85), (32, 64)])
def test_packed_layout_drives_the_conv(c, o, dtype):
    rng = np.random.default_rng(14 + c)
    x = torch.from_numpy(rng.normal(0, 1, (1, 6, 7, 8, c)).astype(
        np.float32)).to(dtype)
    w = torch.from_numpy((rng.normal(0, 1, (3, 3, 3, c, o))
                          / np.sqrt(27 * c)).astype(np.float32)).to(dtype)
    plan = cuda_conv.conv3_plan(c, o, dtype)
    got = _emulate_tc(x, cuda_conv.pack_conv3_weights(w, dtype), plan)
    want = _conv(x.float(), w.float())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)


def test_packed_weights_cache():
    rng = np.random.default_rng(15)
    w = torch.from_numpy(rng.normal(0, 1, (3, 3, 3, 8, 16)).astype(
        np.float32))
    before = read_counts()["conv3_weight_packs"]
    p1 = cuda_conv.packed_weights(w)
    assert cuda_conv.packed_weights(w) is p1           # hit
    assert read_counts()["conv3_weight_packs"] == before + 1
    w.mul_(2.0)                                        # in place: new version
    p2 = cuda_conv.packed_weights(w)
    assert p2 is not p1
    assert read_counts()["conv3_weight_packs"] == before + 2
    assert torch.equal(_unpack(p2, 8, 16, torch.float32), w)


def test_packed_weights_bf16_target_packs_once_per_version():
    """A bf16 forward packs straight from the f32 parameter: once over
    repeated calls (in inference_mode too, where a per-call cast would be
    an inference tensor with no version counter), once more after an
    in-place update, each pack bit-equal to packing the cast weight, and
    apart from the f32 pack of the same parameter."""
    rng = np.random.default_rng(16)
    w = torch.nn.Parameter(torch.from_numpy(
        rng.normal(0, 1, (3, 3, 3, 8, 16)).astype(np.float32)))
    bf16 = torch.bfloat16
    before = read_counts()["conv3_weight_packs"]
    p1 = cuda_conv.packed_weights(w, bf16)
    with torch.inference_mode():
        assert cuda_conv.packed_weights(w, bf16) is p1
    assert cuda_conv.packed_weights(w, bf16) is p1
    assert read_counts()["conv3_weight_packs"] == before + 1
    assert p1.dtype == bf16
    assert torch.equal(p1.view(torch.int16), cuda_conv.pack_conv3_weights(
        w.detach().to(bf16), bf16).view(torch.int16))
    p32 = cuda_conv.packed_weights(w)
    assert p32.dtype == torch.float32
    assert read_counts()["conv3_weight_packs"] == before + 2
    with torch.no_grad():
        w.add_(1e-2)
    p2 = cuda_conv.packed_weights(w, bf16)
    assert cuda_conv.packed_weights(w, bf16) is p2 is not p1
    assert read_counts()["conv3_weight_packs"] == before + 3
    assert torch.equal(p2.view(torch.int16), cuda_conv.pack_conv3_weights(
        w.detach().to(bf16), bf16).view(torch.int16))


@pytest.mark.parametrize("c,o,act", [(8, 16, True), (1, 8, True),
                                     (16, 1, False)])
def test_bf16_forward_takes_the_f32_parameter(c, o, act):
    """A bf16 conv3 block on its f32 parameter computes what it computed on
    a per-call bf16 cast, forward and backward, and the gradient reaches
    the f32 parameter (in f32)."""
    from transfer_em_tpu_torch.models.blocks import ConvActND

    torch.manual_seed(0)
    m = (ConvActND if act else ConvND)(c, o, 3)
    x = torch.from_numpy(np.random.default_rng(17).normal(
        0, 1, (2, 9, 8, 7, c)).astype(np.float32)).to(torch.bfloat16)
    xs = [x.clone().requires_grad_(True) for _ in range(2)]
    y = m(xs[0])
    w16 = m.kernel.to(torch.bfloat16)  # the cast the block used to make
    # the block's activation takes the slope in bf16, as JAX's bf16 one does
    want = cuda_conv.conv3(xs[1], w16,
                           slope_in(torch.bfloat16) if act else None)
    assert y.dtype == torch.bfloat16 and torch.equal(y, want)
    g = torch.from_numpy(np.random.default_rng(18).normal(
        0, 1, tuple(y.shape)).astype(np.float32)).to(torch.bfloat16)
    (gw,) = torch.autograd.grad(want, m.kernel, g, retain_graph=True)
    y.backward(g)
    assert m.kernel.grad.dtype == torch.float32
    assert torch.equal(m.kernel.grad, gw)
    assert torch.equal(xs[0].grad, torch.autograd.grad(want, xs[1], g)[0])


# -- (4) the dispatch rule -----------------------------------------------------

def _on_conv3(m):
    """Whether ``ops/convs.py`` runs ConvND ``m``'s float32 conv on conv3."""
    n = m.kernel.dim() - 2
    x = torch.empty((1,) + (8,) * n + (m.kernel.shape[-2],), device="meta")
    return convs.conv_form(x, m.kernel, m.stride, m.padding) == "conv3"


@pytest.mark.parametrize("wf", [1, 2, 4, 8, 16, 32])
def test_every_generator_layer_has_a_kernel(wf):
    with torch.device("meta"):
        gen = UNetGenerator(wf=wf)
    pairs = [(m.kernel.shape[3], m.kernel.shape[4])
             for m in gen.modules()
             if isinstance(m, ConvND) and _on_conv3(m)]
    assert len(pairs) == 8
    for c, o in pairs:
        path = cuda_conv.conv3_path(c, o)
        assert path == ("tc" if c >= 4 and o >= 8 else "direct")
        if path == "tc":
            for dtype in DTYPES:
                p = cuda_conv.conv3_plan(c, o, dtype)
                es = torch.empty((), dtype=dtype).element_size()
                assert p.nc in (8, 16, 32, 64) and p.cb % p.kk == 0
                assert p.cb * es <= 64 and p.n_cb * p.cb >= c
                assert p.n_chunks * p.nc >= o
                assert p.smem_bytes <= cuda_conv.SMEM_LIMIT
    if wf == 8:
        assert [cuda_conv.conv3_path(c, o) for c, o in pairs] == [
            "direct", "tc", "tc", "tc", "tc", "tc", "tc", "direct"]


# -- (5) the kw form: f32 at O <= 32 -------------------------------------------

# (C, O) of the f32 k3 convs at wf=8 that take the kw form: the generator's
# down1.conv, down2.conv, up1.conv, mid, up0.conv, head and the
# discriminator's hack, down2.conv, down3.conv
KW_PAIRS = [(8, 8), (8, 16), (16, 32), (32, 32), (32, 16), (16, 16)]


@pytest.mark.parametrize("c,o", KW_PAIRS + [(4, 8), (5, 13), (21, 30),
                                            (64, 32), (256, 32)])
def test_kw_pack_roundtrip(c, o):
    """The kw form's B layout: its shape (the three kw taps side by side,
    N = 3 nc), the exact inverse, hi a TF32 value and hi + lo the weight,
    tap kw's weights at columns kw * nc + o of each k-step, and the hi and
    lo parts of a k-step neighbours, so that [w_hi | w_lo] reads as one
    B of N = 6 nc."""
    rng = np.random.default_rng(30 + c + o)
    w = torch.from_numpy(rng.normal(0, 1, (3, 3, 3, c, o)).astype(np.float32))
    p = cuda_conv.conv3_plan(c, o, torch.float32)
    assert p.kw and p.n_chunks == 1 and p.nc >= o
    packed = cuda_conv.pack_conv3_weights(w, torch.float32)
    assert tuple(packed.shape) == (1, p.n_cb, 3, 3, p.cb // 8, 2,
                                   3 * p.nc // 8, 2, 8, 4)
    assert torch.equal(_unpack(packed, c, o, torch.float32), w)
    assert (_bits(packed[:, :, :, :, :, 0]) & 0x1FFF).eq(0).all()
    perm = _k_perm(8)
    for kd, kh, cbi, cs in ((0, 0, 0, 0), (2, 1, p.n_cb - 1, p.cb // 8 - 1)):
        tile = packed[0, cbi, kh, kd, cs]
        bmat = _b_tile(tile.sum(0), 8, 3 * p.nc)
        both = _b_tile(tile.reshape((6 * p.nc // 8,) + tile.shape[2:]), 8,
                       6 * p.nc)
        assert torch.equal(both, torch.cat([_b_tile(tile[0], 8, 3 * p.nc),
                                            _b_tile(tile[1], 8, 3 * p.nc)],
                                           1))
        for kw in range(3):
            want = torch.zeros((8, p.nc))
            ch = [cbi * p.cb + cs * 8 + k for k in perm]
            for k, cc in enumerate(ch):
                if cc < c:
                    want[k, :o] = w[kd, kh, kw, cc]
            assert torch.equal(bmat[:, kw * p.nc:(kw + 1) * p.nc], want)


@pytest.mark.parametrize("c,o,shape", [
    (8, 8, (1, 6, 10, 32)),      # two full tiles a row, OW = 30 = 2 x 14 + 2
    (8, 16, (2, 5, 7, 16)),      # OW = 14: one tile exactly
    (16, 32, (1, 4, 13, 13)),    # up1.conv's 11^3 outputs a plane
    (32, 32, (1, 3, 9, 24)),     # mid's 22 columns: one ragged tile
    (32, 16, (1, 4, 6, 22)),     # up0.conv's 20 columns
    (16, 16, (1, 3, 11, 17)),    # OW = 15: a tile of one column
    (5, 13, (1, 3, 3, 3)),       # one output voxel, C and O ragged
    (21, 30, (1, 4, 5, 31))])
def test_kw_walk_matches_the_conv(c, o, shape):
    """The kw form walked as the kernel walks it (per (kd, kh) k-step,
    N = 3 O, the three shifted rows summed through the epilogue's lanes,
    the tiles' ragged edges masked) against the plain f32 conv, at the wf=8
    narrow shapes and at ragged extents: atol 1e-4, the bar of
    test_packed_layout_drives_the_conv."""
    rng = np.random.default_rng(40 + c + o)
    x = torch.from_numpy(rng.normal(0, 1, shape + (c,)).astype(np.float32))
    w = torch.from_numpy((rng.normal(0, 1, (3, 3, 3, c, o))
                          / np.sqrt(27 * c)).astype(np.float32))
    plan = cuda_conv.conv3_plan(c, o, torch.float32)
    assert plan.kw
    got = _emulate_kw(x, cuda_conv.pack_conv3_weights(w, torch.float32), plan)
    want = _conv(x, w)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4)


def test_kw_walk_with_a_shift_dropped_fails():
    """The walk's epilogue with one kw shift left out (tap 2's row not
    added, the fault chip_smoke.py plants in the kernel) misses the conv
    by far more than the bar."""
    rng = np.random.default_rng(47)
    x = torch.from_numpy(rng.normal(0, 1, (1, 4, 6, 20, 8)).astype(
        np.float32))
    w = torch.from_numpy((rng.normal(0, 1, (3, 3, 3, 8, 8))
                          / np.sqrt(27 * 8)).astype(np.float32))
    plan = cuda_conv.conv3_plan(8, 8, torch.float32)
    packed = cuda_conv.pack_conv3_weights(w, torch.float32)
    want = _conv(x, w)
    sound = (_emulate_kw(x, packed, plan) - want).abs().max()
    fault = (_emulate_kw(x, packed, plan, shifts=(1,)) - want).abs().max()
    assert sound <= 1e-4 < 0.1 < fault


@pytest.mark.parametrize("c,o", KW_PAIRS)
def test_kw_tf32x3_matches_jax_conv(c, o):
    """The kw form's f32 arithmetic emulated (x split in registers by
    truncation, each lo read as TF32, the three products summed in f32 over
    each k-step of N = 3 O, then the shifted rows) against the JAX conv at
    conv3's f32 bar, 1e-4 max(1, |ref|)."""
    x, w, ref = _inputs(c, o, 50 + c + o)
    plan = cuda_conv.conv3_plan(c, o, torch.float32)
    got = _emulate_kw(x, cuda_conv.pack_conv3_weights(w, torch.float32), plan,
                      tf32x3=True).numpy()
    assert got.shape == ref.shape
    tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
    assert np.abs(got - ref).max() <= tol


def _tap_plan_fields(c, o, dtype):
    """The tap form's plan as conv3_plan made it before the kw form: planes,
    residency and shared memory from the tap kernel's ``Cfg``."""
    kk = 8 if dtype == torch.float32 else 16
    es = 4 if dtype == torch.float32 else 2
    cb = min(-(-c // kk) * kk, 64 // es)
    nc = next((n for n in (8, 16, 32, 64) if n >= o), 64)
    planes = 4 if nc <= 32 else 2
    stage = 3 * (cb // kk) * (2 if es == 4 else 1) * nc * 32
    inp = (planes + 2) * 100 * (32 if cb == kk else 96)
    resident = inp + 9 * stage <= 75 * 1024
    return (cb, nc, planes, resident, inp + (9 if resident else 2) * stage)


@pytest.mark.parametrize("wf", [1, 2, 4, 8, 16, 32])
def test_kw_form_where_f32_and_o_at_most_32(wf):
    """conv3_plan takes the kw form exactly where the dtype is float32 and
    O <= 32, at every tensor-core k3 conv of UNetGenerator(wf) and
    Discriminator(wf); every bf16 plan and every plan with nc = 64 is the
    tap form's plan as it was, field by field."""
    from transfer_em_tpu_torch.models import Discriminator

    with torch.device("meta"):
        nets = (UNetGenerator(wf=wf), Discriminator(wf=wf))
    pairs = {(m.kernel.shape[3], m.kernel.shape[4])
             for net in nets for m in net.modules()
             if isinstance(m, ConvND) and _on_conv3(m)}
    kw_seen = tap_seen = 0
    for c, o in sorted(pairs):
        if cuda_conv.conv3_path(c, o) != "tc":
            continue
        for dtype in DTYPES:
            p = cuda_conv.conv3_plan(c, o, dtype)
            assert p.kw == (dtype == torch.float32 and o <= 32)
            assert p == cuda_conv.tc_plan(c, o, dtype, p.kw)
            if p.kw:
                kw_seen += 1
                assert p.nc in (8, 16, 32) and p.n_chunks == 1
                assert p.smem_bytes <= cuda_conv.SMEM_LIMIT
            else:
                tap_seen += 1
                assert dtype == torch.bfloat16 or p.nc == 64
                assert (p.cb, p.nc, p.planes, p.resident, p.smem_bytes) == (
                    _tap_plan_fields(c, o, dtype))
    assert tap_seen > 0 and kw_seen > 0


def test_kw_form_counts_beside_conv3_tc():
    """``conv3_tc_kw`` is a count of the registry, read beside conv3_tc."""
    from transfer_em_tpu_torch import telemetry

    names = list(telemetry.LAUNCHES)
    assert names.index("conv3_tc_kw") == names.index("conv3_tc") + 1
    assert "conv3_tc_kw" in read_counts()
    with pytest.raises(ValueError):
        cuda_conv.tc_plan(16, 64, torch.float32, True)
    with pytest.raises(ValueError):
        cuda_conv.tc_plan(16, 16, torch.bfloat16, True)


@pytest.mark.parametrize("planes,n_td,chunks", [(4, 17, 17), (4, 17, 5),
                                                (2, 6, 3), (4, 1, 1)])
def test_kw_ring_keeps_each_chunks_planes(planes, n_td, chunks):
    """The kw kernel's input ring replayed as it runs it: a block walking
    chunks [dc0, dc1) copies chunk dc0's P + 2 planes to slot dc0 P mod R
    on, then at each chunk's start (after its barrier) the next chunk's P
    new planes to their own plane mod R (R = 2P + 2).  Every slot a chunk
    reads, (dc P mod R + j) mod R for j < P + 2, holds plane dc P + j when
    it is read, and a copy never lands in a slot the current chunk reads."""
    ring = 2 * planes + 2
    for dc0 in range(0, n_td, chunks):
        dc1 = min(n_td, dc0 + chunks)
        slots = [None] * ring
        for j in range(planes + 2):
            slots[(dc0 * planes % ring + j) % ring] = dc0 * planes + j
        for dc in range(dc0, dc1):
            reads = [(dc * planes % ring + j) % ring
                     for j in range(planes + 2)]
            if dc + 1 < dc1:  # the prefetch, before this chunk's products
                z = dc * planes + planes + 2
                for j in range(planes):
                    assert (z + j) % ring not in reads
                    slots[(z + j) % ring] = z + j
            assert [slots[s] for s in reads] == [
                dc * planes + j for j in range(planes + 2)]
