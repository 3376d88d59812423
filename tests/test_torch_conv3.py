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

def _unpack(packed, c, o, dtype):
    """Inverse of pack_conv3_weights (f32: hi + lo)."""
    p = cuda_conv.conv3_plan(c, o, dtype)
    v = packed.sum(dim=6) if p.parts == 2 else packed.squeeze(6)
    v = v.reshape(v.shape[:-1] + (4, p.kk // 8))
    # (chunk, cb, kd, kh, kw, k-step, j, h, row, a, r) -> (kd, kh, kw, cb,
    # k-step, a, h, r, chunk, j, row)
    v = v.permute(2, 3, 4, 1, 5, 9, 7, 10, 0, 6, 8)
    v = v.reshape(3, 3, 3, p.n_cb * p.cb, p.n_chunks * p.nc)
    return v[:, :, :, :c, :o]


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
        assert tuple(packed.shape) == (
            p.n_chunks, p.n_cb, 3, 3, 3, p.cb // p.kk, p.parts, p.nc // 8, 2,
            8, p.kk // 2)
        assert torch.equal(_unpack(packed, c, o, dtype), w)
        if dtype == torch.float32:  # hi is TF32, hi + lo exact
            assert (_bits(packed[:, :, :, :, :, :, 0]) & 0x1FFF).eq(0).all()


def _emulate_tc(x, packed, plan):
    """The tensor-core kernel's GEMM walked as the kernel walks it: for each
    output chunk, channel block, (kd, kh) stage, kw tap and k-step, the
    shifted input channels (in the kernel's K order) times the B tile read
    the way the wgmma descriptor reads it (core matrix (j, h) holds output
    channels 8j..8j+7 at K h*kk/2 .. h*kk/2 + kk/2 - 1)."""
    b, d, h, w, c = x.shape
    xp = torch.zeros((b, d, h, w, plan.n_cb * plan.cb))
    xp[..., :c] = x.float()
    y = torch.zeros((b, d - 2, h - 2, w - 2, plan.n_chunks * plan.nc))
    kk = plan.kk
    # the channel that K index k of a k-step holds (h = k // (kk/2),
    # e = k % (kk/2) = a * kk/8 + r -> channel a * kk/4 + h * kk/8 + r)
    perm = [(k % (kk // 2)) // (kk // 8) * (kk // 4)
            + k // (kk // 2) * (kk // 8) + k % (kk // 8) for k in range(kk)]
    assert sorted(perm) == list(range(kk))
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
                            bmat = tile.sum(0)  # hi + lo (f32) or the one part
                            # (j, half, row, e) -> B[k = half*kk/2 + e, n]
                            bmat = bmat.permute(1, 3, 0, 2).reshape(
                                kk, plan.nc)
                            n0 = chunk * plan.nc
                            y[..., n0:n0 + plan.nc] += a @ bmat
    return y[..., :plan.o]


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
