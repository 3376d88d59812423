"""Which form the port's k4 stride-2 down conv takes by default
(``ops/convs.py`` ``conv_form``): the down4 kernel (``ops/cuda_down.py``,
``csrc/down4_tc.cu``) for a 3D VALID float32 call that records no
gradient, ``F.conv{2,3}d`` for every other call; the kernel's plain
version against ``F.conv3d`` and the JAX package's ``conv_nd`` at the
generator's and discriminator's down shapes; the kernel's walk (its input
patch, gather and packed weights, as ``csrc/down4_tc.cu`` indexes them)
against ``F.conv3d``; the fused LeakyReLU; the weight pack cached per
parameter; the counts by form.

Tolerances: each output of a k4 conv sums 64 * Cin products, and the
plain version sums them in another order (8 * Cin channels a tap over 8
taps) than ``F.conv3d`` or XLA does.  At these shapes, with weights of std
1/sqrt(64 * Cin) (outputs O(1)), either float32 form lies within 3.3e-6
of the largest value of a float64 reference, so the forms are held to
each other within 1e-5 of the largest value: about three times the widest
float32 gap, and far under an error of one term."""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from transfer_em_tpu.ops import convs as jconvs
from transfer_em_tpu_torch.models import Discriminator, UNetGenerator
from transfer_em_tpu_torch.models.blocks import DownBlock, leaky
from transfer_em_tpu_torch.ops import convs, cuda_down, quant
from transfer_em_tpu_torch.ops.counts import read_counts, reset_counts
from transfer_em_tpu_torch.ops.cuda_kernels import slope_in

torch.set_num_threads(1)

# (layer, x shape without channels, Cin, Cout, default route the down4
# kernel) at B=1: the wf=8 generator's and discriminator's down convs, a
# wf=1 width (64 channels), odd extents, and small odd and even extents
# (under DOWN_MIN_OUT outputs an axis: F.conv3d by default)
DOWN_CONVS = [("gen.down1.down", (1, 70, 70, 70), 8, 8, True),
              ("gen.down2.down", (1, 32, 32, 32), 16, 16, True),
              ("disc.down1.down", (1, 38, 38, 38), 8, 8, True),
              ("disc.down2.down", (1, 14, 14, 14), 32, 32, False),
              ("disc.down3.down", (1, 4, 4, 4), 32, 32, False),
              ("wf1.64to64", (1, 32, 32, 32), 64, 64, True),
              ("odd", (1, 33, 35, 37), 8, 16, True),
              ("small_odd", (1, 9, 11, 13), 8, 16, False),
              ("small_odd_even", (2, 7, 8, 5), 4, 8, False)]
REL_TOL = 1e-5  # of the largest value (module docstring)


def _kernel(cin, cout, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((4, 4, 4, cin, cout), generator=g) / (64 * cin) ** 0.5


def _x(shape, cin, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape + (cin,), generator=g)


def _cudnn_form(x, w):
    """The k4 stride-2 VALID conv as F.conv3d (cuDNN on the card)."""
    y = F.conv3d(x.permute(0, 4, 1, 2, 3), w.permute(4, 3, 0, 1, 2),
                 stride=2)
    return y.permute(0, 2, 3, 4, 1)


def _down(x, w, stride, padding):
    """Whether ``conv_form`` picks the down4 kernel for the call."""
    return convs.conv_form(x, w, stride, padding) == "down4"


def _routes():
    c = read_counts()
    return c["down_k4"], c["down_cudnn"]


def _assert_parity(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0.5
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=REL_TOL * scale)


@pytest.mark.parametrize("layer,shape,cin,cout,k4", DOWN_CONVS,
                         ids=[c[0] for c in DOWN_CONVS])
def test_k4_form_matches_cudnn_and_jax(layer, shape, cin, cout, k4):
    """The down4 kernel's plain version against F.conv3d and the JAX
    package's conv_nd; the default of a call that records no gradient
    bit-equal to it where the rule takes it (the generator's down convs),
    to F.conv3d where not; the output extent n//2 - 1 an axis, an odd
    extent's last voxel unread."""
    x, w = _x(shape, cin), _kernel(cin, cout)
    with torch.inference_mode():
        got = cuda_down.down4_plain(x, w)
        reset_counts()
        routed = convs.conv_nd(x, w, stride=2)
        assert _routes() == ((1, 0) if k4 else (0, 1))
    assert torch.equal(routed, got if k4 else _cudnn_form(x, w))
    want = np.asarray(jconvs.conv_nd(jnp.asarray(x.numpy()),
                                     jnp.asarray(w.numpy()), stride=2))
    assert got.shape == want.shape == (shape[0],) + tuple(
        s // 2 - 1 for s in shape[1:]) + (cout,)
    _assert_parity(got, _cudnn_form(x, w))
    _assert_parity(got, want)


def test_planted_channel_order_fault_is_caught(monkeypatch):
    """kernel_to_depth with its input channels ordered (c, p) where
    space_to_depth orders them (p, c): the parity check fails."""
    def swapped(k, s):
        n = k.dim() - 2
        kk, c, o = k.shape[0], k.shape[-2], k.shape[-1]
        k = k.reshape([kk // s, s] * n + [c, o])
        perm = ([2 * i for i in range(n)] + [2 * n]
                + [1 + 2 * i for i in range(n)] + [2 * n + 1])
        return k.permute(perm).reshape((kk // s,) * n + (s ** n * c, o))

    _, shape, cin, cout, _ = DOWN_CONVS[1]
    x, w = _x(shape, cin), _kernel(cin, cout)
    monkeypatch.setattr(cuda_down, "kernel_to_depth", swapped)
    with torch.inference_mode():
        got = cuda_down.down4_plain(x, w)
    with pytest.raises(AssertionError):
        _assert_parity(got, _cudnn_form(x, w))


def _tap_order_fault(k, s):
    """kernel_to_depth with the taps of each axis ordered (r, j) where
    space_to_depth's blocks run (j, r): w[2j + r] read as w[2r + j]."""
    n = k.dim() - 2
    kk, c, o = k.shape[0], k.shape[-2], k.shape[-1]
    k = k.reshape([s, kk // s] * n + [c, o])
    perm = [1 + 2 * i for i in range(n)] + [2 * i for i in range(n)]
    return k.permute(perm + [2 * n, 2 * n + 1]).reshape(
        (kk // s,) * n + (s ** n * c, o))


def _stride_offset_fault(x, s):
    """space_to_depth of x one voxel on along W: the stride-2 blocks start
    at odd offsets."""
    shifted = torch.cat([x[:, :, :, 1:], x[:, :, :, :1]], dim=3)
    return _real_space_to_depth(shifted, s)


_real_space_to_depth = cuda_down.space_to_depth


@pytest.mark.parametrize("fault", ["tap_order", "stride_offset"])
def test_planted_plain_fault_is_caught(monkeypatch, fault):
    """The plain version with a tap-order fault (each axis's taps read
    (r, j) for (j, r)) or a stride-2 offset fault (the blocks one voxel on
    along W) fails the parity check against F.conv3d, at the generator's
    down1.down and down2.down."""
    if fault == "tap_order":
        monkeypatch.setattr(cuda_down, "kernel_to_depth", _tap_order_fault)
    else:
        monkeypatch.setattr(cuda_down, "space_to_depth", _stride_offset_fault)
    for _, shape, cin, cout, _ in DOWN_CONVS[:2]:
        x, w = _x(shape, cin), _kernel(cin, cout)
        with torch.inference_mode():
            got = cuda_down.down4_plain(x, w)
        with pytest.raises(AssertionError):
            _assert_parity(got, _cudnn_form(x, w))


def test_space_to_depth_pair_is_shared():
    """The plain version's space-to-depth pair is the int8 path's (quant.py
    imports cuda_down's), and it pairs: a 2-tap stride-1 conv over
    space_to_depth(x) by kernel_to_depth(w) is the k4 stride-2 conv of the
    even crop (an odd extent's last voxel unread)."""
    assert quant.space_to_depth is cuda_down.space_to_depth
    assert quant.kernel_to_depth is cuda_down.kernel_to_depth
    x, w = _x((2, 9, 6, 7), 3), _kernel(3, 5)
    xs = cuda_down.space_to_depth(x[:, :8, :6, :6], 2)
    assert xs.shape == (2, 4, 3, 3, 24)
    # block (1, 2, 0), offsets (0, 1, 1): channels 3 * 3 .. 3 * 3 + 2
    assert torch.equal(xs[0, 1, 2, 0, 9:12], x[0, 2, 5, 1])
    _assert_parity(cuda_down.down4_plain(x, w), _cudnn_form(x, w))


def test_route_rule_reads_only_the_call():
    """conv_form's down4 rule: 3D, k4, s2, VALID, float32, DOWN_MIN_OUT
    outputs an axis and no recorded gradient, each needed; grad enabled
    alone does not count, a requires_grad operand does; no width bound."""
    x, w = _x((1, 32, 33, 32), 4), _kernel(4, 8)
    assert _down(x, w, 2, "VALID")
    with torch.no_grad():
        assert _down(x, w, 2, "VALID")
    with torch.inference_mode():
        assert _down(x, w, 2, "VALID")
    assert not _down(x.bfloat16(), w, 2, "VALID")
    assert not _down(x.double(), w, 2, "VALID")
    assert not _down(x, w.clone().requires_grad_(), 2, "VALID")
    assert not _down(x.clone().requires_grad_(), w, 2, "VALID")
    assert not _down(x[:, 0], w[0], 2, "VALID")  # 2D
    assert not _down(x, w, 2, "SAME")
    assert not _down(x, w, 1, "VALID")
    assert not _down(x, torch.randn(3, 3, 3, 4, 8), 2, "VALID")
    assert not _down(x, torch.randn(4, 4, 2, 4, 8), 2, "VALID")
    # 15 outputs an axis: the wf=8 generator's down2.down (32^3 in) takes
    # it, the discriminator's down2.down (14^3 in) does not
    assert convs.DOWN_MIN_OUT == 32 // 2 - 1
    assert not _down(x[:, :31], w, 2, "VALID")
    assert not _down(x[:, :, :, :30], w, 2, "VALID")
    wide = torch.empty(4, 4, 4, 256, 256, device="meta")
    assert _down(torch.empty(1, 32, 32, 32, 256, device="meta"), wide, 2,
                 "VALID")


def _bf16(x, w):
    with torch.inference_mode():
        return convs.conv_nd(x.bfloat16(), w, stride=2)


def _recording(x, w):
    return convs.conv_nd(x, w.clone().requires_grad_(), stride=2)


def _twod(x, w):
    with torch.inference_mode():
        return convs.conv_nd(x[:, 0], w[0], stride=2)


def _vmapped(x, w):
    """Under torch.func.vmap over stacked kernels (the train step's
    ensemble_apps), whose wrappers do not show requires_grad."""
    ws = torch.stack([w, w]).requires_grad_()
    return torch.func.vmap(lambda k: convs.conv_nd(x, k, stride=2))(ws)


@pytest.mark.parametrize("call", [_bf16, _recording, _twod, _vmapped],
                         ids=["bf16", "recording", "2d", "vmap"])
def test_other_down_calls_stay_on_cudnn(call):
    """bf16, a forward that records a gradient (or may, under vmap), and
    2D each run F.conv{2,3}d, as before, at an extent the route takes in
    f32 inference: the down_k4 count stays, the other rises (once a
    vmapped call)."""
    x, w = _x((1, 32, 32, 32), 8), _kernel(8, 8)
    reset_counts()
    call(x, w)
    assert _routes() == (0, 1)


def test_same_and_other_convs_count_neither():
    """A SAME k4 stride-2 conv, a k3 or a 1x1 conv, and the int8
    generator's down convs (their own layout on the int8 kernel) take
    F.conv or the int8 path and count under neither form."""
    x = _x((1, 8, 8, 8), 8)
    reset_counts()
    with torch.inference_mode():
        convs.conv_nd(x, _kernel(8, 8), stride=2, padding="SAME")
        convs.conv_nd(x, torch.randn(3, 3, 3, 8, 8))
        convs.conv_nd(x, torch.randn(1, 1, 1, 8, 8))
        UNetGenerator(wf=32, int8_conv=True).eval()(_x((1, 42, 42, 42), 1))
    assert _routes() == (0, 0)


def test_fused_leaky_equals_leaky_after_cudnn_form():
    """conv_nd(leaky=) on the route: the LeakyReLU of the kernel's epilogue
    is exactly leaky after the plain version, and within the parity
    tolerance of leaky after the cuDNN form; off the route, exactly leaky
    after it."""
    x, w = _x((1, 32, 34, 32), 8), _kernel(8, 16)
    slope = slope_in(torch.float32)
    with torch.inference_mode():
        fused = convs.conv_nd(x, w, stride=2, leaky=slope)
        plain = cuda_down.down4_plain(x, w)
    assert torch.equal(fused, leaky(plain))
    _assert_parity(fused, leaky(_cudnn_form(x, w)))
    wg = w.clone().requires_grad_()
    off = convs.conv_nd(x, wg, stride=2, leaky=slope)
    assert torch.equal(off, leaky(convs.conv_nd(x, wg, stride=2)))


def test_down_block_fuses_its_leaky_on_the_route():
    """DownBlock under inference_mode: its down conv on the route with the
    LeakyReLU fused, within the parity tolerance of leaky after F.conv3d;
    with a recorded gradient, leaky after F.conv3d bit for bit, and the
    gradient flows."""
    g = torch.Generator().manual_seed(4)
    block = DownBlock(4, 8, generator=g)
    with torch.no_grad():
        for p in block.parameters():
            p.copy_(torch.randn(p.shape, generator=g)
                    * p[..., 0].numel() ** -0.5)
    x = _x((1, 34, 34, 34), 4)
    reset_counts()
    with torch.inference_mode():
        down, skip = block(x)
    assert _routes() == (1, 0)
    _assert_parity(down, leaky(_cudnn_form(skip,
                                           block.down.kernel.detach())))
    xg = x.clone().requires_grad_()
    down_g, skip_g = block(xg)
    assert _routes() == (1, 1)
    assert torch.equal(down_g, leaky(_cudnn_form(skip_g, block.down.kernel)))
    down_g.sum().backward()
    assert xg.grad is not None and block.down.kernel.grad is not None


def test_counts_through_the_generator_under_inference_mode():
    """An f32 UNetGenerator forward under inference_mode runs both down
    convs on the down4 route, none on F.conv3d (on the card each is one
    down4 launch; the CPU's is its plain version, uncounted); the
    discriminator its first (18^3 out), its 6^3 and 1^3 ones on F.conv3d;
    bf16 and a recorded gradient take F.conv3d."""
    gen = UNetGenerator(wf=8).eval()
    x = _x((1, 74, 74, 74), 1)
    reset_counts()
    with torch.inference_mode():
        gen(x)
    c = read_counts()
    assert (c["down_k4"], c["down_cudnn"], c["down4"]) == (2, 0, 0)
    assert (c["transpose_phase"], c["transpose_cudnn"]) == (2, 0)
    reset_counts()
    with torch.inference_mode():
        Discriminator(wf=8).eval()(_x((1, 40, 40, 40), 1))
    assert _routes() == (1, 2)
    reset_counts()
    with torch.inference_mode():
        UNetGenerator(wf=8, compute_dtype="bfloat16").eval()(x)
    assert _routes() == (0, 2)
    reset_counts()
    gen(x.clone().requires_grad_())
    assert _routes() == (0, 2)


# -- the kernel's own walk (csrc/down4_tc.cu), on the CPU ------------------

def _unpack(packed, c, o):
    """pack_down4_weights' inverse: (4, 4, 4, C, O), hi + lo summed."""
    p = cuda_down.down4_plan(c, o)
    v = packed.sum(5)  # (chunk, cb, kd, kh, kw, j, h, row, a)
    v = v.permute(2, 3, 4, 1, 8, 6, 0, 5, 7)  # kd kh kw cb a h chunk j row
    v = v.reshape(4, 4, 4, p.n_cb * 8, p.n_chunks * p.nc)
    return v[:, :, :, :c, :o]


@pytest.mark.parametrize("c,o", [(1, 1), (3, 5), (8, 8), (16, 16), (20, 85),
                                 (64, 64), (128, 128)])
def test_pack_roundtrip(c, o):
    """The pack's shape, hi a TF32 value, hi + lo the weight exactly, and
    the zero padding of C and O."""
    g = torch.Generator().manual_seed(c * 131 + o)
    w = torch.randn((4, 4, 4, c, o), generator=g)
    p = cuda_down.down4_plan(c, o)
    packed = cuda_down.pack_down4_weights(w)
    assert packed.dtype == torch.float32 and packed.is_contiguous()
    assert tuple(packed.shape) == (p.n_chunks, p.n_cb, 4, 4, 4, 2,
                                   p.nc // 8, 2, 8, 4)
    assert torch.equal(_unpack(packed, c, o), w)
    hi = packed[:, :, :, :, :, 0].contiguous().view(torch.int32)
    assert (hi & 0x1FFF).eq(0).all()
    assert int((packed.sum(5) != 0).sum()) == w.numel()  # padding zero


def _walk_down4(x, w, tiles, leaky_slope=None):
    """csrc/down4_tc.cu walked as it walks, in float64: for each block
    (sample, 4x4x(4 tiles) outputs, output chunk) and channel block, the
    input patch stored in its slots (W's parities apart), each thread's A
    words read at the kernel's offsets (its base, the tap's offset, the
    tile's, kRow8 for the second row set), each B word read where the
    kernel reads it in the pack, and the sums stored by the epilogue's
    mapping of rows to outputs; tiles wholly past the edge skipped."""
    kt, kin, cb = cuda_down.TILE, 2 * cuda_down.TILE + 2, 8
    bsz, d, h, wd, c = x.shape
    o = w.shape[-1]
    plan = cuda_down.down4_plan(c, o)
    wp = cuda_down.pack_down4_weights(w).double()
    iw = 2 * kt * tiles + 2
    wb = iw // 2
    od_, oh_, ow_ = d // 2 - 1, h // 2 - 1, wd // 2 - 1
    n_td, n_th = -(-od_ // kt), -(-oh_ // kt)
    n_tw = -(-ow_ // (kt * tiles))
    nn = plan.n_chunks * plan.nc

    def slot(sd, sh, sw):
        return ((sd * kin + sh) * 2 + (sw & 1)) * wb + (sw >> 1)

    warp = torch.arange(4).view(4, 1, 1)
    g = torch.arange(8).view(1, 8, 1)
    t = torch.arange(4).view(1, 1, 4)
    base = slot(2 * warp, 2 * (g >> 2), 2 * (g & 3)) * cb + 2 * t
    row8 = 4 * 2 * wb * cb
    rows = (16 * warp + g).expand(4, 8, 4)
    tt = t.expand(4, 8, 4)
    sd, sh, sw = torch.meshgrid(torch.arange(kin), torch.arange(kin),
                                torch.arange(iw), indexing="ij")
    slots = slot(sd, sh, sw).reshape(-1)
    # B[k, n] as the kernel reads core matrix j of a part: b0 = (k t,
    # n 8j + g) at word 64j + 4g + t, b1 = (k t + 4, n 8j + g) 32 words on
    k_, n_ = torch.meshgrid(torch.arange(8), torch.arange(nn), indexing="ij")
    b_chunk, b_j = n_ // plan.nc, n_ % plan.nc // 8
    b_word = k_ // 4 * 32 + n_ % 8 * 4 + k_ % 4
    xd = torch.zeros((bsz, d + kin, h + kin, wd + iw, plan.n_cb * cb),
                     dtype=torch.float64)
    xd[:, :d, :h, :wd, :c] = x.double()
    y = torch.zeros((bsz, od_, oh_, ow_, nn), dtype=torch.float64)
    for b, td, th, tw in itertools.product(range(bsz), range(n_td),
                                           range(n_th), range(n_tw)):
        od0, oh0, ow0 = td * kt, th * kt, tw * kt * tiles
        live = min(tiles, -(-(ow_ - ow0) // kt))
        acc = torch.zeros((tiles, 64, nn), dtype=torch.float64)
        for cbi in range(plan.n_cb):
            patch = xd[b, 2 * od0:2 * od0 + kin, 2 * oh0:2 * oh0 + kin,
                       2 * ow0:2 * ow0 + iw, cbi * cb:(cbi + 1) * cb]
            smem = torch.zeros((kin * kin * iw, cb), dtype=torch.float64)
            smem[slots] = patch.reshape(-1, cb)
            smem = smem.reshape(-1)
            for st, kw in itertools.product(range(16), range(4)):
                kd, kh = st >> 2, st & 3
                src0 = base + (((kd * kin + kh) * 2 + (kw & 1)) * wb
                               + (kw >> 1)) * cb
                step = wp[:, cbi, kd, kh, kw].sum(1).reshape(
                    plan.n_chunks, plan.nc // 8, 64)  # hi + lo
                bmat = step[b_chunk, b_j, b_word]
                for p in range(live):
                    src = src0 + p * kt * cb
                    a = torch.zeros((64, 8), dtype=torch.float64)
                    a[rows, tt] = smem[src]
                    a[rows + 8, tt] = smem[src + row8]
                    a[rows, tt + 4] = smem[src + 1]
                    a[rows + 8, tt + 4] = smem[src + row8 + 1]
                    acc[p] += a @ bmat
        for p, half in itertools.product(range(tiles), range(2)):
            od = od0 + warp.expand(4, 8, 1)
            oh = oh0 + (g >> 2).expand(4, 8, 1) + 2 * half
            ow = ow0 + p * kt + (g & 3).expand(4, 8, 1)
            m = (16 * warp + g + 8 * half).expand(4, 8, 1)
            ok = (od < od_) & (oh < oh_) & (ow < ow_)
            y[b, od[ok], oh[ok], ow[ok]] = acc[p, m[ok]]
    y = y[..., :o]
    if leaky_slope is not None:
        y = torch.where(y >= 0, y, y * leaky_slope)
    return y


@pytest.mark.parametrize("tiles", [1, 2])
@pytest.mark.parametrize("shape,c,o", [((1, 13, 11, 21), 8, 8),
                                       ((1, 10, 12, 19), 3, 5),
                                       ((2, 9, 10, 11), 20, 20)],
                         ids=["c8o8", "c3o5_odd", "c20_two_blocks"])
def test_kernel_walk_drives_the_conv(shape, c, o, tiles):
    """The kernel's walk (_walk_down4) against F.conv3d in float64 at odd
    extents, partial tiles along every axis, a tile wholly past the edge
    (tiles=2 at 9 outputs along W), C under one channel block and over
    one, O under one chunk; then with the epilogue's LeakyReLU."""
    x = _x(shape, c, seed=5)
    w = _kernel(c, o, seed=6)
    want = _cudnn_form(x.double(), w.double())
    got = _walk_down4(x, w, tiles)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0,
                               atol=1e-12)
    slope = slope_in(torch.float32)
    act = _walk_down4(x, w, tiles, slope)
    assert torch.equal(act, torch.where(got >= 0, got, got * slope))


@pytest.mark.parametrize("wf", [1, 2, 4, 8, 16, 32])
def test_down4_plan_covers_the_channels(wf):
    """The plan of each down conv of the generator and discriminator at
    ``wf``: O in chunks of the narrowest of the kernel's instantiations
    (csrc/down4_tc.cu ``tem_down4_tc``: 8, 16, 32, 64) that holds it, or of
    64 past it, and C in blocks of 8, each covering its channels with less
    than one chunk (block) of padding."""
    for c in (max(64 // wf, 1), max(128 // wf, 1), max(256 // wf, 1)):
        p = cuda_down.down4_plan(c, c)
        assert p.nc == min(n for n in (8, 16, 32, 64) if n >= min(c, 64))
        assert c <= p.nc * p.n_chunks < c + p.nc
        assert c <= p.n_cb * 8 < c + 8


def test_down4_pack_built_once_and_rebuilt_after_update():
    """The down4 pack of a parameter: built once over repeated calls (in
    inference_mode too), again after an in-place update, each pack the
    current weight's; apart from conv3's packs."""
    gen = UNetGenerator(wf=32).eval()
    kern = gen.down2.down.kernel
    reset_counts()
    p1 = cuda_down.packed_down4_weights(kern)
    with torch.inference_mode():
        assert cuda_down.packed_down4_weights(kern) is p1
    assert read_counts()["down4_weight_packs"] == 1
    with torch.no_grad():
        kern.mul_(1.5)
    p2 = cuda_down.packed_down4_weights(kern)
    assert p2 is not p1 and read_counts()["down4_weight_packs"] == 2
    assert torch.equal(_unpack(p2, *kern.shape[3:]), kern.detach())
    assert read_counts()["conv3_weight_packs"] == 0
    with torch.inference_mode():
        y = gen.down2.down(_x((1, 32, 32, 32), kern.shape[3]))
    _assert_parity(y, _cudnn_form(_x((1, 32, 32, 32), kern.shape[3]),
                                  kern.detach()))
