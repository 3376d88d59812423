"""Which form the port's k4 stride-2 down conv takes by default
(``ops/convs.py`` ``down_route``): the space-to-depth conv on conv3 for a
3D VALID float32 call that records no gradient, ``F.conv{2,3}d`` for every
other call; the s2d form against ``F.conv3d`` and the JAX package's
``conv_nd`` at the generator's and discriminator's down shapes; the fused
LeakyReLU; the s2d kernel cached per parameter; the counts by form.

Tolerances: each output of a k4 conv sums 64 * Cin products, and the s2d
form sums them in another order (8 * Cin channels a tap over 8 taps) than
``F.conv3d`` or XLA does.  At these shapes, with weights of std
1/sqrt(64 * Cin) (outputs O(1)), either float32 form lies within 3.3e-6
of the largest value of a float64 reference, so the forms are held to
each other within 1e-5 of the largest value: about three times the widest
float32 gap, and far under an error of one term."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from transfer_em_tpu.ops import convs as jconvs
from transfer_em_tpu_torch.models import Discriminator, UNetGenerator
from transfer_em_tpu_torch.models.blocks import DownBlock, leaky
from transfer_em_tpu_torch.ops import convs, quant
from transfer_em_tpu_torch.ops.counts import read_counts, reset_counts
from transfer_em_tpu_torch.ops.cuda_kernels import slope_in

torch.set_num_threads(1)

# (layer, x shape without channels, Cin, Cout, default route the s2d
# form) at B=1: the wf=8 generator's and discriminator's down convs, a
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


def _routes():
    c = read_counts()
    return c["down_s2d"], c["down_cudnn"]


def _assert_parity(got, want):
    want = np.asarray(want)
    scale = float(np.abs(want).max())
    assert scale > 0.5
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=REL_TOL * scale)


@pytest.mark.parametrize("layer,shape,cin,cout,s2d", DOWN_CONVS,
                         ids=[c[0] for c in DOWN_CONVS])
def test_s2d_form_matches_cudnn_and_jax(layer, shape, cin, cout, s2d):
    """The s2d form (the private helper, forced) against F.conv3d and the
    JAX package's conv_nd; the default of a call that records no gradient
    bit-equal to the forced form where the rule takes it (the generator's
    down convs), to F.conv3d where not; the output extent n//2 - 1 an
    axis, an odd extent's last voxel unread."""
    x, w = _x(shape, cin), _kernel(cin, cout)
    with torch.inference_mode():
        got = convs._conv_down_s2d(x, w)
        reset_counts()
        routed = convs.conv_nd(x, w, stride=2)
        assert _routes() == ((1, 0) if s2d else (0, 1))
    assert torch.equal(routed, got if s2d else _cudnn_form(x, w))
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
    monkeypatch.setattr(convs, "kernel_to_depth", swapped)
    with torch.inference_mode():
        got = convs._conv_down_s2d(x, w)
    with pytest.raises(AssertionError):
        _assert_parity(got, _cudnn_form(x, w))


def test_space_to_depth_padded_is_one_block_larger():
    """The padded buffer: the crop's space_to_depth, then zeros on each
    high face, bit for bit; quant.py's names are convs.py's."""
    x = _x((2, 9, 6, 7), 3)
    got = convs.space_to_depth_padded(x)
    want = F.pad(convs.space_to_depth(x[:, :8, :6, :6], 2),
                 (0, 0, 0, 1, 0, 1, 0, 1))
    assert torch.equal(got, want)
    assert quant.space_to_depth is convs.space_to_depth
    assert quant.kernel_to_depth is convs.kernel_to_depth


def test_route_rule_reads_only_the_call():
    """down_route: 3D, k4, s2, VALID, float32, DOWN_MIN_OUT outputs an
    axis and no recorded gradient, each needed; grad enabled alone does
    not count, a requires_grad operand does; no width bound."""
    x, w = _x((1, 32, 33, 32), 4), _kernel(4, 8)
    assert convs.down_route(x, w, 2, "VALID")
    with torch.no_grad():
        assert convs.down_route(x, w, 2, "VALID")
    with torch.inference_mode():
        assert convs.down_route(x, w, 2, "VALID")
    assert not convs.down_route(x.bfloat16(), w, 2, "VALID")
    assert not convs.down_route(x.double(), w, 2, "VALID")
    assert not convs.down_route(x, w.clone().requires_grad_(), 2, "VALID")
    assert not convs.down_route(x.clone().requires_grad_(), w, 2, "VALID")
    assert not convs.down_route(x[:, 0], w[0], 2, "VALID")  # 2D
    assert not convs.down_route(x, w, 2, "SAME")
    assert not convs.down_route(x, w, 1, "VALID")
    assert not convs.down_route(x, torch.randn(3, 3, 3, 4, 8), 2, "VALID")
    assert not convs.down_route(x, torch.randn(4, 4, 2, 4, 8), 2, "VALID")
    # 15 outputs an axis: the wf=8 generator's down2.down (32^3 in) takes
    # it, the discriminator's down2.down (14^3 in) does not
    assert convs.DOWN_MIN_OUT == 32 // 2 - 1
    assert not convs.down_route(x[:, :31], w, 2, "VALID")
    assert not convs.down_route(x[:, :, :, :30], w, 2, "VALID")
    wide = torch.empty(4, 4, 4, 256, 256, device="meta")
    assert convs.down_route(torch.empty(1, 32, 32, 32, 256, device="meta"),
                            wide, 2, "VALID")


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
    f32 inference: the s2d count stays, the other rises (once a vmapped
    call)."""
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
    """conv_nd(leaky=) on the route: the LeakyReLU of conv3's epilogue is
    exactly leaky after the s2d form, and within the parity tolerance of
    leaky after the cuDNN form; off the route, exactly leaky after it."""
    x, w = _x((1, 32, 34, 32), 8), _kernel(8, 16)
    slope = slope_in(torch.float32)
    with torch.inference_mode():
        fused = convs.conv_nd(x, w, stride=2, leaky=slope)
        plain = convs._conv_down_s2d(x, w)
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
    convs as the s2d conv, none on F.conv3d (on the card each is one more
    conv3 launch; the CPU's conv3 is its plain version, uncounted); the
    discriminator its first (18^3 out), its 6^3 and 1^3 ones on F.conv3d;
    bf16 and a recorded gradient take F.conv3d."""
    gen = UNetGenerator(wf=8).eval()
    x = _x((1, 74, 74, 74), 1)
    reset_counts()
    with torch.inference_mode():
        gen(x)
    c = read_counts()
    assert (c["down_s2d"], c["down_cudnn"]) == (2, 0)
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


def test_s2d_kernel_built_once_and_rebuilt_after_update(monkeypatch):
    """A second forward builds no s2d kernel; an in-place update of one
    down conv's kernel under no_grad rebuilds that one alone, and the
    route then computes with the updated kernel."""
    built = []
    real = convs.down_kernel

    def counting(kernel):
        built.append(tuple(kernel.shape))
        return real(kernel)

    monkeypatch.setattr(convs, "down_kernel", counting)
    gen = UNetGenerator(wf=32).eval()
    x = _x((1, 74, 74, 74), 1)
    with torch.inference_mode():
        gen(x)
        assert len(built) == 2
        gen(x)
        assert len(built) == 2
    down = gen.down2.down
    with torch.no_grad():
        down.kernel.mul_(1.5)
    xd = _x((1, 32, 32, 32), down.kernel.shape[3])
    with torch.inference_mode():
        y = down(xd)
        gen.down1.down(_x((1, 32, 32, 32), gen.down1.down.kernel.shape[3]))
    assert built[2:] == [tuple(down.kernel.shape)]
    _assert_parity(y, _cudnn_form(xd, down.kernel.detach()))
