"""Which form the port's transposed conv takes by default
(``ops/convs.py`` ``conv_form``): the phase conv on conv3 for a 3D k4
stride-2 float32 call that records no gradient, cuDNN's transposed conv
for every other call; the phase kernel cached per parameter; and the
generator on that route against the JAX generator."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from transfer_em_tpu.models import UNetGenerator as JaxUNet
from transfer_em_tpu_torch.models import UNetGenerator
from transfer_em_tpu_torch.models.convert import params_from_jax
from transfer_em_tpu_torch.ops import convs
from transfer_em_tpu_torch.ops.counts import read_counts, reset_counts

torch.set_num_threads(1)

# (layer, x shape without channels, Cin, Cout) of the wf=8 generator's up
# convs at B=2
UP_CONVS = [("up1.up", (2, 13, 13, 13), 32, 16),
            ("up0.up", (2, 22, 22, 22), 16, 8)]


def _phase(x, w, stride):
    """Whether ``conv_form`` picks the phase conv for the transposed
    conv."""
    return convs.conv_form(x, w, stride, transpose=True) == "phase"


def _routes():
    c = read_counts()
    return c["transpose_phase"], c["transpose_cudnn"]


def _kernel(cin, cout, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn((4, 4, 4, cin, cout), generator=g) / (64 * cin) ** 0.5


def _x(shape, cin, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape + (cin,), generator=g)


def _numpy_params(wf, seed):
    """A flax-shaped param tree, std 1/sqrt(fan-in) (activations O(1))."""
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


def test_generator_inference_takes_phase_route_and_matches_jax():
    """An f32 3D forward under inference_mode runs both up convs as the
    phase conv (2 a forward, none on cuDNN), within the generator parity
    tests' atol of the JAX generator."""
    params = _numpy_params(8, seed=8)
    x = np.random.default_rng(42).normal(
        0, 1, (2, 42, 42, 42, 1)).astype(np.float32)
    want = np.asarray(jax.jit(JaxUNet(wf=8).apply)(params, jnp.asarray(x)))
    gen = UNetGenerator(wf=8)
    gen.load_state_dict(params_from_jax(params))
    gen.eval()
    reset_counts()
    with torch.inference_mode():
        got = gen(torch.from_numpy(x)).numpy()
        assert _routes() == (2, 0)
        again = gen(torch.from_numpy(x)).numpy()
    assert _routes() == (4, 0)
    np.testing.assert_array_equal(again, got)
    assert np.abs(want).max() > 0.05
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


@pytest.mark.parametrize("layer,shape,cin,cout", UP_CONVS,
                         ids=[c[0] for c in UP_CONVS])
@pytest.mark.parametrize("grad_off", ["inference_mode", "no_grad"])
def test_phase_route_equals_cudnn(layer, shape, cin, cout, grad_off):
    """The default route of a call that records no gradient, at the wf=8
    up convs' shapes, equals cuDNN's transposed conv (phase_decompose=
    False) to rtol 1e-5 of the largest value."""
    x, w = _x(shape, cin), _kernel(cin, cout)
    want = convs.conv_transpose_nd(x, w, phase_decompose=False)
    reset_counts()
    ctx = torch.inference_mode() if grad_off == "inference_mode" \
        else torch.no_grad()
    with ctx:
        got = convs.conv_transpose_nd(x, w)
    assert _routes() == (1, 0)
    assert got.shape == want.shape == (shape[0],) + tuple(
        2 * s for s in shape[1:]) + (cout,)
    scale = float(want.abs().max())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * scale)


def test_route_rule_reads_only_the_call():
    """conv_form's phase rule: 3D, k4, s2, float32, Cin * Cout under the
    limit and no recorded gradient, each needed; grad enabled alone does
    not count, a requires_grad input does."""
    x, w = _x((1, 5, 5, 5), 4), _kernel(4, 2)
    assert _phase(x, w, 2)
    assert not _phase(x, w, 1)
    assert not _phase(x.bfloat16(), w, 2)
    assert not _phase(x.double(), w, 2)
    assert not _phase(x, w.requires_grad_(), 2)
    with torch.no_grad():
        assert _phase(x, w, 2)
    k3 = torch.randn(3, 3, 3, 4, 2)
    assert not _phase(x, k3, 2)
    # Cin * Cout: the wf=1 generator's up0.up (128 -> 64) takes the phase
    # conv, its up1.up (256 -> 128) cuDNN's
    assert _phase(torch.randn(1, 4, 4, 4, 128),
                  torch.randn(4, 4, 4, 128, 64), 2)
    assert not _phase(torch.randn(1, 4, 4, 4, 256),
                      torch.randn(4, 4, 4, 256, 128), 2)
    assert 128 * 96 < convs.PHASE_CIN_COUT_LIMIT <= 192 * 96
    x2, w2 = torch.randn(1, 5, 5, 4), torch.randn(4, 4, 4, 2)
    with torch.inference_mode():
        assert not _phase(x2, w2, 2)


def _bf16(x, w):
    with torch.inference_mode():
        return convs.conv_transpose_nd(x.bfloat16(), w)


def _recording(x, w):
    return convs.conv_transpose_nd(x, w.clone().requires_grad_())


def _twod(x, w):
    with torch.inference_mode():
        return convs.conv_transpose_nd(x[:, 0], w[0])


def _vmapped(x, w):
    """Under torch.func.vmap over stacked kernels (the train step's
    ensemble_apps), whose wrappers do not show requires_grad."""
    ws = torch.stack([w, w]).requires_grad_()
    return torch.func.vmap(lambda k: convs.conv_transpose_nd(x, k))(ws)


@pytest.mark.parametrize("call", [_bf16, _recording, _twod, _vmapped],
                         ids=["bf16", "recording", "2d", "vmap"])
def test_other_calls_stay_on_cudnn(call):
    """bf16, a forward that records a gradient (or may, under vmap), and
    2D each run cuDNN's transposed conv, as before: the phase count stays,
    cuDNN's rises (once a vmapped call)."""
    x, w = _x((1, 6, 6, 6), 8), _kernel(8, 4)
    reset_counts()
    call(x, w)
    assert _routes() == (0, 1)


def test_int8_takes_neither_route():
    """The int8 generator's transposed convs run their own phase plan on
    the int8 kernel: neither count rises."""
    gen = UNetGenerator(wf=32, int8_conv=True).eval()
    reset_counts()
    with torch.inference_mode():
        gen(_x((1, 42, 42, 42), 1))
    assert _routes() == (0, 0)


def test_phase_kernel_built_once_and_rebuilt_after_update(monkeypatch):
    """A second forward builds no phase kernel; an in-place update of one
    up conv's kernel under no_grad rebuilds that one alone, and the route
    then computes with the updated kernel."""
    built = []
    real = convs.phase_kernel

    def counting(kernel):
        built.append(tuple(kernel.shape))
        return real(kernel)

    monkeypatch.setattr(convs, "phase_kernel", counting)
    gen = UNetGenerator(wf=32).eval()
    x = _x((1, 42, 42, 42), 1)
    with torch.inference_mode():
        gen(x)
        assert len(built) == 2
        gen(x)
        assert len(built) == 2
    up = gen.up0.up
    with torch.no_grad():
        up.kernel.mul_(1.5)
    xu = _x((1, 22, 22, 22), up.kernel.shape[3])
    with torch.inference_mode():
        y = up(xu)
        gen.up1.up(_x((1, 13, 13, 13), gen.up1.up.kernel.shape[3]))
    assert built[2:] == [tuple(up.kernel.shape)]
    want = convs.conv_transpose_nd(xu, up.kernel.detach(),
                                   phase_decompose=False)
    np.testing.assert_allclose(y.numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5 * float(want.abs().max()))


def test_recording_forward_gradient_unchanged():
    """A forward that records a gradient takes cuDNN's transposed conv, so
    its gradients are those of phase_decompose=False, bit for bit; the
    forced phase form's are equal to rounding."""
    x0, w0 = _x((2, 6, 6, 6), 8), _kernel(8, 4)
    g = torch.randn((2, 12, 12, 12, 4),
                    generator=torch.Generator().manual_seed(3))

    def grads(phase_decompose):
        x, w = x0.clone().requires_grad_(), w0.clone().requires_grad_()
        convs.conv_transpose_nd(x, w, phase_decompose=phase_decompose
                                ).backward(g)
        return x.grad, w.grad

    reset_counts()
    dx, dw = grads(None)
    assert _routes() == (0, 1)
    dx_c, dw_c = grads(False)
    assert torch.equal(dx, dx_c) and torch.equal(dw, dw_c)
    dx_p, dw_p = grads(True)
    for got, want in ((dx_p, dx), (dw_p, dw)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-5,
                                   atol=1e-5 * float(want.abs().max()))
