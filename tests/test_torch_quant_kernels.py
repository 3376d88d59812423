"""The int8 conv site's two kernels as far as the CPU can hold them:
``ops/quant.quantize_int8`` (csrc/quant_int8.cu) and the packed operand
and weight cache of ``ops/cuda_int8.conv_int8`` (csrc/conv_int8.cu).

* The quantize pass's plain version is bit-equal (tolerance 0) to the JAX
  package's ``quantize_sym`` followed by the layout written here in numpy,
  for every layout the int8 generator uses: channels padded to whole
  words, the stem's kw taps packed in the channel word, SAME, the stride-2
  cut and space-to-depth (even and odd extents), the transposed conv's pad
  by 1; float32 and bfloat16, 2D and 3D, N(0, 1) inputs and tie-rich ones
  (every a / scale an exact half, where rounding half to even and
  half away from zero part).
* A one-channel conv (the stem's packing) through ``conv_nd_int8`` is
  bit-equal to JAX's; a NaN in an activation makes its scale and every
  output NaN, as in JAX.
* Every conv of the generator at wf 1..8 hands the kernel codes and
  weights its entry takes, and the packed operand walked as the kernel
  walks it (tests/test_torch_quant.py ``kernel_walk``) gives the plain
  accumulators at multi-block widths and padded voxel pitches, and for
  the phase conv's interleaved store.  (The kernel makes its block plans
  itself, in csrc/conv_int8.cu, which only the card runs.)
* The weight cache: made once per parameter and layout; remade after an
  in-place update and after ``load_state_dict(assign=True)`` at an equal
  version count; not otherwise.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_quant import kernel_walk, walk_plan

from transfer_em_tpu.models import UNetGenerator as JaxGenerator
from transfer_em_tpu.ops import quant as jquant
from transfer_em_tpu_torch.models import UNetGenerator
from transfer_em_tpu_torch.models.convert import params_to_jax
from transfer_em_tpu_torch.ops import cuda_int8, quant
from transfer_em_tpu_torch.ops.convs import phase_kernel
from transfer_em_tpu_torch.ops.counts import read_counts

torch.set_num_threads(1)
DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def np_layout(q, layout):
    """Codes into ``layout``, written in numpy from the Layout docstring."""
    n = q.ndim - 2
    lo, size, s = layout.lo, layout.size, layout.stride
    q = np.pad(q, [(0, 0)] + [(a, max(0, z - a - d)) for a, z, d in
                              zip(lo, size, q.shape[1:-1])] + [(0, 0)])
    q = q[(slice(None),) + tuple(slice(0, z) for z in size)]
    if s > 1:
        sp = [z // s for z in size]
        q = q.reshape([q.shape[0]] + sum([[z, s] for z in sp], [])
                      + [q.shape[-1]])
        q = q.transpose([0] + [1 + 2 * i for i in range(n)]
                        + [2 + 2 * i for i in range(n)] + [2 * n + 1])
        q = q.reshape([q.shape[0]] + sp + [-1])
    if layout.wtaps > 1:
        w = q.shape[-2] - layout.wtaps + 1
        q = np.concatenate([q[..., j:j + w, :] for j in range(layout.wtaps)],
                           axis=-1)
    return np.pad(q, [(0, 0)] * (n + 1) + [(0, layout.channels - q.shape[-1])])


# (name, spatial side, channels, kernel side, stride, padding, transpose)
LAYOUTS = {
    "words": (7, 5, 3, 1, "VALID", False),
    "stem": (9, 1, 3, 1, "VALID", False),
    "stem_same": (8, 1, 3, 1, "SAME", False),
    "same": (6, 3, 3, 1, "SAME", False),
    "s2d_even": (10, 3, 4, 2, "VALID", False),
    "s2d_odd": (11, 2, 4, 2, "VALID", False),
    "transpose": (5, 6, 4, 2, "VALID", True),
}


def _input(shape, data, rng):
    if data == "normal":
        return rng.normal(size=shape).astype(np.float32)
    # amax 127, so scale = 1 and every other a / scale is k + 0.5
    x = rng.integers(-126, 126, shape).astype(np.float32) + 0.5
    x.reshape(-1)[0] = 127.0
    return x


@pytest.mark.parametrize("data", ["normal", "ties"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("ndim", [2, 3])
@pytest.mark.parametrize("name", list(LAYOUTS))
def test_quantize_int8_plain_matches_jax(name, ndim, dtype, data):
    side, c, k, stride, padding, transpose = LAYOUTS[name]
    jd, td = DTYPES[dtype]
    rng = np.random.default_rng(len(name) * 7 + ndim)
    shape = (2,) + (side,) * ndim + (c,)
    x = _input(shape, data, rng)
    layout = quant.conv_layout(shape, (k,) * ndim + (c, 8),
                               1 if transpose else stride, padding,
                               transpose)
    assert layout.channels % 4 == 0
    assert (layout.wtaps > 1) == name.startswith("stem")
    jq, js = jquant.quantize_sym(jnp.asarray(x, jd), tuple(range(x.ndim)))
    want = np_layout(np.asarray(jq), layout)
    q, s = quant.quantize_int8(torch.from_numpy(x).to(td), layout)
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert tuple(q.shape) == layout.shape(shape) == want.shape
    np.testing.assert_array_equal(q.numpy(), want)
    np.testing.assert_array_equal(s.numpy(), np.asarray(js))
    if data == "ties":  # the inputs do fall on halves of both parities
        halves = np.asarray(jq, np.float64) - np.asarray(
            jnp.asarray(x, jd), np.float64)
        assert (halves == 0.5).any() and (halves == -0.5).any()


@pytest.mark.parametrize("padding", ["VALID", "SAME"])
@pytest.mark.parametrize("ndim", [2, 3])
def test_one_channel_conv_matches_jax(ndim, padding):
    """A one-channel k3 conv (the stem) through the kw-tap packing, with
    the fused LeakyReLU and without: bit-equal to JAX's int8 conv."""
    rng = np.random.default_rng(10 + ndim)
    x = rng.normal(size=(2,) + (9,) * ndim + (1,)).astype(np.float32)
    w = rng.normal(size=(3,) * ndim + (1, 8)).astype(np.float32)
    want = np.asarray(jquant.conv_nd_int8(jnp.asarray(x), jnp.asarray(w),
                                          padding=padding))
    got = quant.conv_nd_int8(torch.from_numpy(x), torch.from_numpy(w),
                             padding=padding)
    np.testing.assert_array_equal(got.numpy(), want)
    got = quant.conv_nd_int8(torch.from_numpy(x), torch.from_numpy(w),
                             padding=padding, leaky=0.3)
    np.testing.assert_array_equal(got.numpy(),
                                  np.where(want >= 0, want, want * 0.3))


@pytest.mark.parametrize("transpose", [False, True])
def test_nan_activation_carries_into_scale_and_output(transpose):
    """One NaN in the activation makes the scale NaN and every output NaN,
    as in the JAX package (whose max carries the NaN): a diverged model is
    not served as finite values."""
    rng = np.random.default_rng(12)
    x = rng.normal(size=(2, 6, 6, 6, 4)).astype(np.float32)
    x[1, 2, 3, 4, 1] = np.nan
    layout = quant.conv_layout(x.shape, (3, 3, 3, 4, 8), 1, "SAME")
    _, scale = quant.quantize_int8_plain(torch.from_numpy(x), layout)
    _, jscale = jquant.quantize_sym(jnp.asarray(x), (0, 1, 2, 3, 4))
    assert torch.isnan(scale).all() and np.isnan(np.asarray(jscale)).all()
    if transpose:
        w = rng.normal(size=(4, 4, 4, 4, 3)).astype(np.float32)
        want = jquant.conv_transpose_nd_int8(jnp.asarray(x), jnp.asarray(w))
        got = quant.conv_transpose_nd_int8(torch.from_numpy(x),
                                           torch.from_numpy(w))
    else:
        w = rng.normal(size=(3, 3, 3, 4, 8)).astype(np.float32)
        want = jquant.conv_nd_int8(jnp.asarray(x), jnp.asarray(w),
                                   padding="SAME")
        got = quant.conv_nd_int8(torch.from_numpy(x), torch.from_numpy(w),
                                 padding="SAME")
    assert got.shape == want.shape
    assert torch.isnan(got).all() and np.isnan(np.asarray(want)).all()


def _generator_convs(wf, is3d):
    """(input shape, kernel shape, stride, transpose) of the int8
    generator's 12 convs on one 74^n tile, in call order."""
    calls = []
    saved = quant.conv_int8

    def rec(qx, qk, sx, sk, out_dtype=torch.float32, leaky=None, **kw):
        """Records the call; zeros of the output's shape stand in for the
        conv, which only the shapes here need."""
        phases = bool(kw.get("phases"))
        calls.append((tuple(qx.shape), tuple(qk.shape), phases))
        n = qx.dim() - 2
        sp = [a - b + 1 for a, b in zip(qx.shape[1:-1], qk.shape[:n])]
        o = qk.shape[-1]
        if phases:
            sp, o = [2 * a for a in sp], o // 2 ** n
        return torch.zeros([qx.shape[0]] + sp + [o])

    gen = UNetGenerator(wf=wf, is3d=is3d, int8_conv=True)
    quant.conv_int8 = rec
    try:
        with torch.no_grad():
            gen(torch.ones((1,) + (74,) * (3 if is3d else 2) + (1,)))
    finally:
        quant.conv_int8 = saved
    return calls


@pytest.mark.parametrize("wf", [1, 2, 8])
@pytest.mark.parametrize("is3d", [True, False])
def test_generator_convs_fit_the_kernel(wf, is3d):
    """Every conv of the int8 generator hands the kernel what its entry
    (tem_conv_int8) takes: channels in whole 4-byte words, kernel extents
    1 to 3 within the input, a phase conv's outputs whole phases; the stem
    runs as 3 (or 2 in 2D) taps of 4 channels."""
    calls = _generator_convs(wf, is3d)
    assert len(calls) == 12
    stem_x, stem_k, _ = calls[0]
    assert stem_x[-1] == 4 and stem_k[-3:-1] == (1, 4)
    n = 3 if is3d else 2
    for x, k, phases in calls:
        assert len(x) == len(k) == n + 2
        assert x[-1] % 4 == 0 and k[-2] == x[-1]
        assert all(1 <= e <= 3 and e <= s for e, s in zip(k[:n], x[1:-1]))
        if phases:
            assert k[-1] % 2 ** n == 0


@pytest.mark.parametrize("case", ["multi_block", "phases_3d", "phases_2d",
                                  "narrow_k2"])
def test_kernel_walk_wide_and_phases(case):
    """The kernel's walk at widths with several channel blocks (a partial
    last one, voxels at a padded pitch) and O chunks, and the transposed
    conv's phase conv with the epilogue's interleaved store, against the
    plain version."""
    rng = np.random.default_rng(20)
    shape, k, o, phases, plan = {
        "multi_block": ((1, 5, 11, 10, 96), (3, 3, 3), 72, False,
                        (64, 2, 64, 80)),
        "phases_3d": ((1, 6, 5, 9, 8), None, 16, True, (16, 4, 8)),
        "phases_2d": ((2, 9, 10, 12), None, 12, True, (16, 1, 12)),
        "narrow_k2": ((2, 5, 9, 9, 4), (2, 2, 2), 3, False, (8, 8, 4)),
    }[case]
    qx = torch.from_numpy(rng.integers(-127, 128, shape, dtype=np.int8))
    n = len(shape) - 2
    if phases:
        k4 = torch.from_numpy(rng.integers(-127, 128, (4,) * n + (
            shape[-1], o // 2 ** n), dtype=np.int8))
        qk = phase_kernel(k4)
    else:
        qk = torch.from_numpy(rng.integers(-127, 128, k + (shape[-1], o),
                                           dtype=np.int8))
    want = cuda_int8.conv_int8_plain(qx, qk, torch.ones(1), torch.ones(o),
                                     torch.int32, phases=phases).numpy()
    np.testing.assert_array_equal(
        kernel_walk(qx, qk, walk_plan(qk, *plan), phases), want)


def _k(seed, shape=(3, 3, 3, 4, 8)):
    return torch.nn.Parameter(torch.from_numpy(
        np.random.default_rng(seed).normal(size=shape).astype(np.float32)))


def test_weight_cache_once_per_parameter_and_layout():
    """One make per (parameter, layout), hits after; a detached alias hits
    the parameter's entry; a tensor made in inference mode is remade each
    call; the codes and scales are JAX's."""
    w = _k(0)
    layout = quant.conv_layout((2, 9, 9, 9, 4), w.shape, 1, "VALID")
    n0 = read_counts()["int8_weight_packs"]
    a = quant.int8_weights(w, layout)
    assert read_counts()["int8_weight_packs"] == n0 + 1
    assert quant.int8_weights(w, layout) is a
    assert quant.int8_weights(w.detach(), layout) is a
    assert read_counts()["int8_weight_packs"] == n0 + 1
    same = quant.conv_layout((2, 9, 9, 9, 4), w.shape, 1, "SAME")
    assert quant.int8_weights(w, same) is a  # padding moves no weight
    strided = quant.conv_layout((2, 9, 9, 9, 4), w.shape, 2, "VALID")
    s2d = quant.int8_weights(w, strided)
    assert read_counts()["int8_weight_packs"] == n0 + 2
    assert s2d.codes.shape == (2, 2, 2, 32, 8)
    jq, js = jquant.quantize_sym(jnp.asarray(w.detach().numpy()),
                                 (0, 1, 2, 3))
    np.testing.assert_array_equal(a.codes.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(a.scales.numpy(),
                                  np.asarray(js).reshape(-1))
    assert a.packed is None  # the kernel's operand is made on CUDA only
    with torch.inference_mode():
        t = torch.ones((3, 3, 3, 4, 8))
    quant.int8_weights(t, layout)
    quant.int8_weights(t, layout)
    assert read_counts()["int8_weight_packs"] == n0 + 4


def test_weight_cache_remakes_after_update_and_assign():
    """An in-place update (an optimizer's step) and load_state_dict(sd,
    assign=True) with the new tensor at the old one's version count each
    give a new make whose codes follow the new weights."""
    conv = torch.nn.Module()
    conv.kernel = _k(1)
    layout = quant.conv_layout((1, 8, 8, 8, 4), conv.kernel.shape, 1,
                               "VALID")
    first = quant.int8_weights(conv.kernel, layout)
    n0 = read_counts()["int8_weight_packs"]
    with torch.no_grad():
        conv.kernel.mul_(-2.0)
    second = quant.int8_weights(conv.kernel, layout)
    assert read_counts()["int8_weight_packs"] == n0 + 1
    assert torch.equal(second.codes, -first.codes)
    new = _k(2).detach()
    with torch.no_grad():
        while new._version < conv.kernel._version:
            new.add_(0)  # equal version counts: only the identity differs
    before = conv.kernel._version
    conv.load_state_dict({"kernel": new}, assign=True)
    assert conv.kernel._version == before
    third = quant.int8_weights(conv.kernel, layout)
    assert read_counts()["int8_weight_packs"] == n0 + 2
    want, _ = quant.quantize_sym(new, (0, 1, 2, 3))
    assert torch.equal(third.codes, want)
    assert quant.int8_weights(conv.kernel, layout) is third
    assert read_counts()["int8_weight_packs"] == n0 + 2


def test_generator_makes_its_weights_once():
    """An int8 generator's forward makes its 12 convs' weights on the first
    call and none on the next; after load_state_dict it remakes them and
    still matches the JAX package."""
    gen = UNetGenerator(wf=8, is3d=False, int8_conv=True,
                        generator=torch.Generator().manual_seed(3))
    x = torch.from_numpy(np.random.default_rng(4).uniform(
        -1, 1, (2, 74, 74, 1)).astype(np.float32))
    n0 = read_counts()["int8_weight_packs"]
    with torch.no_grad():
        gen(x)
        assert read_counts()["int8_weight_packs"] == n0 + 12
        gen(x)
        assert read_counts()["int8_weight_packs"] == n0 + 12
        other = UNetGenerator(wf=8, is3d=False,
                              generator=torch.Generator().manual_seed(5))
        gen.load_state_dict(other.state_dict())
        got = gen(x).numpy()
    assert read_counts()["int8_weight_packs"] == n0 + 24
    want = JaxGenerator(wf=8, int8_conv=True).apply(
        params_to_jax(other.state_dict()),
                                                    jnp.asarray(x.numpy()))
    np.testing.assert_array_equal(got, np.asarray(want))


def test_quantize_int8_refuses_a_non_cpu_non_cuda_tensor():
    """Off the CPU the quantize wrapper launches its kernel or raises."""
    layout = quant.conv_layout((1, 5, 5, 5, 4), (3, 3, 3, 4, 8), 1, "VALID")
    with pytest.raises(ValueError, match="CUDA tensor"):
        quant.quantize_int8(torch.zeros((1, 5, 5, 5, 4), device="meta"),
                            layout)
