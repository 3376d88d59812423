"""chip_smoke.py's bf16 rounding replay (``conv3_rounding``), on the CPU.

In bf16 with ``use_norm`` the card's check has the plain step take the
kernels' conv3 outputs wherever each is a bf16 rounding of a sum within the
f32 sums' error bound of the plain version's own; every other output counts
as a miss.  Here a stand-in "kernel" replaces conv3 while the outputs are
recorded: sums in float64 or in float32 with a relative perturbation of
1e-6 are correct roundings and must not miss; a tap dropped, or every
output two bf16 steps away from zero, must miss on most outputs.  The
replayed step's values are the recorded ones and its gradient is the plain
version's.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from transfer_em_tpu_torch.models import UNetGenerator
from transfer_em_tpu_torch.ops import convs, cuda_conv

BF = torch.bfloat16
SLOPE = 0.30078125  # LeakyReLU's 0.3 rounded to bf16


def test_bounds_bracket_the_rounded_sum():
    g = torch.Generator().manual_seed(0)
    s = (torch.randn(20000, generator=g)
         * torch.exp(3 * torch.randn(20000, generator=g)))
    s[:6] = torch.tensor([0.0, -1.0, 3.0, 1.00390625, 2.0 ** -130, -1e-30])
    zero = torch.zeros_like(s)
    lo, hi = cs._bf16_bounds(s, zero, None)
    rounded = s.to(BF).float()
    assert bool(((lo <= s) & (s <= hi)).all())
    assert bool(((rounded == lo) | (rounded == hi)).all())
    # both bounds are bf16 values, at most one bf16 step apart
    assert bool((lo.to(BF).float() == lo).all())
    assert bool((hi.to(BF).float() == hi).all())
    assert bool((hi.to(BF).view(torch.int16).int()
                 - lo.to(BF).view(torch.int16).int()).abs().le(1).all())
    lo_e, hi_e = cs._bf16_bounds(s, zero, SLOPE)
    r = rounded.to(BF)
    act = torch.where(r >= 0, r, r * SLOPE).float()
    assert bool(((lo_e <= act) & (act <= hi_e)).all())
    # a slack widens the interval outward
    lo_w, hi_w = cs._bf16_bounds(s, s.abs() * 0.05, None)
    assert bool(((lo_w <= lo) & (hi <= hi_w)).all())


def _stand_in(kind):
    """conv3 as a kernel under test might compute it in bf16."""
    def conv3(x, w, leaky=None):
        wf = w.to(x.dtype)
        if kind == "f64":
            y = cuda_conv.conv3_plain(x.double(), wf.double()).to(x.dtype)
        else:
            y = cuda_conv.conv3_plain(x.float(), wf.float())
            if kind == "perturbed":
                g = torch.Generator().manual_seed(3)
                y = y * (1 + 1e-6 * torch.randn(y.shape, generator=g))
            y = y.to(x.dtype)
            if kind == "two_steps":
                y = (y.view(torch.int16) + 2).view(x.dtype)
        return y if leaky is None else torch.where(y >= 0, y, y * leaky)
    return conv3


@pytest.fixture(scope="module")
def norm_generator():
    rng = np.random.default_rng(66)
    gen = UNetGenerator(wf=32, use_norm=True, compute_dtype=BF)
    gen.load_state_dict({k: torch.from_numpy(rng.normal(
        0, float(np.prod(v.shape[:-1])) ** -0.5, tuple(v.shape)).astype(
            np.float32)) for k, v in gen.state_dict().items()})
    x = torch.from_numpy(rng.normal(0, 0.3, (1, 74, 74, 74, 1)).astype(
        np.float32))
    return gen.eval(), x


@pytest.mark.parametrize("kind", ["plain", "f64", "perturbed", "two_steps",
                                  "tap_dropped"])
def test_replay_takes_correct_roundings_and_flags_the_rest(norm_generator,
                                                           kind, monkeypatch):
    gen, x = norm_generator
    if kind in ("f64", "perturbed", "two_steps"):
        monkeypatch.setattr(convs, "conv3", _stand_in(kind))
    outs, misses = [], {}
    with torch.no_grad(), cs.conv3_rounding(
            outs, fault="tap_dropped" if kind == "tap_dropped" else None):
        got = gen(x)
    monkeypatch.undo()
    n_calls = len(outs)
    with torch.no_grad(), cs.conv3_rounding(outs, True, misses):
        replayed = gen(x)
    assert n_calls == 8 and misses["of"] == sum(o.numel() for o in outs)
    share = misses["n"] / misses["of"]
    if kind in ("plain", "f64", "perturbed"):
        assert misses["n"] == 0
        assert torch.equal(replayed, got)
    else:
        assert share > 0.5
        assert not torch.equal(replayed, got)


def test_replay_keeps_the_plain_gradient(norm_generator):
    gen, x = norm_generator
    outs = []
    with torch.no_grad(), cs.conv3_rounding(outs):
        gen(x)
    xs = [x.clone().requires_grad_() for _ in range(2)]
    plain = gen(xs[0])
    plain.square().sum().backward()
    with cs.conv3_rounding(outs, True, {}):
        replayed = gen(xs[1])
    replayed.square().sum().backward()
    assert torch.equal(replayed, plain)
    assert torch.equal(xs[1].grad, xs[0].grad)
