"""The frozen plain references against the port's plain CPU path at a
small width (wf=32), and the benchmark's operation counts against the
port's bench module."""

import numpy as np
import pytest
import torch

from benchmark import counts, harness, inputs
from benchmark.reference import infer as RI
from benchmark.reference import models as RM
from benchmark.reference import pipeline as RP
from benchmark.reference import train as RT
from benchmark.tests import helpers

WF = 32


def _ncdhw(x):
    return x.permute(0, 4, 1, 2, 3)


# The port's gap to a float64 run of the reference may be at most this
# multiple of the float32 reference's own gap to it.  Both are float32
# rounding in other orders: the port's down and transposed convs take other
# forms than the reference's F.conv3d and F.conv_transpose3d.  At gain 1.35
# the port's gap read 0.93 to 1.11 times the reference's over 8 draws of
# weights and inputs (5.6e-6 against 5.8e-6 on outputs up to 10 here); a
# down conv with its output channels reversed reads a million times.
ROUNDING_MULTIPLE = 2.0


def _generator_gaps(gain):
    """The port's plain CPU generator and the float32 reference, each
    against a float64 run of the reference on the same weights, inputs and
    dropout masks: their greatest gaps."""
    from transfer_em_tpu_torch.models import UNetGenerator
    w = RM.make_weights([RM.generator_spec(WF)], 3, "cpu", gain=gain)[0]
    gen = UNetGenerator(wf=WF)
    gen.load_state_dict(w, strict=True)
    x = torch.randn(2, 74, 74, 74, 1, generator=torch.Generator()
                    .manual_seed(1))
    with torch.no_grad():
        got = _ncdhw(gen(x, deterministic=False,
                         dropout_generator=torch.Generator().manual_seed(5)))
        masks = RM.draw_masks(torch.Generator().manual_seed(5), 2, 74, WF,
                              "cpu")
        ref = RM.generator(w, _ncdhw(x), masks)
        exact = RM.generator({k: v.double() for k, v in w.items()},
                             _ncdhw(x).double(), masks)
    return {"port": (got.double() - exact).abs().max().item(),
            "reference": (ref.double() - exact).abs().max().item(),
            "scale": exact.abs().max().item()}


@pytest.mark.parametrize("gain", [1.0, RM.GAIN])  # the cells' two draws
def test_generator_forward(gain):
    g = _generator_gaps(gain)
    assert 0 < g["reference"] < 1e-5 * g["scale"]
    assert g["port"] <= ROUNDING_MULTIPLE * g["reference"], g


def test_generator_forward_catches_a_channel_fault(monkeypatch):
    """A down conv whose kernel takes its output channels in reverse order
    fails the comparison."""
    import transfer_em_tpu_torch.ops.convs as C
    down4 = C.down4
    monkeypatch.setattr(C, "down4", lambda x, w, leaky=None: down4(
        x, w.flip(-1), leaky))
    g = _generator_gaps(RM.GAIN)
    assert g["port"] > ROUNDING_MULTIPLE * g["reference"], g


def _probe_gaps(fault=None):
    """The generators' probe gradients (``reference.train.generator_probe``:
    dL/dθ of <generator(x), r>) of the float32 reference and of the port's
    plain CPU generator, each against a float64 run of the reference on the
    same weights, batches and cotangents: ``probe_compare``'s numbers.
    ``fault`` (a monkeypatch context's setattr) plants a fault in the
    float32 reference only."""
    from transfer_em_tpu_torch.models import UNetGenerator
    w = RM.make_weights([RM.generator_spec(WF)] * 2, 0, "cpu", gain=1.0)
    g = torch.Generator().manual_seed(10)
    xs = [torch.randn(2, 1, 74, 74, 74, generator=g) for _ in range(2)]
    rs = [torch.randn(2, 1, 40, 40, 40, generator=g) / (2 * 40 ** 3) ** 0.5
          for _ in range(2)]
    exact = RT.generator_probe(
        [{k: v.double() for k, v in net.items()} for net in w],
        [x.double() for x in xs], [r.double() for r in rs], 2)
    port = {}
    for k, net, x, r in zip(RT.GEN, w, xs, rs):
        gen = UNetGenerator(wf=WF)
        gen.load_state_dict(net, strict=True)
        params = dict(gen.named_parameters())
        y = gen(x.permute(0, 2, 3, 4, 1).contiguous())
        port[k] = dict(zip(params, torch.autograd.grad(
            y, list(params.values()),
            grad_outputs=r.permute(0, 2, 3, 4, 1))))
    if fault is not None:
        fault()
    ref = RT.generator_probe(w, xs, rs, 2)
    return {"port": RT.probe_compare(port, exact),
            "reference": RT.probe_compare(ref, exact)}


def test_generator_probe_gradient():
    """The reference's probe gradients in float32 sit within float32's
    rounding of a float64 run (5.8e-7 and 2.3e-11 here, 1e-6 to 9e-5 and
    3e-11 to 7e-7 over three draws), and the port's plain CPU path within
    twice the reference's own gap."""
    g = _probe_gaps()
    ref, port = g["reference"], g["port"]
    assert 0 < ref["probe_gap_gen"] < 1e-4 and ref["probe_cos_gen"] < 1e-6
    assert port["probe_gap_gen"] <= ROUNDING_MULTIPLE * ref["probe_gap_gen"]
    assert port["probe_cos_gen"] <= ROUNDING_MULTIPLE * max(
        ref["probe_cos_gen"], 1e-12)


def test_generator_probe_catches_a_gradient_fault(monkeypatch):
    """The reference's transposed convs, each kernel's gradient with its
    output channels reversed: the norms hold, the directions of those
    leaves, each under the median leaf's norm, turn past the cell's
    limit."""
    real = RM.conv_transpose

    class Flip(torch.autograd.Function):
        @staticmethod
        def forward(ctx, t):
            return t.view_as(t)

        @staticmethod
        def backward(ctx, grad):
            return grad.flip(-1)

    def fault():
        monkeypatch.setattr(RM, "conv_transpose", lambda x, w, **k: real(
            x, Flip.apply(w), **k))
    g = _probe_gaps(fault)["reference"]
    limits = harness.load_json("workloads", "train-wf1-bf16")["limits"]
    assert g["probe_cos_gen"] > limits["probe_cos_gen"], g
    assert g["probe_gap_gen"] < limits["probe_gap_gen"], g


def test_discriminator_forward():
    from transfer_em_tpu_torch.models import Discriminator
    w = RM.make_weights([RM.discriminator_spec(WF)], 4, "cpu")[0]
    w["out.bias"] = torch.tensor([0.25])
    disc = Discriminator(wf=WF)
    disc.load_state_dict(w, strict=True)
    x = torch.randn(3, 40, 40, 40, 1, generator=torch.Generator()
                    .manual_seed(2))
    with torch.no_grad():
        torch.testing.assert_close(RM.discriminator(w, _ncdhw(x)),
                                   _ncdhw(disc(x)), rtol=1e-5, atol=1e-6)


def test_pipeline_batches():
    from transfer_em_tpu_torch.data.pipeline import \
        create_dataset_from_tensors
    vol = inputs.synth_volume(90, 3)
    els = inputs.crops(vol, 6, 74, 4)
    ds, ms = create_dataset_from_tensors(els, batch_size=2, randomize=True,
                                         seed=11, device="cpu")
    want = [b for _, b in zip(range(5), (x for _ in range(3) for x in ds))]
    got = RP.batches([torch.from_numpy(e) for e in els], 2, 11, True, 5)
    assert RP.meanstd([torch.from_numpy(e) for e in els]) == \
        pytest.approx(ms, rel=1e-12)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, _ncdhw(w), rtol=0, atol=0)


def test_train_step():
    """Two steps of the port's train step (f32, dropout on, B=2, micro 1)
    against the reference's."""
    from transfer_em_tpu_torch.config import CycleGANConfig
    from transfer_em_tpu_torch.train import create_state, make_train_step
    w = RM.make_weights([RM.generator_spec(WF)] * 2
                        + [RM.discriminator_spec(WF)] * 2, 9, "cpu")
    cfg = CycleGANConfig(wf=WF)
    state = create_state(cfg, 0, device="cpu")
    for k, net in zip(RT.NETS, w):
        getattr(state, k).load_state_dict(net, strict=True)
    step = make_train_step(cfg, device="cpu")
    g = torch.Generator().manual_seed(3)
    bx = [0.5 * torch.randn(2, 74, 74, 74, 1, generator=g) for _ in range(2)]
    by = [0.5 * torch.randn(2, 74, 74, 74, 1, generator=g) for _ in range(2)]
    losses = [step(state, bx[0], by[0], 77)]
    first = {k: {n: m.clone() / 0.5 for n, m in
                 getattr(state, "opt_" + k).mu.items()} for k in RT.NETS}
    losses.append(step(state, bx[1], by[1], 77))
    prog = {"losses": torch.stack(losses).double().numpy(),
            "first_grads": first,
            "params": {k: dict(getattr(state, k).named_parameters())
                       for k in RT.NETS}}
    ref = RT.run_steps(w, [_ncdhw(x) for x in bx], [_ncdhw(y) for y in by],
                       77, WF, micro=1)
    np.testing.assert_allclose(prog["losses"], ref["losses"], rtol=1e-4)
    gaps = RT.compare(prog, ref, w)
    assert gaps["objective_gap_first"] < 1e-5 and gaps["grad_gap"] < 1e-3
    # Adam's first steps move an element by the learning rate whatever its
    # gradient's size, so f32 rounding that flips a tiny gradient's sign
    # moves a small leaf's change by a few per cent (0.048 here)
    assert gaps["change_gap"] < 0.1


def test_tile_step():
    """predict_volume's device mode (the tile step, on the CPU) against the
    reference's tiled prediction, 1000 tiles' worth of a region cut small."""
    from transfer_em_tpu_torch.infer import predict_volume
    from transfer_em_tpu_torch.models import UNetGenerator
    w = RM.make_weights([RM.generator_spec(WF)], 5, "cpu")[0]
    gen = UNetGenerator(wf=WF).eval()
    gen.load_state_dict(w, strict=True)
    vol = inputs.device_volume(100, 6, "cpu")
    ms_x, ms_y = inputs.meanstd(1, 0), inputs.meanstd(1, 1)
    got = predict_volume(vol.numpy(), gen, (5, 10, 15), (80, 72, 76), ms_x,
                         ms_y, device="cpu")
    want = RI.predict_region(vol, w, (5, 10, 15), (80, 72, 76), ms_x, ms_y)
    r = RI.level_gaps(got, want.numpy(), RI.tile_plan((5, 10, 15),
                                                      (80, 72, 76))[0])
    assert r["max_gap"] <= 1 and r["off_share"] < 1e-3
    assert want.float().std() > 5  # the outputs span many levels


def test_level_gaps():
    """The volume checks' numbers on a ragged region (80 x 72 x 76 zyx in
    tiles of 36: the last tile of each axis cut short): one tile one level
    up reads a tile shift of 1 whatever its size, three voxels two or more
    levels off read as such."""
    rng = np.random.default_rng(3)
    want = rng.integers(5, 250, (80, 72, 76), dtype=np.uint8)
    got = want.copy()
    got[72:, 36:, :36] += 1  # an 8 x 36 x 36 tile
    got[0, 0, :3] += np.array([2, 3, 5], np.uint8)
    r = RI.level_gaps(got, want, 36)
    assert r["off_share"] == (8 * 36 * 36 + 3) / want.size
    assert r["far_share"] == 3 / want.size
    assert r["max_gap"] == 5
    assert r["tile_shift"] == 1.0
    got[72:, 36:, :36] -= 2
    assert RI.level_gaps(got, want, 36)["tile_shift"] == 1.0  # by magnitude
    assert RI.level_gaps(want, want, 36) == {
        "off_share": 0.0, "far_share": 0.0, "tile_shift": 0.0, "max_gap": 0}


@pytest.mark.parametrize("wf,tf_a_pair,gf_a_tile",
                         [(1, 5.08, 277.4), (8, 0.084, 4.52)])
def test_counts(wf, tf_a_pair, gf_a_tile):
    from transfer_em_tpu_torch.bench.train import step_flops
    from transfer_em_tpu_torch.config import CycleGANConfig
    ours = counts.train_step_flops(wf, 8)
    assert ours["per_tile_pair"] / 1e12 == pytest.approx(tf_a_pair, rel=2e-3)
    assert counts.forward_flops("gen", wf) / 1e9 == pytest.approx(
        gf_a_tile, rel=2e-3)
    port = step_flops(CycleGANConfig(wf=wf), 8)
    for k in ("total", "forward", "backward_dw", "backward_dx"):
        assert ours[k] == port[k]


def test_roofline_at_most_the_work():
    """conv3's count covers only k3 layers: under the forward's total."""
    c3 = counts.conv_work(counts.train_conv3_calls(8), 1, "bfloat16")
    assert 0 < c3["flops"] < counts.train_step_flops(1, 8)["forward"]


def test_cells_correct_on_the_cpu():
    """Each cell's whole run at its small size: the port against the
    reference comes out correct."""
    for name in helpers.TINY:
        line = helpers.run_cell(name)
        assert line["correct"] is True, (name, line["checks"])
