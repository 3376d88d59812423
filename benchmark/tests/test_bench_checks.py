"""Each cell's comparison fails what it has to fail, at a size a test run
holds: its control (the reference in the precision below the
configuration's) and, with the timed path broken underneath, a run of the
harness on the CPU (``harness.run`` without the look for a card)."""

import pytest
import torch

from benchmark import harness
from benchmark.reference import models as RM
from benchmark.tests import helpers
from benchmark.tests.helpers import card  # noqa: F401  (a fixture)
from benchmark.tools import control

STEP_CHECKS = ("objective_gap_first", "grad_gap_disc", "grad_cos_disc",
               "change_gap")
PROBE_CHECKS = ("probe_gap_gen", "probe_cos_gen")


def test_train_control_fails():
    """The reference with float8 operands and gradients, in the program's
    place, comes out not correct: the discriminators' first gradients and
    the generators' probe turn past their limits."""
    line = helpers.run_control("train-wf1-bf16", RM.fake_fp8)
    assert line["correct"] is False
    c = line["checks"]
    assert c["grad_cos_disc"]["value"] > c["grad_cos_disc"]["limit"]
    assert any(c[k]["value"] > c[k]["limit"] for k in PROBE_CHECKS), c


def test_train_sound_program_passes_every_check():
    """The port as it stands: each of the six numbers under its limit."""
    line = helpers.run_cell("train-wf1-bf16")
    c = line["checks"]
    assert set(c) == set(STEP_CHECKS + PROBE_CHECKS)
    assert line["correct"] is True, c


VOLUME_CONTROLS = {"volume-wf8-f32": RM.fake_tf32,
                   "volume-wf1-bf16": RM.fake_fp8}


@pytest.mark.parametrize("name", sorted(VOLUME_CONTROLS))
def test_volume_control_fails(name):
    """The reference one precision below the configuration's, in the
    program's place, reads past a limit: with TF32 operands against the
    float32 reference the share of voxels off, with float8 operands
    against the bf16 reference the share two or more levels off."""
    line = helpers.run_control(name, VOLUME_CONTROLS[name])
    c = line["checks"]
    assert line["correct"] is False
    key = "off_share" if name == "volume-wf8-f32" else "far_share"
    assert c[key]["value"] > c[key]["limit"], c


@pytest.mark.parametrize("name", sorted(VOLUME_CONTROLS))
def test_volume_sound_program_passes_every_check(name):
    """The port as it stands, each number under its limit: float32
    against the float32 reference, bf16 against the reference on
    bf16-rounded operands."""
    line = helpers.run_cell(name)
    assert set(line["checks"]) == set(
        harness.load_json("workloads", name)["limits"])
    assert line["correct"] is True, line["checks"]


def test_train_state_unchanged_is_caught(monkeypatch):
    import transfer_em_tpu_torch.train as T
    monkeypatch.setattr(T, "make_train_step",
                        lambda config, device=None: (
                            lambda state, x, y, seed: torch.zeros(7)))
    line = helpers.run_cell("train-wf1-bf16")
    assert line["correct"] is False
    assert line["checks"]["change_gap"]["value"] == pytest.approx(1.0)


def test_train_half_batch_is_caught(monkeypatch):
    control.half_batch(monkeypatch.setattr)
    line = helpers.run_cell("train-wf1-bf16")
    assert line["correct"] is False


@pytest.mark.parametrize("fault", ["transposed_wgrad_half",
                                   "transposed_wgrad_flipped",
                                   "conv3_wgrad_half_over_40"])
def test_train_generator_backward_fault_is_caught(monkeypatch, fault):
    """A weight gradient halved, or turned with its norm held, where only
    the generators' backward goes (the transposed convs; conv3 over 40
    voxels an axis, which the 40^3 discriminator never reaches): the four
    numbers of the step pass it, since Adam's first updates hardly feel a
    gradient's scale and the generators' first gradients are not compared,
    and the probe catches it."""
    control.FAULTS[fault](monkeypatch.setattr)
    line = helpers.run_cell("train-wf1-bf16")
    c = line["checks"]
    assert line["correct"] is False
    for k in STEP_CHECKS:
        assert c[k]["value"] <= c[k]["limit"], (k, c)
    assert any(c[k]["value"] > c[k]["limit"] for k in PROBE_CHECKS), c


@pytest.mark.parametrize("name", sorted(VOLUME_CONTROLS))
def test_volume_answer_altered_is_caught(monkeypatch, name):
    """One tile of every batch one level off where the port makes its
    uint8 output: the float32 cell's share of voxels off and the bf16
    cell's largest tile shift read past their limits."""
    control.tile_off_by_one(monkeypatch.setattr)
    line = helpers.run_cell(name)
    c = line["checks"]
    assert line["correct"] is False
    key = "off_share" if name == "volume-wf8-f32" else "tile_shift"
    assert c[key]["value"] > c[key]["limit"], c


def test_train_disc_backward_fault_is_caught(monkeypatch):
    """A discriminator kernel's weight gradient off by half (a wgrad
    fault): Adam's first update hardly feels a gradient's scale, so the
    objective and the change pass it, and the first gradient catches it."""
    import transfer_em_tpu_torch.train as T
    real = T.create_state

    def faulty(config, seed, **kw):
        state = real(config, seed, **kw)
        for net in (state.dx, state.dy):
            p = dict(net.named_parameters())["down2.conv.kernel"]
            p.register_hook(lambda g: g * 1.5)
        return state

    monkeypatch.setattr(T, "create_state", faulty)
    line = helpers.run_cell("train-wf1-bf16")
    assert line["correct"] is False
    c = line["checks"]
    assert c["grad_gap_disc"]["value"] > c["grad_gap_disc"]["limit"]
    assert c["objective_gap_first"]["value"] < c["objective_gap_first"][
        "limit"]


def test_cells_run_on_the_card(card):
    """Each cell once, briefly, on the card through the command itself."""
    import json
    import subprocess
    import sys
    for name in helpers.TINY:
        res = subprocess.run(
            [sys.executable, "benchmark/run.py", "--workload", name,
             "--seed", str(2 ** 31 + 5), "--seconds", "3", "--trace", "0"],
            cwd=harness.ROOT, capture_output=True, text=True, timeout=900)
        assert res.returncode == 0, res.stderr[-2000:]
        assert json.loads(res.stdout.strip().splitlines()[-1])["correct"]
