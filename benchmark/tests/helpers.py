"""Small cells for the CPU: the cells' own drivers and harness at sizes a
test run holds."""

import io
import json
import time
from contextlib import redirect_stdout
from types import SimpleNamespace

import pytest
import torch

from benchmark import harness

TINY = {
    "train-wf1-bf16": {"config": {"wf": 32},
                       "cell": {"batch": 2, "volume_side": 80,
                                "elements": 4, "dtype": "float32"}},
    "volume-wf8-f32": {"config": {"wf": 32},
                       "cell": {"volume_side": 90, "volumes": 2,
                                "start": [10, 10, 10], "size": [72, 72, 72],
                                "warm_calls": 1, "samples": 2}},
    "volume-wf1-bf16": {"config": {"wf": 8},
                        "cell": {"volume_side": 90, "volumes": 2,
                                 "start": [10, 10, 10], "size": [72, 72, 72],
                                 "warm_calls": 1, "samples": 2}},
}
SECONDS = {"train-wf1-bf16": 1.0, "volume-wf8-f32": 1.0,
           "volume-wf1-bf16": 1.0}


def run_cell(name: str, seed: int = 2 ** 31 + 7, trace: int = 0,
             overrides=None) -> dict:
    """One run of cell ``name`` on the CPU at its small size, through
    ``harness.run``: returns the result line, parsed."""
    over = TINY[name] if overrides is None else overrides
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = harness.run(_args(name, seed, trace), time.perf_counter(),
                         devices=[torch.device("cpu")], overrides=over)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def run_control(name: str, control, seed: int = 2 ** 31 + 11) -> dict:
    """One run of cell ``name`` at its small size with ``control`` in the
    program's place (``harness.measure``): returns the result line."""
    line, _ = harness.measure(_args(name, seed, 0), time.perf_counter(),
                              devices=[torch.device("cpu")],
                              overrides=TINY[name], control=control)
    return line


def _args(name: str, seed: int, trace: int):
    return SimpleNamespace(workload=name, seed=seed,
                           seconds=SECONDS.get(name, 1.0), trace=trace)


@pytest.fixture
def card():
    """A test that needs an NVIDIA card asks for this fixture: it skips
    where torch.cuda has none, deciding when the test runs, not at
    import."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: torch.cuda.is_available() is "
                    "False")
    return torch.device("cuda", 0)
