"""The port's notebooks (examples/torch/*.ipynb): regeneration-fresh from
the port's scripts by examples/torch/make_notebooks.py, and every one
executed cell by cell on the CPU, the final cell's invocation replaced by a
small configuration with ``device="cpu"`` (as tests/test_examples.py does
for the JAX package's notebooks)."""

import importlib.util
import json
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_EXAMPLES = os.path.join(REPO, "examples", "torch")

torch.set_num_threads(1)


def _make_notebooks():
    spec = importlib.util.spec_from_file_location(
        "torch_make_notebooks", os.path.join(PORT_EXAMPLES,
                                             "make_notebooks.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_notebooks_fresh_and_valid(tmp_path):
    """The committed notebooks are exactly what make_notebooks.py makes of
    the scripts (a stale or hand-edited one fails here), every code cell
    parses, and the path-setup cell puts the repo root on sys.path from
    examples/torch/."""
    mk = _make_notebooks()
    mk.main(str(tmp_path))
    assert len(mk.RECIPES) == 5
    for script, (nb_name, _) in mk.RECIPES.items():
        committed = os.path.join(PORT_EXAMPLES, nb_name)
        assert os.path.exists(committed), f"{nb_name} not committed"
        with open(committed) as f:
            got = json.load(f)
        with open(tmp_path / nb_name) as f:
            want = json.load(f)
        assert got == want, f"{nb_name} is stale: rerun make_notebooks.py"
        code_cells = [c for c in got["cells"] if c["cell_type"] == "code"]
        assert got["nbformat"] == 4 and len(code_cells) >= 3
        for cell in code_cells:
            compile("".join(cell["source"]), nb_name, "exec")
        code = "".join("".join(c["source"]) for c in code_cells)
        assert 'os.path.abspath("../..")' in code and "__file__" not in code


def _nb_simple_training(ns, tmp_path):
    ns["main"](epochs=1, wf=32, batch_size=4, n_patches=8, device="cpu")
    assert (tmp_path / "simple2d_sample.png").exists()


def _nb_generator_training3d(ns, tmp_path):
    from transfer_em_tpu_torch.serve import (DataService, NumpyVolume,
                                             register_volume)
    rng = np.random.default_rng(5)
    register_volume("gen3dnb/x", NumpyVolume(
        rng.integers(0, 255, (128, 128, 128), np.uint8)))
    register_volume("gen3dnb/y", NumpyVolume(
        rng.integers(0, 255, (128, 128, 128), np.uint8)))
    svc = DataService()
    svc.start()
    try:
        model = ns["main"]("gen3dnb/x", "gen3dnb/y", cloudrun=svc.url,
                           epochs=1, wf=32, batch_size=1, epoch_size=2,
                           bbox=((0, 0, 0), (128, 128, 128)),
                           compute_dtype="float32",
                           exp_name="gen3d_nb_smoke", device="cpu")
    finally:
        svc.stop()
    assert int(model.state.step) == 2


def _nb_cloudrun_test_3d(ns, tmp_path):
    ns["main"](device="cpu")  # asserts the stitching invariant inside


def _nb_run_local_predict(ns, tmp_path):
    from transfer_em_tpu_torch.train import EM2EM
    model = EM2EM(74, "lp_nb_smoke", is3d=True, wf=32, device="cpu")
    model.make_checkpoint(1)
    model.wait_until_finished()
    out = ns["main"](1, "lp_nb_smoke", wf=32, request=(36, 36, 36),
                     device="cpu")
    assert out.shape == (36, 36, 36) and out.dtype == np.uint8


def _nb_run_cloud_predict_service(ns, tmp_path):
    ns["main"](device="cpu")


NOTEBOOK_DRIVERS = {
    "simple_training.ipynb": _nb_simple_training,
    "generator_training3D.ipynb": _nb_generator_training3d,
    "3dcloudrun_test.ipynb": _nb_cloudrun_test_3d,
    "run_local_predict.ipynb": _nb_run_local_predict,
    "run_cloud_predict_service.ipynb": _nb_run_cloud_predict_service,
}


@pytest.mark.parametrize("nb_name", sorted(NOTEBOOK_DRIVERS))
def test_notebook_executes(nb_name, tmp_path, monkeypatch):
    """Every code cell but the last, top to bottom in one namespace, then a
    small run with device="cpu" in place of the final invocation cell."""
    with open(os.path.join(PORT_EXAMPLES, nb_name)) as f:
        nb = json.load(f)
    monkeypatch.chdir(tmp_path)
    ns = {}
    code = ["".join(c["source"]) for c in nb["cells"]
            if c["cell_type"] == "code"]
    # The path-setup cell inserts os.path.abspath('../..'), right from
    # examples/torch/; from tmp_path it would put an unrelated directory on
    # the process-wide sys.path, so sys.path is restored after the run.
    saved_path = list(sys.path)
    try:
        for cell_src in code[:-1]:
            exec(cell_src, ns)
        NOTEBOOK_DRIVERS[nb_name](ns, tmp_path)
    finally:
        sys.path[:] = saved_path
