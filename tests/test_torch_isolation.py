"""The port stands alone: no JAX import, no silent CPU fallback.

In this environment every process may import jax at start-up, so a
``sys.modules`` check would prove nothing: the imports are read from the
source with ``ast`` instead.
"""

import ast
import glob
import os

import numpy as np
import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "transfer_em_tpu")
# the port's recipes also leave the JAX recipes' notebook tool alone
FORBIDDEN_IN_EXAMPLES = FORBIDDEN + ("make_notebooks", "examples")
PORT_EXAMPLES = os.path.join(ROOT, "examples", "torch")


def _port_sources():
    files = sorted(glob.glob(os.path.join(ROOT, "transfer_em_tpu_torch",
                                          "**", "*.py"), recursive=True))
    files += sorted(glob.glob(os.path.join(ROOT, "tools", "*.py")))
    files.append(os.path.join(ROOT, "chip_smoke.py"))
    files += sorted(glob.glob(os.path.join(PORT_EXAMPLES, "*.py")))
    return files


def _imported_modules(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""
        elif (isinstance(node, ast.Call)
              and getattr(node.func, "attr", getattr(node.func, "id", ""))
              in ("import_module", "__import__")
              and node.args and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value)


def test_port_sources_found():
    files = _port_sources()
    assert len(files) > 15 and all(os.path.exists(f) for f in files)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_jax_imports(path):
    forbidden = (FORBIDDEN_IN_EXAMPLES
                 if os.path.dirname(path) == PORT_EXAMPLES else FORBIDDEN)
    for mod in _imported_modules(path):
        top = mod.split(".")[0]
        assert top not in forbidden, f"{path} imports {mod}"


def _entry_points(tmp_path):
    from transfer_em_tpu_torch.infer import (device_predict_tiled,
                                             load_generator,
                                             make_tile_batcher,
                                             make_tile_step, predict_tiled,
                                             predict_volume,
                                             predict_volume_streaming,
                                             slab_predict)
    from transfer_em_tpu_torch.config import CycleGANConfig
    from transfer_em_tpu_torch.models import UNetGenerator
    from transfer_em_tpu_torch.serve import ModelService
    from transfer_em_tpu_torch.train import (EM2EM, create_state,
                                             make_train_step)
    from transfer_em_tpu_torch.data import (create_dataset_from_generator,
                                            create_dataset_from_tensors)
    from transfer_em_tpu_torch.infer.export import \
        predict_cube_from_saved_model
    from transfer_em_tpu_torch.infer.tiling import predict_ng_cube
    from transfer_em_tpu_torch.serve import (NgOutputPredictor,
                                             TransferEMPredictor)
    from transfer_em_tpu_torch import compat
    from transfer_em_tpu_torch.parallel import make_mesh
    from transfer_em_tpu_torch.train import create_prior_helper
    from transfer_em_tpu_torch.bench import infer as bench_infer
    from transfer_em_tpu_torch.bench import train as bench_train

    gen = UNetGenerator(wf=32)
    cfg = CycleGANConfig(dimsize=74, wf=32)
    fetch = lambda c, s: np.zeros((s,) * 3, np.uint8)
    vol = np.zeros((80, 80, 80), np.uint8)
    region = ((0, 0, 0), (36, 36, 36))
    return {
        "ModelService": lambda: ModelService(model_root=str(tmp_path)),
        "load_generator": lambda: load_generator(str(tmp_path)),
        "predict_tiled": lambda: predict_tiled(
            fetch, gen, (0, 0, 0), (36, 36, 36), 40, 17, None, None),
        "make_tile_batcher": lambda: make_tile_batcher(
            gen, None, None, 40, 17),
        "make_tile_step": lambda: make_tile_step(gen, None, None, 2),
        "predict_volume": lambda: predict_volume(vol, gen, *region, None,
                                                 None),
        "device_predict_tiled": lambda: device_predict_tiled(
            vol, gen, *region, 40, 17, None, None),
        "slab_predict": lambda: slab_predict(vol, gen, *region, None, None),
        "predict_volume_streaming": lambda: predict_volume_streaming(
            vol, gen, *region, None, None),
        "create_state": lambda: create_state(cfg, 0),
        "make_train_step": lambda: make_train_step(cfg),
        "EM2EM": lambda: EM2EM(74, "x", wf=32,
                               checkpoint_root=str(tmp_path)),
        "create_dataset_from_tensors": lambda: create_dataset_from_tensors(
            [np.zeros((8, 8, 8), np.uint8)] * 2, batch_size=1),
        "create_dataset_from_generator": lambda:
            create_dataset_from_generator(
                lambda: iter([np.zeros((8, 8, 8), np.uint8)] * 2),
                batch_size=1),
        "predict_ng_cube": lambda: predict_ng_cube(
            "file://" + str(tmp_path), (0, 0, 0), (36, 36, 36), gen, None,
            None, outdimsize=40, buffer=17),
        "predict_cube_from_saved_model": lambda:
            predict_cube_from_saved_model("file://" + str(tmp_path),
                                          (0, 0, 0), (36, 36, 36), None,
                                          str(tmp_path)),
        "TransferEMPredictor.from_path": lambda:
            TransferEMPredictor.from_path(str(tmp_path)),
        "NgOutputPredictor.from_path": lambda:
            NgOutputPredictor.from_path(str(tmp_path),
                                        dest_root=str(tmp_path)),
        "compat.load_tf_generator": lambda: compat.load_tf_generator(
            str(tmp_path / "gen.h5")),
        "compat.load_tf_discriminator": lambda:
            compat.load_tf_discriminator(str(tmp_path / "disc.h5")),
        "compat.load_reference_checkpoint": lambda:
            compat.load_reference_checkpoint(str(tmp_path)),
        "create_prior_helper(.h5)": lambda: create_prior_helper(
            str(tmp_path / "prior.h5"), "down1"),
        "make_mesh": lambda: make_mesh(),
        "bench.train.measure": lambda: bench_train.measure(wf=32, batch=1),
        "bench.infer.measure": lambda: bench_infer.measure(wf=32, side=80),
    }


@pytest.mark.parametrize("name", ["ModelService", "load_generator",
                                  "predict_tiled", "make_tile_batcher",
                                  "make_tile_step", "predict_volume",
                                  "device_predict_tiled", "slab_predict",
                                  "predict_volume_streaming", "create_state",
                                  "make_train_step", "EM2EM",
                                  "create_dataset_from_tensors",
                                  "create_dataset_from_generator",
                                  "predict_ng_cube",
                                  "predict_cube_from_saved_model",
                                  "TransferEMPredictor.from_path",
                                  "NgOutputPredictor.from_path",
                                  "compat.load_tf_generator",
                                  "compat.load_tf_discriminator",
                                  "compat.load_reference_checkpoint",
                                  "create_prior_helper(.h5)", "make_mesh",
                                  "bench.train.measure",
                                  "bench.infer.measure"])
def test_entry_points_default_to_cuda(name, tmp_path):
    """Called without ``device`` where CUDA is absent, every entry point
    raises instead of running on the CPU."""
    assert not torch.cuda.is_available()
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _entry_points(tmp_path)[name]()


def test_mesh_is_a_later_slice(tmp_path):
    """(The name is kept from the slices before the parallel one.)  A mesh
    without a 'data' axis raises ValueError in predict_tiled and
    ModelService, as in the JAX package (tests/test_tiling.py:155-160)."""
    from transfer_em_tpu_torch.infer import predict_tiled
    from transfer_em_tpu_torch.parallel import make_mesh
    from transfer_em_tpu_torch.parallel.mesh import Mesh
    from transfer_em_tpu_torch.serve import ModelService

    cpu = torch.device("cpu")
    space_only = Mesh(np.array([cpu] * 4, dtype=object), ("space",))
    halo_mesh = make_mesh(4, data=1, space=4, devices=[cpu] * 4)
    assert "data" in halo_mesh.shape  # a data axis of size 1 still serves
    with pytest.raises(ValueError, match="'data' axis"):
        ModelService(model_root=str(tmp_path), device="cpu",
                     mesh=space_only)
    with pytest.raises(ValueError, match="'data' axis"):
        predict_tiled(None, None, (0, 0, 0), (36, 36, 36), 40, 17, None,
                      None, device="cpu", mesh=space_only)


def test_data_plane_loads_no_torch(tmp_path):
    """The data service forks workers: importing the data plane, and
    opening and reading a tensorstore volume through it, loads no torch in
    a fresh interpreter (which starts with neither torch nor jax)."""
    import subprocess
    import sys

    pytest.importorskip("tensorstore")
    code = f"""
import sys
assert "torch" not in sys.modules and "jax" not in sys.modules
import transfer_em_tpu_torch.serve.data_service
import transfer_em_tpu_torch.serve.client
import transfer_em_tpu_torch.serve.backends as backends
import tensorstore as ts
spec = {{"driver": "neuroglancer_precomputed",
        "kvstore": {{"driver": "file", "path": {str(tmp_path)!r}}},
        "scale_metadata": {{"size": [8, 8, 8], "resolution": [8, 8, 8],
                            "chunk_size": [8, 8, 8], "encoding": "raw"}},
        "multiscale_metadata": {{"data_type": "uint8", "num_channels": 1,
                                 "type": "image"}},
        "create": True}}
ts.open(spec).result()[...] = 7
vol = backends.open_volume("file://{tmp_path}")
assert isinstance(vol, backends.TensorstoreVolume)
assert vol.read((4, 4, 4), (8, 8, 8)).sum() == 7 * 64
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "jax", "transfer_em_tpu"))
assert not bad, bad
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr


def test_top_level_names_load_no_torch():
    """The JAX package's top-level names (transfer_em_tpu/__init__.py:
    14-26) are the port's too: ``shapes``, ``CycleGANConfig``,
    ``ExportMeta`` and ``__version__`` load with a bare import, in a fresh
    interpreter, without torch; EM2EM and the rest stay lazy."""
    import subprocess
    import sys

    import transfer_em_tpu
    import transfer_em_tpu_torch

    assert set(transfer_em_tpu.__all__) <= set(transfer_em_tpu_torch.__all__)
    assert transfer_em_tpu_torch.__version__ == transfer_em_tpu.__version__
    code = """
import sys
import transfer_em_tpu_torch as t
assert t.shapes.discriminator_shapes(40, is3d=False).out == 6
assert t.CycleGANConfig(is3d=False).dimsize == 74
assert t.ExportMeta(17, 40, (0, 1), (0, 1)).is3d
assert isinstance(t.__version__, str)
assert "EM2EM" in dir(t) and "EM2EM" not in vars(t)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("torch", "jax"))
assert not bad, bad
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr



def test_compat_and_quant_load_no_jax_or_tf():
    """``transfer_em_tpu_torch.compat`` (through the top-level lazy name and
    as a module) loads neither TensorFlow, JAX nor torch at import, and
    ``ops.quant`` loads torch but neither TensorFlow nor JAX, in a fresh
    interpreter; TF comes only with the interop functions."""
    import subprocess
    import sys

    code = """
import sys
import transfer_em_tpu_torch as t
compat = t.compat
import transfer_em_tpu_torch.compat
assert compat.GEN_SLOTS[0] == ("stem", None)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("torch", "jax", "tensorflow", "keras"))
assert not bad, bad
from transfer_em_tpu_torch.ops import quant
assert "torch" in sys.modules
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "tensorflow", "keras",
                                    "transfer_em_tpu"))
assert not bad, bad
"""
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert res.returncode == 0, res.stderr


def _example_mains(tmp_path):
    """Each recipe's main as a user calls it (no ``device``), at
    arguments that reach no remote store: local volume names and a local
    data-service URL that is never read before the device is resolved."""
    import importlib.util

    def main(name):
        spec = importlib.util.spec_from_file_location(
            "isolated_" + name, os.path.join(PORT_EXAMPLES, name + ".py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.main

    local = "http://127.0.0.1:9"
    return {
        "run_local_predict": lambda: main("run_local_predict")(1),
        "simple_training_2d": lambda: main("simple_training_2d")(
            n_patches=8),
        "generator_training_3d": lambda: main("generator_training_3d")(
            "local/x", "local/y", cloudrun=local),
        "streaming_training_3d_local": lambda: main(
            "streaming_training_3d_local")(extent=40),
        "cloudrun_test_3d": lambda: main("cloudrun_test_3d")(),
        "run_cloud_predict_service": lambda: main(
            "run_cloud_predict_service")(),
        "multichip_inference": lambda: main("multichip_inference")(),
        "migrate_tf_assets": lambda: main("migrate_tf_assets")(
            workdir=str(tmp_path)),
    }


@pytest.mark.parametrize("name", ["run_local_predict", "simple_training_2d",
                                  "generator_training_3d",
                                  "streaming_training_3d_local",
                                  "cloudrun_test_3d",
                                  "run_cloud_predict_service",
                                  "multichip_inference",
                                  "migrate_tf_assets"])
def test_examples_default_to_cuda(name, tmp_path, monkeypatch):
    """Every recipe under examples/torch/, run without ``device`` where
    CUDA is absent, raises instead of running on the CPU."""
    assert not torch.cuda.is_available()
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="torch.cuda.is_available"):
        _example_mains(tmp_path)[name]()
