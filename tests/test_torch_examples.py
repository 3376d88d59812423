"""The port's recipes (examples/torch/) on the CPU, at the JAX recipes' test
configurations (tests/test_examples.py), each given ``device="cpu"``.

Where the two packages can be held to the same inputs they are: the
recipes' numpy data (``synth_patches``, ``synth_volume``) bit-equal to the
JAX scripts', and ``run_local_predict``'s uint8 output within one level, on
at most 1e-3 of the voxels, of the JAX script's on the same generator
weights (the JAX ``EM2EM``'s, carried into the port's by
``models.convert``), each package reading its own checkpoint.  A warped X
domain comes from each package's own RNG, so trained models are not
compared.

Both packages name their recipe modules alike, so each script is loaded
from its file under a name of its own, not through ``sys.path``.
"""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_EXAMPLES = os.path.join(REPO, "examples", "torch")
JAX_EXAMPLES = os.path.join(REPO, "examples")

torch.set_num_threads(1)


def load(directory, name, prefix):
    """The recipe ``name`` from ``directory`` as module ``prefix.name``."""
    spec = importlib.util.spec_from_file_location(
        f"{prefix}_{name}", os.path.join(directory, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def port(name):
    return load(PORT_EXAMPLES, name, "torch_example")


def jax_recipe(name):
    return load(JAX_EXAMPLES, name, "jax_example")


def within_one_level(got, want):
    """uint8 outputs within one level, on at most 1e-3 of the voxels."""
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(np.int16) - want.astype(np.int16))
    assert diff.max() <= 1, diff.max()
    assert (diff > 0).mean() <= 1e-3, (diff > 0).mean()


def test_run_local_predict(tmp_path, monkeypatch):
    """Recipe 3 against the JAX script: the same generator weights, each
    package's own checkpoint at step 1 -> save_model(ckpt PATH) -> load ->
    predict_tiled; uint8 outputs within one level."""
    import jax

    from transfer_em_tpu.train import EM2EM as JaxEM2EM
    from transfer_em_tpu_torch.models.convert import load_jax_state
    from transfer_em_tpu_torch.train import EM2EM

    jax_dir, port_dir = tmp_path / "jax", tmp_path / "port"
    jax_dir.mkdir()
    port_dir.mkdir()
    monkeypatch.chdir(jax_dir)
    jmodel = JaxEM2EM(74, "lp_smoke", is3d=True, wf=32)
    jmodel.make_checkpoint(1)
    jmodel.wait_until_finished()
    want = jax_recipe("run_local_predict").main(1, "lp_smoke", wf=32,
                                                request=(36, 36, 36))

    monkeypatch.chdir(port_dir)
    model = EM2EM(74, "lp_smoke", is3d=True, wf=32, device="cpu")
    load_jax_state(model.state, jax.tree.map(np.asarray, jmodel.state))
    model.make_checkpoint(1)
    model.wait_until_finished()
    got = port("run_local_predict").main(1, "lp_smoke", wf=32,
                                         request=(36, 36, 36), device="cpu")
    assert got.shape == (36, 36, 36) and got.dtype == np.uint8
    within_one_level(got, want)


def test_simple_training_2d(tmp_path, monkeypatch):
    """Recipe 1: the synthesized patches bit-equal to the JAX script's, then
    one epoch of 2D training, its metrics log and sample image."""
    ex = port("simple_training_2d")
    ref = jax_recipe("simple_training_2d")
    for got, want in zip(ex.synth_patches(n=8), ref.synth_patches(n=8)):
        np.testing.assert_array_equal(got, want)
    monkeypatch.chdir(tmp_path)
    ex.main(epochs=1, wf=32, batch_size=4, n_patches=8, device="cpu")
    assert (tmp_path / "simple2d_sample.png").exists()
    assert (tmp_path / "simple2d_metrics.jsonl").exists()


def test_generator_training_3d(tmp_path, monkeypatch):
    """Recipe 2: streamed two-domain 3D training with augmentation and a
    seeded test set, over the port's local data service."""
    from transfer_em_tpu_torch.serve import (DataService, NumpyVolume,
                                             register_volume)

    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(5)
    register_volume("gen3d/x", NumpyVolume(
        rng.integers(0, 255, (128, 128, 128), np.uint8)))
    register_volume("gen3d/y", NumpyVolume(
        rng.integers(0, 255, (128, 128, 128), np.uint8)))
    svc = DataService()
    svc.start()
    try:
        model = port("generator_training_3d").main(
            "gen3d/x", "gen3d/y", cloudrun=svc.url, epochs=1, wf=32,
            batch_size=1, epoch_size=2, bbox=((0, 0, 0), (128, 128, 128)),
            compute_dtype="float32", exp_name="gen3d_smoke", device="cpu")
    finally:
        svc.stop()
    assert int(model.state.step) == 2


def test_streaming_training_3d_local(tmp_path, monkeypatch):
    """Recipe 2b: the synthesized volume bit-equal to the JAX script's, then
    HTTP-streamed 3D training end to end."""
    ex = port("streaming_training_3d_local")
    np.testing.assert_array_equal(
        ex.synth_volume(extent=100),
        jax_recipe("streaming_training_3d_local").synth_volume(extent=100))
    monkeypatch.chdir(tmp_path)
    rmse = ex.main(epochs=1, wf=32, batch_size=1, epoch_size=2, extent=100,
                   exp_name="stream3d_smoke", device="cpu")
    assert np.isfinite(rmse)


def test_cloudrun_test_3d(tmp_path, monkeypatch):
    """Recipe 4: the data service over HTTP and the reference notebook's
    overlap-stitching invariant (asserted inside, bit for bit)."""
    monkeypatch.chdir(tmp_path)
    port("cloudrun_test_3d").main(device="cpu")


def test_run_cloud_predict_service(tmp_path, monkeypatch):
    """Recipe 5: the data service, the 64-aligned model service and the
    AI-Platform-style predictor, locally."""
    monkeypatch.chdir(tmp_path)
    port("run_cloud_predict_service").main(device="cpu")


def test_multichip_inference(tmp_path, monkeypatch):
    """Recipe 6 on 8 x the CPU: the DP train step, DP tiled inference
    bit-equal to one device, halo inference in z and z x y within the JAX
    recipe's bar (asserted inside)."""
    monkeypatch.chdir(tmp_path)
    losses = port("multichip_inference").main(
        wf=32, steps=1, exp_name="multichip_smoke", device="cpu",
        devices=["cpu"] * 8)
    assert losses.shape == (7,) and np.all(np.isfinite(losses))


def test_migrate_tf_assets(tmp_path, monkeypatch):
    """Recipe 7: the port's export -> TF SavedModel keeps the voxels; with
    no reference package given, direction 1 is skipped and reported None
    (as tests/test_examples.py checks of the JAX recipe)."""
    pytest.importorskip("tensorflow")
    monkeypatch.chdir(tmp_path)
    d1, d2 = port("migrate_tf_assets").main(None, workdir=str(tmp_path),
                                            device="cpu")
    assert d1 is None
    assert d2 < 1e-3


def test_sample_image_without_matplotlib(tmp_path, monkeypatch):
    """The 2D recipe's last step where matplotlib is not installed:
    ``generate_images`` saves the pair through PIL, each image at
    its place, mapped as the figure maps it; with ``show`` it still needs
    matplotlib."""
    from PIL import Image

    from transfer_em_tpu_torch.debug import generate_images

    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    rng = np.random.default_rng(3)
    orig = rng.uniform(-1, 1, (2, 74, 74, 1)).astype(np.float32)
    pred = torch.from_numpy(rng.uniform(-1, 1, (2, 40, 40, 1))
                            .astype(np.float32))
    path = tmp_path / "pair.png"
    generate_images(orig, pred, show=False, save_path=str(path))
    img = np.asarray(Image.open(path))
    assert img.shape == (74, 74 + 8 + 40) and img.dtype == np.uint8
    np.testing.assert_array_equal(
        img[:, :74], np.round((orig[0, :, :, 0] * 0.5 + 0.5) * 255))
    np.testing.assert_array_equal(
        img[:40, 82:], np.round((pred[0, :, :, 0].numpy() * 0.5 + 0.5) * 255))
    assert not img[:, 74:82].any() and not img[40:, 82:].any()
    with pytest.raises(ImportError):
        generate_images(orig, pred, show=True)
