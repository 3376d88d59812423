"""Recipe 7: migrate model assets between the reference TF stack and the
PyTorch port — BOTH directions (no reference notebook equivalent; this is
the path a janelia-flyem/transfer_em user walks when switching).

Direction 1 (requires the reference package, e.g. a checkout on sys.path):
a reference-trained Keras generator (.h5 or SavedModel, the
``utils.py:133-167`` export) becomes a ``UNetGenerator`` via
``compat.load_tf_generator`` — and keeps producing the same voxels.

Direction 2 (TF only): a generator exported with ``save_model`` /
``tem-torch-save-model`` becomes a TF SavedModel via
``compat.export_tf_savedmodel`` (restored ``predict`` function +
``serving_default`` signature + the reference's meta.json), so the
reference-era TF serving stack can run it.

Run:  python examples/torch/migrate_tf_assets.py [reference_path]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np


def migrate_from_reference(reference_path, workdir=".", device="cuda"):
    """Reference Keras .h5 -> UNetGenerator (direction 1). Returns max
    |diff| between the TF model and the converted generator on one tile."""
    import tensorflow as tf
    import torch

    from transfer_em_tpu_torch import compat

    sys.path.insert(0, reference_path)
    try:
        from transfer_em.models.generator import unet_generator
        tf_model, _ = unet_generator(74, is3d=False, wf=64)
    finally:
        sys.path.remove(reference_path)
    h5 = os.path.join(workdir, "reference_gen.h5")
    tf_model.save(h5)

    gen, _ = compat.load_tf_generator(h5, device=device)
    x = np.random.default_rng(0).uniform(-1, 1, (1, 74, 74, 1)).astype(
        np.float32)
    with torch.no_grad():
        ours = gen(torch.from_numpy(x).to(gen.stem.kernel.device))
    theirs = tf_model(x, training=False).numpy()
    return float(np.max(np.abs(ours.cpu().numpy() - theirs)))


def migrate_to_tf(workdir=".", device="cuda"):
    """Our export dir -> TF SavedModel (direction 2). Returns max |diff|
    between our generator and the SavedModel's restored predict fn."""
    import torch

    from transfer_em_tpu_torch.device import resolve_device
    device = resolve_device(device)  # before TensorFlow's slow import

    import tensorflow as tf

    from transfer_em_tpu_torch import compat
    from transfer_em_tpu_torch.config import ExportMeta
    from transfer_em_tpu_torch.infer.export import export_generator
    from transfer_em_tpu_torch.models import UNetGenerator

    # Stand-in for a real training run: any exported generator dir works
    # (a real one comes from save_model(name, ckpt_path, ...)).
    gen = UNetGenerator(wf=64, is3d=False,
                        generator=torch.Generator().manual_seed(0))
    gen = gen.to(device).eval()
    meta = ExportMeta(buffer=17, outdimsize=40, meanstd_x=(0.0, 1.0),
                      meanstd_y=(0.0, 1.0), dimsize=74, is3d=False, wf=64)
    src = os.path.join(workdir, "ours")
    dst = os.path.join(workdir, "ours_tf")
    export_generator(gen, meta, src)
    compat.export_tf_savedmodel(src, dst)

    x = np.random.default_rng(1).uniform(-1, 1, (2, 74, 74, 1)).astype(
        np.float32)
    with torch.no_grad():
        want = gen(torch.from_numpy(x).to(device)).cpu().numpy()
    loaded = tf.saved_model.load(dst)          # what the reference stack does
    got = loaded.predict(tf.constant(x)).numpy()
    assert os.path.exists(os.path.join(dst, "meta.json"))
    return float(np.max(np.abs(got - want)))


def main(reference_path=None, workdir=".", device="cuda"):
    d2 = migrate_to_tf(workdir, device)
    print(f"ours -> TF SavedModel: max|diff| = {d2:.2e}")
    if reference_path and os.path.isdir(reference_path):
        d1 = migrate_from_reference(reference_path, workdir, device)
        print(f"reference .h5 -> UNetGenerator: max|diff| = {d1:.2e}")
    else:
        d1 = None
        print("reference package not given; skipped direction 1")
    return d1, d2


if __name__ == "__main__":
    main(*(sys.argv[1:2]))
