"""Recipe 1: 2D CycleGAN on in-memory patches with a warp-synthesized source
domain (mirrors reference examples/simple_training.ipynb), on the PyTorch
port; ``device="cpu"`` runs it without a card.

The reference notebook loads resources/*.png patches (shipped as a missing
resources.tgz); we synthesize equivalent 128x128 uint8 grayscale patches and
crop 74x74 windows.

Run:  python examples/torch/simple_training_2d.py [epochs]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np

from transfer_em_tpu_torch.data import create_dataset_from_tensors
from transfer_em_tpu_torch.debug import accuracy, generate_images, warp
from transfer_em_tpu_torch.ops.convs import center_crop
from transfer_em_tpu_torch.train import EM2EM


def synth_patches(n=64, size=74, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        v = rng.normal(size=(size + 8, size + 8)).astype(np.float32)
        c = np.cumsum(np.cumsum(v, 0), 1)
        s = (c[8:, 8:] - c[:-8, 8:] - c[8:, :-8] + c[:-8, :-8])[:size, :size]
        s = (s - s.min()) / max(float(np.ptp(s)), 1e-6)
        out.append((s * 255).astype(np.uint8))
    return out


def main(epochs=10, wf=8, batch_size=8, n_patches=64, device="cuda"):
    patches = synth_patches(n=n_patches)

    # domain Y: the real data; domain X: warped (blur + holes) Y
    target_ds, meanstd_y = create_dataset_from_tensors(
        patches, batch_size=batch_size, device=device)
    source_ds, meanstd_x = create_dataset_from_tensors(
        patches, batch_size=batch_size, custom_map=warp, device=device)
    print(f"meanstd_x={meanstd_x} meanstd_y={meanstd_y}")

    model = EM2EM(74, "simple2d", is3d=False, wf=wf, device=device)
    sample = next(iter(source_ds))
    gt = next(iter(target_ds))
    model.train(source_ds, target_ds, epochs=epochs, check_freq=5,
                sample=sample, sample_gt=gt,
                metrics_log="simple2d_metrics.jsonl")

    pred = model.predict(sample)
    gt_c = center_crop(gt, model.buffer)
    print("final RMSE on sample:", accuracy(gt_c[0], pred[0]))
    generate_images(sample, pred, show=False, save_path="simple2d_sample.png")


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 10)
