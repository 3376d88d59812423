"""Recipe 2b: streaming 3D training end-to-end with zero cloud dependencies,
on the PyTorch port.

Exercises the full production streaming path locally:

  synthetic EM volume  ->  in-process data service (the reference's Cloud Run
  /volume contract, cloudrun_functions/transferem.py:109)  ->  HTTP streaming
  source volume3d_ng(cloudrun=...) (reference datasets/generators.py:59-165)
  ->  create_dataset_from_generator with a warp custom_map building the
  source domain from the target domain (reference debug.py:7)  ->  EM2EM
  training + RMSE eval on a fixed seeded test set.

Every layer a real deployment uses (HTTP transport, threaded fetch, seeded
ROI sampling, population standardization, augmentation) runs for real — only
the storage backend is swapped for an in-memory volume.

Run:  python examples/torch/streaming_training_3d_local.py [epochs]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np

from transfer_em_tpu_torch.data import create_dataset_from_generator, volume3d_ng
from transfer_em_tpu_torch.debug import accuracy, warp
from transfer_em_tpu_torch.ops.convs import center_crop
from transfer_em_tpu_torch.serve.backends import NumpyVolume, register_volume
from transfer_em_tpu_torch.serve.data_service import DataService
from transfer_em_tpu_torch.train import EM2EM

DIM = 74


def synth_volume(extent=160, seed=0):
    """Smooth EM-like uint8 texture (box-filtered noise), zyx order."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(extent + 8,) * 3).astype(np.float32)
    c = np.cumsum(np.cumsum(np.cumsum(v, 0), 1), 2)
    s = (c[8:, 8:, 8:] - c[:-8, 8:, 8:] - c[8:, :-8, 8:] - c[8:, 8:, :-8]
         + c[:-8, :-8, 8:] + c[:-8, 8:, :-8] + c[8:, :-8, :-8]
         - c[:-8, :-8, :-8])
    s = (s - s.min()) / max(float(np.ptp(s)), 1e-6)
    return (s * 255).astype(np.uint8)


def main(epochs=3, wf=8, batch_size=4, epoch_size=64, extent=160,
         exp_name="stream3d_local", device="cuda"):
    vol = synth_volume(extent=extent)
    register_volume("localbucket/em", NumpyVolume(vol))
    svc = DataService()
    svc.start()
    try:
        bbox = ((0, 0, 0), (extent,) * 3)
        # domain Y: crops of the volume; domain X: the same crops warped
        # (blur + holes) — the reference's debug fixture, streamed over HTTP.
        src_y = volume3d_ng("localbucket/em", bbox, size=DIM, seed=22,
                            cloudrun=svc.url)
        src_x = volume3d_ng("localbucket/em", bbox, size=DIM, seed=11,
                            cloudrun=svc.url)
        ds_y, meanstd_y = create_dataset_from_generator(
            src_y, batch_size=batch_size, epoch_size=epoch_size,
            enable_augmentation=True, device=device)
        ds_x, meanstd_x = create_dataset_from_generator(
            src_x, batch_size=batch_size, epoch_size=epoch_size,
            custom_map=warp, enable_augmentation=True, device=device)
        print(f"meanstd_x={meanstd_x} meanstd_y={meanstd_y}")

        # fixed seeded test pair: same ROI stream, with and without warp
        test_src = volume3d_ng("localbucket/em", bbox, size=DIM, seed=777,
                               cloudrun=svc.url)
        test_x, _ = create_dataset_from_generator(
            test_src, batch_size=1, epoch_size=2, custom_map=warp,
            meanstd=meanstd_x, device=device)
        test_y, _ = create_dataset_from_generator(
            test_src, batch_size=1, epoch_size=2, meanstd=meanstd_y,
            device=device)

        model = EM2EM(DIM, exp_name, is3d=True, wf=wf, device=device)
        model.train(ds_x, ds_y, epochs=epochs, check_freq=max(1, epochs))

        sample = next(iter(test_x))
        gt = next(iter(test_y))
        pred = model.predict(sample)
        rmse = accuracy(center_crop(gt, model.buffer)[0], pred[0])
        print("streamed-test RMSE:", rmse)
        return float(np.asarray(rmse))
    finally:
        svc.stop()


if __name__ == "__main__":
    main(int(sys.argv[1]) if len(sys.argv) > 1 else 3)
