"""Recipe 2: 3D CycleGAN training on streamed volumes (mirrors reference
examples/generator_training3D.ipynb), on the PyTorch port.

Streams 74^3 crops from two neuroglancer-precomputed volumes (or DVID) with
seeded ROI sampling, trains with augmentation, and builds a fixed seeded test
set for repeatable eval.

Run:  python examples/torch/generator_training_3d.py <locationX> <locationY> [cloudrun]
      (locations: 'bucket/path' for GCS tensorstore, 'file:///path' local,
       or '/path/vol.npy' via the serve backend registry)
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

from transfer_em_tpu_torch.data import (create_dataset_from_generator,
                                        volume3d_ng)
from transfer_em_tpu_torch.train import EM2EM

DIM = 74
BBOX = ((0, 0, 0), (512, 512, 512))


def main(loc_x, loc_y, cloudrun=None, epochs=5, wf=8, batch_size=4,
         epoch_size=256, bbox=BBOX, compute_dtype="bfloat16",
         exp_name="gen3d", device="cuda"):
    src_x = volume3d_ng(loc_x, bbox, size=DIM, seed=11, cloudrun=cloudrun)
    src_y = volume3d_ng(loc_y, bbox, size=DIM, seed=22, cloudrun=cloudrun)

    ds_x, meanstd_x = create_dataset_from_generator(
        src_x, batch_size=batch_size, epoch_size=epoch_size,
        enable_augmentation=True, device=device)
    ds_y, meanstd_y = create_dataset_from_generator(
        src_y, batch_size=batch_size, epoch_size=epoch_size,
        enable_augmentation=True, device=device)
    print(f"meanstd_x={meanstd_x} meanstd_y={meanstd_y}")

    # fixed seeded test set (same seed -> same ROIs every run)
    test_src = volume3d_ng(loc_x, bbox, size=DIM, seed=777, cloudrun=cloudrun)
    test_ds, _ = create_dataset_from_generator(
        test_src, batch_size=1, epoch_size=2, meanstd=meanstd_x,
        device=device)

    model = EM2EM(DIM, exp_name, is3d=True, wf=wf,
                  compute_dtype=compute_dtype, device=device)
    model.train(ds_x, ds_y, epochs=epochs, check_freq=1)

    for batch in test_ds:
        print("pred", model.predict(batch).shape)
    return model


if __name__ == "__main__":
    main(sys.argv[1], sys.argv[2],
         sys.argv[3] if len(sys.argv) > 3 else None)
