"""Recipe 4: streaming 3D data through the data service + stitching sanity
check (mirrors reference examples/3dcloudrun_test.ipynb), on the PyTorch
port.

Starts a local DataService over a synthetic volume, streams tiles through the
HTTP transport (the reference's Cloud Run path), and verifies the manual
stitching invariant from the reference notebook (cell 11): predictions of
shifted, overlapping requests agree on their overlap.

Run:  python examples/torch/cloudrun_test_3d.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np

from transfer_em_tpu_torch.data import create_dataset_from_generator, volume3d_ng
from transfer_em_tpu_torch.infer.tiling import predict_ng_cube
from transfer_em_tpu_torch.serve import DataService, NumpyVolume, register_volume
from transfer_em_tpu_torch.train import EM2EM


def main(device="cuda"):
    rng = np.random.default_rng(0)
    vol = rng.integers(0, 255, (256, 256, 256), np.uint8)
    register_volume("local/test", NumpyVolume(vol))
    svc = DataService()
    svc.start()
    try:
        # stream training tiles over HTTP
        src = volume3d_ng("local/test", ((0, 0, 0), (180, 180, 180)),
                          size=74, seed=3, cloudrun=svc.url)
        ds, meanstd = create_dataset_from_generator(src, batch_size=2,
                                                    epoch_size=8,
                                                    device=device)
        print("first batch:", next(iter(ds)).shape, "meanstd:", meanstd)

        model = EM2EM(74, "cloudrun3d", is3d=True, wf=32, device=device)

        # stitching sanity: two overlapping requests agree on the overlap
        a = predict_ng_cube("local/test", (64, 64, 64), (36, 36, 36), model,
                            meanstd, meanstd, cloudrun=svc.url, device=device)
        b = predict_ng_cube("local/test", (64, 64, 100), (36, 36, 36), model,
                            meanstd, meanstd, cloudrun=svc.url, device=device)
        c = predict_ng_cube("local/test", (64, 64, 64), (36, 36, 72), model,
                            meanstd, meanstd, cloudrun=svc.url, device=device)
        np.testing.assert_array_equal(c[:36], a)
        np.testing.assert_array_equal(c[36:], b)
        print("overlap stitching check passed")
    finally:
        svc.stop()


if __name__ == "__main__":
    main()
