"""Recipe 5: the full serving stack locally (mirrors reference
examples/run_cloud_predict_service.ipynb), on the PyTorch port.

Brings up the data service + model service, exports a model into the model
root, requests a 64-aligned chunk prediction, and reads back the gzip ng
blocks — the reference's Cloud Run deployment flow end-to-end without a
cloud.

Run:  python examples/torch/run_cloud_predict_service.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import gzip
import tempfile

import numpy as np
import torch

from transfer_em_tpu_torch.config import ExportMeta
from transfer_em_tpu_torch.infer.export import export_generator
from transfer_em_tpu_torch.models import UNetGenerator
from transfer_em_tpu_torch.serve import (DataService, ModelService,
                                         NumpyVolume, TransferEMPredictor,
                                         predict_chunk, register_volume)


def main(device="cuda"):
    rng = np.random.default_rng(0)
    vol = rng.integers(0, 255, (256, 256, 256), np.uint8)
    register_volume("local/test", NumpyVolume(vol))

    tmp = tempfile.mkdtemp()
    gen = UNetGenerator(wf=8, generator=torch.Generator().manual_seed(0))
    meta = ExportMeta(buffer=17, outdimsize=40, meanstd_x=(0.0, 1.0),
                      meanstd_y=(0.0, 1.0), dimsize=74, is3d=True, wf=8)
    model_dir = os.path.join(tmp, "models", "demo", "v1")
    export_generator(gen, meta, model_dir)

    model_svc = ModelService(model_root=os.path.join(tmp, "models"),
                             device=device)
    data_svc = DataService()
    data_svc.start()
    model_svc.start()
    try:
        dest = os.path.join(tmp, "out")
        predict_chunk(model_svc.url, "local/test", start=(64, 64, 64),
                      size=(64, 64, 64), model_name="demo:v1", dest=dest)
        blocks = os.listdir(dest)
        print("ng blocks written:", blocks)
        raw = gzip.decompress(open(os.path.join(dest, blocks[0]), "rb").read())
        print("block bytes:", len(raw))

        # AI-Platform-style predictor over the data service transport
        pred = TransferEMPredictor.from_path(model_dir, device=device)
        out = pred.predict([{"location": "local/test",
                             "cloudrun": data_svc.url,
                             "start": (64, 64, 64), "size": (36, 36, 36)}])
        print("base64 prediction bytes:", len(out[0]))
    finally:
        data_svc.stop()
        model_svc.stop()


if __name__ == "__main__":
    main()
