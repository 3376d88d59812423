"""Recipe 3: export a trained generator and run tiled inference locally
(mirrors reference examples/run_local_predict.ipynb), on the PyTorch port.

The checkpoint is one the port's ``EM2EM`` wrote (``torch.save`` files under
``checkpoints/train_<exp_name>/<step>/``).

Run:  python examples/torch/run_local_predict.py <ckpt_step> [exp_name]
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np

from transfer_em_tpu_torch.infer.export import load_generator, save_model
from transfer_em_tpu_torch.infer.tiling import predict_tiled
from transfer_em_tpu_torch.native import gather_blocks


def main(ckpt_step, exp_name="simple2d", wf=8, request=(72, 72, 72),
         device="cuda"):
    # export generator G + meta.json (reference bin/save_model.py flow):
    # the checkpoint is addressed by PATH, like the reference CLI's
    # <ckpt> argument (bin/save_model.py:18-24)
    ckpt_path = os.path.join("checkpoints", f"train_{exp_name}",
                             str(int(ckpt_step)))
    save_model("exported_" + exp_name, ckpt_path,
               meanstd_x=(0.0, 1.0), meanstd_y=(0.0, 1.0),
               size=74, is3d=True, wf=wf, device=device)

    # local tiled inference over an in-memory volume
    gen, meta = load_generator("exported_" + exp_name, device=device)
    vol = np.random.default_rng(0).integers(0, 255, (256, 256, 256), np.uint8)

    def fetch_tile(corner, insize):
        return gather_blocks(vol, [corner], insize)[0]

    out = predict_tiled(fetch_tile, gen,
                        start=(64, 64, 64), size=request,
                        outdimsize=meta.outdimsize, buffer=meta.buffer,
                        meanstd_x=meta.meanstd_x, meanstd_y=meta.meanstd_y,
                        device=device)
    print("tiled prediction:", out.shape, out.dtype)
    return out


if __name__ == "__main__":
    main(sys.argv[1], *(sys.argv[2:3]))
