"""Recipe 6: multi-card training + inference over a device mesh, on the
PyTorch port.

Everything the reference left as a TODO or ran serially, as one recipe:

  * data-parallel TRAINING (``EM2EM.to_mesh`` — the MirroredStrategy TODO,
    reference cgan.py:8-11 / README.md:93-94, with global-batch losses)
  * data-parallel TILED INFERENCE (``predict_volume(mesh=)`` — the
    reference's serial tile loop, utils.py:107-126, as one split batch)
  * spatially-sharded HALO INFERENCE (``parallel.halo_predict`` — one huge
    block split across devices, VALID-conv halos exchanged between them),
    including 2-D z x y decomposition on a (space, space_y) mesh

It uses every visible card; ``devices=`` takes any list of devices instead,
repeats allowed, so no machine of several cards is needed to try it:

  python examples/torch/multichip_inference.py cpu     # 8 x the CPU
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))))

import numpy as np
import torch

from transfer_em_tpu_torch.infer import predict_volume
from transfer_em_tpu_torch.models import UNetGenerator
from transfer_em_tpu_torch.ops.convs import zero_pad
from transfer_em_tpu_torch.parallel import halo_predict, make_mesh
from transfer_em_tpu_torch.parallel.mesh import local_cuda_devices
from transfer_em_tpu_torch.shapes import generator_shapes
from transfer_em_tpu_torch.train import EM2EM


def main(wf=32, steps=2, exp_name="multichip_demo", device="cuda",
         devices=None):
    # the mesh's devices: every visible card, or 8 x the CPU
    if devices is None:
        devices = (["cpu"] * 8 if torch.device(device).type == "cpu"
                   else local_cuda_devices())
    devices = [torch.device(d) for d in devices]
    n = len(devices)
    print(f"{n} device(s): {sorted({str(d) for d in devices})}")

    # --- 1. Data-parallel training: one call after construction ---------
    model = EM2EM(74, exp_name, is3d=False, wf=wf, device=devices[0])
    model.to_mesh(make_mesh(n, devices=devices))  # batch split, params
    rng = np.random.default_rng(0)                 # replicated, gradients
    x = rng.normal(size=(n, 74, 74, 1)).astype(np.float32)  # summed
    y = rng.normal(size=(n, 74, 74, 1)).astype(np.float32)
    for _ in range(steps):
        losses = model.train_step(x, y)
    losses = losses.cpu().numpy()
    print(f"DP train step on {n} devices, losses: {losses[:3]}")

    # --- 2. Data-parallel tiled inference (volume replicated, tile -----
    # batches split over 'data'; bit-identical to one device) ------------
    gen = UNetGenerator(wf=wf, generator=torch.Generator().manual_seed(0))
    gen = gen.to(devices[0]).eval()
    vol = rng.integers(0, 255, size=(100, 100, 100), dtype=np.uint8)
    args = (vol, gen, (20, 20, 20), (36, 36, 36), (0.0, 1.0), (0.0, 1.0))
    single = predict_volume(*args, mode="device", batch_size=2,
                            device=devices[0])
    sharded = predict_volume(*args, mode="device", batch_size=2,
                             mesh=make_mesh(n, devices=devices),
                             device=devices[0])
    np.testing.assert_array_equal(sharded, single)
    print(f"DP tiled inference == single-device: {sharded.shape} uint8")

    # --- 3. Spatially-sharded halo inference: one block across all ------
    # devices, halos exchanged (slab%4==0, slab+2*buffer a valid dimsize) -
    buffer = generator_shapes(74).buffer  # 17
    slab = 20
    big = torch.from_numpy(rng.normal(size=(n * slab, 74, 74, 1)).astype(
        np.float32)).to(devices[0])
    smesh = make_mesh(n, data=1, space=n, devices=devices)
    with torch.no_grad():
        out = halo_predict(gen, None, big, smesh, buffer)
        want = gen(zero_pad(big[None], buffer)
                   [:, :, buffer:-buffer, buffer:-buffer])[0]
    np.testing.assert_allclose(out.cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=1e-5)
    print(f"halo-sharded {tuple(big.shape)} -> {tuple(out.shape)} == "
          "unsharded generator")

    # --- 4. 2-D spatial decomposition: z x y device grid ----------------
    if n % 4 == 0:
        m2 = make_mesh(n, data=n // 4, space=2, space_y=2, devices=devices)
        sq = torch.from_numpy(rng.normal(size=(2 * slab, 2 * slab, 74, 1))
                              .astype(np.float32)).to(devices[0])
        with torch.no_grad():
            out2 = halo_predict(gen, None, sq, m2, buffer, y_axis="space_y")
            want2 = gen(zero_pad(sq[None], buffer)
                        [:, :, :, buffer:-buffer])[0]
        np.testing.assert_allclose(out2.cpu().numpy(), want2.cpu().numpy(),
                                   rtol=1e-4, atol=1e-5)
        print(f"z x y halo grid {tuple(sq.shape)} -> {tuple(out2.shape)} "
              "== unsharded")
    return losses


if __name__ == "__main__":
    main(device=sys.argv[1] if len(sys.argv) > 1 else "cuda")
