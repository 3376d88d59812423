"""BASELINE.md's two configurations that the train and infer benches do
not cover: the counterpart of the JAX package's
``bench_baseline_configs.py``.

    python -m transfer_em_tpu_torch.bench.baseline_configs [config2|config4]
        [--ladder 4096,16384,32768] [--steps 10] [--batch 8]
        [--epoch-size 32] [--epochs 8] [--device cuda]

* ``config2``, 2D inference from a pretrained checkpoint: an ``EM2EM(74,
  is3d=False, wf=8, bf16)`` checkpoint -> ``save_model`` -> ``load_generator``
  (bf16) -> the fused uint8 tile step (preprocess, the generator, postprocess
  to 40^2) over card-resident batches of seeded 74^2 tiles, the result left
  on the card, at each batch of ``--ladder`` (the JAX bench's 256 x 16, 64,
  128).  ``inference2d_mvox_per_sec`` is the best rung's output rate
  (``--steps`` calls after a warm one, host clock to a synchronise).  A rung
  that runs out of device memory is reported as such and skipped.
  Reckoned: B = 32768 is 0.72 GB of float32 input, and each 32-channel
  activation of the wf=8 2D generator is 32768 * 74^2 * 32 values, 11.5 GB
  in bf16 (23 GB in float32); an inference forward holds one or two at a
  time, so in bf16 the top rung should fit on an 80 GB card.
  The 2D generator's convs all run on cuDNN (the JAX package keeps its
  Pallas conv to 3D), so this config reaches LeakyReLU and the uint8
  edges, not conv3.
* ``config4``, 3D training with streaming fetch and augmentation: a seeded
  synthetic volume behind an in-process data service speaking the
  reference's ``/volume`` contract (no prefork workers, so no fork), two
  ``volume3d_ng`` sources, ``create_dataset_from_generator`` with the warp
  and augmentation, and ``EM2EM.train_step`` (wf=8, bf16).
  ``stream_train_tiles74_per_sec`` over ``--epochs`` timed epochs after a
  warm one.

One JSON line a config, with the card and the kernels' launches.
Checkpoints and exports go to a temporary directory, removed after.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time
from typing import List, Optional, Sequence

import numpy as np
import torch

from . import (DTYPES, card, emit, float32_exact, launch_counts, launches,
               log, peak_memory_gb, reset_peak_memory, sync, synth_volume)
from ..device import resolve_device

DIM = 74
LADDER = (256 * 16, 256 * 64, 256 * 128)


def config2_2d_inference(dev, ladder: Sequence[int] = LADDER,
                         steps: int = 10, wf: int = 8,
                         dtype: str = "bfloat16") -> dict:
    from ..infer import load_generator, save_model
    from ..ops.normalize import postprocess_to_u8, preprocess_u8
    from ..train import EM2EM

    root = tempfile.mkdtemp(prefix="bench_cfg2_")
    before = launch_counts()
    rungs, best = [], None
    try:
        model = EM2EM(DIM, "bench_cfg2", is3d=False, wf=wf,
                      compute_dtype=dtype, checkpoint_root=root, device=dev)
        model.make_checkpoint(1)
        model.wait_until_finished()
        export = os.path.join(root, "export")
        save_model(export, os.path.join(model.checkpoint_path, "1"),
                   (0.0, 1.0), (0.0, 1.0), size=DIM, is3d=False, wf=wf,
                   device=dev)
        del model
        gen, meta = load_generator(export, device=dev, compute_dtype=dtype)
        out_side = meta.outdimsize

        def step(tiles):
            with torch.inference_mode():
                return postprocess_to_u8(gen(preprocess_u8(
                    tiles, meta.meanstd_x)), meta.meanstd_y, 0)

        rng = np.random.default_rng(0)
        for b in ladder:
            rung = {"batch": b}
            tiles = out = None
            try:
                reset_peak_memory(dev)
                tiles = torch.from_numpy(rng.integers(
                    0, 256, size=(b, DIM, DIM), dtype=np.uint8)).to(dev)
                out = step(tiles)  # warm: cuDNN's algorithm search
                sync(dev)
                t0 = time.perf_counter()
                for _ in range(steps):
                    out = step(tiles)
                sync(dev)
                dt = time.perf_counter() - t0
                rung.update(mvox_per_sec=steps * b * out_side ** 2 / dt / 1e6,
                            step_s=dt / steps,
                            peak_memory_gb=peak_memory_gb(dev),
                            out_shape=list(out.shape))
                log(f"# config2 B={b}: {rung['mvox_per_sec']:.2f} Mvox/s")
                if best is None or rung["mvox_per_sec"] > best[
                        "mvox_per_sec"]:
                    best = rung
            except torch.cuda.OutOfMemoryError as e:
                rung.update(out_of_memory=True, error=str(e).split("\n")[0])
                log(f"# config2 B={b}: out of device memory, skipped")
            finally:
                del tiles, out
                if dev.type == "cuda":
                    torch.cuda.empty_cache()
            rungs.append(rung)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    if best is None:
        raise RuntimeError("config2: every rung of the ladder ran out of "
                           "device memory")
    return {"bench": "baseline_configs", "config": "config2",
            "metric": "inference2d_mvox_per_sec",
            "value": best["mvox_per_sec"], "unit": "Mvox/s",
            "note": f"config 2: ckpt->export->load, {dtype}, "
                    f"B={best['batch']}", "wf": wf, "dtype": dtype,
            "steps": steps, "rungs": rungs, "launches": launches(before)}


def config4_stream_train(dev, batch: int = 8, epoch_size: int = 32,
                         extent: int = 160, epochs: int = 8, wf: int = 8,
                         dtype: str = "bfloat16") -> dict:
    from ..data import create_dataset_from_generator, volume3d_ng
    from ..debug import warp
    from ..serve import NumpyVolume, register_volume
    from ..serve.data_service import DataService
    from ..train import EM2EM

    register_volume("benchbucket/em", NumpyVolume(synth_volume(extent)))
    svc = DataService()  # threaded, no workers: nothing forks
    svc.start()
    root = tempfile.mkdtemp(prefix="bench_cfg4_")
    before = launch_counts()
    try:
        bbox = ((0, 0, 0), (extent,) * 3)
        src_y = volume3d_ng("benchbucket/em", bbox, size=DIM, seed=22,
                            cloudrun=svc.url)
        src_x = volume3d_ng("benchbucket/em", bbox, size=DIM, seed=11,
                            cloudrun=svc.url)
        ds_y, _ = create_dataset_from_generator(
            src_y, batch_size=batch, epoch_size=epoch_size,
            enable_augmentation=True, device=dev)
        ds_x, _ = create_dataset_from_generator(
            src_x, batch_size=batch, epoch_size=epoch_size, custom_map=warp,
            enable_augmentation=True, device=dev)
        model = EM2EM(DIM, "bench_cfg4", is3d=True, wf=wf,
                      compute_dtype=dtype, checkpoint_root=root, device=dev)

        def epoch():
            n, losses = 0, None
            for bx, by in zip(ds_x, ds_y):
                losses = model.train_step(bx, by)
                n += batch
            float(losses.sum())  # the epoch's last step on the host
            return n

        epoch()  # warm: cuDNN's algorithm search, the first fetches
        t0 = time.perf_counter()
        # several epochs, so the epoch-restart costs (fresh fetch threads,
        # a cold prefetch queue) are amortised as a real run amortises them
        n = sum(epoch() for _ in range(epochs))
        dt = time.perf_counter() - t0
    finally:
        svc.stop()
        shutil.rmtree(root, ignore_errors=True)
    log(f"# config4: {n / dt:.2f} tiles/s over {epochs} epochs")
    return {"bench": "baseline_configs", "config": "config4",
            "metric": "stream_train_tiles74_per_sec", "value": n / dt,
            "unit": "tiles/s",
            "note": f"config 4: HTTP fetch+warp+augment->train, B={batch}, "
                    f"{epochs} epochs", "wf": wf, "dtype": dtype,
            "batch": batch, "epoch_size": epoch_size, "epochs": epochs,
            "tiles": n, "seconds": dt, "launches": launches(before)}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="BASELINE configs 2 and 4 on the port (one JSON line "
                    "each).")
    ap.add_argument("which", nargs="?", default="both",
                    choices=("config2", "config4", "both"))
    ap.add_argument("--ladder", default=",".join(map(str, LADDER)),
                    help="config2: comma-separated tile batches")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--batch", type=int, default=8, help="config4")
    ap.add_argument("--epoch-size", type=int, default=32)
    ap.add_argument("--extent", type=int, default=160)
    ap.add_argument("--epochs", type=int, default=8)
    ap.add_argument("--wf", type=int, default=8)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    float32_exact()
    dev = resolve_device(args.device)
    dtype = DTYPES[args.dtype]
    if args.which in ("config2", "both"):
        ladder = [int(b) for b in args.ladder.split(",") if b]
        emit({**config2_2d_inference(dev, ladder, args.steps, args.wf,
                                     dtype), **card(dev)})
    if args.which in ("config4", "both"):
        emit({**config4_stream_train(dev, args.batch, args.epoch_size,
                                     args.extent, args.epochs, args.wf,
                                     dtype), **card(dev)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
