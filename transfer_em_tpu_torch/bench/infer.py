"""Volume inference throughput of the port: the counterpart of the JAX
package's ``bench_infer.py``.

    python -m transfer_em_tpu_torch.bench.infer [--wf N] [--dtype f32|bf16]
        [--batch B] [--side S] [--modes device,slab] [--reps N]
        [--device cuda]

A seeded uint8 volume of ``--side``^3 voxels is uploaded to the card once
(the serving pattern: upload once, predict many) and ``predict_volume``
runs on it in each mode over the region (20, 20, 20) + (side - 40)^3, the
result left on the card; one warm call, then ``--reps`` timed calls (host
clock to a synchronise).  The generator is seeded too (numpy weights of
std 1/sqrt(fan-in), so its outputs span the grey levels).  Defaults:
wf=1, bf16, the width's device batch (``infer.tiling.default_batch_size``),
side 400 (bench_infer.py's 360^3 request).  The volume's upload and the
last result's download are timed and printed apart, as the JAX bench
does: the metric is the device program's.  Prints one JSON line with
Mvox/s (output voxels a second) per mode and the best.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from . import (DTYPES, card, float32_exact, peak_memory_gb,
               reset_peak_memory, sync)
from ..device import resolve_device
from ..infer import predict_volume
from ..infer.tiling import default_batch_size
from ..models import UNetGenerator

MS = (0.05, 0.9)  # bench_infer.py's meanstd, for x and y
START = (20, 20, 20)


def seeded_generator(wf: int = 1, seed: int = 0, dtype: str = "bfloat16",
                     device="cuda") -> UNetGenerator:
    """A 3D generator whose weights are drawn from a numpy seed with std
    1/sqrt(fan-in) (every layer's output stays O(1)), in eval mode."""
    gen = UNetGenerator(wf=wf, compute_dtype=DTYPES[dtype])
    rng = np.random.default_rng(seed)
    gen.load_state_dict({k: torch.from_numpy(rng.normal(
        0, float(np.prod(v.shape[:-1])) ** -0.5, tuple(v.shape)).astype(
            np.float32)) for k, v in gen.state_dict().items()})
    return gen.to(resolve_device(device)).eval()


def make_volume(side: int, seed: int = 0) -> np.ndarray:
    """A seeded uint8 zyx volume of side^3 uniform grey levels, as
    bench_infer.py draws its own."""
    return np.random.default_rng(seed).integers(
        0, 255, size=(side,) * 3, dtype=np.uint8)


def request(side: int):
    """The benchmark's region of a side^3 volume: (start, size), xyz."""
    if side <= 2 * START[0]:
        raise ValueError(f"side {side} leaves no region past the 20-voxel "
                         "margins")
    return START, (side - 2 * START[0],) * 3


def measure(wf: int = 1, dtype: str = "bfloat16",
            batch: Optional[int] = None, side: int = 400,
            modes: Sequence[str] = ("device", "slab"), reps: int = 3,
            device="cuda", seed: int = 0, gen=None, vol=None) -> dict:
    """Mvox/s of ``predict_volume`` in each of ``modes`` (device, slab).
    ``gen``: a generator to use in place of :func:`seeded_generator`'s;
    ``vol``: the uint8 volume (numpy or a tensor already on the device, then
    used in place and not uploaded again) in place of :func:`make_volume`'s.
    """
    dev = resolve_device(device)
    if reps < 1:
        raise ValueError(f"reps must be >= 1, got {reps}")
    gen = gen if gen is not None else seeded_generator(wf, seed, dtype, dev)
    batch = default_batch_size(gen) if batch is None else batch
    if vol is None:
        vol = make_volume(side, seed + 1)
    side = int(vol.shape[0])
    start, size = request(side)
    nvox = int(np.prod(size))
    upload_s = None
    if not (isinstance(vol, torch.Tensor) and vol.device == dev):
        sync(dev)
        t0 = time.perf_counter()
        vol = torch.as_tensor(vol).to(dev)
        sync(dev)
        upload_s = time.perf_counter() - t0
    rec = {"bench": "infer", "metric": "volume_mvox_per_s", "wf": gen.wf,
           "dtype": ("bfloat16" if gen.compute_dtype == torch.bfloat16
                     else "float32"),
           "batch": batch, "volume": [side] * 3, "start": list(start),
           "size": list(size), "reps": reps, "upload_s": upload_s,
           "modes": {}}
    out = None
    for mode in modes:
        kw = {"batch_size": batch} if mode == "device" else {}
        reset_peak_memory(dev)

        def run():
            return predict_volume(vol, gen, start, size, MS, MS, mode=mode,
                                  as_numpy=False, device=dev, **kw)

        sync(dev)
        t0 = time.perf_counter()
        out = run()
        sync(dev)
        warm = time.perf_counter() - t0
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            out = run()
            sync(dev)
            times.append(time.perf_counter() - t0)
        med = statistics.median(times)
        rec["modes"][mode] = {"warm_s": warm, "s": times, "median_s": med,
                              "mvox_per_s": nvox / med / 1e6,
                              "peak_memory_gb": peak_memory_gb(dev)}
    if out is not None:
        t0 = time.perf_counter()
        host = out.cpu().numpy()
        rec["download_s"] = time.perf_counter() - t0
        rec["output_std"] = float(host.std())
    if rec["modes"]:
        best = max(rec["modes"], key=lambda m: rec["modes"][m]["mvox_per_s"])
        rec["best"] = {"mode": best,
                       "mvox_per_s": rec["modes"][best]["mvox_per_s"]}
    rec.update(card(dev))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="predict_volume throughput of the port (one JSON line).")
    ap.add_argument("--wf", type=int, default=1)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    ap.add_argument("--batch", type=int, default=None,
                    help="device mode's tile batch (default: the width's)")
    ap.add_argument("--side", type=int, default=400)
    ap.add_argument("--modes", default="device,slab")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    float32_exact()
    modes = [m for m in args.modes.split(",") if m]
    unknown = set(modes) - {"device", "slab"}
    if unknown:
        ap.error(f"unknown mode(s) {sorted(unknown)}: device, slab")
    print(json.dumps(measure(args.wf, args.dtype, args.batch, args.side,
                             modes, args.reps, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
