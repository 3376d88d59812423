"""Int8 serving against bf16: the counterpart of the JAX package's
``bench_int8.py``.

    python -m transfer_em_tpu_torch.bench.int8 [--configs 8:128,1:4,1:8]
        [--reps 5] [--goldens DIR] [--device cuda]

* Throughput: the fused uint8 tile step (preprocess -> generator -> tpad
  trim -> postprocess, tpad 2) on a card-resident batch of seeded uint8
  74^3 tiles, the result left on the card, bf16 against
  ``UNetGenerator(compute_dtype="bfloat16", int8_conv=True)`` on the same
  weights (``torch.Generator().manual_seed(0)``, the modules' N(0, 0.02)
  init), at each ``wf:batch`` of ``--configs`` (default wf=8 B=128, wf=1
  B=4 and 8); one warm call, then ``--reps`` timed calls (host clock to a
  synchronise).  Mvox/s counts 36^3 output voxels a tile.
* Fidelity: the frozen goldens (``gen_2d``, ``gen_3d``) through
  ``UNetGenerator(wf=8, int8_conv=True)`` in float32, PSNR against the TF
  reference (bar 40 dB).

One JSON line: ``int8_speedup_b128_wf8`` (for other ``--configs``,
``int8_speedup_b<B>_wf<wf>`` of the first), the int8 / bf16 throughput
ratio (> 1: int8 wins; ``vs_baseline`` the same ratio, as in the JAX
bench), every config's rates, the golden PSNRs, and the launches of the
kernels, ``quantize_int8`` and ``conv_int8`` among them.
"""

from __future__ import annotations

import argparse
import os
import statistics
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import (card, emit, float32_exact, launch_counts, launches, log,
               psnr, sync)
from .fidelity import DEFAULT_GOLDENS
from ..device import resolve_device
from ..models import UNetGenerator
from ..models.convert import GEN_ORDER, params_from_tf_order
from ..ops.normalize import postprocess_to_u8, preprocess_u8

MS = (0.05, 0.9)
TPAD = 2
DEFAULT_CONFIGS = ((8, 128), (1, 4), (1, 8))


def golden_psnr_int8(goldens: str, dev) -> Dict[str, float]:
    out = {}
    for tag in ("2d", "3d"):
        data = np.load(os.path.join(goldens, f"gen_{tag}.npz"))
        gen = UNetGenerator(wf=8, is3d=tag == "3d", int8_conv=True)
        gen.load_state_dict(params_from_tf_order(data, GEN_ORDER))
        gen = gen.to(dev).eval()
        with torch.inference_mode():
            got = gen(torch.from_numpy(data["x"]).to(dev)).cpu().numpy()
        out[f"gen_{tag}_int8"] = psnr(got, data["y"])
        log(f"# fidelity gen_{tag} int8: {out[f'gen_{tag}_int8']:.2f} dB "
            "(bar 40)")
    return out


def device_step(gen: torch.nn.Module):
    """The fused tile step on a device-resident uint8 batch, its result
    left on the device."""
    def step(tiles: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return postprocess_to_u8(gen(preprocess_u8(tiles, MS)), MS, TPAD)
    return step


def time_step(step, tiles, dev, reps: int) -> Tuple[float, List[float]]:
    out = step(tiles)  # warm: cuDNN's algorithm search, weight packs
    sync(dev)
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = step(tiles)
        sync(dev)
        times.append(time.perf_counter() - t0)
    del out
    return statistics.median(times), times


def throughput(configs: Sequence[Tuple[int, int]], reps: int, dev) -> list:
    rows = []
    rng = np.random.default_rng(0)
    for wf in dict.fromkeys(w for w, _ in configs):
        gen_bf = UNetGenerator(wf=wf, compute_dtype="bfloat16",
                               generator=torch.Generator().manual_seed(0))
        gen_q8 = UNetGenerator(wf=wf, compute_dtype="bfloat16",
                               int8_conv=True)
        gen_q8.load_state_dict(gen_bf.state_dict())
        steps = {"bf16": device_step(gen_bf.to(dev).eval()),
                 "int8": device_step(gen_q8.to(dev).eval())}
        for w, b in configs:
            if w != wf:
                continue
            tiles = torch.from_numpy(rng.integers(
                0, 256, size=(b, 74, 74, 74), dtype=np.uint8)).to(dev)
            vox = b * 36 ** 3
            row = {"wf": wf, "batch": b}
            for name, step in steps.items():
                med, times = time_step(step, tiles, dev, reps)
                row[name] = {"ms": med * 1e3, "times_s": times,
                             "mvox_per_sec": vox / med / 1e6}
                log(f"# wf={wf} B={b} {name}: {med * 1e3:.1f} ms -> "
                    f"{row[name]['mvox_per_sec']:.1f} Mvox/s")
            row["speedup"] = (row["int8"]["mvox_per_sec"]
                              / row["bf16"]["mvox_per_sec"])
            log(f"# wf={wf} B={b} int8/bf16 speedup: {row['speedup']:.3f}x")
            rows.append(row)
            del tiles
        del gen_bf, gen_q8, steps
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return rows


def measure(configs: Sequence[Tuple[int, int]] = DEFAULT_CONFIGS,
            reps: int = 5, goldens: str = DEFAULT_GOLDENS,
            device="cuda") -> dict:
    dev = resolve_device(device)
    before = launch_counts()
    fid = golden_psnr_int8(goldens, dev)
    rows = throughput(configs, reps, dev)
    first = rows[0]
    worst = min(fid.values())
    name = ("int8_speedup_b128_wf8" if (first["wf"], first["batch"])
            == (8, 128) else
            f"int8_speedup_b{first['batch']}_wf{first['wf']}")
    return {"bench": "int8", "metric": name, "value": first["speedup"],
            "unit": "x (int8/bf16 device tile-step throughput)",
            "vs_baseline": first["speedup"],
            "note": (f"bf16 {first['bf16']['mvox_per_sec']:.1f} vs int8 "
                     f"{first['int8']['mvox_per_sec']:.1f} Mvox/s; golden "
                     f"PSNR min {worst:.1f} dB (bar 40); "
                     + "; ".join(f"wf{r['wf']} B={r['batch']}: "
                                 f"{r['speedup']:.2f}x" for r in rows[1:])),
            "golden_psnr_db": fid, "golden_psnr_db_min": worst,
            "configs": rows, "reps": reps, "launches": launches(before),
            **card(dev)}


def _configs(text: str) -> List[Tuple[int, int]]:
    out = []
    for item in filter(None, text.split(",")):
        wf, b = item.split(":")
        out.append((int(wf), int(b)))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="int8 against bf16 serving of the port (one JSON line).")
    ap.add_argument("--configs", default="8:128,1:4,1:8",
                    help="comma-separated wf:batch")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--goldens", default=DEFAULT_GOLDENS)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    float32_exact()
    emit(measure(_configs(args.configs), args.reps, args.goldens,
                 args.device))
    return 0


if __name__ == "__main__":
    sys.exit(main())
