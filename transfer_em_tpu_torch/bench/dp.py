"""Data-parallel scaling of the train step over a device mesh: the
counterpart of the JAX package's ``bench_dp.py``.

    python -m transfer_em_tpu_torch.bench.dp [--cpu N] [--batch B]
        [--dim 74] [--3d] [--wf N] [--steps 10] [--device cuda]

``parallel.make_dp_train_step`` over meshes of 1, 2, 4, .. devices, up to
the cards present (``--cpu N``: N positions on the CPU, the mesh
``tests/test_torch_parallel.py`` builds), at a constant batch a device
(weak scaling).  Per mesh, on stderr and in the JSON line: global tiles/s,
tiles/s a device and the scaling efficiency against one device; the
metric, ``dp_train_tiles_per_sec``, is the largest mesh's.  On one card
the mesh is of one, as the JAX bench's on one chip: the DP program itself
is what runs and is timed.  Defaults as the JAX bench's: on a card 3D,
wf=8, 16 tiles a device, bfloat16; on the CPU 2D (``--3d`` for 3D), wf=32,
8 tiles a device, float32.  Each mesh runs two warm steps, then
``--steps`` timed ones (host clock to a synchronise).  Batches are drawn
from ``numpy.random.default_rng(0)``, the state from seed 0.
"""

from __future__ import annotations

import argparse
import copy
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from . import (card, emit, float32_exact, launch_counts, launches, log,
               sync)
from ..config import CycleGANConfig
from ..device import resolve_device


def mesh_sizes(ndev: int) -> List[int]:
    """1, 2, 4, .. up to ``ndev``."""
    sizes = [1]
    while sizes[-1] * 2 <= ndev:
        sizes.append(sizes[-1] * 2)
    return sizes


def make_case(cfg: CycleGANConfig, state0, devices, n: int,
              per_dev_batch: int, seed: int = 0):
    """The DP step over the first ``n`` of ``devices`` (a data=n mesh), a
    copy of ``state0`` placed on it, and a global batch of ``per_dev_batch
    * n`` tiles a domain, drawn from ``numpy.random.default_rng(seed)``
    (on the host: the step moves each shard's rows to its device).
    Returns (step, state, x, y, mesh)."""
    from ..parallel import (make_dp_train_step, make_mesh, shard_batch,
                            shard_state)

    mesh = make_mesh(n, data=n, space=1, devices=devices[:n])
    bsz = per_dev_batch * n
    sp = (cfg.dimsize,) * (3 if cfg.is3d else 2)
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(bsz,) + sp + (1,)).astype(np.float32)
    y = rng.normal(size=(bsz,) + sp + (1,)).astype(np.float32)
    state = shard_state(copy.deepcopy(state0), mesh)
    return (make_dp_train_step(cfg, mesh), state, shard_batch(x, mesh),
            shard_batch(y, mesh), mesh)


def measure(devices, cfg: CycleGANConfig, per_dev_batch: int,
            steps: int = 10) -> dict:
    from ..train import create_state

    dev0 = devices[0]
    state0 = create_state(cfg, 0, device=dev0)
    before = launch_counts()
    base, meshes = None, []
    for n in mesh_sizes(len(devices)):
        step, state, xs, ys, _ = make_case(cfg, state0, devices, n,
                                           per_dev_batch)
        for _ in range(2):  # warm: cuDNN's algorithm search, allocations
            loss = step(state, xs, ys, 1)
        for d in set(devices[:n]):
            sync(d)
        t0 = time.perf_counter()
        for _ in range(steps):
            loss = step(state, xs, ys, 1)
        float(loss.sum())  # the last step's result on the host
        for d in set(devices[:n]):
            sync(d)
        dt = time.perf_counter() - t0
        bsz = per_dev_batch * n
        tps = bsz * steps / dt
        base = tps if base is None else base
        eff = tps / (base * n)
        log(f"# mesh={n:<3d} global_batch={bsz:<4d} {tps:9.2f} tiles/s "
            f"{tps / n:9.2f} tiles/s/dev  efficiency {eff:6.1%}")
        meshes.append({"ndev": n, "global_batch": bsz,
                       "tiles_per_sec": tps, "tiles_per_sec_per_device":
                       tps / n, "efficiency": eff, "step_s": dt / steps})
        del step, state, xs, ys
    last = meshes[-1]
    return {"bench": "dp", "metric": "dp_train_tiles_per_sec",
            "value": last["tiles_per_sec"], "unit": "tiles/s",
            "vs_baseline": None, "ndev": last["ndev"],
            "scaling_efficiency": last["efficiency"], "meshes": meshes,
            "config": {"dim": cfg.dimsize, "is3d": cfg.is3d, "wf": cfg.wf,
                       "per_dev_batch": per_dev_batch,
                       "dtype": cfg.compute_dtype},
            "steps": steps, "launches": launches(before), **card(dev0)}


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        description="DP train-step scaling of the port (one JSON line).")
    ap.add_argument("--cpu", type=int, default=0, metavar="N",
                    help="a mesh of N CPU positions instead of the cards")
    ap.add_argument("--batch", type=int, default=0,
                    help="tiles a device (default: 8 for 2D / CPU, 16 "
                         "for 3D)")
    ap.add_argument("--dim", type=int, default=74)
    ap.add_argument("--3d", dest="is3d", action="store_true")
    ap.add_argument("--wf", type=int, default=0,
                    help="width factor (default: 32 on the CPU, 8 on a "
                         "card)")
    ap.add_argument("--steps", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="the cards' type (--cpu overrides it)")
    args = ap.parse_args(argv)
    float32_exact()
    if args.cpu:
        devices = [torch.device("cpu")] * args.cpu
    else:
        dev = resolve_device(args.device)
        devices = ([torch.device("cuda", i)
                    for i in range(torch.cuda.device_count())]
                   if dev.type == "cuda" else [dev])
    on_cpu = devices[0].type == "cpu"
    is3d = args.is3d or not on_cpu
    cfg = CycleGANConfig(dimsize=args.dim, is3d=is3d,
                         wf=args.wf or (32 if on_cpu else 8),
                         compute_dtype="float32" if on_cpu else "bfloat16")
    per_dev = args.batch or (8 if on_cpu and not args.is3d else 16)
    emit(measure(devices, cfg, per_dev, args.steps))
    return 0


if __name__ == "__main__":
    sys.exit(main())
