"""Train-step throughput of the port at a chosen width and dtype: the
counterpart of the JAX package's ``bench.py`` and ``bench_wf1.py``.

    python -m transfer_em_tpu_torch.bench.train [--wf N] [--dtype f32|bf16]
        [--batch B] [--accum K] [--remat] [--steps N] [--sweep]
        [--device cuda]

Defaults: wf=1, bf16, B=8, 5 steps (``bench_wf1.py``'s first config).  One
JSON line a configuration: ``tiles_per_s`` (the batch over the median of
steps 2..n, each timed on the host clock to a synchronise), the step
seconds, peak device memory, and the step's FLOPs counted from the port's
own layer shapes (:func:`step_flops`) beside the share of the card's peak
that the step reaches (:data:`PEAK_TFLOPS`).  ``--sweep`` runs
``bench_wf1.py``'s configurations in its order at ``--wf`` and
``--dtype``; one that runs out of device memory is reported as such and
skipped.

There is no ``vs_baseline``: the JAX ``bench.py`` divides by the TF2
reference's train step on the host CPU, and the card's machine has no
TensorFlow.
"""

from __future__ import annotations

import argparse
import gc
import json
import math
import statistics
import sys
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from . import (DTYPES, card, float32_exact, peak_memory_gb,
               reset_peak_memory, sync)
from ..config import CycleGANConfig
from ..device import resolve_device
from ..models import Discriminator, UNetGenerator
from ..models.blocks import ConvND, ConvTransposeND
from ..shapes import generator_shapes
from ..train import create_state, make_train_step

# NVIDIA H100 SXM peaks (data sheet, dense, at 700 W), TFLOP/s: bf16 on the
# tensor cores; f32 on the CUDA cores, and f32-accurate products as 3xTF32
# (a third of TF32's 495), the rate conv3's float32 kernel is built on.
PEAK_TFLOPS = {"bfloat16": {"bf16_tensor_cores": 989.0},
               "float32": {"f32_cuda_cores": 67.0, "f32_3xtf32": 165.0}}

# bench_wf1.py's configurations, in its order
SWEEP = (dict(batch=8), dict(batch=8, remat=True), dict(batch=16, accum=2),
         dict(batch=10), dict(batch=12), dict(batch=12, remat=True),
         dict(batch=24, accum=2))

CONV_KINDS = ("k3", "k4_down", "transposed", "1x1")


# -- the FLOP count ------------------------------------------------------------

def _kind(m: torch.nn.Module) -> str:
    if isinstance(m, ConvTransposeND):
        return "transposed"
    return {3: "k3", 4: "k4_down", 1: "1x1"}[int(m.kernel.shape[0])]


def conv_macs(kind: str, in_shape, kernel_shape, out_shape) -> int:
    """Multiply-adds of one conv: every output voxel of a conv takes
    taps x Cin x Cout of them; a transposed conv (cuDNN runs it as the
    input gradient of a conv) every INPUT voxel.  Shapes channels-last,
    batch first; the kernel (*taps, Cin, Cout)."""
    voxels = math.prod(in_shape[:-1] if kind == "transposed"
                       else out_shape[:-1])
    return voxels * math.prod(kernel_shape)


def conv_layers(build: Callable[[], torch.nn.Module],
                input_shape) -> List[dict]:
    """Every conv of one forward of the module ``build()`` makes, on an
    input of ``input_shape`` (B, *S, 1), in call order: name, kind (one of
    :data:`CONV_KINDS`), input, kernel and output shapes, multiply-adds.
    The module is built and run on fake tensors, which carry shapes and no
    data: nothing is computed or allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    rec: List[dict] = []

    def hook(name, m, args, out):
        kind = _kind(m)
        shapes = (tuple(args[0].shape), tuple(m.kernel.shape),
                  tuple(out.shape))
        rec.append({"name": name, "kind": kind, "in_shape": shapes[0],
                    "kernel": shapes[1], "out_shape": shapes[2],
                    "macs": conv_macs(kind, *shapes)})

    with FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad():
        net = build()
        for name, m in net.named_modules():
            if isinstance(m, (ConvND, ConvTransposeND)):
                m.register_forward_hook(
                    lambda m, a, o, name=name: hook(name, m, a, o))
        net(torch.empty(tuple(input_shape)))
    return rec


def step_flops(config: CycleGANConfig, batch: int) -> dict:
    """FLOPs (2 per multiply-add) of one train step of ``batch`` tile pairs
    as :func:`..train.cgan.cyclegan_losses` runs it (batched_apps), over
    every k3, k4 down, transposed and 1x1 conv:

    * forward: 6 generator tile applications a pair (G and F on 2B in
      round 1, on B in the cycles; with ``remat`` each is run again in the
      backward) and 6 discriminator ones (Dx and Dy on the real and the
      detached fake, 2B each, then frozen on the fake, B each);
    * backward, the weight gradient: every generator application and the
      discriminators' 4 trained ones (the frozen ones take no dw);
    * the input gradient: every layer but the first of an application
      whose input needs none (the generators' round 1 reads the real
      batches, the trained discriminators real and detached inputs); the
      cycles and the frozen discriminators carry it down to their input.

    ``accum_steps`` splits the batch without changing the count.  Returns
    totals, the split by pass and by conv kind, and the count per tile
    pair (one x and one y tile, the unit of the JAX package's 5.1 TF at
    wf=1)."""
    nd = 3 if config.is3d else 2
    out = generator_shapes(config.dimsize).out
    gen = conv_layers(lambda: UNetGenerator(wf=config.wf, is3d=config.is3d),
                      (1,) + (config.dimsize,) * nd + (1,))
    disc = conv_layers(lambda: Discriminator(wf=config.wf,
                                             is3d=config.is3d),
                       (1,) + (out,) * nd + (1,))
    b = batch
    passes = {"forward": 0, "backward_dw": 0, "backward_dx": 0}
    by_kind = dict.fromkeys(CONV_KINDS, 0)
    for net, layers in (("gen", gen), ("disc", disc)):
        for i, layer in enumerate(layers):
            if net == "gen":
                mult = {"forward": 6 * b * (2 if config.remat else 1),
                        "backward_dw": 6 * b,
                        "backward_dx": 6 * b - (4 * b if i == 0 else 0)}
            else:
                mult = {"forward": 6 * b, "backward_dw": 4 * b,
                        "backward_dx": (4 * b if i > 0 else 0) + 2 * b}
            for k, n in mult.items():
                flops = 2 * n * layer["macs"]
                passes[k] += flops
                by_kind[layer["kind"]] += flops
    total = sum(passes.values())
    return {"total": total, **passes, "by_kind": by_kind,
            "per_tile_pair": total / b,
            "generator_layers": gen, "discriminator_layers": disc}


# -- the measurement -----------------------------------------------------------

def config_tag(batch: int, accum: int = 1, remat: bool = False) -> str:
    return (f"B={batch}" + (f" accum={accum}" if accum > 1 else "")
            + (" remat" if remat else ""))


def _batches(cfg: CycleGANConfig, batch: int, seed: int,
             dev: torch.device) -> Tuple[torch.Tensor, torch.Tensor]:
    """Two N(0, 1) batches from a numpy seed, as bench_wf1.py draws them."""
    rng = np.random.default_rng(seed)
    shape = (batch,) + (cfg.dimsize,) * (3 if cfg.is3d else 2) + (1,)
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(
        np.float32)).to(dev) for _ in range(2))


def measure(wf: int = 1, dtype: str = "bfloat16", batch: int = 8,
            accum: int = 1, remat: bool = False, steps: int = 5,
            device="cuda", seed: int = 0,
            profile: Optional[Callable[[Callable[[], None]], dict]] = None
            ) -> dict:
    """``steps`` train steps (3D, 74^3, dropout on) of a fresh state at
    ``wf`` and ``dtype``; steps 2..n timed.  ``profile``: called after the
    timed steps with a function that runs one more step; what it returns
    is kept under ``profiled_step``."""
    if steps < 2:
        raise ValueError(f"steps must be >= 2 (step 1 is the warm-up), got "
                         f"{steps}")
    dev = resolve_device(device)
    dtype = DTYPES[dtype]
    cfg = CycleGANConfig(dimsize=74, is3d=True, wf=wf, compute_dtype=dtype,
                         accum_steps=accum, remat=remat, batch_size=batch)
    reset_peak_memory(dev)
    state = create_state(cfg, seed, device=dev)
    step = make_train_step(cfg, device=dev)
    x, y = _batches(cfg, batch, seed + 1, dev)
    times, losses = [], []
    for _ in range(steps):
        sync(dev)
        t0 = time.perf_counter()
        loss = step(state, x, y, seed)
        sync(dev)
        times.append(time.perf_counter() - t0)
        losses.append(loss.cpu().tolist())
    peak = peak_memory_gb(dev)
    median = statistics.median(times[1:])
    flops = step_flops(cfg, batch)
    achieved = flops["total"] / median / 1e12
    rec = {"bench": "train", "config": config_tag(batch, accum, remat),
           "wf": wf, "dtype": dtype, "batch": batch, "accum": accum,
           "remat": remat, "steps": steps, "step_s": times,
           "median_step_s_2_to_n": median, "tiles_per_s": batch / median,
           "peak_memory_gb": peak,
           "losses_finite": bool(np.all(np.isfinite(losses))),
           "flops_per_step": flops["total"],
           "flops_per_tile_pair": flops["per_tile_pair"],
           "flops_by_pass": {k: flops[k] for k in
                             ("forward", "backward_dw", "backward_dx")},
           "flops_by_kind": flops["by_kind"], "tflops_per_s": achieved,
           # the card's peaks, so only a card's run has a share of them
           "share_of_peak": ({k: achieved / v for k, v in
                              PEAK_TFLOPS[dtype].items()}
                             if dev.type == "cuda" else None),
           **card(dev)}
    if profile is not None:
        rec["profiled_step"] = profile(lambda: step(state, x, y, seed))
    return rec


def sweep(wf: int = 1, dtype: str = "bfloat16", steps: int = 5,
          device="cuda", configs=SWEEP, emit=print) -> List[dict]:
    """Each of ``configs`` in turn; one that runs out of device memory is
    reported (``oom``) and skipped, any other error raises."""
    out = []
    for c in configs:
        try:
            rec = measure(wf=wf, dtype=dtype, steps=steps, device=device, **c)
        except torch.cuda.OutOfMemoryError as e:
            rec = {"bench": "train", "config": config_tag(**c), "wf": wf,
                   "dtype": DTYPES[dtype], "oom": True,
                   "error": str(e).splitlines()[0][:200]}
        gc.collect()
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
        emit(json.dumps(rec))
        out.append(rec)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Train-step throughput of the port (one JSON line a "
                    "configuration).")
    ap.add_argument("--wf", type=int, default=1)
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--sweep", action="store_true",
                    help="bench_wf1.py's configurations in order")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    float32_exact()
    if args.sweep:
        sweep(args.wf, args.dtype, args.steps, args.device)
        return 0
    print(json.dumps(measure(args.wf, args.dtype, args.batch, args.accum,
                             args.remat, args.steps, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
