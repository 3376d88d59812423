"""Benchmarks of the port at a width of the caller's choice.

* ``python -m transfer_em_tpu_torch.bench.train``: train-step tiles/s,
  step seconds, peak memory and the step's FLOPs beside the card's peak
  (the counterpart of the JAX package's ``bench.py`` and ``bench_wf1.py``).
* ``python -m transfer_em_tpu_torch.bench.infer``: ``predict_volume``
  Mvox/s in device and slab mode over a card-resident uint8 volume, the
  host<->device copies timed apart (the counterpart of ``bench_infer.py``).
* ``python -m transfer_em_tpu_torch.bench.fidelity``: golden PSNR, the
  minimum over the four frozen TF goldens (``bench_fidelity.py``).
* ``python -m transfer_em_tpu_torch.bench.serve [model|data|combined|
  soak]``: the serving fleets over HTTP (``bench_serve.py``).
* ``python -m transfer_em_tpu_torch.bench.dp``: weak scaling of the
  data-parallel train step over meshes of 1, 2, 4, .. devices
  (``bench_dp.py``).
* ``python -m transfer_em_tpu_torch.bench.int8``: the int8 tile step
  against bf16, and the goldens through the int8 generator
  (``bench_int8.py``).
* ``python -m transfer_em_tpu_torch.bench.baseline_configs [config2|
  config4]``: 2D inference from an exported checkpoint and streamed 3D
  training (``bench_baseline_configs.py``).

Each prints one JSON line a configuration or section, with the card's name
and power limit (:func:`card`) and, where a section reaches the port's
hand-written kernels, their launches in this process (:func:`launches`).
They run on ``cuda`` unless ``--device cpu`` is given; a CPU run's times
are the CPU's, and its lines carry no share of the card's peak.  None has
a ``vs_baseline`` that divides by a TPU or TF figure.
"""

from __future__ import annotations

import json
import subprocess
import sys
from typing import Dict, Optional

import numpy as np
import torch

from ..device import float32_exact  # noqa: F401  (the benches' mains)

# --dtype spellings -> CycleGANConfig / UNetGenerator compute_dtype
DTYPES = {"f32": "float32", "float32": "float32", "bf16": "bfloat16",
          "bfloat16": "bfloat16"}


def card(dev: torch.device) -> dict:
    """What ran the numbers: the device's name and, on a card, its name and
    power limit as ``nvidia-smi --query-gpu=name,power.limit`` gives them
    (a card set below 700 W runs slower under load)."""
    if dev.type != "cuda":
        return {"device": "cpu", "card": None}
    smi: Optional[str] = None
    try:
        res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader", "-i", str(dev.index)],
                             capture_output=True, text=True, timeout=60)
        smi = res.stdout.strip() or None
    except (OSError, subprocess.TimeoutExpired):
        pass  # the name below still says which card ran
    return {"device": torch.cuda.get_device_name(dev), "card": smi}


def launch_counts() -> Dict[str, int]:
    """The launch counts of the port's hand-written kernels, and the
    transposed convs by form (:func:`..ops.counts.read_counts`, without the
    weight packs)."""
    from ..ops.counts import PACKS, read_counts
    return {k: v for k, v in read_counts().items() if k not in PACKS}


def launches(since: Dict[str, int]) -> Dict[str, int]:
    """The launches of each kernel since :func:`launch_counts` read
    ``since``."""
    now = launch_counts()
    return {k: now[k] - since.get(k, 0) for k in now}


def emit(rec: dict) -> None:
    """Print one bench line (JSON) and flush it."""
    print(json.dumps(rec), flush=True)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def synth_volume(extent: int = 160, seed: int = 0) -> np.ndarray:
    """Smooth EM-like uint8 texture (box-filtered noise), zyx, as the
    streaming recipe draws it (``examples/torch/streaming_training_3d_local.py``)."""
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(extent + 8,) * 3).astype(np.float32)
    c = np.cumsum(np.cumsum(np.cumsum(v, 0), 1), 2)
    s = (c[8:, 8:, 8:] - c[:-8, 8:, 8:] - c[8:, :-8, 8:] - c[8:, 8:, :-8]
         + c[:-8, :-8, 8:] + c[:-8, 8:, :-8] + c[8:, :-8, :-8]
         - c[:-8, :-8, :-8])
    s = (s - s.min()) / max(float(np.ptp(s)), 1e-6)
    return (s * 255).astype(np.uint8)


def psnr(got, want) -> float:
    """PSNR (dB) with the reference output's dynamic range as peak (the
    JAX package's tests/golden_utils.py rule)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    mse = np.mean((got - want) ** 2)
    peak = max(want.max() - want.min(), 1e-6)
    return float(10 * np.log10(peak ** 2 / max(mse, 1e-20)))


def sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def peak_memory_gb(dev: torch.device) -> Optional[float]:
    return (torch.cuda.max_memory_allocated(dev) / 1e9
            if dev.type == "cuda" else None)


def reset_peak_memory(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
