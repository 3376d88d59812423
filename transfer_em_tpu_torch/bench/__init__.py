"""Benchmarks of the port at a width of the caller's choice.

* ``python -m transfer_em_tpu_torch.bench.train``: train-step tiles/s,
  step seconds, peak memory and the step's FLOPs beside the card's peak
  (the counterpart of the JAX package's ``bench.py`` and ``bench_wf1.py``).
* ``python -m transfer_em_tpu_torch.bench.infer``: ``predict_volume``
  Mvox/s in device and slab mode over a card-resident uint8 volume, the
  host<->device copies timed apart (the counterpart of ``bench_infer.py``).

Each prints one JSON line a configuration.  They run on ``cuda`` unless
``--device cpu`` is given; a CPU run's times are the CPU's, and its lines
carry no share of the card's peak.
"""

from __future__ import annotations

import subprocess
from typing import Optional

import torch

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
