"""Observability: step timing, loss logging, profiler traces (counterpart of
transfer_em_tpu/train/metrics.py).

* ``StepTimer``: EMA'd per-item step latency and throughput.
* ``MetricsLogger``: a JSONL log of per-epoch losses and timing; the 7-loss
  vector keeps the reference's order (``LOSS_NAMES``).
* ``profile_trace``: a ``torch.profiler`` trace of the block (CPU and, where
  CUDA is present, CUDA activities) exported as a Chrome trace into a
  directory.

The port's spans and counters live in ``transfer_em_tpu_torch.telemetry``,
the one registry: host totals always, and while a profiler records, a user
annotation in its trace, a record and device time a span.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import IO, Optional, Sequence

LOSS_NAMES = ["g_gen_total", "f_gen_total", "disc_y", "disc_x",
              "g_gen_only", "f_gen_only", "cycle"]

TRACE_FILE = "trace.json"


class StepTimer:
    """Exponential-moving-average step timer."""

    def __init__(self, alpha: float = 0.1):
        self.alpha = alpha
        self.ema: Optional[float] = None
        self._t0: Optional[float] = None
        self.count = 0

    def start(self):
        self._t0 = time.perf_counter()

    def stop(self, items: int = 1) -> float:
        dt = time.perf_counter() - self._t0
        per_item = dt / max(items, 1)  # so items_per_sec honours items=
        self.ema = per_item if self.ema is None else (
            self.alpha * per_item + (1 - self.alpha) * self.ema)
        self.count += items
        return dt

    @property
    def items_per_sec(self) -> Optional[float]:
        if self.ema is None or self.ema <= 0.0:
            return None
        return 1.0 / self.ema


class MetricsLogger:
    """Append-only JSONL metrics log."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._f: Optional[IO] = open(path, "a") if path else None

    def log_epoch(self, epoch: int, loss7: Sequence[float],
                  seconds: float, steps: int):
        if self._f is None:
            return
        rec = {"epoch": epoch, "seconds": seconds, "steps": steps,
               "loss": {k: float(v) for k, v in zip(LOSS_NAMES, loss7)}}
        self._f.write(json.dumps(rec) + "\n")
        self._f.flush()

    def close(self):
        if self._f:
            self._f.close()
            self._f = None


@contextlib.contextmanager
def profile_trace(log_dir: Optional[str]):
    """A torch.profiler trace of the block, written to
    ``<log_dir>/trace.json`` (no-op when log_dir is None).  The trace
    carries the port's spans (``telemetry``) as user annotations, and
    ``telemetry.records()`` holds them after the block."""
    if log_dir is None:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
