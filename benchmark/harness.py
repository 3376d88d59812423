"""What every cell shares: finding a cell, its configuration, its driver
and its per-layer readers by name; the card check; the measured window
with its optional profiler trace; spans around the calls into the system;
the trace's reduction (busy seconds, device operations, idle gaps); the
guard against JAX; and the result line.

A driver (``drivers/<name>.py``) exposes ``run(ctx, control=None) ->
dict`` and calls ``ctx.begin_window()`` when its set-up is done and
``ctx.end_window()`` when the window's work is complete.  Given a
``control`` (a ``reference.models`` rounding), it puts the reference in
that precision in the program's place in its checks.  It returns:

* ``e2e``: end-to-end metric values by name;
* ``attempted`` / ``failed``: operations or requests of the window;
* ``checks``: ``[(name, value, limit)]``, each passing at value <= limit;
* ``obs``: whatever the cell's per-layer readers read (``metrics/<name>.py``
  exposes ``read(obs) -> float | None``; None leaves the metric out);
* ``detail``: what the run reports beside its checks, on standard error.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "transfer_em_tpu")
WINDOW = "bench.window"

from benchmark import kernels  # noqa: E402


# -- finding things by name ----------------------------------------------------

def load_json(kind: str, name: str) -> dict:
    """``benchmark/<kind>/<name>.json`` (configs, workloads)."""
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` (drivers, metrics), loaded from its
    file: names may hold dots and dashes."""
    path = os.path.join(HERE, kind, name + ".py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark_{kind}_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, section: str) -> List[dict]:
    """The metrics of ``section`` (end_to_end, per_layer) that ``cell``
    reports: those that list it, and those that list no cells."""
    return [m for m in bench[section]
            if "workloads" not in m or cell in m["workloads"]]


# -- the run's environment -------------------------------------------------------

def cache_env() -> None:
    """Fixed cache folders inside the checkout for anything that compiles,
    and no JAX behind a library's back.  Call before importing torch."""
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def check_card(chips: int) -> None:
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: torch.cuda.is_available() is "
                         "False; the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} cards, "
                         f"torch.cuda.device_count() is "
                         f"{torch.cuda.device_count()}")


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that are JAX's or the JAX package's,
    compared whole."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


# -- the context a driver gets ---------------------------------------------------

class Ctx:
    """One run of one cell."""

    def __init__(self, name: str, cell: dict, config: dict, seed: int,
                 seconds: float, trace: bool, t0: float, devices=None):
        self.name, self.cell, self.config = name, cell, config
        self.seed, self.seconds, self.trace = int(seed), float(seconds), trace
        self.t0 = t0
        self.devices = devices if devices is not None else _cards(
            int(cell.get("chips", 1)))
        self.tmp = tempfile.mkdtemp(prefix="bench-")
        self.spans: Dict[str, float] = {}
        self.setup_s: Optional[float] = None
        self.window_s: Optional[float] = None
        self.setup_peak = 0
        self.window_peak = 0
        self.events = None
        self._prof = None
        self._ann = None
        self._w0 = None

    # spans: host seconds summed by name; in a traced run also a profiler
    # range of that name, which names the idle gaps under it
    @contextlib.contextmanager
    def span(self, name: str):
        rf = None
        if self.trace and self._prof is not None:
            import torch
            rf = torch.profiler.record_function(name)
            rf.__enter__()
        t = time.perf_counter()
        try:
            yield
        finally:
            self.spans[name] = self.spans.get(name, 0.0) + (
                time.perf_counter() - t)
            if rf is not None:
                rf.__exit__(None, None, None)

    def sync(self) -> None:
        import torch
        for d in self.devices:
            if d.type == "cuda":
                torch.cuda.synchronize(d)

    def begin_window(self) -> None:
        """Set-up ends here: everything is built and warm."""
        import torch
        self.sync()
        for d in self.devices:
            if d.type == "cuda":
                self.setup_peak = max(self.setup_peak,
                                      torch.cuda.max_memory_allocated(d))
                torch.cuda.reset_peak_memory_stats(d)
        self.setup_s = time.perf_counter() - self.t0
        self.spans.clear()
        if self.trace:
            self._prof = _start_profiler(self.devices)
            self._ann = torch.profiler.record_function(WINDOW)
            self._ann.__enter__()
        self._w0 = time.perf_counter()

    def end_window(self) -> None:
        import torch
        self.sync()
        self.window_s = time.perf_counter() - self._w0
        if self._ann is not None:
            self._ann.__exit__(None, None, None)
            self._ann = None
        if self._prof is not None:
            self.events = _stop_profiler(self._prof)
            self._prof = None
        for d in self.devices:
            if d.type == "cuda":
                self.window_peak = max(self.window_peak,
                                       torch.cuda.max_memory_allocated(d))

    @property
    def memory_peak_bytes(self) -> int:
        return max(self.setup_peak, self.window_peak)

    def close(self) -> None:
        shutil.rmtree(self.tmp, ignore_errors=True)


def _cards(n: int):
    import torch
    return [torch.device("cuda", i) for i in range(n)]


# -- the profiler ------------------------------------------------------------------

def _start_profiler(devices):
    """Kineto, CPU and CUDA activities, no shapes or stacks; the raw events
    are read at the stop without building the profiler's Python tables."""
    from torch.autograd import (ProfilerActivity, ProfilerConfig,
                                ProfilerState, _enable_profiler,
                                _prepare_profiler)
    from torch._C._profiler import _ExperimentalConfig
    acts = {ProfilerActivity.CPU}
    if any(d.type == "cuda" for d in devices):
        acts.add(ProfilerActivity.CUDA)
    cfg = ProfilerConfig(ProfilerState.KINETO, False, False, False, False,
                         False, _ExperimentalConfig())
    _prepare_profiler(cfg, acts)
    _enable_profiler(cfg, acts)
    return True


def _stop_profiler(_prof):
    from torch.autograd import _disable_profiler
    return _disable_profiler().events()


def reduce_trace(events, n_devices: int) -> dict:
    """From raw profiler events: the window's bounds (its ``bench.window``
    range), per device the union of operation intervals inside it (busy),
    the device time by operation name, and the longest idle gaps of the
    first device, each named by the innermost benchmark span, else host
    operation, that covers its middle."""
    import numpy as np
    from torch.autograd import DeviceType
    w0 = w1 = None
    host: List[Tuple[int, int, str, bool]] = []
    dev: List[Tuple[int, int, int, str, int]] = []
    launches: Dict[int, Tuple[int, int]] = {}  # correlation -> (thread, ns)
    ops: Dict[Tuple[str, int], list] = {}  # (host op, thread) -> intervals
    for e in events:
        name = e.name()
        if e.device_type() == DeviceType.CPU:
            if name == WINDOW:
                w0, w1 = e.start_ns(), e.end_ns()
                continue
            host.append((e.start_ns(), e.end_ns(), name,
                         bool(e.is_user_annotation())))
            if name.startswith("cu") and e.correlation_id():
                launches[e.correlation_id()] = (e.start_thread_id(),
                                                e.start_ns())
            elif name in kernels.HOST_OPS:
                ops.setdefault((name, e.start_thread_id()), []).append(
                    (e.start_ns(), e.end_ns()))
        elif e.device_type() == DeviceType.CUDA and not e.is_user_annotation():
            dev.append((max(e.device_index(), 0), e.start_ns(), e.end_ns(),
                        name, e.correlation_id()))
    spans = {k: (np.array(sorted(v))[:, 0], np.array(sorted(v))[:, 1])
             for k, v in ops.items()}
    if w0 is None:
        raise RuntimeError("no bench.window range in the trace")
    busy = {}
    by_name: Dict[str, float] = {}
    per_dev: Dict[int, list] = {}
    by_host_op: Dict[str, float] = {}
    for d, s, t, name, corr in dev:
        s, t = max(s, w0), min(t, w1)
        if t <= s:
            continue
        per_dev.setdefault(d, []).append((s, t))
        by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e9
        if corr in launches:
            tid, ts = launches[corr]
            for op in kernels.HOST_OPS:
                if (op, tid) in spans:
                    starts, ends = spans[(op, tid)]
                    i = int(np.searchsorted(starts, ts, "right")) - 1
                    if i >= 0 and ends[i] >= ts:
                        by_host_op[op] = by_host_op.get(op, 0.0) + (
                            t - s) / 1e9
    gaps = []
    for d in sorted(per_dev):
        merged: List[List[int]] = []
        for s, t in sorted(per_dev[d]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], t)
            else:
                merged.append([s, t])
        busy[d] = sum(t - s for s, t in merged) / 1e9
        if not gaps:
            edges = [w0] + [x for iv in merged for x in iv] + [w1]
            gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                           for i in range(0, len(edges), 2)
                           if edges[i + 1] > edges[i]), reverse=True)[:10]
    named = []
    if host:
        hs = np.array([h[0] for h in host], np.int64)
        he = np.array([h[1] for h in host], np.int64)
        user = np.array([h[3] for h in host])
        for length, s, t in gaps:
            mid = (s + t) // 2
            cover = np.nonzero((hs <= mid) & (he >= mid))[0]
            label = "no host activity"
            if len(cover):
                pick = [i for i in cover if user[i]] or list(cover)
                i = min(pick, key=lambda j: he[j] - hs[j])
                label = host[i][2]
            named.append([label, length / 1e9])
    else:
        named = [["no host activity", g[0] / 1e9] for g in gaps]
    n = max(n_devices, 1)
    return {"window_s": (w1 - w0) / 1e9,
            "busy_s": sum(busy.values()) / n,
            "busy_by_device": busy,
            "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1]),
            "by_host_op": by_host_op,
            "idle_gaps": named}


def device_seconds(trace: dict, match: Callable[[str], bool]) -> float:
    """Device seconds of the operations whose name ``match`` accepts."""
    return sum(s for name, s in trace["device_ops"] if match(name))


# -- the result ----------------------------------------------------------------------

def device_info(devices, peak: int) -> dict:
    import torch
    if devices[0].type != "cuda":  # the CPU tests' runs
        return {"platform": "cpu", "kind": "cpu", "count": len(devices),
                "memory_peak_bytes": int(peak)}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": len(devices), "memory_peak_bytes": int(peak)}


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of every card, for the log."""
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().replace("\n", "; ")
    except (OSError, subprocess.TimeoutExpired):
        return "nvidia-smi not readable"


def measure(args, t0: float, devices=None, overrides=None, control=None):
    """One run of one cell: returns the result line (a dict) and the
    driver's output, or None and the names of the JAX modules that the
    run loaded.  ``devices`` and ``overrides`` ({"cell": {..}, "config":
    {..}}, merged into the files') are the tests': they run the rest of a
    run on the CPU at a small size, without the look for a card.
    ``control`` (a ``reference.models`` rounding) puts the reference in
    that precision in the program's place, so the line reads its verdict
    (``tools/control.py``)."""
    name = args.workload
    cell = load_json("workloads", name)
    config = load_json("configs", cell["config"])
    if overrides:
        cell.update(overrides.get("cell", {}))
        config.update(overrides.get("config", {}))
    bench = load_benchmark()
    if devices is None:
        check_card(int(cell["chips"]))
    import torch
    torch.set_num_threads(4)
    driver = load_module("drivers", cell["driver"])
    ctx = Ctx(name, cell, config, args.seed, args.seconds, bool(args.trace),
              t0, devices=devices)
    try:
        out = driver.run(ctx, control=control)
    finally:
        ctx.close()
    bad = forbidden_modules()
    if bad:
        return None, bad
    checks = out["checks"]
    correct = (all(v <= lim for _, v, lim in checks)
               and out["failed"] == 0)
    line = {"correct": correct, "attempted": int(out["attempted"]),
            "failed": int(out["failed"])}
    metrics = {}
    if not ctx.trace:
        for m in cell_metrics(bench, name, "end_to_end"):
            value = (ctx.setup_s if m["name"] == "setup_s"
                     else out["e2e"].get(m["name"]))
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        line["metrics"] = metrics
        line["device"] = device_info(ctx.devices, ctx.memory_peak_bytes)
    else:
        trace = reduce_trace(ctx.events, len(ctx.devices))
        obs = dict(out["obs"], trace=trace, spans=dict(ctx.spans),
                   window_s=ctx.window_s, devices=len(ctx.devices),
                   window_peak_bytes=ctx.window_peak)
        for m in cell_metrics(bench, name, "per_layer"):
            value = load_module("metrics", m["name"]).read(obs)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        line["metrics"] = metrics
        line["device"] = dict(device_info(ctx.devices,
                                          ctx.memory_peak_bytes),
                              busy_s=trace["busy_s"],
                              window_s=trace["window_s"])
        line["breakdown"] = {
            "device_ops": [[n[:200], s] for n, s in trace["device_ops"][:10]],
            "idle_gaps": trace["idle_gaps"][:10]}
    line["checks"] = {n: {"value": v, "limit": lim} for n, v, lim in checks}
    return line, out


def report(line: dict, out: dict) -> None:
    """The run's detail and each number compared beside its limit, last on
    standard error, then the result line, last on standard output."""
    detail = {k: v for k, v in out.get("detail", {}).items()
              if not k.endswith("leaves")}
    print(f"detail: {json.dumps(detail, default=str)}", file=sys.stderr)
    print(f"card: {card_line()}", file=sys.stderr)
    for n, c in line["checks"].items():
        print(f"check {n}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


def run(args, t0: float, devices=None, overrides=None) -> int:
    """One run of one cell, reported; returns the exit code."""
    line, out = measure(args, t0, devices=devices, overrides=overrides)
    if line is None:
        print(f"refused: {out} loaded in this process", file=sys.stderr)
        return 3
    report(line, out)
    return 0
