"""Spans and counters of the port: the one registry.

A span times a block at a layer boundary::

    with telemetry.span("volume.upload"):
        vol = volume_on(vol_zyx, dev)

Always, each span adds one to its name's count and its host seconds
(``time.perf_counter_ns``) to its name's total, and :func:`count` adds to
a counter: about a microsecond a span, read by :func:`totals` (and by
``GET /stats`` of the model service).

While a ``torch.profiler`` session records, each span also

* enters ``torch.profiler.record_function(name)``, so the span is a user
  annotation in the same trace as the device's activities, on its clock;
* keeps a record (:func:`records`): its name, its start and end on the
  profiler's host clock (Unix nanoseconds), its parent span and a request
  id.  A span at an entry point (:data:`ENTRIES`) starts a new request id
  unless it runs inside one; the spans inside it, on its thread, inherit
  it.  Work handed to another thread passes ``parent=current()``;
* given ``device`` (``True`` for the current CUDA device, or a
  ``torch.device``), records a pair of timing events on that device's
  current stream at entry and exit.  Their elapsed time, the device time
  of the work the span enqueued, is read only by :func:`records`, after a
  synchronise: no span waits for the card.

The first span that finds a profiler recording, after one that found
none, clears the previous session's records, so :func:`records` holds the
last session's window alone.  There is nothing to configure: any
``torch.profiler`` session, or ``EM2EM.train(profile_dir=)``, carries the
spans.  A span changes no number the program computes.

The hand-written kernels' wrappers count here too, each under a name of
:data:`LAUNCHES`, where they launch, pack or pick a form.  :func:`totals`
leaves those out, :func:`launches` (``ops.counts.read_counts``) reads
them and :func:`snapshot` reports them beside the totals.
"""

from __future__ import annotations

import functools
import itertools
import threading
import time
from typing import Dict, List, Optional

import torch
import torch.autograd.profiler as _autograd_profiler

# spans that open a request: a train step, a predict_volume call, a request
# to the model service
ENTRIES = frozenset({"train.step", "volume.call", "serve.request"})

# The kernels' counts (``ops/counts.py`` says what each counts), in the
# order :func:`launches` reports them.
LAUNCHES = ("conv3", "down4", "preprocess_u8", "postprocess_u8",
            "leaky_relu", "conv_int8", "quantize_int8", "int8_weight_packs",
            "conv3_tc", "conv3_tc_kw", "conv3_direct", "conv3_bf16",
            "leaky_relu_bf16", "conv3_weight_packs", "down4_weight_packs",
            "transpose_phase", "transpose_cudnn", "down_k4", "down_cudnn")
_LAUNCH_SET = frozenset(LAUNCHES)

_perf_ns = time.perf_counter_ns
# A profiler session records where either says so: ``torch.profiler.profile``
# sets ``_is_profiler_enabled``, which every thread sees; the autograd API's
# session is its own thread's alone.
_enabled_here = torch.autograd._profiler_enabled

_lock = threading.Lock()
_totals: Dict[str, List[int]] = {}  # name -> [count, host ns]
_counts: Dict[str, int] = {}
_records: List[dict] = []
_timed: List[tuple] = []  # (record, start event, end event) not yet read
_local = threading.local()
_ids = itertools.count(1)
_requests = itertools.count(1)


# the profiler's range ops resolved now, not inside the first traced span
with torch.profiler.record_function("telemetry"):
    pass


class _Session:
    on = False  # a profiler was recording at the last span's entry
    thread = 0  # the thread whose span found it first
    number = 0
    offset = 0  # perf_counter ns -> the profiler's clock (Unix ns)


def _stack() -> list:
    s = getattr(_local, "stack", None)
    if s is None:
        s = _local.stack = []
    return s


def current() -> Optional[dict]:
    """The innermost recording span open on this thread (its record), or
    None: pass it as ``parent=`` to a span on another thread."""
    s = getattr(_local, "stack", None)
    return s[-1] if s else None


def _cuda_device(device) -> Optional[torch.device]:
    if device is True:
        return (torch.device("cuda", torch.cuda.current_device())
                if torch.cuda.is_initialized() else None)
    if isinstance(device, torch.device) and device.type == "cuda":
        return device
    return None


class span:
    """``with span(name, device=False, *, parent=None, request=None):``
    times the block (see the module's docstring); ``@span(name)`` times
    each call of a function.  ``parent``: a record from :func:`current` on
    the thread that handed the work over; ``request``: the request id to
    file the span under, where the work is some request's but has no
    parent span (a batch on a worker thread)."""

    __slots__ = ("name", "device", "parent", "request", "_t0", "_rec",
                 "_rf", "_ev", "_session")

    def __init__(self, name: str, device=False, *, parent=None,
                 request=None):
        self.name = name
        self.device = device
        self.parent = parent
        self.request = request

    def __enter__(self):
        if _autograd_profiler._is_profiler_enabled or _enabled_here():
            self._open()
        else:
            self._rec = None
            if _Session.on and _Session.thread == threading.get_ident():
                _Session.on = False
        self._t0 = _perf_ns()
        return self

    def __exit__(self, *exc):
        t1 = _perf_ns()
        dt = t1 - self._t0
        _lock.acquire()
        tot = _totals.get(self.name)
        if tot is None:
            _totals[self.name] = [1, dt]
        else:
            tot[0] += 1
            tot[1] += dt
        _lock.release()
        if self._rec is not None:
            self._close(t1)
        return False

    def __call__(self, fn):
        """As a decorator: each call of ``fn`` is a span of this name."""
        name, device = self.name, self.device

        @functools.wraps(fn)
        def spanned(*args, **kwargs):
            with span(name, device):
                return fn(*args, **kwargs)
        return spanned

    def _open(self) -> None:
        # the annotation first, so that the bookkeeping below lies inside it
        self._rf = torch.profiler.record_function(self.name)
        self._rf.__enter__()
        t0 = _perf_ns()
        if not _Session.on:
            with _lock:
                if not _Session.on:
                    _records.clear()
                    _timed.clear()
                    _Session.number += 1
                    _Session.offset = time.time_ns() - _perf_ns()
                    _Session.thread = threading.get_ident()
                    _Session.on = True
        stack = _stack()
        parent = self.parent if self.parent is not None else (
            stack[-1] if stack else None)
        request = self.request
        if request is None and parent is not None:
            request = parent["request"]
        if request is None and self.name in ENTRIES:
            request = next(_requests)
        self._rec = {"id": next(_ids), "name": self.name,
                     "parent": parent["id"] if parent is not None else None,
                     "request": request, "thread": threading.get_ident(),
                     "start_ns": t0 + _Session.offset, "end_ns": 0,
                     "device_ms": None}
        self._session = _Session.number
        stack.append(self._rec)
        self._ev = None
        dev = _cuda_device(self.device)
        if dev is not None:
            start = torch.cuda.Event(enable_timing=True)
            start.record(torch.cuda.current_stream(dev))
            self._ev = (dev, start)

    def _close(self, t1: int) -> None:
        rec = self._rec
        rec["end_ns"] = t1 + _Session.offset
        timed = None
        if self._ev is not None:
            dev, start = self._ev
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(dev))
            timed = (rec, start, end)
        self._rf.__exit__(None, None, None)
        stack = _stack()
        if stack and stack[-1] is rec:
            stack.pop()
        with _lock:
            if self._session == _Session.number:
                _records.append(rec)
                if timed is not None:
                    _timed.append(timed)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name``."""
    with _lock:
        _counts[name] = _counts.get(name, 0) + n


def records() -> List[dict]:
    """The last profiler session's spans, in order of start: each a dict of
    ``id``, ``name``, ``parent`` (the enclosing span's id, or None),
    ``request``, ``thread``, ``start_ns`` / ``end_ns`` (the profiler's
    host clock), ``self_ns`` (the duration less its children's) and
    ``device_ms`` (the timing events' elapsed time, or None).  Reading
    waits for the card's timing events."""
    with _lock:
        timed = list(_timed)
        _timed.clear()
        recs = list(_records)
    for rec, start, end in timed:
        end.synchronize()
        rec["device_ms"] = start.elapsed_time(end)
    children: Dict[int, int] = {}
    for r in recs:
        if r["parent"] is not None:
            children[r["parent"]] = children.get(r["parent"], 0) + (
                r["end_ns"] - r["start_ns"])
    out = [dict(r, self_ns=r["end_ns"] - r["start_ns"]
                - children.get(r["id"], 0)) for r in recs]
    out.sort(key=lambda r: r["start_ns"])
    return out


def totals() -> dict:
    """``{"spans": {name: {"count", "seconds"}}, "counts": {name: n}}``
    since the process started or the last :func:`reset`; the kernels'
    counts (:data:`LAUNCHES`) are not among ``counts``."""
    with _lock:
        spans = {k: {"count": c, "seconds": ns / 1e9}
                 for k, (c, ns) in _totals.items()}
        return {"spans": spans,
                "counts": {k: n for k, n in _counts.items()
                           if k not in _LAUNCH_SET}}


def launches() -> Dict[str, int]:
    """Each count of :data:`LAUNCHES`, 0 where none was counted."""
    with _lock:
        return {k: _counts.get(k, 0) for k in LAUNCHES}


def reset_launches() -> None:
    """The counts of :data:`LAUNCHES` to 0."""
    with _lock:
        for k in LAUNCHES:
            _counts.pop(k, None)


def snapshot() -> dict:
    """:func:`totals` with the kernels' counts (:func:`launches`) beside
    them under ``launches``."""
    return dict(totals(), launches=launches())


def reset() -> None:
    """Clear the totals, the counters (the kernels' too) and the
    records."""
    with _lock:
        _totals.clear()
        _counts.clear()
        _records.clear()
        _timed.clear()
        _Session.on = False
