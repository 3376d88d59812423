"""The port's own spans in a traced window, for the per-layer readers.

While the profiler records, the port keeps a record of each span it opens
(``transfer_em_tpu_torch.telemetry``: name, start and end on the
profiler's host clock, device time where the span times its device work).
The records hold the last profiler session alone, which in a traced run
is the measured window.  A checkout whose port keeps no such records gives
None, and the reader's metric is left out of the line."""

from __future__ import annotations

from typing import Optional


def _records() -> Optional[list]:
    try:
        from transfer_em_tpu_torch import telemetry
    except ImportError:
        return None
    return telemetry.records()


def total_ms(name: str, device: bool = False) -> Optional[float]:
    """Milliseconds of the window's spans called ``name``: on the host
    clock, or with ``device`` their device time; None where the window has
    no such span, or a span has no device time (no card)."""
    recs = _records()
    if not recs:
        return None
    recs = [r for r in recs if r["name"] == name]
    if not recs:
        return None
    if device:
        times = [r["device_ms"] for r in recs]
        return None if None in times else float(sum(times))
    return sum(r["end_ns"] - r["start_ns"] for r in recs) / 1e6


def per(obs: dict, kind: str, unit: str, name: str,
        device: bool = False) -> Optional[float]:
    """:func:`total_ms` of ``name`` over the window's ``unit``s (steps,
    calls) in a cell of ``kind``."""
    if obs.get("kind") != kind or not obs.get(unit):
        return None
    ms = total_ms(name, device)
    return None if ms is None else ms / obs[unit]
