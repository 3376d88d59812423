"""Tile fetching for tiled inference (own copy of ``_parallel_fetch`` from
transfer_em_tpu/data/sources.py:160-195)."""

from __future__ import annotations

import concurrent.futures as cf
from typing import Callable, Iterator, List, Tuple

import numpy as np


def _parallel_fetch(corners: Iterator[Tuple[int, int, int]],
                    fetch: Callable[[Tuple[int, int, int]], np.ndarray],
                    num_threads: int) -> Iterator[np.ndarray]:
    """Map fetch over corners with a sliding window of 2*num_threads
    in-flight requests, preserving order."""
    if num_threads <= 1:
        for c in corners:
            yield fetch(c)
        return
    ex = cf.ThreadPoolExecutor(max_workers=num_threads)
    pending: List[cf.Future] = []
    try:
        try:
            for _ in range(num_threads * 2):
                pending.append(ex.submit(fetch, next(corners)))
        except StopIteration:
            pass
        while pending:
            fut = pending.pop(0)
            try:
                pending.append(ex.submit(fetch, next(corners)))
            except StopIteration:
                pass
            yield fut.result()
        ex.shutdown(wait=True)
    except BaseException:
        # Abandoned mid-iteration (a cancelled request or a fetch error):
        # drop the queued fetches instead of running them, so the caller can
        # release its admission slot at once.
        for f in pending:
            f.cancel()
        ex.shutdown(wait=False, cancel_futures=True)
        raise
