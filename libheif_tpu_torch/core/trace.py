"""Named spans over the decode path.

Each span is a ``torch.profiler.record_function`` range, so a profiler
trace shows it.  Inside ``collect()`` every span also ends with a device
synchronisation and adds its wall time to a per-name total, so that a
caller can split one decode by part; outside it a span costs one
``record_function`` range and nothing else.  Spans may nest: a total is
inclusive of the spans inside it.  Spans may run on several threads at
once (the tile parses of a grid): a total is then the sum of their wall
times.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager
from typing import Dict, Iterator, Optional

import torch

_totals: Optional[Dict[str, dict]] = None
_lock = threading.Lock()


def _sync() -> None:
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


@contextmanager
def span(name: str) -> Iterator[None]:
    """A named part of the decode path."""
    with torch.profiler.record_function(name):
        if _totals is None:
            yield
            return
        totals = _totals
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            ms = (time.perf_counter() - t0) * 1e3
            with _lock:
                tot = totals.setdefault(name, {"ms": 0.0, "count": 0})
                tot["ms"] += ms
                tot["count"] += 1


@contextmanager
def collect() -> Iterator[Dict[str, dict]]:
    """Collect the spans run inside: a dict name → {"ms": wall time
    summed over its runs, "count": runs}, filled as they end."""
    global _totals
    prev, _totals = _totals, {}
    try:
        _sync()
        yield _totals
    finally:
        _totals = prev
