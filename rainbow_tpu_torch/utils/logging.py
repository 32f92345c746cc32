"""ISO-8601 timestamped logger — the reference's whole logging system
(reference main.py:80-82) — and the port's one span system: seconds per
named phase on the host clock, and the same spans as ``rainbow.<name>``
ranges of a running ``torch.profiler``, on the clock of the device's
kernels, copies and fills."""
from __future__ import annotations

import threading
import time
from datetime import datetime
from typing import Optional

import torch
from torch.autograd import profiler as _autograd_profiler

RANGE_PREFIX = "rainbow."


def log(msg: str) -> None:
    print(f"[{datetime.now().strftime('%Y-%m-%dT%H:%M:%S')}] {msg}", flush=True)


class span:
    """A context manager around one phase. On exit, exceptions included, it
    adds its ``time.perf_counter`` seconds to ``timer.totals[name]`` (no
    timer: nothing). While a profiler is on, it is also the trace's range
    ``rainbow.<name>``; off, that costs one flag read. Its start lives in
    the span itself, so spans may run on any thread at once. It adds no
    synchronisation and no device call."""

    __slots__ = ("name", "timer", "_t0", "_range")

    def __init__(self, name: str, timer: Optional["Timer"] = None):
        self.name, self.timer = name, timer

    def __enter__(self) -> "span":
        self._range = None
        if _autograd_profiler._is_profiler_enabled:
            self._range = torch.profiler.record_function(
                RANGE_PREFIX + self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc) -> bool:
        seconds = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        if self.timer is not None:
            self.timer.add(self.name, seconds)
        return False


class Timer:
    """Wall-clock seconds per named phase, summed over its spans on every
    thread (rebuild of the observability gap noted in SURVEY.md §5). Spans
    nest, so the totals of two keys may overlap."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self._lock = threading.Lock()
        self._made = time.perf_counter()

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.totals[name] = self.totals.get(name, 0.0) + seconds

    def span(self, name: str) -> span:
        return span(name, self)

    def summary(self) -> str:
        """Each key's seconds and its share of the wall time since the
        Timer was made."""
        wall = max(time.perf_counter() - self._made, 1e-9)
        with self._lock:
            items = sorted(self.totals.items())
        return " ".join(f"{k}={v:.1f}s({100 * v / wall:.0f}%)"
                        for k, v in items)
