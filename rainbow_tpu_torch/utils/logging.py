"""ISO-8601 timestamped logger — the reference's whole logging system
(reference main.py:80-82), plus simple throughput counters."""
from __future__ import annotations

import time
from datetime import datetime


def log(msg: str) -> None:
    print(f"[{datetime.now().strftime('%Y-%m-%dT%H:%M:%S')}] {msg}", flush=True)


class Timer:
    """Accumulates wall-clock per named phase for throughput reporting
    (rebuild of the observability gap noted in SURVEY.md §5)."""

    def __init__(self):
        self.totals: dict[str, float] = {}
        self._start: dict[str, float] = {}

    def start(self, name: str) -> None:
        self._start[name] = time.perf_counter()

    def stop(self, name: str) -> None:
        self.totals[name] = (self.totals.get(name, 0.0)
                             + time.perf_counter() - self._start[name])

    def summary(self) -> str:
        total = sum(self.totals.values()) or 1.0
        parts = [f"{k}={v:.1f}s({100*v/total:.0f}%)"
                 for k, v in sorted(self.totals.items())]
        return " ".join(parts)
