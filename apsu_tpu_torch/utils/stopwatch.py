"""Named-timespan aggregation and the timing report (port of
``apsu_tpu/utils/stopwatch.py``, the C++ reference's Stopwatch)."""

from __future__ import annotations

import threading
import time
from collections import defaultdict
from contextlib import contextmanager
from dataclasses import dataclass
from typing import Dict, List


@dataclass
class _Span:
    count: int = 0
    total: float = 0.0
    vmin: float = float("inf")
    vmax: float = 0.0

    def add(self, dt: float) -> None:
        self.count += 1
        self.total += dt
        self.vmin = min(self.vmin, dt)
        self.vmax = max(self.vmax, dt)


class Stopwatch:
    def __init__(self):
        self._spans: Dict[str, _Span] = defaultdict(_Span)
        self._events: List = []
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    @contextmanager
    def span(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            with self._lock:
                self._spans[name].add(dt)

    def event(self, name: str) -> None:
        """Timepoint breadcrumb (the reference's oc::Timer setTimePoint)."""
        with self._lock:
            self._events.append((name, time.perf_counter() - self._t0))

    def report(self) -> str:
        lines = ["--- timing report ---"]
        with self._lock:
            for name, ts in self._events:
                lines.append(f"  @{ts*1000:10.1f} ms  {name}")
            for name in sorted(self._spans):
                s = self._spans[name]
                lines.append(
                    f"  {name:32s} n={s.count:4d} total={s.total*1000:9.1f} ms "
                    f"avg={s.total/s.count*1000:8.1f} ms "
                    f"min={s.vmin*1000:8.1f} max={s.vmax*1000:8.1f}"
                )
        return "\n".join(lines)


GLOBAL = Stopwatch()
