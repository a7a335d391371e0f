"""Named spans and counters, and the timing report (port of
``apsu_tpu/utils/stopwatch.py``, the C++ reference's Stopwatch).

A span is timed on the host clock (``time.perf_counter_ns``) and kept as one
record in a bounded ring (``Stopwatch.records``, a tuple with the fields of
``RECORD``): its name, start and end, the name of the span it opened in (per
thread), the query it belongs to (``Stopwatch.query``, set by
``Receiver.run_query``) and the bytes it moved, where given.  The aggregate
by name (count, total, min, max; ``report``, ``stats``) and the counters
``<name>.bytes`` are worked out from the ring and from what the ring has
dropped: closing a span only appends its record, and the records that leave
the ring, in batches of ``TRIM``, are folded into the aggregate under a lock.
Counters (``count``) are monotonic totals kept beside the spans.

When a torch profiler is active, a span also opens
``record_function("apsu:" + name)``, so it lands on the profiler's timeline
beside the kernels and copies (a ``user_annotation`` in its chrome trace; an
NVTX range under ``torch.autograd.profiler.emit_nvtx()``).  No span
synchronises the device: a span around work enqueued on a card times the
enqueue, and whatever the host waits for inside it.
"""

from __future__ import annotations

import threading
import time
from collections import defaultdict, deque
from dataclasses import dataclass, replace
from typing import Dict, Optional

import torch
from torch.autograd import _profiler_enabled
from torch.profiler import record_function

RING = 1 << 17   # records kept: a 50 s window of queries, ~13 spans each
TRIM = 1 << 12   # records folded at once when the ring overflows
RECORD = ("name", "start_ns", "end_ns", "parent", "query", "nbytes")
_now = time.perf_counter_ns


@dataclass(slots=True)
class _Span:
    """A span's aggregate, in seconds."""

    count: int = 0
    total: float = 0.0
    vmin: float = float("inf")
    vmax: float = 0.0


def host_bytes(*xs) -> int:
    """The bytes of those of ``xs`` (tensors, arrays or None) that lie in
    host memory."""
    return sum(x.nbytes for x in xs if x is not None
               and not (isinstance(x, torch.Tensor) and x.device.type != "cpu"))


class _Open:
    """One span while it is open (what ``Stopwatch.span`` returns); ``up`` is
    the span it opened in, this thread's innermost open span before it."""

    __slots__ = ("sw", "name", "nbytes", "up", "query", "t0")

    def __init__(self, sw: "Stopwatch", name: str, nbytes: Optional[int]):
        self.sw, self.name, self.nbytes = sw, name, nbytes

    def __enter__(self):
        sw = self.sw
        local = sw._local
        self.up = getattr(local, "top", None)
        local.top = self
        self.query = sw.query
        self.t0 = _now()
        return self

    def __exit__(self, *exc):
        t1 = _now()
        sw, up = self.sw, self.up
        sw._local.top = up
        records = sw.records
        records.append((self.name, self.t0, t1, None if up is None else up.name, self.query,
                        self.nbytes))
        if len(records) > RING + TRIM:
            sw._trim()
        return False


class _Ranged(_Open):
    """A span opened while a torch profiler is active: also the range
    ``apsu:<name>``, around the span's own clock readings."""

    __slots__ = ("range",)

    def __enter__(self):
        self.range = record_function("apsu:" + self.name)
        self.range.__enter__()
        return super().__enter__()

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.range.__exit__(*exc)
        return False


class Stopwatch:
    def __init__(self):
        self.records: deque = deque()      # the last RING to RING + TRIM records
        self.query: Optional[int] = None   # the query the next spans belong to
        self._dropped: Dict[str, _Span] = {}              # the records trimmed,
        self._counts: Dict[str, int] = defaultdict(int)   # their bytes, count()
        self._lock = threading.Lock()
        self._local = threading.local()   # .top: this thread's innermost open span

    def span(self, name: str, nbytes: Optional[int] = None) -> _Open:
        """A context manager timing its block as the span ``name``;
        ``nbytes``, the bytes the block moves, goes into its record and into
        the counter ``<name>.bytes``."""
        if _profiler_enabled():
            return _Ranged(self, name, nbytes)
        return _Open(self, name, nbytes)

    def count(self, name: str, n: int) -> None:
        """Add ``n`` to the counter ``name``."""
        with self._lock:
            self._counts[name] += n

    def _trim(self) -> None:
        with self._lock:
            records = self.records
            _fold(self._dropped, self._counts,
                  [records.popleft() for _ in range(len(records) - RING)])

    def _totals(self):
        """(aggregate by span name, counters): the ring's records folded
        into copies of what was trimmed."""
        with self._lock:
            spans = {k: replace(v) for k, v in self._dropped.items()}
            counts = dict(self._counts)
            ring = list(self.records)
        _fold(spans, counts, ring)
        return spans, counts

    def counts(self) -> Dict[str, int]:
        """Every counter's total."""
        return self._totals()[1]

    def stats(self, name: str) -> Optional[_Span]:
        """The aggregate of the span ``name`` (None if it never closed)."""
        return self._totals()[0].get(name)

    def report(self) -> str:
        spans, counts = self._totals()
        lines = ["--- timing report ---"]
        for name in sorted(spans):
            s = spans[name]
            lines.append(
                f"  {name:32s} n={s.count:4d} total={s.total*1000:9.1f} ms "
                f"avg={s.total/s.count*1000:8.1f} ms "
                f"min={s.vmin*1000:8.1f} max={s.vmax*1000:8.1f}"
            )
        for name in sorted(counts):
            lines.append(f"  {name:32s} {counts[name]}")
        return "\n".join(lines)


def _fold(spans: dict, counts: dict, records: list) -> None:
    """Add ``records`` to an aggregate by span name and to the counters."""
    for name, t0, t1, _, _, nbytes in records:
        dt = (t1 - t0) * 1e-9
        s = spans.get(name)
        if s is None:
            s = spans[name] = _Span()
        s.count += 1
        s.total += dt
        if dt < s.vmin:
            s.vmin = dt
        if dt > s.vmax:
            s.vmax = dt
        if nbytes is not None:
            key = name + ".bytes"
            counts[key] = counts.get(key, 0) + nbytes


GLOBAL = Stopwatch()
