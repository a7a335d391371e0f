"""The one general generator: a traffic mix is a data file
(``traffic/<mix>.json``) that this module reads.

The loop is closed: one query in flight, the next sent when the response
is on the host.  Keys of a mix:

* ``pool``: distinct senders' requests made in set-up and cycled in order;
* ``match_every`` (dense DBs) or ``common_share`` (item DBs): how much of a
  query the receiver's set holds;
* ``check_share``: the share of the window's responses, drawn from the seed,
  that the reference checks (the last one always);
* ``profile_queries``: the queries of a traced run's profiled segment.

A query is ``Receiver.run_query(request)`` and the copy of its result to
host memory, as the serving loop packs it for the wire.
"""

from __future__ import annotations

import gc
import sys
import time
from dataclasses import dataclass, field

import numpy as np

CHECK = 5   # the purpose of the seed's stream, beside inputs.py's


@dataclass
class Window:
    start: float = 0.0
    end: float = 0.0
    latencies: list = field(default_factory=list)   # seconds, each completed query
    done: list = field(default_factory=list)        # seconds from the start, each completion
    attempted: int = 0
    failed: int = 0
    kept: list = field(default_factory=list)        # (ordinal, request index, host result)

    @property
    def seconds(self) -> float:
        return self.end - self.start


class Driver:
    """Sends the pool's requests to ``query`` (a callable: request ->
    host result), numbering every query the receiver answers (its
    ``ordinal``, 0 first, warm-ups included): the receiver draws one mask a
    query, so the ordinal says which mask a response carries."""

    def __init__(self, query, pool: list, traffic: dict, seed: int):
        from harness.inputs import stream

        self.query, self.pool, self.traffic = query, pool, traffic
        self.ordinal = 0
        self._check = stream(seed, CHECK)

    def one(self):
        i = self.ordinal % len(self.pool)
        self.ordinal += 1
        return i, self.query(self.pool[i])

    def warm(self) -> list:
        """Each request of the pool once (the first captures the programs);
        returns their (ordinal, request index, result)."""
        out = []
        for _ in self.pool:
            o = self.ordinal
            i, res = self.one()
            out.append((o, i, res))
        return out

    def window(self, seconds: float) -> Window:
        """Queries back to back for ``seconds``.  What set-up left for the
        collector is collected first and frozen until the window closes, so
        that no collection of it falls in the window."""
        w = Window()
        share = float(self.traffic["check_share"])
        gc.collect()
        gc.freeze()
        w.start = time.perf_counter()
        last = None
        while True:
            sent = time.perf_counter()
            if sent - w.start >= seconds:
                break
            o = self.ordinal
            w.attempted += 1
            try:
                i, res = self.one()
            except Exception as exc:   # a failed query counts, and the run goes on
                w.failed += 1
                print(f"query {o} failed: {exc!r}", file=sys.stderr, flush=True)
                continue
            done = time.perf_counter()
            w.latencies.append(done - sent)
            w.done.append(done - w.start)
            last = (o, i, res)
            if self._check.random() < share:
                w.kept.append(last)
            w.end = done
        gc.unfreeze()
        if last is not None and (not w.kept or w.kept[-1][0] != last[0]):
            w.kept.append(last)
        return w


def p95(values) -> float:
    return float(np.percentile(np.asarray(values), 95))
