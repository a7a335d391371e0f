"""The traced run's instruments, all from the benchmark's own files, around
the calls into the program's layers:

* ``ProgramEvents``: a CUDA event before and after each call of a query's
  two programs (``engine/programs.py``), so the device time of the programs
  is read without a profiler;
* ``host_spans``: ``record_function`` ranges named ``bench:<span>`` around
  the receiver's ``_prepare`` and each program call (the query and the
  response's copy are wrapped by the caller);
* ``profile``: a segment of queries under ``torch.profiler``, reduced from its
  chrome trace to device time by operation name, the device's busy time
  (the union of its operations) and the idle gaps by the host span that was
  open when each began.
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile

import torch

# the functions of engine/programs.py that Receiver.run_query calls: the powers
# program, then the evaluation program
PROGRAMS = {"power_tensor": "powers", "ps_power_tensors": "powers",
            "matching": "eval", "matching_labeled": "eval", "ps_matching": "eval"}


@contextlib.contextmanager
def _patched(owner, name, make):
    saved = getattr(owner, name)
    setattr(owner, name, make(saved))
    try:
        yield
    finally:
        setattr(owner, name, saved)


class ProgramEvents:
    """CUDA event pairs around every program call while active."""

    def __init__(self):
        self.pairs = []     # (span, start event, end event)

    @contextlib.contextmanager
    def active(self):
        from apsu_tpu_torch.engine import programs

        def wrap(span):
            def make(f):
                def run(*a, **k):
                    e0 = torch.cuda.Event(enable_timing=True)
                    e1 = torch.cuda.Event(enable_timing=True)
                    e0.record()
                    out = f(*a, **k)
                    e1.record()
                    self.pairs.append((span, e0, e1))
                    return out
                return run
            return make

        with contextlib.ExitStack() as stack:
            for name, span in PROGRAMS.items():
                stack.enter_context(_patched(programs, name, wrap(span)))
            yield self

    def seconds(self) -> float:
        torch.cuda.synchronize()
        return sum(e0.elapsed_time(e1) for _, e0, e1 in self.pairs) / 1e3


@contextlib.contextmanager
def host_spans(recv):
    """``bench:prepare`` and ``bench:powers`` / ``bench:eval`` ranges while
    active (the caller wraps ``bench:query`` and ``bench:response``)."""
    from apsu_tpu_torch.engine import programs

    def wrap(span):
        def make(f):
            def run(*a, **k):
                with torch.profiler.record_function("bench:" + span):
                    return f(*a, **k)
            return run
        return make

    with contextlib.ExitStack() as stack:
        stack.enter_context(_patched(recv, "_prepare", wrap("prepare")))
        for name, span in PROGRAMS.items():
            stack.enter_context(_patched(programs, name, wrap(span)))
        yield


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _merge(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(events: list) -> dict:
    """From chrome-trace events (µs): device seconds and count by operation
    name, the names that are kernels, the busy seconds and the window's
    seconds (first ``bench:query`` start to last end), and the idle gaps'
    seconds by the innermost ``bench:`` span open when each gap began
    (``between`` when none)."""
    queries = [e for e in events if e.get("name") == "bench:query" and e.get("ph") == "X"]
    if not queries:
        return {}
    w0 = min(e["ts"] for e in queries)
    w1 = max(e["ts"] + e["dur"] for e in queries)
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS
           and e["ts"] < w1 and e["ts"] + e["dur"] > w0]
    ops, kernels = {}, sorted({e["name"] for e in dev if e["cat"] == "kernel"})
    for e in dev:
        d = ops.setdefault(e["name"], [0.0, 0])
        d[0] += e["dur"] / 1e6
        d[1] += 1
    busy = _merge((max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in dev)
    spans = sorted((e["ts"], e["ts"] + e["dur"], e["name"][len("bench:"):]) for e in events
                   if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and str(e.get("name", "")).startswith("bench:"))
    gaps, cursor = {}, w0
    for s, e in busy + [[w1, w1]]:
        if s > cursor:
            open_ = [(b - a, name) for a, b, name in spans if a <= cursor < b and name != "query"]
            label = min(open_)[1] if open_ else "between"
            gaps[label] = gaps.get(label, 0.0) + (s - cursor) / 1e6
        cursor = max(cursor, e)
    return {"ops": ops, "kernels": kernels, "busy_s": sum(e - s for s, e in busy) / 1e6,
            "window_s": (w1 - w0) / 1e6, "idle_gaps": gaps}


def profile(run_queries) -> dict:
    """``run_queries()`` under ``torch.profiler`` (CPU and CUDA activities),
    reduced by ``reduce_trace``; the chrome trace goes to a temporary file
    that is deleted."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run_queries()
        torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    return reduce_trace(events)
