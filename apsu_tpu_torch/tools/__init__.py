"""Measuring tools of the port (the counterparts of the reference's
``tools/vpu_roofline.py`` and ``tools/ntt4p_gl_ab.py``) and the CUDA-event
timers they and ``chip_smoke.py`` share.  Every time is device time on the
card; on the CPU the tools report none."""

from __future__ import annotations

import torch

from apsu_tpu_torch.ops import behz, ntt, polyeval, roofline

# every kernel wrapper's launch count, as (module, name)
_COUNTERS = ((ntt, "launches"), (polyeval, "launches"), (polyeval, "dot_launches"),
             (roofline, "loop_launches"), (roofline, "add_launches"),
             (behz, "lift_launches"), (behz, "mac_launches"), (behz, "scaledown_launches"),
             (behz, "divround_launches"))


def _launch_counts() -> list:
    return [getattr(mod, name) for mod, name in _COUNTERS]


def window_ms(fn):
    """``fn()`` and the milliseconds of one CUDA-event window around it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cuda_ms(fn, reps: int = 5) -> float:
    """Mean milliseconds of ``fn()`` over ``reps`` eager calls (warmed), from
    CUDA events around the calls: host launch cost and device time together,
    whichever is longer."""
    fn()

    def run():
        for _ in range(reps):
            fn()

    return window_ms(run)[1] / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Mean device milliseconds of ``fn()`` replayed from a CUDA graph of
    ``reps`` calls: the launches run back to back with no host gaps, so a
    kernel shorter than the host's launch overhead is timed too.

    The wrappers count no launch while the graph is captured; each replay
    adds ``reps`` times the launches of one eager call of ``fn`` to their
    counts, since that is what runs."""
    fn()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    before = _launch_counts()
    with torch.cuda.stream(side):
        fn()
    per_call = [a - b for a, b in zip(_launch_counts(), before)]
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    ms = window_ms(graph.replay)[1]
    del graph
    for (mod, name), n in zip(_COUNTERS, per_call):   # two replays
        setattr(mod, name, getattr(mod, name) + 2 * n * reps)
    return ms / reps
