"""Measuring tools of the port (the counterparts of the reference's
``tools/vpu_roofline.py`` and ``tools/ntt4p_gl_ab.py``) and the CUDA-event
timers they and ``chip_smoke.py`` share.  Every time is device time on the
card; on the CPU the tools report none."""

from __future__ import annotations

import torch

from apsu_tpu_torch.ops import counts


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
    adds the hand-written kernels the graph holds to their counts
    (``ops/counts.capture``)."""
    fn()
    graph, _, per_replay = counts.capture(fn, reps)
    graph.replay()
    ms = window_ms(graph.replay)[1]
    del graph
    counts.add(per_replay, 2)   # two replays
    return ms / reps
