"""One run of one cell: set-up, the measured window, the check, the line.

With ``--trace 0`` the line carries the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read from a window in which every query
passes ``timings=`` and its programs are bracketed by CUDA events, then a
profiled segment of ``profile_queries`` queries.
"""

from __future__ import annotations

import gc
import sys
import time

import numpy as np
import torch

from harness import check, inputs, trace, traffic

# top-level module names that may not be loaded in a run, compared whole
FORBIDDEN = ("jax", "jaxlib", "flax", "apsu_tpu")


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _query_fn(recv, timings_log=None, spans=False):
    """The query as the serving loop runs it: ``run_query`` and the result's
    copy to host memory."""
    from apsu_tpu_torch.core.mod32 import to_u32

    def plain(req):
        return to_u32(recv.run_query(req).results)

    def timed(req):
        t0 = time.perf_counter()
        tm = {}
        res = to_u32(recv.run_query(req, timings=tm).results)
        timings_log.append((time.perf_counter() - t0, tm["powers_s"], tm["eval_s"]))
        return res

    def spanned(req):
        rf = torch.profiler.record_function
        with rf("bench:query"):
            resp = recv.run_query(req)
            with rf("bench:response"):
                return to_u32(resp.results)

    return spanned if spans else (timed if timings_log is not None else plain)


def _profiled(driver, recv, n: int, kept: list) -> dict:
    """``n`` more queries under the profiler and the host spans, their
    responses added to ``kept``; the reduced trace."""
    driver.query = _query_fn(recv, spans=True)

    def segment():
        for _ in range(n):
            o = driver.ordinal
            kept.append((o, *driver.one()))

    with trace.host_spans(recv):
        prof = trace.profile(segment)
    prof["queries"] = n
    return prof


def _metric(value, unit):
    return {"value": value, "unit": unit}


def run_cell(cell, seed: int, seconds: float, traced: bool, device, t_process: float,
             marks=None, control: bool = False) -> dict:
    """One run of ``cell`` on ``device`` (a CUDA device in a benchmark run;
    the CPU in the harness's own tests).  ``t_process`` is the
    ``perf_counter`` reading at process start; ``marks`` the set-up phases
    the caller timed before, as (phase, reading at its end).  ``control``
    adds the control's reading (``control.py``; the benchmark's runs never
    do).  Returns the result line; the caller checks ``sys.modules`` before
    it prints it."""
    from apsu_tpu_torch.api.parties import Receiver
    from apsu_tpu_torch.mpc.prg import CsRng

    cuda = torch.device(device).type == "cuda"
    cfg, mix = cell.config, cell.traffic
    marks = list(marks or []) + [("imports", time.perf_counter())]
    params, db, pool, inp = inputs.make(cfg, mix, seed, device, marks)
    cache_shape = list(db.coeff_cache.shape)
    _check_shape(cfg, cache_shape)
    recv = Receiver(params, db, rng=CsRng(inp.mask_key))

    timings_log = [] if traced else None
    driver = traffic.Driver(_query_fn(recv, timings_log), pool, mix, seed)
    kept = driver.warm()
    if timings_log is not None:
        timings_log.clear()
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_process
    marks.append(("warm", t_process + setup_s))
    prev = t_process
    for name, t in marks:   # set-up by phase, before the checks' lines
        print(f"setup {name}: {t - prev:.3f} s", file=sys.stderr)
        prev = t

    events = trace.ProgramEvents()
    if traced and cuda:
        with events.active():
            window = driver.window(seconds)
    else:
        window = driver.window(seconds)
    kept += window.kept
    per_second = np.bincount(np.asarray(window.done, dtype=int))
    print(f"window: queries completed in each second {per_second.tolist()}", file=sys.stderr)

    prof = _profiled(driver, recv, int(mix["profile_queries"]), kept) if traced and cuda else None
    memory_peak = torch.cuda.max_memory_allocated() if cuda else 0
    programs_s = events.seconds() if (traced and cuda) else None

    del recv, db, driver, pool
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t_ref = time.perf_counter()
    checks = check.wrong_slots(cfg, params, inp, kept, device)
    print(f"reference check: {time.perf_counter() - t_ref:.3f} s over "
          f"{checks['responses_checked']} responses", file=sys.stderr)
    correct = (checks["wrong_slots"] == 0 and checks["responses_checked"] > 0
               and window.failed == 0)

    if traced:
        tr = {"cache_shape": cache_shape, "ps_low_degree": params.query_params.ps_low_degree,
              "max_items_per_bin": params.table_params.max_items_per_bin,
              "window": {"queries": len(timings_log), "seconds": window.seconds,
                         "wall_s": [a for a, _, _ in timings_log],
                         "powers_s": [b for _, b, _ in timings_log],
                         "eval_s": [c for _, _, c in timings_log],
                         "programs_s": programs_s},
              "profile": prof}
        metrics = {}
        for m in cell.per_layer:
            v = cell.readers[m["name"]](tr)
            if v is not None:
                metrics[m["name"]] = _metric(v, m["unit"])
    else:
        e2e = {"queries_per_s": len(window.latencies) / window.seconds,
               "query_ms.p95": 1e3 * traffic.p95(window.latencies),
               "setup_s": setup_s}
        metrics = {m["name"]: _metric(e2e[m["name"]], m["unit"]) for m in cell.end_to_end}

    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.chips if cuda else 0, "memory_peak_bytes": memory_peak}
    line = {"correct": correct, "attempted": window.attempted, "failed": window.failed,
            "metrics": metrics, "device": dev}
    if prof:
        dev["busy_s"], dev["window_s"] = prof["busy_s"], prof["window_s"]
        top = sorted(prof["ops"].items(), key=lambda kv: -kv[1][0])[:10]
        gaps = sorted(prof["idle_gaps"].items(), key=lambda kv: -kv[1])[:10]
        line["breakdown"] = {"device_ops": [[k[:120], v[0]] for k, v in top],
                             "idle_gaps": [[k, v] for k, v in gaps]}
    line["checks"] = {"wrong_slots": {"value": checks["wrong_slots"], "limit": 0},
                      "responses_checked": {"value": checks["responses_checked"], "least": 1},
                      "failed_queries": {"value": window.failed, "limit": 0}}
    if control:
        line["checks"]["control_wrong_slots"] = check.wrong_slots(
            cfg, params, inp, kept, device, control=True)["wrong_slots"]
        line["checks"]["slots_checked"] = checks["slots_checked"]
    return line


def _check_shape(cfg: dict, shape: list) -> None:
    """The DB must have the configuration's cache shape; an item DB's cache
    count follows its fullest bin and may differ."""
    want = cfg["cache_shape"]
    free = {1} if cfg["db"]["kind"] == "items" else set()
    if any(a != b for k, (a, b) in enumerate(zip(shape, want)) if k not in free):
        raise SystemExit(f"cache shape {shape} differs from the configuration's {want}")
