"""The device: the share of the traced window's wall time in which neither
of a query's two programs ran, from CUDA events recorded before and after
each program call (not the profiler, which slows the host)."""


def read(trace):
    w = trace.get("window")
    if not w or w.get("programs_s") is None or w["seconds"] <= 0:
        return None
    return 100.0 * (1.0 - w["programs_s"] / w["seconds"])
