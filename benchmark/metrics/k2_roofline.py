"""K2, the PS inner sums (``ops/polyeval.py:ps_inner`` -> ``csrc/ps_inner.cu``):
its bound (the harness's yardstick, from the DB's cache shape) over its
profiled device time per query, in percent of the published peak."""

from harness import yardstick

KERNEL = "ps_inner_kernel"


def read(trace):
    p = trace.get("profile")
    if not p or not p.get("queries"):
        return None
    s = sum(v for name, (v, _) in p["ops"].items() if KERNEL in name) / p["queries"]
    if s <= 0:
        return None
    low, cache5 = yardstick.ps_shapes(trace["cache_shape"], trace["ps_low_degree"],
                                      trace["max_items_per_bin"])
    return yardstick.roofline_pct(yardstick.bound_s(*yardstick.ps_work(low, cache5)), s)
