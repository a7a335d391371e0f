"""K3, the matching dot product (``ops/polyeval.py:eval_dot`` ->
``csrc/eval_dot.cu``): its bound (the harness's yardstick, from the DB's
cache shape) over its profiled device time per query, in percent of the
published peak."""

from harness import yardstick

KERNEL = "eval_dot_kernel"


def read(trace):
    p = trace.get("profile")
    if not p or not p.get("queries"):
        return None
    s = sum(v for name, (v, _) in p["ops"].items() if KERNEL in name) / p["queries"]
    if s <= 0:
        return None
    powers, cache = yardstick.dot_shapes(trace["cache_shape"], trace["max_items_per_bin"])
    return yardstick.roofline_pct(yardstick.bound_s(*yardstick.dot_work(powers, cache)), s)
