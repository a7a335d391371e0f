"""K1, the NTT (``ops/ntt.py`` -> ``csrc/ntt.cu``): the profiled segment's
device milliseconds per query of ``ntt_kernel``."""

KERNEL = "ntt_kernel"


def read(trace):
    p = trace.get("profile")
    if not p or not p.get("queries"):
        return None
    ms = sum(s for name, (s, _) in p["ops"].items() if KERNEL in name)
    return 1e3 * ms / p["queries"] if ms > 0 else None
