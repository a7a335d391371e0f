"""BFV/RNS glue (``core/bfv.py``, ``core/rns.py``, ``ops/behz.py`` -> G1-G4,
and the plain PyTorch ops): the profiled segment's device milliseconds per
query of every kernel that is not K1, K2 or K3 (copies and fills of memory
are not kernels and are left out)."""

NOT_GLUE = ("ntt_kernel", "ps_inner_kernel", "eval_dot_kernel")


def read(trace):
    p = trace.get("profile")
    if not p or not p.get("queries"):
        return None
    s = sum(v for name, (v, _) in p["ops"].items()
            if name in p["kernels"] and not any(k in name for k in NOT_GLUE))
    return 1e3 * s / p["queries"] if s > 0 else None
