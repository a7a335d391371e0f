"""Parties layer (``api/parties.py``: ``Receiver._prepare``'s validation,
mask draw and uploads, and the response's copy to the host): the mean per
query of its wall time less the in-call ``powers_s`` and ``eval_s``."""


def read(trace):
    w = trace.get("window")
    if not w or not w["powers_s"]:
        return None
    host = [a - b - c for a, b, c in zip(w["wall_s"], w["powers_s"], w["eval_s"])]
    return 1e3 * sum(host) / len(host)
