"""Power wavefront (the powers program over ``engine/evaluator.py``'s
``compute_power_tensor`` / ``compute_ps_power_tensors``): the mean of
``Receiver.run_query(timings=)["powers_s"]``."""


def read(trace):
    w = trace.get("window")
    if not w or not w["powers_s"]:
        return None
    return 1e3 * sum(w["powers_s"]) / len(w["powers_s"])
