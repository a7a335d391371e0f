"""Evaluation (the evaluation program over ``eval_matching_polys`` /
``eval_matching_polys_ps``): the mean of ``run_query(timings=)["eval_s"]``."""


def read(trace):
    w = trace.get("window")
    if not w or not w["eval_s"]:
        return None
    return 1e3 * sum(w["eval_s"]) / len(w["eval_s"])
