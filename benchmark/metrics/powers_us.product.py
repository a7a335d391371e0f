"""Power wavefront (the powers program, ``engine/programs.py`` over
``engine/evaluator.py``): the microseconds of the powers program a
ciphertext product, the mean of ``run_query(timings=)["powers_s"]`` over
the window's queries divided by the products a query.  The port's counter
``powers.products`` (``apsu_tpu_torch/utils/stopwatch.py``) gains each
query's products over every bundle; it is read over the run's queries, the
count of the span ``program.powers``.  Without the counter, or with no
product, it reads nothing."""

COUNTER = "powers.products"


def read(trace):
    from apsu_tpu_torch.utils import stopwatch

    w = trace.get("window")
    sw = stopwatch.GLOBAL
    if not w or not w["powers_s"] or not hasattr(sw, "counts") or not hasattr(sw, "stats"):
        return None
    products = sw.counts().get(COUNTER)
    queries = sw.stats("program.powers")
    if not products or queries is None:
        return None
    mean_s = sum(w["powers_s"]) / len(w["powers_s"])
    return 1e6 * mean_s / (products / queries.count)
