"""Power wavefront (the powers program, ``engine/programs.py`` over
``engine/evaluator.py``): the kernels a query's powers program launches,
every kernel node of its CUDA graph, hand-written and PyTorch's alike.  The
port's counter ``program.powers.kernels`` (``apsu_tpu_torch/utils/
stopwatch.py``) gains the graph's nodes at each replay; it is read over the
run's queries, the count of the span ``program.powers``.  Without a graph
(the CPU, or a program with no such counter) it reads nothing."""

COUNTER = "program.powers.kernels"


def read(trace):
    from apsu_tpu_torch.utils import stopwatch

    sw = stopwatch.GLOBAL
    if not hasattr(sw, "counts") or not hasattr(sw, "stats"):
        return None
    kernels = sw.counts().get(COUNTER)
    queries = sw.stats("program.powers")
    if not kernels or queries is None:
        return None
    return kernels / queries.count
