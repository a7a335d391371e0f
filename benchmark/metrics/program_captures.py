"""Programs (``engine/programs.py``): how many programs the run captured
into CUDA graphs, the port's span ``program.capture``
(``apsu_tpu_torch/utils/stopwatch.py``).  A run whose programs keep their
keys captures each of a query's two programs once."""


def read(trace):
    from apsu_tpu_torch.utils import stopwatch

    if not getattr(stopwatch.GLOBAL, "records", None):
        return None
    captures = stopwatch.GLOBAL.stats("program.capture")
    return captures.count if captures is not None else 0
