"""Programs (``engine/programs.py``): the median over the run's queries of
the host time of a query's two programs, the port's spans
``program.powers`` + ``program.eval`` (``apsu_tpu_torch/utils/stopwatch.py``:
the inputs' copy, the replay's launch, the clone).  Queries that captured a
program are left out."""

import statistics

PROGRAMS = ("program.powers", "program.eval")


def read(trace):
    from apsu_tpu_torch.utils import stopwatch

    per_query, captured = {}, set()
    for name, start, end, _, query, _ in getattr(stopwatch.GLOBAL, "records", ()):
        if query is None:
            continue
        if name in PROGRAMS:
            per_query[query] = per_query.get(query, 0) + end - start
        elif name == "program.capture":
            captured.add(query)
    ms = [ns / 1e6 for query, ns in per_query.items() if query not in captured]
    return statistics.median(ms) if ms else None
