"""Serving loop: the median host time of the response's copy to host
memory (``core/mod32.py:to_u32``, as the serving loop packs a response), the
port's span ``to_host`` (``apsu_tpu_torch/utils/stopwatch.py``), over the
records of the run's queries.  It includes whatever the copy waits for on
the card."""

import statistics


def read(trace):
    from apsu_tpu_torch.utils import stopwatch

    ms = [(end - start) / 1e6
          for name, start, end, _, query, _ in getattr(stopwatch.GLOBAL, "records", ())
          if name == "to_host" and query is not None]
    return statistics.median(ms) if ms else None
