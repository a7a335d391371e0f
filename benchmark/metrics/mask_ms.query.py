"""Parties layer (``api/parties.py``): the median host time of
``Receiver._prepare``'s mask draw (``CsRng``), the port's span
``prepare.mask`` (``apsu_tpu_torch/utils/stopwatch.py``), over the records
of the run's queries."""

import statistics


def read(trace):
    from apsu_tpu_torch.utils import stopwatch

    ms = [(end - start) / 1e6
          for name, start, end, _, query, _ in getattr(stopwatch.GLOBAL, "records", ())
          if name == "prepare.mask" and query is not None]
    return statistics.median(ms) if ms else None
