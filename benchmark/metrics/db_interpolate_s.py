"""DB (``db/receiver_db.py``): the seconds of the run's matching
polynomials ∏(x − r), the K-step loop of ``engine/interpolate.py:
polyn_with_roots`` with its inputs' upload, the port's span
``db.interpolate`` (``apsu_tpu_torch/utils/stopwatch.py``), read from the
span's aggregate.  On a card it holds the loop's enqueue and whatever the
upload waits for of the work queued before it."""


def read(trace):
    from apsu_tpu_torch.utils import stopwatch

    stats = getattr(stopwatch.GLOBAL, "stats", None)
    s = stats("db.interpolate") if stats is not None else None
    return s.total if s is not None else None
