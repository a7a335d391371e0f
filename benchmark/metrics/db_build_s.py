"""DB (``db/receiver_db.py``): the seconds of the run's DB builds, the
port's span ``db.build`` (``apsu_tpu_torch/utils/stopwatch.py``), read
from the span's aggregate, which keeps the set-up's records after the ring
has dropped them.  No span synchronises the device: the number is the
host's time in the build, and what the build leaves queued on the card
falls after it."""


def read(trace):
    from apsu_tpu_torch.utils import stopwatch

    stats = getattr(stopwatch.GLOBAL, "stats", None)
    s = stats("db.build") if stats is not None else None
    return s.total if s is not None else None
