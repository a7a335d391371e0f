"""The NTT kernel (K1) against the per-call floor (K10) over the reference's
grid of shapes.

The counterpart of the reference's ``tools/ntt4p_gl_ab.py``, over the same
grid: L in {4, 7, 14} 28-bit primes, B in {64, 256} rows, N = 8192.  For each
shape it reports

- K1's forward transform: ms and us a plane, from a CUDA graph of R launches
  (R from ``APSU_NTT_BENCH_REPS``, default 32, as the reference);
- K10 (``add_one``, the trivial kernel ``x + 1``) on the same tensor, graph
  replayed (the device floor of one launch) and launched eagerly between CUDA
  events (host and device together: the per-call floor that a path of many
  small launches pays);
- ``torch.add(x, 1)`` launched eagerly the same way (the per-call floor of
  one PyTorch operation, which most launches of those paths are);
- K1 less K10 a plane; ``bit_identical``, K1 against ``ntt_plain``, and
  ``add_one_identical``, K10 against ``add_one_plain``.

The reference's third arm, the grid-over-L kernel ``ntt4_pallas_gl`` (K6), is
served by K1's kernel in the port, so it is not timed twice.  Rows whose input
and output together fit the card's 50 MB L2 are marked: a replayed launch
finds them there.

    python -m apsu_tpu_torch.tools.ntt4p_gl_ab

runs on the card (``cuda``) and raises without one.  Its last line is
``{"tool": "ntt4p_gl_ab", "reps": R, "rows": [...]}``.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from apsu_tpu_torch.core.mod32 import from_u32
from apsu_tpu_torch.core.nt import gen_ntt_primes
from apsu_tpu_torch.core.ntt import NttContext
from apsu_tpu_torch.device import resolve
from apsu_tpu_torch.ops.ntt import ntt, ntt_plain
from apsu_tpu_torch.ops.roofline import add_one, add_one_plain
from apsu_tpu_torch.tools import cuda_ms, graph_ms

L2_BYTES = 50 * 2**20   # H100 L2 (NVIDIA data sheet)


def measure(device="cuda", Ls=(4, 7, 14), Bs=(64, 256), n: int = 8192) -> dict:
    """One row per (L, B); on the CPU the times are not measured."""
    dev = resolve(device)
    on_card = dev.type == "cuda"
    R = int(os.environ.get("APSU_NTT_BENCH_REPS", 32))
    rows = []
    for L in Ls:
        primes = gen_ntt_primes([28] * L, 2 * n)
        tb = NttContext(primes, n, dev)
        rng = np.random.default_rng(0)
        for B in Bs:
            x = np.empty((B, L, n), np.uint32)
            for j, p in enumerate(primes):
                x[:, j, :] = rng.integers(0, p, size=(B, n))
            xt = from_u32(x, dev)
            planes = B * L
            row = {"L": L, "B": B, "n": n, "planes": planes, "input_mb": xt.numel() * 4 / 1e6,
                   "l2_resident": 2 * xt.numel() * 4 <= L2_BYTES,
                   "bit_identical": bool(torch.equal(ntt(xt, tb), ntt_plain(xt, tb))),
                   "add_one_identical": bool(torch.equal(add_one(xt), add_one_plain(xt))),
                   "gl": "K6 runs on K1's kernel: its time is ntt_ms"}
            if on_card:
                ntt_ms = graph_ms(lambda: ntt(xt, tb), reps=R)
                floor_ms = graph_ms(lambda: add_one(xt), reps=R)
                row.update(ntt_ms=ntt_ms, ntt_us_per_plane=ntt_ms * 1e3 / planes,
                           add_one_graph_ms=floor_ms,
                           add_one_eager_ms=cuda_ms(lambda: add_one(xt), reps=R),
                           torch_add_eager_ms=cuda_ms(lambda: torch.add(xt, 1), reps=R),
                           ntt_less_add_one_us_per_plane=(ntt_ms - floor_ms) * 1e3 / planes)
            else:
                add_one(xt)
                row.update(ntt_ms=None, ntt_us_per_plane=None, add_one_graph_ms=None,
                           add_one_eager_ms=None, torch_add_eager_ms=None,
                           ntt_less_add_one_us_per_plane=None)
            rows.append(row)
            del xt
    return {"tool": "ntt4p_gl_ab", "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
            "reps": R, "rows": rows}


def main() -> int:
    res = measure()
    print(res["device"], flush=True)
    for row in res["rows"]:
        print(row, flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
