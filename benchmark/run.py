"""One run of one benchmark cell of the PyTorch and CUDA port.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout.  The cell's configuration, traffic mix and
per-layer metric readers are found by the names in ``BENCHMARK.json``.  The
last line of standard output is the result as one JSON object; the numbers
that decide ``correct`` are also the last lines of standard error.  Without
a CUDA device, or with fewer than the cell asks for, it exits with 2 and
prints no result; with ``jax``, ``jaxlib``, ``flax`` or ``apsu_tpu`` loaded
when the line is due, with 3.
"""

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
# every cache of the run at a fixed path inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ[var] = str(ROOT / ".bench_cache" / sub)
sys.path[:0] = [str(BENCH), str(ROOT)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from harness.spec import load_cell

    cell = load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}", file=sys.stderr)
        return 2
    marks = [("torch", time.perf_counter())]
    from harness.cell import forbidden_modules, run_cell

    line = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda", T_PROCESS, marks)
    found = forbidden_modules()   # the last step before the result is printed
    if found:
        print(f"forbidden modules loaded: {found}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name}: {json.dumps(c)}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
