"""The control of a cell's correctness check, on the chip at the cell's size.

    python3 benchmark/harness/control.py --workload <name> --seconds 2 --seeds S1 S2 S3 ...

For each seed, in one process: a run of the cell (set-up, a window of
``--seconds``), then every checked response held against its own mask (the
sound reading of ``wrong_slots``) and against the next query's mask (the
control, which breaks the configuration's guarantee that each query carries
a fresh mask of its own).  Prints one JSON line a seed and a summary.  The
benchmark's own runs do not run it.
"""

import gc
import json
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent)]


def main(argv=None) -> int:
    import argparse

    import torch

    from harness.cell import forbidden_modules, run_cell
    from harness.spec import load_cell

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("the control runs on a CUDA device", file=sys.stderr)
        return 2
    cell = load_cell(args.workload)
    rows = []
    for seed in args.seeds:
        line = run_cell(cell, seed, args.seconds, False, "cuda", time.perf_counter(),
                        control=True)
        found = forbidden_modules()
        if found:
            print(f"forbidden modules loaded: {found}", file=sys.stderr)
            return 3
        c = line["checks"]
        row = {"seed": seed, "correct": line["correct"], "wrong_slots": c["wrong_slots"]["value"],
               "control_wrong_slots": c["control_wrong_slots"],
               "slots_checked": c["slots_checked"],
               "responses_checked": c["responses_checked"]["value"]}
        print(json.dumps(row), flush=True)
        rows.append(row)
        gc.collect()
        torch.cuda.empty_cache()
    print(json.dumps({"workload": args.workload, "sound_max": max(r["wrong_slots"] for r in rows),
                      "control_min": min(r["control_wrong_slots"] for r in rows),
                      "seeds": len(rows)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
