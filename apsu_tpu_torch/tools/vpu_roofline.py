"""Measure the card's own ceilings for the port's primitive operations.

The counterpart of the reference's ``tools/vpu_roofline.py``.  The port's
kernels are u32 integer work (NTT butterflies on Shoup products, the inner
sums and dot product on 32x32->64 products), so whether a kernel is fast is
judged against the larger of two times: its bytes at the card's streaming
rate and its products at the card's rate for that product.  This tool
measures both on the card:

  stream     : 16 chained ``add_one`` launches (K10) between two 1 GiB
               buffers, 2 x 1 GiB a launch, timed with CUDA events around the
               launches alone; in turns with it ``torch.add(x, 1, out=y)``
               timed the same way (the library's rate)
  mul32, mul_wide, mont_mul, shoup_lazy :
               ``vpu_loop`` (K9) on the reference's (8, 512, 128) block, REPS
               dependent products an element, chained ``outer`` times: once
               inside one launch (the rate) and once as a CUDA graph of
               ``outer`` one-round launches (the reference's structure, which
               adds the per-launch gaps)

Each arm's operation count is the number of integer SASS instructions in the
loop body of its kernel, read with ``cuobjdump -sass`` from the built library,
per step; split by pipe, since Hopper issues IMAD on its FMA pipe beside the
integer ALU pipe.  Each arm's bound is the least a step needs, counted by
hand (``MIN_PER_STEP``), on its busier pipe.  A rate above 105% of the
published figure it is compared with (3.35 TB/s; 64 INT32 lanes an SM at
1.98 GHz, per pipe, for the SASS count and for the hand count) raises: it
would mean that a count or the window is wrong.

    python -m apsu_tpu_torch.tools.vpu_roofline

runs on the card (``cuda``) and raises without one.  Its last line is one
JSON object with every rate.
"""

from __future__ import annotations

import json
import re
import subprocess
from pathlib import Path

import numpy as np
import torch

from apsu_tpu_torch.core.mod32 import from_u32
from apsu_tpu_torch.device import resolve
from apsu_tpu_torch.ops import _build
from apsu_tpu_torch.ops.roofline import OPS, REPS, add_one, vpu_loop
from apsu_tpu_torch.tools import graph_ms, window_ms

# H100 SXM published peaks (NVIDIA data sheet; Hopper architecture white
# paper): HBM3 rate, and 132 SMs x 64 INT32 lanes x 1.98 GHz boost
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
LIMIT = 1.05          # a measured rate above this share of its published figure raises
CHAINS = 4            # independent elements a thread of the K9 kernel (csrc/roofline.cu)
STREAM_LAUNCHES = 16
TRIALS = 5            # timed windows per measurement; the best is kept
# the least integer instructions a step of each arm needs on Hopper, by pipe,
# counted by hand (as the reference's ops_per_rep): an arm's bound is its
# busier pipe at one pipe's INT32 rate.  The compiled loop is counted beside
# it (``sass_per_step``) to show where it needs more.
MIN_PER_STEP = {
    "mul32": {"fma_pipe": 1, "alu_pipe": 0},       # IMAD acc*x+1
    "mul_wide": {"fma_pipe": 1, "alu_pipe": 1},    # IMAD.WIDE.U32; LOP3 hi^lo
    # IMAD.WIDE.U32 acc*x, IMAD lo*pni, IMAD.WIDE.U32 m*p+w; t-p and a select
    # (sm_90 does t-p and the select as one VIADDMNMX, and the kernel takes
    # hi(m*p+w) by one IMAD.HI.U32: 3 + 1 compiled; the FMA pipe's 3 sets
    # the bound either way)
    "mont_mul": {"fma_pipe": 3, "alu_pipe": 2},
    "shoup_lazy": {"fma_pipe": 3, "alu_pipe": 0},  # IMAD.HI q, IMAD acc*x, IMAD -q*p
}
_NOT_ALU = {"BRA", "NOP", "EXIT", "BAR", "BSSY", "BSYNC", "WARPSYNC", "RET", "CALL"}


def _loop_counts(sass: str) -> dict:
    """Integer instructions in the body of one kernel's outer loop (the span
    of its widest backward branch), by pipe: IMAD/IMUL issue to the FMA pipe,
    the rest to the integer ALU pipe.  Memory, uniform-datapath and control
    instructions are not counted."""
    insns = [(int(a, 16), op, rest) for a, op, rest in re.findall(
        r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P[T0-9]+\s+)?([A-Z][A-Z0-9_.]*)([^;]*);", sass)]
    loops = []
    for addr, op, rest in insns:
        m = re.search(r"(0x[0-9a-f]+)", rest)
        if op.split(".")[0] == "BRA" and m and int(m[1], 16) < addr:
            loops.append((int(m[1], 16), addr))
    if not loops:
        raise RuntimeError("no backward branch in the kernel's SASS")
    lo, hi = max(loops, key=lambda ab: ab[1] - ab[0])
    fma = alu = 0
    for addr, op, _ in insns:
        base = op.split(".")[0]
        if not lo <= addr <= hi or base in _NOT_ALU or base.startswith(("U", "LD", "ST", "S2")):
            continue
        if base in ("IMAD", "IMUL"):
            fma += 1
        else:
            alu += 1
    return {"fma": fma, "alu": alu}


def sass_per_step(lib=None, names=OPS) -> dict:
    """Per arm: integer SASS instructions a step (REPS * CHAINS steps a loop
    iteration), in all and on the FMA and ALU pipes, of the package's build
    or of another build ``lib`` of a K9 source, whose kernel
    ``vpu_loop_kernel<i>`` runs arm ``names[i]``."""
    cuobjdump = Path(_build._nvcc()).parent / "cuobjdump"
    dump = subprocess.run([str(cuobjdump), "-sass", str(lib or _build.build())],
                          capture_output=True, text=True, check=True).stdout
    out = {}
    for func in re.split(r"\n\s*Function : ", dump)[1:]:
        m = re.search(r"vpu_loop_kernelILi(\d)E", func.split("\n", 1)[0])
        if m and int(m[1]) < len(names):
            c = _loop_counts(func)
            steps = REPS * CHAINS
            name = names[int(m[1])]
            if c["fma"] + c["alu"] < steps:
                raise RuntimeError(f"{name}: {c} instructions for {steps} steps")
            out[name] = {"total": (c["fma"] + c["alu"]) / steps,
                         "fma_pipe": c["fma"] / steps, "alu_pipe": c["alu"] / steps}
    if lib is None and set(out) != set(OPS):
        raise RuntimeError(f"found the loops of {sorted(out)} in the SASS, not of every arm")
    return out


def _best_window_ms(run, trials: int = TRIALS) -> float:
    """Best of ``trials`` windows around ``run()`` (warmed)."""
    run()
    return min(window_ms(run)[1] for _ in range(trials))


def _stream(dev, elems: int) -> dict:
    """K10 and torch.add chained between two buffers of ``elems`` u32; each
    launch reads one buffer and writes the other.  The values are checked
    after the timed windows, outside them."""
    x = from_u32(np.random.default_rng(1).integers(0, 1 << 30, (elems,), np.uint64)
                 .astype(np.uint32), dev)
    y = torch.empty_like(x)
    want = x.to(torch.int64).sum()
    added = 0

    def chain(step):
        nonlocal added
        for i in range(STREAM_LAUNCHES):
            src, dst = (x, y) if i % 2 == 0 else (y, x)
            step(src, dst)
        added += STREAM_LAUNCHES

    kernel = lambda: chain(lambda s, d: add_one(s, out=d))        # noqa: E731
    library = lambda: chain(lambda s, d: torch.add(s, 1, out=d))  # noqa: E731
    res = {"elems": elems, "buffer_bytes": x.numel() * 4, "launches_a_window": STREAM_LAUNCHES,
           "bytes_a_window": STREAM_LAUNCHES * 2 * x.numel() * 4}
    if dev.type == "cuda":
        # in turns (kernel, library, library, kernel, ...), best of each
        kernel()
        library()
        turns = {kernel: [], library: []}
        for trial in range(TRIALS):
            for run in (kernel, library) if trial % 2 == 0 else (library, kernel):
                turns[run].append(window_ms(run)[1])
        res["ms"], res["torch_add_ms"] = min(turns[kernel]), min(turns[library])
        res["bytes_per_s"] = res["bytes_a_window"] / (res["ms"] * 1e-3)
        res["torch_add_bytes_per_s"] = res["bytes_a_window"] / (res["torch_add_ms"] * 1e-3)
    else:
        kernel()
        res.update(ms=None, torch_add_ms=None, bytes_per_s=None, torch_add_bytes_per_s=None)
    # an even number of launches a window leaves every value in x, +1 each;
    # no value reaches 2^32 (they start below 2^30)
    if x.to(torch.int64).sum() != want + added * x.numel():
        raise RuntimeError("the stream's values are wrong after its windows")
    del x, y
    return res


def bound_ms(op: str, steps: int) -> float:
    """Least milliseconds for ``steps`` steps of arm ``op``: its busier pipe's
    instructions (``MIN_PER_STEP``) at one pipe's published INT32 rate."""
    return steps * max(MIN_PER_STEP[op].values()) / INT32_OPS_PER_S * 1e3


def _check_limits(res: dict) -> None:
    s = res["stream"]
    for key in ("bytes_per_s", "torch_add_bytes_per_s"):
        if s[key] > LIMIT * HBM_BYTES_PER_S:
            raise RuntimeError(f"stream {key} {s[key]:.4g} above {LIMIT} x {HBM_BYTES_PER_S:.4g}")
    for arm in res["arms"]:
        if arm["share_of_bound"] > LIMIT:
            raise RuntimeError(f"{arm['arm']}: {arm['ms']:.4g} ms, under {1 / LIMIT:.3g} of its "
                               f"bound {arm['bound_ms']:.4g} ms")
        if arm["busiest_pipe_ops_per_s"] > LIMIT * INT32_OPS_PER_S:
            raise RuntimeError(f"{arm['arm']}: {arm['busiest_pipe_ops_per_s']:.4g} instructions/s "
                               f"on one pipe, above {LIMIT} x {INT32_OPS_PER_S:.4g}")


def measure(device="cuda", shape=(8, 512, 128), outer: int = 256,
            stream_elems: int = 1 << 28) -> dict:
    """Every arm's rate and the streaming rate on ``device``.  On the CPU the
    arms run their plain versions once and no time is reported."""
    dev = resolve(device)
    on_card = dev.type == "cuda"
    x = from_u32(np.random.default_rng(0).integers(1, 1 << 28, shape, np.uint64)
                 .astype(np.uint32), dev)
    n = x.numel()
    sass = sass_per_step() if on_card else {op: None for op in OPS}
    res = {"tool": "vpu_roofline",
           "device": torch.cuda.get_device_name(dev) if on_card else "cpu",
           "shape": list(shape), "reps": REPS, "outer": outer, "chains": CHAINS,
           "published": {"hbm_bytes_per_s": HBM_BYTES_PER_S, "int32_ops_per_s": INT32_OPS_PER_S},
           "arms": []}
    for op in OPS:
        arm = {"arm": op, "steps": n * REPS * outer, "sass_per_step": sass[op],
               "min_per_step": MIN_PER_STEP[op], "bound_ms": bound_ms(op, n * REPS * outer)}
        if on_card:
            ms = _best_window_ms(lambda: vpu_loop(x, op, outer))
            g_ms = graph_ms(lambda: vpu_loop(x, op), reps=outer) * outer
            steps_per_s = arm["steps"] / (ms * 1e-3)
            per = sass[op]
            arm.update(ms=ms, graph_ms=g_ms, share_of_bound=arm["bound_ms"] / ms,
                       steps_per_s=steps_per_s,
                       graph_steps_per_s=arm["steps"] / (g_ms * 1e-3),
                       ops_per_s=steps_per_s * per["total"],
                       busiest_pipe_ops_per_s=steps_per_s * max(per["fma_pipe"], per["alu_pipe"]))
        else:
            vpu_loop(x, op, outer)
            arm.update(ms=None, graph_ms=None, share_of_bound=None, steps_per_s=None,
                       graph_steps_per_s=None,
                       ops_per_s=None, busiest_pipe_ops_per_s=None)
        res["arms"].append(arm)
    del x
    res["stream"] = _stream(dev, stream_elems)
    if on_card:
        _check_limits(res)
    return res


def _g(v) -> str:
    return "not measured" if v is None else f"{v / 1e9:10.2f}"


def _ms(v) -> str:
    return "not measured" if v is None else f"{v:9.4f}"


def main() -> int:
    res = measure()
    print(res["device"], flush=True)
    for a in res["arms"]:
        total = a["sass_per_step"]["total"] if a["sass_per_step"] else None
        print(f"{a['arm']:10s} {_ms(a['ms'])} ms  {_g(a['ops_per_s'])} G op/s  "
              f"({_g(a['steps_per_s'])} G {a['arm']}/s; {total} SASS a step; "
              f"bound {a['bound_ms']:.4f} ms; "
              f"graph of {res['outer']} launches {_ms(a['graph_ms'])} ms)", flush=True)
    s = res["stream"]
    print(f"stream     {_ms(s['ms'])} ms  {_g(s['bytes_per_s'])} GB/s r+w  "
          f"(torch.add {_ms(s['torch_add_ms'])} ms, {_g(s['torch_add_bytes_per_s'])} GB/s)",
          flush=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
