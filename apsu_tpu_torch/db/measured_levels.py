"""Measured evaluation-level overrides for specific parameter sets.

The analytic level selectors (``ReceiverDB.eval_level/ps_level/
result_level``) carry safety margins sized for the WORST configuration, so
on well-behaved chains they leave whole unused limbs of headroom — and
every retained limb costs ~1/L of the whole online-phase compute (all NTT
/ BEHZ / relin work is per-limb) plus result bytes on the wire.

This table records LOWER levels that were measured safe on the real chip:
``tools/level_calibrate.py`` re-runs the worst-case dense probe
(engine/probe.py — every bin at max_items_per_bin, production query path)
at candidate levels and only emits an entry when decryption stays exact
with ≥ MIN_BUDGET_BITS of residual invariant-noise budget.  The override
is keyed by the full parameter content (not the file name), so any edit
to a parameter file safely falls back to the analytic levels.

The reference's analogue is SEAL's per-parameter-set chain-index choice
inside eval_patstock (receiver/apsu/bin_bundle.cpp:192-360
operates at a fixed chain depth picked by psu_params.cpp); here the choice
is per-file and measurement-backed.
"""

from __future__ import annotations

import hashlib
import json
from typing import Dict, Optional

MIN_BUDGET_BITS = 6.0  # calibration refuses entries with less residual room


def params_key(params) -> str:
    """Stable content key of a PSUParams (independent of file name)."""
    blob = json.dumps(params.to_dict(), sort_keys=True).encode()
    return hashlib.blake2b(blob, digest_size=8).hexdigest()


# key -> {"ps": int, "result": int, "eval": int} (any subset).  Each entry
# cites the calibration measurement (dense full-bin probe; bit-identical
# CPU/chip since all probe randomness is host-seeded).  The analytic base
# for every entry below was ps=6/result=5 of a 7-limb ≤28-bit chain.
MEASURED: Dict[str, Dict[str, int]] = {
    # 16M-4096 / 16M-4096-32 (identical params): iterative descent accepted
    # ps=4/result=2 with 19.7 bits of residual budget; ps=3 overflowed.
    # query=6 (fresh-encryption level) at 8.0 bits; query=5 overflowed —
    # and likewise for every other 16M entry below (budgets 7.6-13.6).
    # 2026-08-18 calibration, tools/level_calibrate.py.
    "771908e86c261b31": {"ps": 4, "result": 2, "query": 6},
    # 16M-1 / 16M-1-32: ps=4/result=2 at 23.7 bits (ps=3 overflowed)
    "178bf66cb3d99f55": {"ps": 4, "result": 2, "query": 6},
    # 16M-1024: ps=4/result=2 at 20.1 bits (ps=3 overflowed)
    "c9e0dc0738635988": {"ps": 4, "result": 2, "query": 6},
    # 16M-2048: ps=4/result=2 at 19.5 bits (ps=3 overflowed)
    "78d723fcc718d5fc": {"ps": 4, "result": 2, "query": 6},
    # 16M-5535: ps=4/result=2 at 19.6 bits (ps=3 overflowed)
    "b1a406a5ea0d9eea": {"ps": 4, "result": 2, "query": 6},
    # 16M-11041: ps=4/result=2 at 19.8 bits (ps=3 overflowed)
    "7db80464df48a875": {"ps": 4, "result": 2, "query": 6},
    # 256K family, 2026-08-20 calibration (CPU, bit-identical probe).
    # All descents below the recorded points overflowed (budget 0.0);
    # at_eval rejected everywhere; query descent rejected everywhere.
    # 256K-512: eval 3->2 at 8.4 bits
    "9db5e6530137716e": {"eval": 2},
    # 256K-1024: eval 3->2 at 8.7 bits
    "f08dfebe1f2ae777": {"eval": 2},
    # 256K-2048-cmp: eval 3->2 at 9.5 bits
    "eb554f094649de56": {"eval": 2},
    # 256K-2048-com: result 3->2 + defer_relin at 7.2 bits (ps=2 overflowed)
    "37153a726850dcbb": {"ps": 3, "result": 2, "defer_relin": 1},
    # 256K-4096-cmp: eval 3->2 at 6.5 bits
    "6b5c8b48b6acbc27": {"eval": 2},
    # 256K-4096-com: ps 5->4, result 4->2 + defer_relin at 14.8 bits
    "6d33295f8b99ff09": {"ps": 4, "result": 2, "defer_relin": 1},
    # 1M family, 2026-08-20 calibration (same protocol; 1M-1, 1M-256-288,
    # 1M-4096-cmp and 100K-1 held no headroom below their analytic picks)
    # 1M-256: eval 3->2 at 9.5 bits
    "58bad4e04c849f1e": {"eval": 2},
    # 1M-512-cmp: eval 3->2 at 7.9 bits
    "a3659a5de7e36d6e": {"eval": 2},
    # 1M-512-com: result 3->2 + defer_relin at 11.3 bits
    "d1b0c1d8249e7628": {"ps": 3, "result": 2, "defer_relin": 1},
    # 1M-1024-cmp: eval 3->2 at 9.2 bits
    "fe1c3e0f080fdabc": {"eval": 2},
    # 1M-1024-com: result 3->2 + defer_relin at 8.1 bits
    "788b7f6f68bded8c": {"ps": 3, "result": 2, "defer_relin": 1},
    # 1M-2048-cmp: eval 3->2 at 9.5 bits
    "8e2208e16bed876d": {"eval": 2},
    # 1M-2048-com: result 3->2 + defer_relin at 10.6 bits
    "725c14864b698b0b": {"ps": 3, "result": 2, "defer_relin": 1},
    # 1M-4096-com: ps 4->3, result 4->2 at 14.4 bits (defer_relin overflowed)
    "19a0f88441f2d9d9": {"ps": 3, "result": 2},
    # 1M-5535: ps 5->4, result 4->2 + defer_relin at 9.0 bits
    "a196e9452126afbd": {"ps": 4, "result": 2, "defer_relin": 1},
    # 1M-11041: ps 5->4, result 4->2 + defer_relin at 9.2 bits
    "1d8ccda41798fd3a": {"ps": 4, "result": 2, "defer_relin": 1},
    # 256M-4096 (north star), 2026-08-20 partial calibration: first
    # descent step ps 7->6 / result 5->4 ACCEPTED at 18.7 bits (CPU dense
    # probe, 1293 s/probe — the deep-310 DAG makes full descent a
    # multi-hour run; deeper steps not yet measured, so this entry is
    # conservative-but-measured, not the floor)
    "b9e817289e5e4031": {"ps": 6, "result": 4},
    # 256M-2048: same first descent step, 18.9 bits (same caveat)
    "8f0a6dae264347d1": {"ps": 6, "result": 4},
}


def lookup(params) -> Optional[Dict[str, int]]:
    return MEASURED.get(params_key(params))


def powers_at_eval(params) -> bool:
    """Whether the power wavefront runs directly at the evaluation level.

    Default False: sources stay at the fresh-query level through the DAG
    and mod-switch down after (the analytically safe order — the mod-switch
    rounding floor then never passes through a ct×ct).  A measured
    ``at_eval`` entry flips it: every DAG multiply/relinearization then
    runs on eval-level limbs, saving (k_query - k_eval)/k_query of the
    powers phase.  The trade is noise (the switch floor enters BEFORE the
    DAG and is amplified by its depth), so the flag is only recorded when
    tools/level_calibrate.py measured the dense probe exact with margin."""
    ov = lookup(params)
    return bool(ov and ov.get("at_eval"))


def defer_relin(params) -> bool:
    """Whether terminal power-DAG products defer relinearization to the
    eval level (engine/evaluator._run_schedule docstring): the gadget then
    runs on eval-level digit rows/limb columns — at 16M-4096, 46 of 66
    relins shrink from 6x7 to 4x5 digit-NTT planes.  The trade is noise
    (the key-switch additive term enters at the SMALLER modulus, ~q/P
    above the mod-switch floor), so the flag is only recorded after
    tools/level_calibrate.py measured the dense probe exact with margin."""
    ov = lookup(params)
    return bool(ov and ov.get("defer_relin"))


def query_level(params, n_limbs: int) -> int:
    """Fresh-query encryption level: how many chain limbs the sender
    encrypts its query powers (and generates its relin key) at.

    Default: the full chain — the behavior every config is analytically
    safe at.  A measured "query" entry lowers it: upload bytes and every
    power-wavefront op scale linearly in limbs (the relin key roughly
    quadratically), and a SMALLER modulus at the same N is at least as
    secure — only the noise floor binds, which the calibration probe
    measures (the wavefront then runs at this level before switching down
    to the evaluation level)."""
    ov = lookup(params)
    if ov and "query" in ov:
        return max(1, min(ov["query"], n_limbs))
    return n_limbs
