"""Worst-case dense query probe (port of ``apsu_tpu/engine/probe.py``):
build a synthetic DB with every bin packed to ``max_items_per_bin``, run one
real query through the production path of the parameter set (the
Paterson–Stockmeyer evaluation or the plain dot product), and check exact
decryption plus the residual invariant-noise budget.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np

from apsu_tpu_torch.api.parties import _pow_mod
from apsu_tpu_torch.core.bfv import Ciphertext
from apsu_tpu_torch.core.mod32 import to_u32
from apsu_tpu_torch.core.params import PSUParams
from apsu_tpu_torch.db.measured_levels import defer_relin, powers_at_eval, query_level
from apsu_tpu_torch.db.receiver_db import ReceiverDB
from apsu_tpu_torch.engine.evaluator import (
    compute_power_tensor,
    compute_ps_power_tensors,
    eval_matching_polys,
    eval_matching_polys_ps,
)
from apsu_tpu_torch.engine.powers import plan_query


@dataclasses.dataclass
class ProbeResult:
    exact: bool              # every planted match decrypted to the mask
    n_matched: int           # planted matches
    n_wrong: int             # planted matches that decrypted wrong (noise!)
    n_false: int             # non-matches that collided with the mask
    noise_budget_bits: float  # residual invariant-noise budget (min over sample)
    eval_level: int
    result_level: int


def plant_query(roots: np.ndarray, rng, t: int, match_every: int = 4) -> np.ndarray:
    """Query vector [B, N]: a planted root (cache lane % C, depth lane % K)
    on every ``match_every``-th lane, a guaranteed non-root elsewhere."""
    B, C, K, N = roots.shape
    lanes = np.arange(N)
    qvec = np.empty((B, N), dtype=np.uint32)
    is_match = (lanes % match_every) == 0
    for b in range(B):
        qvec[b] = roots[b, lanes % C, lanes % K, lanes]
        for l in np.nonzero(~is_match)[0]:
            v = int(rng.integers(1, t))
            while v in roots[b, :, :, l]:
                v = int(rng.integers(1, t))
            qvec[b, l] = v
    return qvec


def dense_query_probe(
    params: PSUParams,
    rng,
    n_caches: int = 1,
    match_every: int = 4,
    budget_sample: int = 64,
    device="cuda",
) -> ProbeResult:
    """Full-degree probe of one parameter set through the production path.
    Matched lanes MUST decrypt to exactly the mask: a wrong decryption means
    the noise margin of the parameter file is too small."""
    p = params
    t = p.seal_params.plain_modulus
    B, N, K = p.bundle_idx_count, p.poly_degree, p.table_params.max_items_per_bin
    plan = plan_query(p.query_params.query_powers, K, p.query_params.ps_low_degree)

    db = ReceiverDB(p, device=device)
    roots = db.set_synthetic_dense(rng, n_caches=n_caches)  # [B, C, K, N]
    C = n_caches
    bfv = db.bfv
    qvec = plant_query(roots, rng, t, match_every)

    plist = tuple(p.query_params.query_powers)
    stack = np.stack(
        [_pow_mod(qvec.astype(np.uint64), s, t).astype(np.uint32) for s in plist]
    )  # [P, B, N]
    sk = bfv.gen_secret_key(rng)
    ql = query_level(p, len(bfv.q_primes))
    ct = bfv.encrypt_symmetric(bfv.encode(stack), sk, rng, level=ql)
    cts = {s: Ciphertext(ct.data[i], is_ntt=False, level=ql) for i, s in enumerate(plist)}
    rk = bfv.gen_relin_key(sk, rng, level=ql) if bfv.qp is not None else None

    mask = rng.integers(0, t, size=(B, C, N), dtype=np.uint64).astype(np.uint32)
    if plan.uses_ps:
        low_ntt, high_coeff = compute_ps_power_tensors(
            bfv, cts, plan, rk, eval_level=db.eval_lvl,
            at_eval=powers_at_eval(p), defer_relin=defer_relin(p),
        )
        res = eval_matching_polys_ps(
            bfv, low_ntt, high_coeff, db.coeff_cache, db.ps_const_polys,
            bfv.tensor(mask), rk, p.query_params.ps_low_degree, db.result_lvl, K,
            eval_level=db.eval_lvl,
        )
    else:
        powers = compute_power_tensor(
            bfv, cts, plan.low, rk, db.eval_lvl, at_eval=powers_at_eval(p),
        ).movedim(0, 1).contiguous()
        res = eval_matching_polys(bfv, powers, db.coeff_cache, db.const_slots,
                                  bfv.tensor(mask), db.eval_lvl)

    vals = to_u32(bfv.decode(bfv.decrypt_device(res, sk)))
    n_matched = n_wrong = n_false = 0
    for b in range(B):
        for c in range(C):
            lane_match = (roots[b, c] == qvec[b][None, :]).any(axis=0)
            eq = vals[b, c] == mask[b, c]
            n_matched += int(lane_match.sum())
            n_wrong += int((lane_match & ~eq).sum())
            n_false += int((~lane_match & eq).sum())

    budget = _sampled_noise_budget(bfv, res, sk, budget_sample)
    return ProbeResult(
        exact=(n_wrong == 0),
        n_matched=n_matched,
        n_wrong=n_wrong,
        n_false=n_false,
        noise_budget_bits=budget,
        eval_level=db.eval_lvl,
        result_level=db.result_lvl,
    )


def _sampled_noise_budget(bfv, ct: Ciphertext, sk, sample: int) -> float:
    """Invariant-noise budget over a coefficient sample (the full scan is a
    per-coefficient host big-int loop)."""
    x = to_u32(bfv._dot_with_secret(ct, sk))
    base = bfv.levels[ct.level]
    flat = x.reshape(-1, base.k, x.shape[-1])
    idx = np.linspace(0, x.shape[-1] - 1, num=min(sample, x.shape[-1]), dtype=int)
    Ql = base.prod
    max_frac = 0
    for i in range(flat.shape[0]):
        big = base.compose(flat[i][:, idx])
        for v in big.reshape(-1):
            tx = int(v) * bfv.t
            frac = tx - (tx + Ql // 2) // Ql * Ql
            max_frac = max(max_frac, abs(frac))
    if max_frac == 0:
        return float(Ql.bit_length())
    return max(0.0, math.log2(Ql) - 1.0 - math.log2(max_frac))
