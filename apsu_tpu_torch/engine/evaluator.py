"""The receiver's query: power wavefront and batched evaluation (port of
``apsu_tpu/engine/evaluator.py``).

Non-PS sets: ``compute_power_tensor`` runs the power DAG as a
level-synchronous wavefront of batched BEHZ products and relinearizations,
mod-switches every power to the evaluation level and NTTs it;
``eval_matching_polys`` computes Σ_j x^j ⊙ pt_j per (bundle, cache) row with
kernel 3, leaves the NTT domain and adds Δ·encode(const + mask).  ``eval_matching_polys_labeled`` runs
two such dot products over the one power tensor, the matching cache's and
the label cache's, both through kernel 3, and blinds the label result by
ρ·M(x).

PS sets: ``compute_ps_power_tensors`` runs the low (x^1..x^ℓ) and high
(y^1..y^nh, y = x^(ℓ+1)) power DAGs as ONE merged level-synchronous
wavefront of batched BEHZ products and relinearizations, then mod-switches to
the evaluation level and NTTs the low powers.  ``eval_matching_polys_ps``
computes M(x) = Σ_k y^k·I_k(x) per (bundle, cache) row: the inner sums I_k
(kernel 2), one lazy BEHZ outer sum, one relinearization, a mod-switch to the
result level and the random mask.  Every transform goes through kernel 1.

The reference's defaults are fixed behaviour here: merged wavefront,
deduplicated operand forms, 8 targets per batched multiply, Bsk width 28 and
the hand-written PS inner-sum kernel.

Row parallelism: with ``mesh=`` (``parallel/mesh.py``) every per-row stage of
the power wavefront (operand transforms, BEHZ products, relinearizations, the
final mod-switch + NTT) splits its flattened (group × bundle) rows over the
mesh (``_rowmap``), the counterpart of the reference's ``_make_rowmap``.  The
PS evaluation's rows go through one function, ``ps_eval_rows``, which the
direct path and the sharded one (``parallel/runtime.py``) both call.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

from apsu_tpu_torch.core.bfv import BfvContext, Ciphertext, RelinKey
from apsu_tpu_torch.core.mod32 import add_mod, mont_mul
from apsu_tpu_torch.device import canonical
from apsu_tpu_torch.engine.powers import PowerSchedule, QueryPlan
from apsu_tpu_torch.ops import behz
from apsu_tpu_torch.ops.polyeval import eval_dot, ps_inner

MUL_CHUNK = 8            # targets per batched multiply + relinearize
ROW_BUDGET_BYTES = 40 << 30  # device bytes one eval row chunk may use


def _rk_on(rk: RelinKey, bfv: BfvContext) -> RelinKey:
    """``rk`` with its key on ``bfv``'s device."""
    if rk.ksk.device == canonical(bfv.device):
        return rk
    return RelinKey(rk.ksk.to(bfv.device), rk.level)


def _rowmap(bfv: BfvContext, mesh=None):
    """The row-parallelism hook: ``rowmap(f, *xs)`` applies ``f(ctx, *rows)``
    (batch-agnostic over one leading row axis, computing with the context
    ``ctx``) to tensors whose two leading axes are (group, bundle).  Without
    a mesh it is ``f(bfv, *xs)``.  With one, the flattened rows split into
    the mesh's contiguous row ranges; each range moves to its shard's device
    (a view when it is there already) and runs there with that device's
    context; the results are concatenated in row order on ``bfv``'s device,
    which must be the mesh's first.  Each row's value is the computation
    the direct path makes, so the result is bit-identical (the reference's
    ``_make_rowmap`` likewise repartitions work, never values)."""
    if mesh is None:
        return lambda f, *xs: f(bfv, *xs)
    if canonical(bfv.device) != mesh.devices[0]:
        raise ValueError(f"the context lives on {bfv.device}, the mesh starts at "
                         f"{mesh.devices[0]}")
    ctxs = [bfv.on(d) for d in mesh.devices]

    def rowmap(f, *xs):
        G, Bq = xs[0].shape[0], xs[0].shape[1]
        rows = G * Bq
        flat = [x.reshape((rows,) + tuple(x.shape[2:])) for x in xs]
        parts = []
        for ctx, (r0, r1) in zip(ctxs, mesh.row_ranges(rows)):
            if r1 > r0:
                parts.append(f(ctx, *[x[r0:r1].to(ctx.device) for x in flat]))
        tup = isinstance(parts[0], tuple)
        outs = []
        for k in range(len(parts[0]) if tup else 1):
            ys = [(y[k] if tup else y).to(bfv.device) for y in parts]
            y = ys[0] if len(ys) == 1 else torch.cat(ys)
            outs.append(y.reshape((G, Bq) + tuple(y.shape[1:])))
        return tuple(outs) if tup else outs[0]

    return rowmap


def _run_schedule(
    bfv: BfvContext,
    have: Dict[int, Ciphertext],
    schedule: PowerSchedule,
    relin_key: Optional[RelinKey],
    level: Optional[int] = None,
    defer_terminal: bool = False,
    rowmap=None,
) -> Dict[int, Ciphertext]:
    """Level-synchronous wavefront: each DAG level runs as batched
    multiplies + relinearizations over its (target, a, b) products, chunked
    to ``MUL_CHUNK`` targets.  Each distinct operand is transformed into its
    (q, Bsk) NTT forms once (one stacked transform per level) and reused by
    every product that consumes it.

    ``defer_terminal``: targets no later level consumes stay 3-component;
    the caller mod-switches and relinearizes them at the eval level.
    ``rowmap``: the row-parallelism hook (``_rowmap``) of every per-row
    stage; None runs them directly."""
    k = level if level is not None else bfv.q.k
    rm = rowmap if rowmap is not None else _rowmap(bfv)
    forms: Dict[int, tuple] = {}
    used = {a for lg in schedule.levels for (_, a, _) in lg} | {
        b for lg in schedule.levels for (_, _, b) in lg
    }
    for level_grp in schedule.levels:
        if relin_key is None:
            raise ValueError("power schedule requires relinearization keys")
        new = sorted(
            s
            for s in {a for (_, a, _) in level_grp} | {b for (_, _, b) in level_grp}
            if s not in forms
        )
        if new:
            fq, fb = rm(lambda ctx, x: ctx.operand_forms(x, k),
                        torch.stack([have[s].data for s in new]))
            for i, s in enumerate(new):
                forms[s] = (fq[i], fb[i])
        for c0 in range(0, len(level_grp), MUL_CHUNK):
            group = level_grp[c0: c0 + MUL_CHUNK]
            prod3 = rm(
                lambda ctx, aq, ab, bq, bb: ctx.tensor_scaledown_fused(aq, ab, bq, bb, k),
                torch.stack([forms[a][0] for (_, a, _) in group]),
                torch.stack([forms[a][1] for (_, a, _) in group]),
                torch.stack([forms[b][0] for (_, _, b) in group]),
                torch.stack([forms[b][1] for (_, _, b) in group]),
            )
            defer_idx = [
                i for i, (t, _, _) in enumerate(group) if defer_terminal and t not in used
            ]
            now_idx = [i for i in range(len(group)) if i not in defer_idx]
            if now_idx:
                # a stack of views, not a list index: that would upload the
                # index from the host, which a CUDA graph cannot capture
                sel = (prod3 if len(now_idx) == len(group)
                       else torch.stack([prod3[i] for i in now_idx]))
                rel = rm(lambda ctx, x: ctx.relinearize(
                    Ciphertext(x, is_ntt=False, level=k), _rk_on(relin_key, ctx)).data, sel)
                for j, i in enumerate(now_idx):
                    have[group[i][0]] = Ciphertext(rel[j], is_ntt=False, level=k)
            for i in defer_idx:  # stays 3-component; caller relinearizes
                have[group[i][0]] = Ciphertext(prod3[i], is_ntt=False, level=k)
    return have


def compute_power_tensor(
    bfv: BfvContext,
    source_cts: Dict[int, Ciphertext],
    schedule: PowerSchedule,
    relin_key: Optional[RelinKey],
    eval_level: int,
    at_eval: bool = False,
    mesh=None,
) -> torch.Tensor:
    """Power tensor for the non-PS path: NTT-Montgomery powers x^1..x^D
    [D, B, 2, Le, N] at ``eval_level``.  ``source_cts`` are the fresh query
    ciphertexts (coeff domain, query level) [B, 2, L, N] each; the
    wavefront runs at the query level, or at the evaluation level when
    ``at_eval`` (from the measured-level table).  ``mesh``: split every
    per-row stage over the mesh's shards (``_rowmap``; ``bfv`` lives on the
    mesh's first device); bit-identical to the direct path."""
    src_lvl = next(iter(source_cts.values())).level
    if schedule.levels and relin_key is None:
        raise ValueError("power schedule requires relinearization keys")
    rm = _rowmap(bfv, mesh)
    wf_lvl = eval_level if at_eval else src_lvl
    have = {s: bfv.mod_switch_to(ct, wf_lvl) for s, ct in source_cts.items()}
    have = _run_schedule(bfv, have, schedule, relin_key, level=wf_lvl, rowmap=rm)
    stack = torch.stack([have[p].data for p in range(1, schedule.max_power + 1)])

    def fin(ctx, x):
        switched = ctx.mod_switch_to(Ciphertext(x, is_ntt=False, level=wf_lvl), eval_level)
        return ctx.to_ntt(switched).data

    return rm(fin, stack)


def eval_matching_polys(
    bfv: BfvContext,
    powers_ntt: torch.Tensor,   # [B, D, 2, Le, N] NTT mont: x^1..x^D
    coeff_cache: torch.Tensor,  # [B, C, Dp, Le, N] NTT mont plaintext planes
    const_slots: torch.Tensor,  # [B, C, N] < t: coefficient 0 in the slot domain
    mask_slots: torch.Tensor,   # [B, C, N] < t: random mask r
    eval_level: int,
) -> Ciphertext:
    """result[b, c] = Σ_{j=1..D} x^j[b] ⊙ pt[b, c, j] + Δ·encode(const + mask):
    the dot product (kernel 3) in the NTT domain, INTT to the coefficient
    domain, then the constant and the mask, added in the slot domain before
    encoding.  Returns ciphertexts [B, C, 2, Le, N] in the coefficient
    domain."""
    base = bfv.levels[eval_level]
    cms = add_mod(const_slots, mask_slots, bfv.t)
    acc = base.from_mont(base.ntt.intt(eval_dot(powers_ntt, coeff_cache, base)))
    behz.delta_add(acc[:, :, 0], bfv.encode(cms), bfv.delta[eval_level])   # + round(Q_l·m/t)
    return Ciphertext(acc, is_ntt=False, level=eval_level)


def eval_matching_polys_labeled(
    bfv: BfvContext,
    powers_ntt: torch.Tensor,    # [B, D, 2, Le, N] NTT mont: x^1..x^D
    coeff_cache: torch.Tensor,   # [B, C, Dp, Le, N] matching-poly planes
    const_slots: torch.Tensor,   # [B, C, N] matching constant coefficients
    mask_slots: torch.Tensor,    # [B, C, N] random mask r
    label_cache: torch.Tensor,   # [B, C, Dp, Le, N] label-poly planes
    label0_slots: torch.Tensor,  # [B, C, N] label constant coefficients L_0
    rho_slots: torch.Tensor,     # [B, C, N] label blinding factor ρ
    eval_level: int,
):
    """Labeled evaluation over one shared power tensor, slot-wise:

        result_M = M(x) + Δ·r
        result_L = L(x) + ρ·M(x)

    At a matching slot M(x) = 0, so result_L decrypts to exactly the label
    felt; elsewhere ρ·M(x) blinds L.  The two dot products Σ_j x^j ⊙ plane_j
    (the reference pads the powers with a zero plane 0 and zero planes past
    D, which add nothing) are kernel 3; the matching constant is folded in
    the NTT domain so that the blinding sees the whole M(x).  Returns
    (match_ct, label_ct), each [B, C, 2, Le, N] in the coefficient domain."""
    base = bfv.levels[eval_level]
    p, pni = base.p_d, base.pni_d
    ds = bfv.delta[eval_level]
    acc_m = eval_dot(powers_ntt, coeff_cache, base)   # NTT mont, sans constant
    acc_l = eval_dot(powers_ntt, label_cache, base)
    dm0 = base.ntt.ntt(base.to_mont(bfv._scale_impl(bfv.encode(const_slots), eval_level)))
    behz.add_into(acc_m[:, :, 0], dm0, ds)
    rho_ntt = bfv.lift_plaintext_ntt(bfv.encode(rho_slots), eval_level)
    acc_l = add_mod(acc_l, mont_mul(acc_m, rho_ntt[:, :, None], p, pni), p)

    res_m = base.from_mont(base.ntt.intt(acc_m))
    behz.delta_add(res_m[:, :, 0], bfv.encode(mask_slots), ds)
    res_l = base.from_mont(base.ntt.intt(acc_l))
    behz.delta_add(res_l[:, :, 0], bfv.encode(label0_slots), ds)
    return (Ciphertext(res_m, is_ntt=False, level=eval_level),
            Ciphertext(res_l, is_ntt=False, level=eval_level))


_MERGE_OFF = 1 << 20  # disjoint target namespace for merged high powers


def _merge_schedules(low: PowerSchedule, high: PowerSchedule) -> PowerSchedule:
    """Zip the low/high wavefronts level by level into ONE schedule (high
    targets/operands offset by _MERGE_OFF): the two DAGs are independent, so
    level i of each shares one batched multiply + relinearization."""
    depth = max(len(low.levels), len(high.levels))
    levels = []
    for i in range(depth):
        grp = list(low.levels[i]) if i < len(low.levels) else []
        if i < len(high.levels):
            grp += [
                (t + _MERGE_OFF, a + _MERGE_OFF, b + _MERGE_OFF)
                for (t, a, b) in high.levels[i]
            ]
        levels.append(grp)
    return PowerSchedule(
        sources=low.sources + tuple(s + _MERGE_OFF for s in high.sources),
        max_power=0,  # unused by _run_schedule (targets listed explicitly)
        levels=levels,
    )


def compute_ps_power_tensors(
    bfv: BfvContext,
    source_cts: Dict[int, Ciphertext],
    plan: QueryPlan,
    relin_key: Optional[RelinKey],
    eval_level: Optional[int] = None,
    at_eval: bool = False,
    defer_relin: bool = False,
    mesh=None,
):
    """Power tensors for the PS path.  Returns (low_ntt [B, ℓ, 2, L, N],
    high_coeff [B, nh, 2, L, N]) at the evaluation level, the power axis
    behind the leading batch axis (the reference's ``batch_first=True``):
    x^1..x^ℓ in NTT-Montgomery form for the inner sums, y^1..y^nh in the
    coefficient domain for the outer BEHZ products.  ``at_eval``/
    ``defer_relin`` come from the measured-level table (db/measured_levels).
    ``mesh``: as in ``compute_power_tensor``."""
    lvl = eval_level or bfv.q.k
    src_lvl = next(iter(source_cts.values())).level  # fresh query level
    low_srcs = tuple(sorted(s for s in source_cts if s <= plan.ps_low_degree))
    ph = plan.ps_low_degree + 1
    high_srcs = tuple(sorted(s // ph for s in source_cts if s > plan.ps_low_degree))
    need_rk = bool(plan.low.levels) or bool(plan.high.levels)
    if need_rk and relin_key is None:
        raise ValueError("power schedule requires relinearization keys")
    wf_lvl = lvl if at_eval else src_lvl
    rm = _rowmap(bfv, mesh)

    def src(s):
        return bfv.mod_switch_to(source_cts[s], wf_lvl)

    have = {s: src(s) for s in low_srcs}
    have.update({s + _MERGE_OFF: src(s * ph) for s in high_srcs})
    have = _run_schedule(
        bfv, have, _merge_schedules(plan.low, plan.high), relin_key,
        level=wf_lvl, defer_terminal=defer_relin, rowmap=rm,
    )
    nlow = plan.low.max_power
    items = [have[p] for p in range(1, nlow + 1)] + [
        have[p + _MERGE_OFF] for p in range(1, plan.high.max_power + 1)
    ]
    # 2-component powers switch straight down; deferred 3-component terminal
    # products switch down THEN relinearize once, batched, at the eval level
    i2 = [i for i, c in enumerate(items) if c.size == 2]
    i3 = [i for i, c in enumerate(items) if c.size == 3]

    def switch(ctx, x):
        return ctx.mod_switch_to(Ciphertext(x, is_ntt=False, level=wf_lvl), lvl)

    def stack(idx):
        return torch.stack([items[i].data for i in idx])

    rows = {}
    if i2:
        rows.update(zip(i2, rm(lambda ctx, x: switch(ctx, x).data, stack(i2)).unbind()))
    if i3:
        rows.update(zip(i3, rm(lambda ctx, x: ctx.relinearize(
            switch(ctx, x), _rk_on(relin_key, ctx)).data, stack(i3)).unbind()))
    full = torch.stack([rows[i] for i in range(len(items))])  # back to power order
    low_ntt = rm(lambda ctx, x: ctx.to_ntt(Ciphertext(x, is_ntt=False, level=lvl)).data,
                 full[:nlow])
    high_coeff = full[nlow:]
    return low_ntt.movedim(0, 1).contiguous(), high_coeff.movedim(0, 1).contiguous()


def _row_chunk(bfv, lvl, nh, ell, B, C, planes, N):
    """Rows (bundle, cache) per evaluation chunk, sized from the port's own
    int64 working set: the BEHZ outer sum (~4 live int64 copies across
    q ∪ Bsk), the inner-sum output, and the per-row share of the per-bundle
    operands.  Returns (row_chunk, aligned): aligned chunks cover whole
    bundles, so per-bundle operands broadcast instead of being gathered.
    Chunking changes no bit."""
    q = bfv.levels[lvl]
    Lb = bfv._mul_ctx(lvl, max(1, (nh - 1).bit_length()))["bsk"].k
    rows = B * C
    behz = nh * 3 * (q.k + Lb) * N * 8 * 4
    inner = (planes // (ell + 1)) * 2 * q.k * N * (4 + 8 * 3)
    per_bundle = (nh * 2 * (q.k + Lb) + ell * 2 * q.k) * N * 4
    row_bytes = behz + inner + per_bundle
    row_chunk = int(max(1, min(rows, ROW_BUDGET_BYTES // row_bytes)))
    rc_a = int(max(1, min(rows, ROW_BUDGET_BYTES // (behz + inner + per_bundle // C))))
    rc_a -= rc_a % C
    if rc_a >= C:
        return rc_a, True
    return row_chunk, False


def ps_dims(low_powers_ntt, planes: int, ps_low_degree: int, max_degree: int):
    """(nh, ph) of a PS evaluation, checked against the operands' shapes."""
    ph = ps_low_degree + 1
    nh = max_degree // ph
    assert low_powers_ntt.shape[1] == ps_low_degree
    assert planes >= nh * ph + ps_low_degree + 1, (
        f"coefficient cache has {planes} planes; PS gather needs {nh * ph + ps_low_degree + 1}"
    )
    return nh, ph


def _ps_rows(bfv, cache_r, const_r, mask_r, low_c, fbq_c, fbb_c, cpb, rk, lvl,
             result_level, nh, ph):
    """Result ciphertexts [R, 2, Lr, N] of R rows of the PS evaluation:
    ``cache_r`` [R, planes, L, N], ``const_r`` [R, nh+1, N], ``mask_r``
    [R, N] the rows' own, ``low_c``/``fbq_c``/``fbb_c`` their bundles'
    operands, one for every ``cpb`` rows (bundle-aligned rows when cpb > 1).
    Every tensor lies on ``bfv``'s device."""
    q = bfv.levels[lvl]
    size, planes, N = cache_r.shape[0], cache_r.shape[1], cache_r.shape[-1]
    nseg = planes // ph
    # plane k·ph + i == [k, i] of a [nseg, ph] plane view (strided, no copy)
    cache5 = cache_r[:, : nseg * ph].reshape((size, nseg, ph) + tuple(cache_r.shape[2:]))
    ds = bfv.delta[lvl]
    acc = ps_inner(low_c, cache5, q, cpb)[:, : nh + 1]
    inner = q.from_mont(q.ntt.intt(acc))             # coeff plain
    # + Δ·c (c = const_r [R, nh+1, N]) into component 0, in one pass (G5)
    # that also gives Montgomery Δ·c of planes 1..nh
    dm_mont = behz.delta_add(inner[..., 0, :, :], const_r, ds, mont_skip=1)[1]

    # lazy BEHZ: the lhs's q-NTT form is the inner accumulator itself, with
    # NTT(mont(Δ·c)) added to component 0 in place (acc is read no more),
    # the rhs is pre-transformed
    behz.add_into(acc[:, 1:, 0], q.ntt.ntt(dm_mont), ds)
    fa_q = acc[:, 1:]
    if cpb == 1:
        tot = bfv.multiply_sum_fused(fa_q, inner[:, 1:], fbq_c, fbb_c, lvl, nh)
    else:
        # per-bundle rhs broadcasts against bundle-blocked lhs rows
        nb = size // cpb
        blk = lambda x: x.reshape((nb, cpb) + tuple(x.shape[1:]))
        tot = bfv.multiply_sum_fused(
            blk(fa_q), blk(inner[:, 1:]), fbq_c[:, None], fbb_c[:, None], lvl, nh,
        ).reshape((size, 3, q.k, N))
    behz.add_into(tot[:, :2], inner[:, 0], ds)
    rel = bfv.relinearize(Ciphertext(tot, is_ntt=False, level=lvl), _rk_on(rk, bfv))
    sw = bfv.mod_switch_to(rel, result_level).data    # [R, 2, Lr, N]
    behz.delta_add(sw[:, 0], bfv.encode(mask_r), bfv.delta[result_level])   # + Δ·r
    return sw


def ps_eval_rows(bfv, r0, r1, C, row_chunk, aligned, low_b, fbq, fbb, cache_rows,
                 const_rows, mask_rows, rk, lvl, result_level, nh, ph) -> torch.Tensor:
    """Result ciphertexts [r1 - r0, 2, Lr, N] of the global (bundle × cache)
    rows [r0, r1) of the PS evaluation, on ``bfv``'s device.  ``cache_rows``,
    ``const_rows`` and ``mask_rows`` hold exactly those rows (row 0 is global
    row r0); ``low_b``/``fbq``/``fbb`` are every bundle's operands.  The rows
    go in chunks of the global grid of ``row_chunk`` rows (``_row_chunk``):
    a chunk of whole bundles broadcasts its bundles' operands when
    ``aligned``, any other gathers them row by row.  ``eval_matching_polys_ps``
    calls this on all rows, ``parallel.runtime.ShardedEvaluator`` on each
    shard's; chunking and sharding change no bit."""
    out = []
    for g0 in range(r0 - r0 % row_chunk, r1, row_chunk):
        a, b = max(g0, r0), min(g0 + row_chunk, r1)
        loc = slice(a - r0, b - r0)
        if aligned and a % C == 0 and (b - a) % C == 0:
            b0, b1 = a // C, b // C
            low_c, fbq_c, fbb_c, cpb = low_b[b0:b1], fbq[b0:b1], fbb[b0:b1], C
        else:
            bo = torch.div(torch.arange(a, b, device=low_b.device), C, rounding_mode="floor")
            low_c, fbq_c, fbb_c, cpb = low_b[bo], fbq[bo], fbb[bo], 1
        out.append(_ps_rows(bfv, cache_rows[loc], const_rows[loc], mask_rows[loc], low_c,
                            fbq_c, fbb_c, cpb, rk, lvl, result_level, nh, ph))
    return out[0] if len(out) == 1 else torch.cat(out)


def eval_matching_polys_ps(
    bfv: BfvContext,
    low_powers_ntt: torch.Tensor,    # [B, ℓ, 2, L, N] NTT mont: x^1..x^ℓ
    high_powers_coeff: torch.Tensor,  # [B, nh, 2, L, N] coeff plain: y^1..y^nh
    coeff_cache: torch.Tensor,       # [B, C, planes, L, N] NTT mont plaintexts
    const_polys: torch.Tensor,       # [B, C, nh+1, N] mod-t polys c_{k·ph}
    mask_slots: torch.Tensor,        # [B, C, N] < t: random mask r
    relin_key: RelinKey,
    ps_low_degree: int,
    result_level: int,
    max_degree: int,
    eval_level: Optional[int] = None,
) -> Ciphertext:
    """Paterson–Stockmeyer evaluation M(x) = Σ_k x^{k(ℓ+1)}·I_k(x): inner
    sums as ct⊙pt dot products in the NTT domain, ONE lazy BEHZ outer sum per
    (bundle, cache), one relinearization, mod-switch and mask.  Returns the
    result ciphertexts [B, C, 2, L_result, N] at ``result_level``."""
    lvl = eval_level or bfv.q.k
    B, C, planes = coeff_cache.shape[0], coeff_cache.shape[1], coeff_cache.shape[2]
    N = coeff_cache.shape[-1]
    nh, ph = ps_dims(low_powers_ntt, planes, ps_low_degree, max_degree)
    rows = B * C
    row_chunk, aligned = _row_chunk(bfv, lvl, nh, ps_low_degree, B, C, planes, N)

    # the high powers are per-bundle constants: transform them once per query
    fbq, fbb = bfv.premul_sum_rhs(Ciphertext(high_powers_coeff, is_ntt=False, level=lvl), nh)
    data = ps_eval_rows(
        bfv, 0, rows, C, row_chunk, aligned, low_powers_ntt.contiguous(), fbq, fbb,
        coeff_cache.reshape((rows,) + tuple(coeff_cache.shape[2:])),
        const_polys.reshape((rows,) + tuple(const_polys.shape[2:])),
        mask_slots.reshape(rows, N), relin_key, lvl, result_level, nh, ph)
    rbase = bfv.levels[result_level]
    return Ciphertext(data.reshape(B, C, 2, rbase.k, N), is_ntt=False, level=result_level)

