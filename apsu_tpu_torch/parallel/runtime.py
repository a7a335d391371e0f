"""The sharded query runtime (port of ``apsu_tpu/parallel/runtime.py``).

Scales the DB party over a ``Mesh`` (``parallel/mesh.py``) along the
protocol's native work axes, as the reference does over a JAX mesh:

* **Power wavefront.**  Every per-row stage (operand transforms, BEHZ
  products, relinearizations, the final mod-switch + NTT) splits its
  flattened (target × bundle) rows over the mesh: the evaluator's own
  functions with ``mesh=`` (``engine/evaluator._rowmap``).
* **Evaluation.**  The cache [B, C, planes, L, N] flattens to B·C rows on the
  (bundle × cache) axis; shard i owns the contiguous row range
  ``mesh.row_ranges(B·C)[i]`` and evaluates it on its own device with its
  own ``BfvContext`` through the direct path's code: the non-PS dot product
  (kernel 3) by ``eval_matching_polys`` on each rectangular (bundles ×
  caches) block of the range, the PS evaluation (kernel 2) by
  ``ps_eval_rows``.  The results are concatenated in row order on the mesh's
  first device.

Every row's value is the direct path's computation, so responses are
bit-identical to ``Receiver.run_query`` under one mask seed.  Ranges are
near-even and need no padding (the reference pads the rows to a multiple of
the device count with zero caches).  A shard's cache rows are views of the
DB's cache when the shard runs on the DB's device, else copied there once,
at construction.

Not copied from the reference: on a labeled DB ``ShardedReceiver`` raises
``ValueError``; the reference answers without the label results.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch

from apsu_tpu_torch.api.parties import QueryRequest, QueryResponse, Receiver
from apsu_tpu_torch.core.bfv import Ciphertext, RelinKey
from apsu_tpu_torch.db.measured_levels import defer_relin, powers_at_eval
from apsu_tpu_torch.db.receiver_db import ReceiverDB
from apsu_tpu_torch.engine.evaluator import (
    _row_chunk,
    compute_power_tensor,
    compute_ps_power_tensors,
    eval_matching_polys,
    ps_dims,
    ps_eval_rows,
)
from apsu_tpu_torch.engine.powers import PowerSchedule
from apsu_tpu_torch.parallel.mesh import Mesh


def bundle_blocks(r0: int, r1: int, C: int) -> List[Tuple[int, int, int, int]]:
    """Rows [r0, r1) of a (bundle × cache) axis with C caches a bundle as
    rectangular blocks (b0, b1, c0, c1): a head of one partial bundle, the
    whole bundles, a tail of one partial bundle (each where present)."""
    out = []
    while r0 < r1:
        b, c = divmod(r0, C)
        if c or r1 - r0 < C:                       # partial bundle
            c1 = min(C, c + r1 - r0)
            out.append((b, b + 1, c, c1))
            r0 += c1 - c
        else:                                      # whole bundles
            nb = (r1 - r0) // C
            out.append((b, b + nb, 0, C))
            r0 += nb * C
    return out


class ShardedEvaluator:
    """A built ReceiverDB's cache split over a mesh's shards, and the query
    stages that run on it."""

    def __init__(self, db: ReceiverDB, mesh: Mesh):
        if db.label_cache is not None:
            raise ValueError("the sharded runtime does not evaluate label caches; "
                             "query a labeled DB through Receiver")
        self.db = db
        self.mesh = mesh
        self.home = db.bfv.on(mesh.devices[0])     # gathers the results
        B, C = db.coeff_cache.shape[0], db.coeff_cache.shape[1]
        self.B, self.C = B, C
        self.ranges = mesh.row_ranges(B * C)
        consts = db.ps_const_polys if db.ps_const_polys is not None else db.const_slots
        flat_cache = db.coeff_cache.reshape((B * C,) + tuple(db.coeff_cache.shape[2:]))
        flat_consts = consts.reshape((B * C,) + tuple(consts.shape[2:]))
        # per shard: its context, and its cache and constant rows on its device
        self.shards = [
            (db.bfv.on(dev), flat_cache[r0:r1].to(dev), flat_consts[r0:r1].to(dev))
            for dev, (r0, r1) in zip(mesh.devices, self.ranges)
        ]

    def _per_device(self, *xs) -> Dict[torch.device, tuple]:
        """``xs`` on every distinct device of the mesh (moved once each)."""
        return {ctx.device: tuple(x.to(ctx.device) for x in xs) for ctx, _, _ in self.shards}

    def _cts_home(self, source_cts):
        return {s: Ciphertext(self.home.tensor(ct.data), is_ntt=False, level=ct.level)
                for s, ct in source_cts.items()}

    def _rk_home(self, rk: Optional[RelinKey]) -> Optional[RelinKey]:
        return None if rk is None else RelinKey(self.home.tensor(rk.ksk), rk.level)

    # ------------------------------------------------------------------
    # power wavefront: the evaluator's functions with every per-row stage
    # split over the mesh
    # ------------------------------------------------------------------
    def compute_power_tensor(self, source_cts, schedule: PowerSchedule, relin_key,
                             eval_level: int, at_eval: bool = False) -> torch.Tensor:
        """Sharded ``engine.evaluator.compute_power_tensor``."""
        return compute_power_tensor(self.home, self._cts_home(source_cts), schedule,
                                    self._rk_home(relin_key), eval_level, at_eval=at_eval,
                                    mesh=self.mesh)

    def compute_ps_power_tensors(self, source_cts, plan, relin_key, eval_level,
                                 at_eval: bool = False, defer_relin: bool = False):
        """Sharded ``engine.evaluator.compute_ps_power_tensors``."""
        return compute_ps_power_tensors(self.home, self._cts_home(source_cts), plan,
                                        self._rk_home(relin_key), eval_level=eval_level,
                                        at_eval=at_eval, defer_relin=defer_relin,
                                        mesh=self.mesh)

    def _gather(self, parts: list) -> torch.Tensor:
        """Shard results [R_i, ...] in row order -> [B, C, ...] on the mesh's
        first device."""
        parts = [p.to(self.home.device) for p in parts]
        data = parts[0] if len(parts) == 1 else torch.cat(parts)
        return data.reshape((self.B, self.C) + tuple(data.shape[1:]))

    # ------------------------------------------------------------------
    # evaluation, non-PS (kernel 3 a block)
    # ------------------------------------------------------------------
    def eval_query(self, powers_ntt, mask_slots, eval_level: int) -> torch.Tensor:
        """powers_ntt [B, D, 2, Le, N] NTT mont; mask_slots [B, C, N].
        Returns the result ciphertexts [B, C, 2, Le, N] on the mesh's first
        device."""
        C, N = self.C, self.db.coeff_cache.shape[-1]
        mask = self.home.tensor(mask_slots).reshape(self.B * C, N)
        put = self._per_device(powers_ntt, mask)
        parts = []
        for (ctx, cache, consts), (r0, r1) in zip(self.shards, self.ranges):
            powers, mask_d = put[ctx.device]
            for b0, b1, c0, c1 in bundle_blocks(r0, r1, C):
                lo, hi = b0 * C + c0 - r0, (b1 - 1) * C + c1 - r0
                blk = lambda x: x[lo:hi].reshape((b1 - b0, c1 - c0) + tuple(x.shape[1:]))
                res = eval_matching_polys(ctx, powers[b0:b1], blk(cache), blk(consts),
                                          blk(mask_d[r0:r1]), eval_level)
                parts.append(res.data.reshape((-1,) + tuple(res.data.shape[2:])))
        return self._gather(parts)

    # ------------------------------------------------------------------
    # evaluation, Paterson–Stockmeyer (kernel 2 a row chunk)
    # ------------------------------------------------------------------
    def eval_query_ps(self, low_powers_ntt, high_powers_coeff, mask_slots, relin_key: RelinKey,
                      ps_low_degree: int, result_level: int, max_degree: int,
                      eval_level: int) -> torch.Tensor:
        """The PS evaluation of each shard's rows through ``ps_eval_rows``,
        the direct path's row function.  Returns the result ciphertexts
        [B, C, 2, Lr, N] on the mesh's first device."""
        home, lvl, C = self.home, eval_level, self.C
        planes, N = self.db.coeff_cache.shape[2], self.db.coeff_cache.shape[-1]
        low = home.tensor(low_powers_ntt).contiguous()
        nh, ph = ps_dims(low, planes, ps_low_degree, max_degree)
        row_chunk, aligned = _row_chunk(home, lvl, nh, ps_low_degree, self.B, C, planes, N)
        # the per-bundle rhs transform runs once, on the first device
        fbq, fbb = home.premul_sum_rhs(
            Ciphertext(home.tensor(high_powers_coeff), is_ntt=False, level=lvl), nh)
        mask = home.tensor(mask_slots).reshape(self.B * C, N)
        put = self._per_device(low, fbq, fbb, mask, relin_key.ksk)
        parts = []
        for (ctx, cache, consts), (r0, r1) in zip(self.shards, self.ranges):
            if r1 == r0:
                continue
            low_d, fbq_d, fbb_d, mask_d, ksk = put[ctx.device]
            parts.append(ps_eval_rows(
                ctx, r0, r1, C, row_chunk, aligned, low_d, fbq_d, fbb_d, cache, consts,
                mask_d[r0:r1], RelinKey(ksk, relin_key.level), lvl, result_level, nh, ph))
        return self._gather(parts)


class ShardedReceiver(Receiver):
    """The DB party with its whole query sharded over a mesh: the drop-in
    multi-device Receiver (same wire behaviour, bit-identical responses under
    one mask seed).  A labeled DB is refused (``ValueError``)."""

    def __init__(self, params, db: ReceiverDB, mesh: Mesh, rng=None):
        super().__init__(params, db, rng=rng)
        self.evaluator = ShardedEvaluator(db, mesh)

    def run_query(self, req: QueryRequest) -> QueryResponse:
        p = self.params
        cts, rk, mask = self._prepare(req)
        ev = self.evaluator
        if self.plan.uses_ps:
            low_ntt, high_coeff = ev.compute_ps_power_tensors(
                cts, self.plan, rk, self.db.eval_lvl, at_eval=powers_at_eval(p),
                defer_relin=defer_relin(p))
            res = ev.eval_query_ps(low_ntt, high_coeff, mask, rk, p.query_params.ps_low_degree,
                                   self.db.result_lvl, p.table_params.max_items_per_bin,
                                   self.db.eval_lvl)
            return QueryResponse(results=res, eval_level=self.db.result_lvl)
        powers = ev.compute_power_tensor(cts, self.plan.low, rk, self.db.eval_lvl,
                                         at_eval=powers_at_eval(p))
        res = ev.eval_query(powers.movedim(0, 1).contiguous(), mask, self.db.eval_lvl)
        return QueryResponse(results=res, eval_level=self.db.eval_lvl)

