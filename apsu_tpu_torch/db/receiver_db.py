"""ReceiverDB — the large-set party's evaluation cache as dense tensors
(port of the unlabeled build and the PS parts of
``apsu_tpu/db/receiver_db.py``).

``set_data`` places every item at each of its ``hash_func_count`` cuckoo
locations (duplicate (item, slot) pairs dropped; within a slot, overflow
beyond ``max_items_per_bin`` spills into the next cache), replaces it by its
slot-bound OPRF value split into ``felts_per_item`` field elements, and
scatters those into the host tensors roots ``[B, C, K, N]`` and per-lane
counts ``[B, C, N]``.  One bundle at a time, the device then builds the
matching polynomials, batch-encodes them and lifts them into the cache
``coeff_cache [B, C, planes, L, N]`` (NTT domain, Montgomery form, planes ≥
K+1 zero-padded to a multiple of 8).  Non-PS sets keep each polynomial's
constant coefficient in the slot domain (``const_slots [B, C, N]``: the
evaluator folds it into the mask); PS sets keep the encoded chunk-constant
polynomials ``ps_const_polys [B, C, nh+1, N]``.  The placement, which
depends on the item hashes alone, is retained, so ``rebind`` serves a fresh
OPRF correlation (a resident server's next KKRT query) by deriving only the
PRF values and the cache again.  ``set_synthetic_dense``
builds the same cache from random full bins, and ``from_arrays`` carries a
reference DB's arrays across.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from apsu_tpu_torch.core.bfv import BfvContext
from apsu_tpu_torch.core.params import PSUParams
from apsu_tpu_torch.db import measured_levels
from apsu_tpu_torch.engine.interpolate import polyn_with_roots
from apsu_tpu_torch.engine.powers import plan_query
from apsu_tpu_torch.hash.encoding import felts_from_items
from apsu_tpu_torch.hash.items import LocFuncs
from apsu_tpu_torch.ops.polyeval import plane_count


@dataclasses.dataclass
class DbStats:
    n_items: int
    n_insertions: int
    n_caches: int             # caches per bundle index (the cache axis C)
    cache_counts: np.ndarray  # [B] caches actually used per bundle index
    max_bin_load: int

    def __eq__(self, other) -> bool:
        if not isinstance(other, DbStats):
            return NotImplemented
        return (
            self.n_items == other.n_items
            and self.n_insertions == other.n_insertions
            and self.n_caches == other.n_caches
            and self.max_bin_load == other.max_bin_load
            and np.array_equal(self.cache_counts, other.cache_counts)
        )


class _Placement(NamedTuple):
    """The OPRF-independent part of a build, in narrow dtypes (~14 bytes a
    placed pair plus the items)."""

    items: np.ndarray         # [n, 2] uint64, a read-only copy of the input
    item_idx: np.ndarray      # [m] int32 row of each placed (item, slot) pair
    slots: np.ndarray         # [m] int32
    cache_idx: np.ndarray     # [m] int32
    depth: np.ndarray         # [m] uint16
    n_caches: int             # the cache axis C
    slot_counts: np.ndarray   # [table_size] pairs per slot


class ReceiverDB:
    def __init__(self, params: PSUParams, oprf=None, bfv: Optional[BfvContext] = None,
                 device="cuda"):
        """``oprf`` (an ``OprfBackend``) is needed by ``set_data`` only."""
        self.params = params
        self.oprf = oprf
        self.bfv = bfv or BfvContext(params.seal_params, device=device)
        self.device = self.bfv.device
        tp = params.table_params
        self.locs = LocFuncs(tp.table_size, tp.hash_func_count)
        self.coeff_cache: Optional[torch.Tensor] = None  # [B, C, planes, L, N] NTT mont
        self.const_slots: Optional[torch.Tensor] = None   # [B, C, N] coeff-0 slots
        self.ps_const_polys: Optional[torch.Tensor] = None
        self.eval_lvl: Optional[int] = None
        self.result_lvl: Optional[int] = None
        self.stats: Optional[DbStats] = None
        self._placement: Optional[_Placement] = None

    @classmethod
    def from_arrays(cls, params: PSUParams, arrays: dict, device="cuda",
                    bfv: Optional[BfvContext] = None) -> "ReceiverDB":
        """A port DB holding a reference DB's state: ``arrays`` carries
        ``coeff_cache`` and ``const_slots`` or ``ps_const_polys`` (numpy
        uint32) and the levels ``eval_lvl``/``result_lvl``."""
        db = cls(params, bfv=bfv, device=device)
        for name in ("coeff_cache", "const_slots", "ps_const_polys"):
            if name in arrays:
                setattr(db, name, db.bfv.tensor(arrays[name]))
        db.eval_lvl = int(arrays["eval_lvl"])
        db.result_lvl = int(arrays["result_lvl"])
        return db

    # ------------------------------------------------------------------
    def set_data(self, items: np.ndarray) -> DbStats:
        """items: [n, 2] uint64 128-bit hashed items.  Builds the cache.

        The OPRF-independent placement (slots, item indices, caches, depths,
        slot loads) is computed first and retained, with a read-only copy of
        ``items``, so that ``rebind`` can serve a fresh OPRF correlation
        without placing the items again; a later change to the caller's array
        cannot reach it."""
        if self.oprf is None:
            raise ValueError("set_data needs an OPRF backend")
        self._placement = self._place(items)
        return self._build_from_placement()

    def _place(self, items: np.ndarray) -> _Placement:
        """Cuckoo locations, duplicate filtering and per-slot ranks: the part
        of the build that depends on the item hashes alone."""
        tp = self.params.table_params
        items = np.array(items, dtype=np.uint64)   # the retained copy
        items.flags.writeable = False
        n = items.shape[0]
        h = tp.hash_func_count
        K = tp.max_items_per_bin

        # 1. all cuckoo locations as (item, slot) pairs; a slot repeated in
        # one item's own row counts once
        locs = self.locs.locations(items)          # [n, h]
        keep2d = np.ones(locs.shape, dtype=bool)
        for j in range(1, h):
            for i in range(j):
                keep2d[:, j] &= locs[:, j] != locs[:, i]
        row_keep = keep2d.reshape(-1)
        item_idx = np.broadcast_to(np.arange(n, dtype=np.int64)[:, None], (n, h)).reshape(-1)
        slots, item_idx = locs.reshape(-1)[row_keep], item_idx[row_keep]

        if len(slots):
            # a duplicate input item hits the same slots: keep its first pair
            r0, r1 = items[item_idx, 0], items[item_idx, 1]
            order0 = np.lexsort((r1, r0, slots))
            sk, s0, s1 = slots[order0], r0[order0], r1[order0]
            dup = (sk[1:] == sk[:-1]) & (s0[1:] == s0[:-1]) & (s1[1:] == s1[:-1])
            keepu = np.empty(len(slots), dtype=bool)
            keepu[order0] = np.concatenate([[True], ~dup])
            slots, item_idx = slots[keepu], item_idx[keepu]

        # 2. per-slot ranks -> (cache, depth)
        order = np.argsort(slots, kind="stable")
        ss = slots[order]
        first = np.searchsorted(ss, ss, side="left")
        ranks = np.empty(len(ss), dtype=np.int64)
        ranks[order] = np.arange(len(ss)) - first
        cache_idx, depth = ranks // K, ranks % K
        C = int(cache_idx.max()) + 1 if len(cache_idx) else 1
        return _Placement(
            items=items, item_idx=item_idx.astype(np.int32), slots=slots.astype(np.int32),
            cache_idx=cache_idx.astype(np.int32), depth=depth.astype(np.uint16), n_caches=C,
            slot_counts=np.bincount(slots, minlength=tp.table_size),
        )

    def _build_from_placement(self) -> DbStats:
        """3. slot-bound OPRF values and felts of the placed pairs under this
        DB's OPRF, then the dense tensors and the device build."""
        pl, p = self._placement, self.params
        slots = pl.slots.astype(np.int64)
        prf = self.oprf.eval(pl.items[pl.item_idx.astype(np.int64)], slots)
        felts = felts_from_items(prf, p.felts_per_item, p.item_bit_count_per_felt)
        return self._finish_build(len(pl.items), slots, felts, pl.cache_idx.astype(np.int64),
                                  pl.depth.astype(np.int64), pl.n_caches, pl.slot_counts)

    @property
    def can_rebind(self) -> bool:
        """True iff this DB retains a placement (built by ``set_data``; a DB
        from ``set_synthetic_dense`` or ``from_arrays`` has none)."""
        return self._placement is not None

    def rebind(self, oprf) -> "ReceiverDB":
        """A new ReceiverDB over the same items under a fresh OPRF
        correlation: only the PRF values, felts, dense tensors and device
        cache are derived again, from the retained placement (which the two
        DBs share, read-only).  This DB is left as it is; a caller that has
        finished with its cache calls ``release_cache`` first, so that the
        card holds one cache at a time."""
        if self._placement is None:
            raise ValueError("no retained placement: rebind needs a DB built by set_data")
        db = ReceiverDB(self.params, oprf, bfv=self.bfv)
        db._placement = self._placement
        db._build_from_placement()
        return db

    def release_cache(self) -> None:
        """Drop the device tensors.  The DB answers no query afterwards; its
        placement stays, so it can still ``rebind``."""
        self.coeff_cache = self.const_slots = self.ps_const_polys = None

    def _finish_build(self, n, slots, felts, cache_idx, depth, C, slot_counts) -> DbStats:
        """Dense host roots/counts tensors, then the device build."""
        p = self.params
        tp = p.table_params
        fpi, K, N, ipb = p.felts_per_item, tp.max_items_per_bin, p.poly_degree, p.items_per_bundle
        B = p.bundle_idx_count

        bundle_idx = slots // ipb
        lane = (slots % ipb) * fpi
        roots = np.zeros((B, C, K, N), dtype=np.uint32)
        counts = np.zeros((B, C, N), dtype=np.int32)
        for f in range(fpi):
            roots[bundle_idx, cache_idx, depth, lane + f] = felts[:, f]
        per_bundle_caches = np.zeros(B, dtype=np.int64)
        sidx = np.arange(tp.table_size)
        sb = sidx // ipb
        sl = (sidx % ipb) * fpi
        for c in range(C):
            cnt_c = np.clip(slot_counts - c * K, 0, K)  # dense rank filling
            for f in range(fpi):
                counts[sb, c, sl + f] = cnt_c
            used = np.bincount(sb[cnt_c > 0], minlength=B) > 0
            per_bundle_caches[used] += 1

        self._build_cache(roots, counts)
        self.stats = DbStats(
            n_items=n,
            n_insertions=len(slots),
            n_caches=C,
            cache_counts=per_bundle_caches,
            max_bin_load=int(slot_counts.max()) if len(slot_counts) else 0,
        )
        if self.stats.max_bin_load > K * C:
            raise ValueError("bin overflow beyond cache capacity")
        return self.stats

    # ------------------------------------------------------------------
    def _build_cache(self, roots: np.ndarray, counts: np.ndarray) -> None:
        """Device build, one bundle at a time: polynomials -> batch encode ->
        lift to NTT mod q.  roots [B, C, K, N] uint32 mod t, counts [B, C, N]
        per-lane bin loads.

        PS sets build at the PS level and keep the encoded chunk-constant
        polynomials c_{k·(ℓ+1)}; non-PS sets build at ``eval_level()``, keep
        each constant coefficient in the slot domain, and answer at that
        level."""
        p = self.params
        B, C, K, N = roots.shape
        ps_low = p.query_params.ps_low_degree
        uses_ps = ps_low > 0
        lvl = self.ps_level() if uses_ps else self.eval_level()
        t = p.seal_params.plain_modulus
        planes = plane_count(K, ps_low)
        if uses_ps:
            ph = ps_low + 1
            const_idx = torch.arange(0, K // ph + 1, device=self.device) * ph
        Lq = self.bfv.levels[lvl].k
        bfv = self.bfv
        cache = torch.empty((B, C, planes, Lq, N), dtype=torch.int32, device=self.device)
        consts, ps_consts = [], []
        for b in range(B):
            coeffs = polyn_with_roots(bfv.tensor(roots[b]), bfv.tensor(counts[b]), t)
            if planes > K + 1:  # zero planes: chunk alignment and in-bounds PS gathers
                pad = torch.zeros((C, planes - (K + 1), N), dtype=coeffs.dtype, device=self.device)
                coeffs = torch.cat([coeffs, pad], dim=-2)
            polys = bfv.encode(coeffs)                                  # [C, planes, N]
            cache[b] = bfv.lift_plaintext_ntt(polys, lvl)               # [C, planes, L, N]
            consts.append(coeffs[..., 0, :])
            if uses_ps:
                ps_consts.append(polys[..., const_idx, :])
        self.coeff_cache = cache
        self.const_slots = torch.stack(consts)
        self.ps_const_polys = torch.stack(ps_consts) if uses_ps else None
        self.eval_lvl = lvl
        self.result_lvl = self.result_level() if uses_ps else lvl

    def set_synthetic_dense(self, rng, n_caches: int = 1) -> np.ndarray:
        """Worst-case synthetic DB: every bin packed to max_items_per_bin with
        random roots (the same draws as the reference).  Returns the roots
        tensor [B, C, K, N] so callers can plant matching query values."""
        p = self.params
        tp = p.table_params
        B, N, K = p.bundle_idx_count, p.poly_degree, tp.max_items_per_bin
        C = n_caches
        t = p.seal_params.plain_modulus
        roots = np.asarray(rng.integers(1, t, size=(B, C, K, N), dtype=np.uint64)).astype(
            np.uint32
        )
        counts = np.full((B, C, N), K, dtype=np.int32)
        self._placement = None   # these roots place no items
        self._build_cache(roots, counts)
        self.stats = DbStats(
            n_items=B * C * K * N,
            n_insertions=B * C * K * N,
            n_caches=C,
            cache_counts=np.full(B, C, dtype=np.int64),
            max_bin_load=K * C,
        )
        return roots

    # ------------------------------------------------------------------
    def eval_level(self, extra_bits: float = 0.0) -> int:
        """Smallest modulus level with room for the matching-poly sum at full
        bin load (see the reference's docstring); a measured override
        (db/measured_levels.py) takes precedence when ``extra_bits`` is 0."""
        if extra_bits == 0.0:
            ov = measured_levels.lookup(self.params)
            if ov and "eval" in ov:
                return min(ov["eval"], len(self.bfv.q_primes))
        p = self.params
        sp = p.seal_params
        t_bits = sp.plain_modulus.bit_length()
        K = p.table_params.max_items_per_bin
        depth = plan_query(p.query_params.query_powers, K, p.query_params.ps_low_degree).low.depth
        need = (
            2 * t_bits + math.log2(p.poly_degree) + math.log2(K + 1) + 4 + 2 * depth + extra_bits
        )
        return self._level_for(need)

    def _level_for(self, need: float) -> int:
        bits = 0
        for lvl, q in enumerate(self.bfv.q_primes, start=1):
            bits += q.bit_length()
            if bits >= need:
                return lvl
        return len(self.bfv.q_primes)

    def ps_level(self) -> int:
        """Evaluation level for the PS path: one multiply's growth
        (~log2(N·t)) above the result level, or the measured override."""
        ov = measured_levels.lookup(self.params)
        if ov and "ps" in ov:
            return min(ov["ps"], len(self.bfv.q_primes))
        t_bits = self.params.seal_params.plain_modulus.bit_length()
        need = self._result_need() + t_bits + math.log2(self.params.poly_degree) / 2 + 12
        return self._level_for(need)

    def _result_need(self) -> float:
        p = self.params
        t_bits = p.seal_params.plain_modulus.bit_length()
        ell = p.query_params.ps_low_degree
        inner_need = (
            2 * t_bits - 1 + 0.5 * (math.log2(p.poly_degree) - 3.58) + math.log2(ell + 1) + 8
        )
        nh = p.table_params.max_items_per_bin // (ell + 1)
        # +22 margin: dense full-degree bins sit ~10 bits above sparse ones
        return inner_need + t_bits + math.log2(p.poly_degree) / 2 + math.log2(nh + 1) + 22

    def result_level(self) -> int:
        """Result-transmission level for the PS path, or the measured override."""
        ov = measured_levels.lookup(self.params)
        if ov and "result" in ov:
            return min(ov["result"], len(self.bfv.q_primes))
        return self._level_for(self._result_need())
