"""ReceiverDB — the large-set party's evaluation cache as dense tensors (port
of ``apsu_tpu/db/receiver_db.py``).

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
polynomials ``ps_const_polys [B, C, nh+1, N]``.

* **Partitions.** ``bundle_range=(b0, b1)`` holds bundle indices [b0, b1)
  only, ``cache_range=(c0, c1)`` caches [c0, c1) of those (build-once: a
  bin's overflow spills across cache ranges).  ``place_data`` computes the
  placement alone, and ``build_partition`` materializes one cache range from
  it.
* **Rebinding.** The placement depends on the item hashes alone and is
  retained, so ``rebind`` serves a fresh OPRF correlation (a resident
  server's next KKRT query) by deriving only the PRF values and the cache.
* **Mutation.** The host roots and counts stay after the build:
  ``has_item``, ``insert_or_assign`` and ``remove`` update them and rebuild
  the touched bundles into the resident cache.  ``strip`` drops them.
* **Labels.** ``set_data(..., labels=...)`` (non-PS sets) also interpolates
  per-bin label polynomials L with L(item felt) = label felt into
  ``label_cache``, shaped like ``coeff_cache``, plus their constants
  ``label0_slots``.  A labeled DB refuses ``insert_or_assign``: the label
  polynomials are built once.
* **Checkpoints.** ``save``/``load`` use the reference's layout (uint32
  ``.npy`` arrays, ``params.json``, ``meta.json``, the KKRT sender state), so
  a DB saved by either package loads in the other.
* **Programs.** A query's CUDA graphs read the cache by address
  (``engine/programs.py``): the builds, ``strip``, ``rebind`` and
  ``release_cache`` (so an insert that grows the cache axis) drop the
  context's programs first.  A mutation rebuilt in place keeps them: every
  address stays.

* **Spans** (``utils/stopwatch.py:GLOBAL``). Each build (``set_data``,
  ``set_synthetic_dense``, ``build_partition``, ``rebind``, the rebuild of
  ``insert_or_assign``) is the span ``db.build``, with the counters
  ``db.build.items`` (items given) and ``db.build.bytes`` (the DB's device
  bytes after it).  Inside it: ``db.place`` (locations, deduplication, the
  placement into bins), ``db.oprf`` (``oprf.eval``), ``db.interpolate``
  (each ``polyn_with_roots`` call with its inputs' upload) and
  ``db.encode`` (each ``_encode_lift_into``).  No span synchronises the
  device: on a card a span times the enqueue and whatever the host waits
  for inside it.

``set_synthetic_dense`` builds the cache from random full bins, and
``from_arrays`` carries a reference DB's arrays across.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import math
import os
from typing import NamedTuple, Optional

import numpy as np
import torch

from apsu_tpu_torch.core.bfv import BfvContext
from apsu_tpu_torch.core.params import PSUParams
from apsu_tpu_torch.db import measured_levels
from apsu_tpu_torch.engine import programs
from apsu_tpu_torch.engine.interpolate import newton_interpolate, polyn_with_roots
from apsu_tpu_torch.engine.powers import plan_query
from apsu_tpu_torch.hash.encoding import felts_from_items
from apsu_tpu_torch.hash.items import LocFuncs
from apsu_tpu_torch.ops.polyeval import plane_count
from apsu_tpu_torch.utils.stopwatch import GLOBAL

_log = logging.getLogger("apsu_tpu_torch")

# (slot, felts) pairs a bin lookup compares at once: bounds its
# [pairs, C, K, fpi] temporaries (the result does not depend on it)
FIND_CHUNK = 4096
# A bundle's device build runs a group of caches at a time, so that its
# int64 temporaries stay well below the cache it fills (a whole 1M-2048-com
# bundle at once peaked 0.75 GB above a 0.31 GB cache on the card, 0.41 GB
# with only its NTT lift grouped): a group's int64 coefficient rows take at
# most 1/BUILD_SHARE of the whole cache's bytes (more groups cost launches:
# a 16M-4096 build took 4.8 s longer with six groups a bundle than with
# one), and its lift at most LIFT_CHUNK_BYTES of output at once (the lift's
# temporaries take ~12x its output).  The result does not depend on either.
BUILD_SHARE = 8
LIFT_CHUNK_BYTES = 16 << 20


def _place_labeled(slots: np.ndarray, felts: np.ndarray, K: int) -> tuple:
    """Collision-aware (cache, depth) assignment for labeled bins.

    Round c selects, among still-unplaced items, those that are the first
    remaining occurrence of their felt value in every column of their slot
    (so x-values are distinct per (slot, cache) interpolation lane), capped
    at K per slot; selected items take cache c at their within-slot rank.
    The first remaining item of a slot is always selected, so the loop ends
    in at most max-bin-total rounds."""
    m = len(slots)
    cache_idx = np.zeros(m, dtype=np.int64)
    depth = np.zeros(m, dtype=np.int64)
    if m == 0:
        return cache_idx, depth
    fpi = felts.shape[1]
    keys = slots.astype(np.int64)[:, None] << 32 | felts.astype(np.int64)
    remaining = np.arange(m)
    c = 0
    while len(remaining):
        ok = np.ones(len(remaining), dtype=bool)
        for f in range(fpi):
            key = keys[remaining, f]
            order = np.argsort(key, kind="stable")
            ks = key[order]
            first = np.empty(len(remaining), dtype=bool)
            first[order] = np.concatenate([[True], ks[1:] != ks[:-1]])
            ok &= first
        sel = remaining[ok]
        # within-slot rank (a stable slot sort keeps the input order)
        so = np.argsort(slots[sel], kind="stable")
        ss = slots[sel][so]
        first_pos = np.searchsorted(ss, ss, side="left")
        rank = np.arange(len(ss)) - first_pos
        keep = rank < K
        chosen = sel[so][keep]
        cache_idx[chosen] = c
        depth[chosen] = rank[keep]
        mask = np.ones(len(remaining), dtype=bool)
        mask[np.searchsorted(remaining, chosen)] = False
        remaining = remaining[mask]
        c += 1
    return cache_idx, depth


def _dedup_pairs(slots: np.ndarray, r0: np.ndarray, r1: np.ndarray) -> np.ndarray:
    """Keep-mask of the first of each equal (slot, item) pair."""
    order0 = np.lexsort((r1, r0, slots))
    sk, s0, s1 = slots[order0], r0[order0], r1[order0]
    dup = (sk[1:] == sk[:-1]) & (s0[1:] == s0[:-1]) & (s1[1:] == s1[:-1])
    keep = np.empty(len(slots), dtype=bool)
    keep[order0] = np.concatenate([[True], ~dup])
    return keep


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
    """The OPRF-independent part of a build over the full cache axis, in
    narrow dtypes (~14 bytes a placed pair plus the items)."""

    items: np.ndarray         # [n, 2] uint64, a read-only copy of the input
    item_idx: np.ndarray      # [m] int32 row of each placed (item, slot) pair
    slots: np.ndarray         # [m] int32
    cache_idx: np.ndarray     # [m] int32
    depth: np.ndarray         # [m] uint16
    n_caches: int             # the cache axis C
    slot_counts: np.ndarray   # [slots of the bundle range] pairs per slot


class ReceiverDB:
    def __init__(self, params: PSUParams, oprf=None, bfv: Optional[BfvContext] = None,
                 loc_seed: bytes = b"apsu-loc", bundle_range: Optional[tuple] = None,
                 cache_range: Optional[tuple] = None, device="cuda"):
        """``oprf`` (an ``OprfBackend``) is needed by the builds and the
        mutations.  ``bundle_range=(b0, b1)``: hold bundle indices [b0, b1)
        only (one host's partition; tensors then have B = b1 − b0).
        ``cache_range=(c0, c1)``: hold caches [c0, c1) of those bundles
        only; such a DB is build-once."""
        self.params = params
        self.oprf = oprf
        self.bfv = bfv or BfvContext(params.seal_params, device=device)
        self.device = self.bfv.device
        tp = params.table_params
        self.bundle_range = (
            tuple(int(x) for x in bundle_range) if bundle_range is not None
            else (0, params.bundle_idx_count)
        )
        self.cache_range = tuple(int(x) for x in cache_range) if cache_range is not None else None
        self._loc_seed = loc_seed  # forwarded by rebind and build_partition
        self.locs = LocFuncs(tp.table_size, tp.hash_func_count, loc_seed)
        self.coeff_cache: Optional[torch.Tensor] = None  # [B, C, planes, L, N] NTT mont
        self.const_slots: Optional[torch.Tensor] = None   # [B, C, N] coeff-0 slots
        self.ps_const_polys: Optional[torch.Tensor] = None
        self.label_cache: Optional[torch.Tensor] = None   # [B, C, planes, L, N], labeled only
        self.label0_slots: Optional[torch.Tensor] = None  # [B, C, N] label constants L_0
        self.eval_lvl: Optional[int] = None
        self.result_lvl: Optional[int] = None
        self.stats: Optional[DbStats] = None
        # the mutation state, dropped by strip()
        self._roots: Optional[np.ndarray] = None    # [B, C, K, N] uint32
        self._counts: Optional[np.ndarray] = None   # [B, C, N] int32
        self._eval_level_arg: Optional[int] = None
        # the placement of an unlabeled build, dropped by strip() and by a mutation
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

    def _slot_range(self) -> tuple:
        ipb = self.params.items_per_bundle
        b0, b1 = self.bundle_range
        return b0 * ipb, min(self.params.table_params.table_size, b1 * ipb)

    def _locations(self, items: np.ndarray) -> tuple:
        """All cuckoo locations as flattened (item, slot) pairs, and the
        keep-mask that counts a slot repeated in one item's row once."""
        h = self.params.table_params.hash_func_count
        locs = self.locs.locations(items)          # [n, h]
        keep2d = np.ones(locs.shape, dtype=bool)
        for j in range(1, h):
            for i in range(j):
                keep2d[:, j] &= locs[:, j] != locs[:, i]
        return locs.reshape(-1), keep2d.reshape(-1)

    # ------------------------------------------------------------------
    def set_data(self, items: np.ndarray, eval_level: Optional[int] = None,
                 labels: Optional[np.ndarray] = None, assume_unique: bool = False) -> DbStats:
        """items: [n, 2] uint64 128-bit hashed items.  Builds the cache.

        labels: optional [n, 16] uint8 per-item labels (non-PS sets only),
        each within the set's ``item_bit_count``; encrypt them with
        ``hash.items.encrypt_label`` first for item-bound label privacy.

        assume_unique: the caller guarantees ``items`` holds no duplicate
        rows, which skips the global duplicate sort (a slot repeated in one
        item's row still counts once).

        An unlabeled build retains its placement, with a read-only copy of
        ``items``, so that ``rebind`` can serve a fresh OPRF correlation
        without placing the items again."""
        if self.oprf is None:
            raise ValueError("set_data needs an OPRF backend")
        programs.drop(self.bfv)
        with self._building(len(items)):
            if labels is not None:
                return self._set_data_labeled(items, labels, eval_level)
            self._placement = self._compute_placement_unlabeled(items, assume_unique)
            return self._materialize_placement(self, self.cache_range, eval_level)

    @contextlib.contextmanager
    def _building(self, n_items: int):
        """The span ``db.build`` around a build given ``n_items`` items,
        then its counters: those items and the device bytes the DB holds."""
        with GLOBAL.span("db.build"):
            yield
        GLOBAL.count("db.build.items", n_items)
        GLOBAL.count("db.build.bytes", sum(
            x.nbytes for x in (self.coeff_cache, self.const_slots, self.ps_const_polys,
                               self.label_cache, self.label0_slots) if x is not None))

    def _set_data_labeled(self, items, labels, eval_level) -> DbStats:
        """Labeled build: the OPRF before the placement, which keeps felt
        values distinct within a (slot, cache) lane."""
        p = self.params
        tp = p.table_params
        h, fpi, K = tp.hash_func_count, p.felts_per_item, tp.max_items_per_bin
        b0, b1 = self.bundle_range
        lo_slot, hi_slot = self._slot_range()
        self._placement = None   # a labeled build cannot rebind
        lab_u64 = np.ascontiguousarray(labels, dtype=np.uint8).view(np.uint64).reshape(-1, 2)
        # a label rides its item's felt lanes: item_bit_count bits at most
        cap = p.item_bit_count
        hi_ok = (lab_u64[:, 1] >> np.uint64(max(0, cap - 64)) == 0 if cap < 128
                 else np.ones(len(lab_u64), bool))
        lo_ok = lab_u64[:, 0] >> np.uint64(cap) == 0 if cap < 64 else True
        if not (np.all(hi_ok) and np.all(lo_ok)):
            raise ValueError(f"label exceeds the {cap}-bit per-item capacity of this parameter set")
        if self.cache_range is not None:
            raise ValueError("labeled mode does not support cache_range")

        with GLOBAL.span("db.place"):
            slots, _ = self._locations(items)
            rep = np.repeat(items, h, axis=0)
            rep_labels = np.repeat(lab_u64, h, axis=0)
            # drop duplicate (item, slot) pairs: colliding location functions
            # and duplicate input items
            if len(slots):
                keep = _dedup_pairs(slots, rep[:, 0], rep[:, 1])
                slots, rep, rep_labels = slots[keep], rep[keep], rep_labels[keep]
            if (b0, b1) != (0, p.bundle_idx_count):
                in_range = (slots >= lo_slot) & (slots < hi_slot)
                slots, rep, rep_labels = slots[in_range], rep[in_range], rep_labels[in_range]

        with GLOBAL.span("db.oprf"):
            prf = self.oprf.eval(rep, slots)
        felts = felts_from_items(prf, fpi, p.item_bit_count_per_felt)     # [m, fpi]
        label_felts = felts_from_items(rep_labels, fpi, p.item_bit_count_per_felt)
        # felt x-values must be distinct within a (slot, cache) lane: a
        # colliding item spills to the next cache
        with GLOBAL.span("db.place"):
            cache_idx, depth = _place_labeled(slots, felts, K)
        C = int(cache_idx.max()) + 1 if len(cache_idx) else 1
        slot_counts = np.bincount(slots, minlength=tp.table_size)[lo_slot:hi_slot]
        if eval_level is None:
            eval_level = self.labeled_eval_level()
        return self._finish_build(len(items), slots, felts, label_felts, cache_idx, depth, C, 0,
                                  slot_counts, eval_level)

    def _compute_placement_unlabeled(self, items, assume_unique) -> _Placement:
        """The cuckoo locations, their deduplication, the bundle-range filter
        and per-slot ranks over the full cache axis: the part of an unlabeled
        build that depends on the item hashes alone (the span ``db.place``);
        the slot-bound OPRF then runs on the kept pairs only."""
        p = self.params
        tp = p.table_params
        n, h, K = len(items), tp.hash_func_count, tp.max_items_per_bin
        b0, b1 = self.bundle_range
        lo_slot, hi_slot = self._slot_range()
        with GLOBAL.span("db.place"):
            slots, row_keep = self._locations(items)
            items = np.array(items, dtype=np.uint64)   # the retained copy
            items.flags.writeable = False
            item_idx = np.broadcast_to(np.arange(n, dtype=np.int64)[:, None], (n, h)).reshape(-1)
            slots, item_idx = slots[row_keep], item_idx[row_keep]
            if not assume_unique and len(slots):
                # a duplicate input item hits the same slots: keep its first pair
                keepu = _dedup_pairs(slots, items[item_idx, 0], items[item_idx, 1])
                slots, item_idx = slots[keepu], item_idx[keepu]
            if (b0, b1) != (0, p.bundle_idx_count):
                in_range = (slots >= lo_slot) & (slots < hi_slot)
                slots, item_idx = slots[in_range], item_idx[in_range]

            # per-slot ranks -> (cache, depth)
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
                slot_counts=np.bincount(slots, minlength=tp.table_size)[lo_slot:hi_slot],
            )

    def _materialize_placement(self, into: "ReceiverDB", cache_range, eval_level) -> DbStats:
        """Slot-bound OPRF values and felts under ``into``'s OPRF, then the
        dense tensors and the device build of ``into``, from this DB's
        placement filtered to ``cache_range``."""
        pl, p = self._placement, self.params
        slots = pl.slots.astype(np.int64)
        item_idx = pl.item_idx.astype(np.int64)
        cache_idx = pl.cache_idx.astype(np.int64)
        depth = pl.depth.astype(np.int64)
        C, cache_base = pl.n_caches, 0
        if cache_range is not None:
            c0, c1 = (int(x) for x in cache_range)
            in_c = (cache_idx >= c0) & (cache_idx < c1)
            slots, item_idx = slots[in_c], item_idx[in_c]
            cache_idx, depth = cache_idx[in_c] - c0, depth[in_c]
            C, cache_base = c1 - c0, c0
        with GLOBAL.span("db.oprf"):
            prf = into.oprf.eval(pl.items[item_idx], slots)
        felts = felts_from_items(prf, p.felts_per_item, p.item_bit_count_per_felt)
        return into._finish_build(len(pl.items), slots, felts, None, cache_idx, depth, C,
                                  cache_base, pl.slot_counts, eval_level)

    # placement alone, then cache-range partitions of it
    def place_data(self, items: np.ndarray, assume_unique: bool = False) -> int:
        """Compute and retain the full-cache-axis placement without building
        any device cache.  Returns the cache count C (the partitions'
        denominator).  Follow with ``build_partition``."""
        self._placement = self._compute_placement_unlabeled(items, assume_unique)
        return int(self._placement.n_caches)

    def build_partition(self, cache_range, oprf=None,
                        eval_level: Optional[int] = None) -> "ReceiverDB":
        """A ReceiverDB over caches [c0, c1), materialized from the retained
        placement (of ``place_data`` or a full ``set_data``).  It shares this
        DB's BfvContext and location seed; drop it after serving to release
        its device cache."""
        if self._placement is None:
            raise ValueError("no retained placement: call place_data/set_data first")
        db = ReceiverDB(self.params, oprf if oprf is not None else self.oprf, bfv=self.bfv,
                        loc_seed=self._loc_seed, bundle_range=self.bundle_range,
                        cache_range=tuple(cache_range))
        with db._building(len(self._placement.items)):
            self._materialize_placement(db, db.cache_range, eval_level)
        return db

    def _finish_build(self, n, slots, felts, label_felts, cache_idx, depth, C, cache_base,
                      slot_counts, eval_level) -> DbStats:
        """Dense host roots/counts tensors (kept for mutation), then the
        device build."""
        p = self.params
        fpi, K, N, ipb = (p.felts_per_item, p.table_params.max_items_per_bin, p.poly_degree,
                          p.items_per_bundle)
        b0, b1 = self.bundle_range
        B = b1 - b0
        lo_slot, hi_slot = self._slot_range()

        with GLOBAL.span("db.place"):   # the dense bins
            bundle_idx = slots // ipb - b0
            lane = (slots % ipb) * fpi
            roots = np.zeros((B, C, K, N), dtype=np.uint32)
            counts = np.zeros((B, C, N), dtype=np.int32)
            for f in range(fpi):
                roots[bundle_idx, cache_idx, depth, lane + f] = felts[:, f]
            label_vals = None
            if label_felts is not None:
                label_vals = np.zeros((B, C, K, N), dtype=np.uint32)
                for f in range(fpi):
                    label_vals[bundle_idx, cache_idx, depth, lane + f] = label_felts[:, f]
            per_bundle_caches = np.zeros(B, dtype=np.int64)
            sidx = np.arange(lo_slot, hi_slot)
            sb = sidx // ipb - b0
            sl = (sidx % ipb) * fpi
            # per-(slot, cache) fills: dense rank filling unlabeled (global cache
            # index = local + cache_base), the collision-aware placement labeled
            slot_cache_cnt = np.zeros((len(sidx), C), dtype=np.int32)
            if label_felts is None:
                for c in range(C):
                    slot_cache_cnt[:, c] = np.clip(slot_counts - (c + cache_base) * K, 0, K)
            else:
                np.add.at(slot_cache_cnt, (slots - lo_slot, cache_idx), 1)
            for c in range(C):
                cnt_c = slot_cache_cnt[:, c]
                for f in range(fpi):
                    counts[sb, c, sl + f] = cnt_c
                used = np.bincount(sb[cnt_c > 0], minlength=B) > 0
                per_bundle_caches[used] += 1

        self._build_cache(roots, counts, eval_level)
        if label_vals is not None:
            self._build_label_cache(roots, label_vals, counts)
        self._roots, self._counts = roots, counts
        self._eval_level_arg = eval_level
        self.stats = DbStats(
            n_items=n,
            n_insertions=len(slots),
            n_caches=C,
            cache_counts=per_bundle_caches,
            max_bin_load=int(slot_counts.max()) if len(slot_counts) else 0,
        )
        if self.cache_range is None and self.stats.max_bin_load > K * C:
            raise ValueError("bin overflow beyond cache capacity")
        return self.stats

    # ------------------------------------------------------------------
    def _encode_lift_into(self, out: torch.Tensor, coeffs: torch.Tensor, lvl: int,
                          keep_planes: Optional[torch.Tensor] = None):
        """out[c] = encode(coeffs[c]) lifted to NTT mod q ([planes, L, N] a
        cache), LIFT_CHUNK_BYTES of output at a time.  Returns the encoded
        planes ``keep_planes`` of every cache ([C, len, N]) when asked."""
        cc = max(1, LIFT_CHUNK_BYTES // (out[0].numel() * 4))
        kept = []
        with GLOBAL.span("db.encode"):
            for c0 in range(0, out.shape[0], cc):
                polys = self.bfv.encode(coeffs[c0: c0 + cc])            # [cc, planes, N]
                out[c0: c0 + cc] = self.bfv.lift_plaintext_ntt(polys, lvl)
                if keep_planes is not None:
                    kept.append(polys[..., keep_planes, :])
            return torch.cat(kept) if keep_planes is not None else None

    @staticmethod
    def _cache_groups(cache: torch.Tensor):
        """[c0, c1) groups of the cache axis of ``cache`` [B, C, planes, L,
        N] whose int64 [planes, N] coefficient rows take at most
        1/BUILD_SHARE of its bytes each."""
        B, C, planes, L, N = cache.shape
        cc = max(1, cache.numel() * 4 // BUILD_SHARE // (planes * N * 8))
        return [(c0, min(C, c0 + cc)) for c0 in range(0, C, cc)]

    def _build_bundle(self, roots_b: np.ndarray, counts_b: np.ndarray, lvl: int,
                      cache: torch.Tensor, b: int):
        """One bundle's device build: polynomials -> batch encode -> lift to
        NTT mod q, written into bundle ``b`` of ``cache`` [B, C, planes, L,
        N], a group of caches at a time.  Returns (constant
        coefficients [C, N], and on PS sets the encoded chunk constants
        [C, nh+1, N])."""
        p = self.params
        bfv = self.bfv
        C, K, N = roots_b.shape
        planes = cache.shape[2]
        ps_low = p.query_params.ps_low_degree
        const_idx = None
        if ps_low > 0:
            const_idx = torch.arange(0, K // (ps_low + 1) + 1, device=self.device) * (ps_low + 1)
        consts, kept = [], []
        for c0, c1 in self._cache_groups(cache):
            with GLOBAL.span("db.interpolate"):
                coeffs = polyn_with_roots(bfv.tensor(roots_b[c0:c1]),
                                          bfv.tensor(counts_b[c0:c1]),
                                          p.seal_params.plain_modulus)
            if planes > K + 1:  # zero planes: chunk alignment and in-bounds PS gathers
                pad = torch.zeros((c1 - c0, planes - (K + 1), N), dtype=coeffs.dtype,
                                  device=self.device)
                coeffs = torch.cat([coeffs, pad], dim=-2)
            consts.append(coeffs[..., 0, :])
            kept.append(self._encode_lift_into(cache[b, c0:c1], coeffs, lvl, const_idx))
        return torch.cat(consts), torch.cat(kept) if const_idx is not None else None

    def _build_cache(self, roots: np.ndarray, counts: np.ndarray,
                     eval_level: Optional[int] = None) -> None:
        """Device build, one bundle at a time, into one preallocated cache.
        roots [B, C, K, N] uint32 mod t, counts [B, C, N] per-lane bin loads.

        PS sets build at the PS level and keep the encoded chunk-constant
        polynomials c_{k·(ℓ+1)}; non-PS sets build at ``eval_level`` (default
        ``eval_level()``), keep each constant coefficient in the slot domain,
        and answer at that level."""
        p = self.params
        B, C, K, N = roots.shape
        ps_low = p.query_params.ps_low_degree
        uses_ps = ps_low > 0
        lvl = self.ps_level() if uses_ps else (eval_level or self.eval_level())
        planes = plane_count(K, ps_low)
        Lq = self.bfv.levels[lvl].k
        cache = torch.empty((B, C, planes, Lq, N), dtype=torch.int32, device=self.device)
        consts, ps_consts = [], []
        for b in range(B):
            const_b, ps_b = self._build_bundle(roots[b], counts[b], lvl, cache, b)
            consts.append(const_b)
            ps_consts.append(ps_b)
        self.coeff_cache = cache
        self.const_slots = torch.stack(consts)
        self.ps_const_polys = torch.stack(ps_consts) if uses_ps else None
        self.eval_lvl = lvl
        self.result_lvl = self.result_level() if uses_ps else lvl

    def _build_label_cache(self, roots: np.ndarray, label_vals: np.ndarray,
                           counts: np.ndarray) -> None:
        """Interpolate per-bin label polynomials L with L(item felt) = label
        felt and lift them into a cache shaped like ``coeff_cache`` (the
        same plane count, so one power tensor serves both dot products)."""
        p = self.params
        if p.query_params.ps_low_degree > 0:
            raise ValueError("labeled mode supports non-PS configs only")
        B, C, K, N = roots.shape
        t = p.seal_params.plain_modulus
        # Newton needs distinct x-values within each lane's valid prefix;
        # padding entries get unique out-of-range keys
        depth_idx = np.arange(K, dtype=np.int64)
        invalid = depth_idx[None, None, :, None] >= counts[:, :, None, :]
        key = np.where(invalid, (t + depth_idx)[None, None, :, None], roots.astype(np.int64))
        ks = np.sort(key, axis=2)
        if bool((ks[:, :, 1:, :] == ks[:, :, :-1, :]).any()):
            raise ValueError(
                "label interpolation impossible: two bin entries share a "
                "felt value in one lane (re-randomize the OPRF or rebuild)"
            )
        bfv = self.bfv
        lvl = self.eval_lvl
        planes = self.coeff_cache.shape[2]
        cache = torch.empty((B, C, planes, bfv.levels[lvl].k, N), dtype=torch.int32,
                            device=self.device)
        l0s = torch.empty((B, C, N), dtype=torch.int32, device=self.device)
        for b in range(B):
            for c0, c1 in self._cache_groups(cache):
                coeffs = newton_interpolate(bfv.tensor(roots[b, c0:c1]),
                                            bfv.tensor(label_vals[b, c0:c1]),
                                            bfv.tensor(counts[b, c0:c1]), t)   # [cc, K, N]
                if planes > K:
                    pad = torch.zeros((c1 - c0, planes - K, N), dtype=coeffs.dtype,
                                      device=self.device)
                    coeffs = torch.cat([coeffs, pad], dim=-2)
                self._encode_lift_into(cache[b, c0:c1], coeffs, lvl)
                l0s[b, c0:c1] = coeffs[..., 0, :]
        self.label_cache = cache
        self.label0_slots = l0s

    def set_synthetic_dense(self, rng, n_caches: int = 1,
                            eval_level: Optional[int] = None) -> np.ndarray:
        """Worst-case synthetic DB: every bin packed to max_items_per_bin with
        random roots (the same draws as the reference).  Returns the roots
        tensor [B, C, K, N] so callers can plant matching query values."""
        programs.drop(self.bfv)
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
        with self._building(B * C * K * N):
            self._build_cache(roots, counts, eval_level)
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

    def labeled_eval_level(self) -> int:
        """Labeled results carry one more plaintext multiply (the ρ·M(x)
        blinding): ~log2(t·√N) more invariant-noise bits."""
        t_bits = self.params.seal_params.plain_modulus.bit_length()
        return self.eval_level(extra_bits=t_bits + 0.5 * math.log2(self.params.poly_degree) + 4)

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

    # ------------------------------------------------------------------
    def strip(self) -> None:
        """Drop the host roots, counts and placement and keep only the
        evaluation cache: the smallest state that still answers queries.  A
        stripped DB can no longer mutate or rebind."""
        programs.drop(self.bfv)
        self._roots = None
        self._counts = None
        self._placement = None

    @property
    def can_rebind(self) -> bool:
        """True iff this DB retains a placement (built unlabeled by
        ``set_data``, not stripped, not mutated since; a DB from
        ``set_synthetic_dense`` or ``from_arrays`` has none)."""
        return self._placement is not None

    def rebind(self, oprf, eval_level: Optional[int] = None) -> "ReceiverDB":
        """A new ReceiverDB over the same items under a fresh OPRF
        correlation: only the PRF values, felts, dense tensors and device
        cache are derived again, from the retained placement (which the two
        DBs share, read-only), with this DB's location seed, partition and
        build level.  This DB is left as it is; a caller that has finished
        with its cache calls ``release_cache`` first, so that the card holds
        one cache at a time."""
        if self._placement is None:
            raise ValueError(
                "no retained placement (labeled build, stripped, or mutated since "
                "set_data): rebind needs a fresh set_data"
            )
        programs.drop(self.bfv)   # the new DB shares this context
        db = ReceiverDB(self.params, oprf, bfv=self.bfv, loc_seed=self._loc_seed,
                        bundle_range=self.bundle_range, cache_range=self.cache_range)
        with db._building(len(self._placement.items)):
            self._materialize_placement(
                db, self.cache_range,
                eval_level if eval_level is not None else self._eval_level_arg)
        db._placement = self._placement
        return db

    def release_cache(self) -> None:
        """Drop the device tensors.  The DB answers no query afterwards; its
        placement stays, so it can still ``rebind``."""
        programs.drop(self.bfv)
        self.coeff_cache = self.const_slots = self.ps_const_polys = None
        self.label_cache = self.label0_slots = None

    # ------------------------------------------------------------------
    # incremental mutation: host roots/counts updates, then a device rebuild
    # of the touched bundle indices only
    # ------------------------------------------------------------------
    def _check_full_cache_axis(self) -> None:
        if self.cache_range is not None:
            raise ValueError("cache-partitioned DBs are build-once (no incremental ops)")

    def _require_mutable(self) -> None:
        self._check_full_cache_axis()
        if self._roots is None:
            raise ValueError(
                "DB was stripped (or never built via set_data): incremental "
                "mutation needs the retained roots/counts tensors"
            )

    def _locations_felts(self, items: np.ndarray) -> tuple:
        """items -> deduplicated (slots, repeated items, felts), as set_data
        derives them."""
        p = self.params
        slots = self.locs.locations(items).reshape(-1)
        rep = np.repeat(items, p.table_params.hash_func_count, axis=0)
        if len(slots):
            keep = _dedup_pairs(slots, rep[:, 0], rep[:, 1])
            slots, rep = slots[keep], rep[keep]
        if self.bundle_range != (0, p.bundle_idx_count):
            lo_slot, hi_slot = self._slot_range()
            in_range = (slots >= lo_slot) & (slots < hi_slot)
            slots, rep = slots[in_range], rep[in_range]
        prf = self.oprf.eval(rep, slots)
        felts = felts_from_items(prf, p.felts_per_item, p.item_bit_count_per_felt)
        return slots, rep, felts

    def _slot_geometry(self, slot: int) -> tuple:
        p = self.params
        b = slot // p.items_per_bundle - self.bundle_range[0]
        lane0 = (slot % p.items_per_bundle) * p.felts_per_item
        return b, lane0

    def _find_entry(self, slot: int, felt_row: np.ndarray):
        """(cache, depth) of felt_row in the slot's bin, or None."""
        c, d = self._find_entries(np.asarray([slot], dtype=np.int64), felt_row[None, :])
        return (int(c[0]), int(d[0])) if c[0] >= 0 else None

    def _find_entries(self, slots: np.ndarray, felt_rows: np.ndarray) -> tuple:
        """Batch bin lookup: the (cache, depth) of each (slot, felt row) pair
        among its bin's valid entries, or (-1, -1); the first hit in cache
        then depth order.  The bins are gathered from a slot-major copy of
        the roots, so each pair's [C, K, fpi] bin is one contiguous block."""
        p = self.params
        fpi, ipb = p.felts_per_item, p.items_per_bundle
        m = len(slots)
        c_out = np.full(m, -1, dtype=np.int64)
        d_out = np.full(m, -1, dtype=np.int64)
        if m == 0:
            return c_out, d_out
        B, C, K, _ = self._roots.shape
        bins = np.ascontiguousarray(   # [B, ipb, C, K, fpi]
            self._roots[..., : ipb * fpi].reshape(B, C, K, ipb, fpi).transpose(0, 3, 1, 2, 4))
        loads = self._counts[..., : ipb * fpi: fpi].transpose(0, 2, 1)   # [B, ipb, C]
        slots = np.asarray(slots, dtype=np.int64)
        b, s = slots // ipb - self.bundle_range[0], slots % ipb
        depth = np.arange(K)[None, None, :]
        for s0 in range(0, m, FIND_CHUNK):
            ch = slice(s0, s0 + FIND_CHUNK)
            match = np.all(bins[b[ch], s[ch]] == felt_rows[ch][:, None, None, :], axis=3)
            hit = (match & (depth < loads[b[ch], s[ch]][:, :, None])).reshape(-1, C * K)
            pos = np.argmax(hit, axis=1)
            found = hit[np.arange(len(pos)), pos]
            c_out[ch] = np.where(found, pos // K, -1)
            d_out[ch] = np.where(found, pos % K, -1)
        return c_out, d_out

    def _slot_total(self, slot: int) -> int:
        b, lane0 = self._slot_geometry(slot)
        return int(self._counts[b, :, lane0].sum())

    def _set_slot_total(self, slot: int, total: int) -> None:
        self._set_slot_totals(np.asarray([slot], dtype=np.int64), np.asarray([total]))

    def _set_slot_totals(self, slots: np.ndarray, totals: np.ndarray) -> None:
        """Dense per-cache counts (cache c holds min(K, total − c·K)) for
        each of the given distinct slots."""
        p = self.params
        K = p.table_params.max_items_per_bin
        fpi = p.felts_per_item
        C = self._counts.shape[1]
        b = slots // p.items_per_bundle - self.bundle_range[0]
        lane0 = (slots % p.items_per_bundle) * fpi
        per_cache = np.clip(totals[:, None] - np.arange(C)[None, :] * K, 0, K).astype(np.int32)
        lanes = lane0[:, None, None] + np.arange(fpi)[None, None, :]
        self._counts[b[:, None, None], np.arange(C)[None, :, None], lanes] = per_cache[:, :, None]

    def has_item(self, items: np.ndarray) -> np.ndarray:
        """[n] bool: is each (hashed) item present in the DB?"""
        self._require_mutable()
        h = self.params.table_params.hash_func_count
        slots = self.locs.locations(items).reshape(-1)
        rep = np.repeat(items, h, axis=0)
        prf = self.oprf.eval(rep, slots)
        felts = felts_from_items(prf, self.params.felts_per_item,
                                 self.params.item_bit_count_per_felt)
        c, _ = self._find_entries(slots.astype(np.int64), felts)
        return (c >= 0).reshape(-1, h).any(axis=1)

    def insert_or_assign(self, new_items: np.ndarray) -> DbStats:
        """Insert items into the built DB (an (item, slot) pair already
        present is skipped), then rebuild the touched bundle indices into the
        resident cache.  An insert that overflows the cache axis C rebuilds
        the whole cache at the new C, after releasing the old one, so the
        card never holds two caches.

        A labeled DB refuses: its label polynomials are built once, and an
        inserted item would match without a label of its own."""
        if self.label_cache is not None:
            raise ValueError("labeled DBs are build-once for insertion: "
                             "insert_or_assign cannot add labels; rebuild with set_data")
        self._require_mutable()
        self._placement = None  # stale after a mutation: rebind refuses
        p = self.params
        K = p.table_params.max_items_per_bin
        fpi = p.felts_per_item
        B, C = self._roots.shape[0], self._roots.shape[1]
        slots, _, felts = self._locations_felts(new_items)
        slots = slots.astype(np.int64)

        c_found, _ = self._find_entries(slots, felts)
        pend = np.flatnonzero(c_found < 0)
        ps, pf = slots[pend], felts[pend]

        # target position of each pending pair: the slot's current total plus
        # its within-slot rank (a stable slot sort keeps the input order)
        so = np.argsort(ps, kind="stable")
        ss = ps[so]
        first_pos = np.searchsorted(ss, ss, side="left")
        rank = np.arange(len(ss)) - first_pos
        b = ss // p.items_per_bundle - self.bundle_range[0]
        lane0 = (ss % p.items_per_bundle) * fpi
        target = self._counts[b, :, lane0].sum(axis=1).astype(np.int64) + rank
        grow_to = max(C, int(-(-(target.max() + 1) // K)) if len(target) else C)
        if grow_to > C:
            new_roots = np.zeros((B, grow_to, K, self._roots.shape[3]), dtype=self._roots.dtype)
            new_roots[:, :C] = self._roots
            new_counts = np.zeros((B, grow_to, self._counts.shape[2]), np.int32)
            new_counts[:, :C] = self._counts
            self._roots, self._counts = new_roots, new_counts

        ci, di = target // K, target % K
        lanes = lane0[:, None] + np.arange(fpi)
        self._roots[b[:, None], ci[:, None], di[:, None], lanes] = pf[so]
        if len(ss):
            last = np.concatenate([first_pos[1:] != first_pos[:-1], [True]])
            self._set_slot_totals(ss[last], target[last] + 1)

        with self._building(len(new_items)):
            if grow_to > C:
                self._regrow(C, grow_to)
            else:
                self._rebuild_bundles(set(np.unique(b).tolist()))
        self._refresh_stats(len(pend))
        return self.stats

    def _regrow(self, c_old: int, c_new: int) -> None:
        """Rebuild the whole cache at the grown cache axis, the old cache
        released first (its memory is logged at debug level on a card)."""
        cuda = self.device.type == "cuda"
        old_gb = self.coeff_cache.numel() * 4 / 1e9
        before = torch.cuda.memory_allocated(self.device) if cuda else 0
        self.release_cache()
        released = torch.cuda.memory_allocated(self.device) if cuda else 0
        self._build_cache(self._roots, self._counts, self._eval_level_arg)
        if cuda:
            _log.debug(
                "insert grows the cache axis %d -> %d: device memory allocated %.4f GB "
                "before, %.4f GB after releasing the old cache (%.4f GB), %.4f GB after "
                "the rebuild (cache %.4f GB)", c_old, c_new, before / 1e9, released / 1e9,
                old_gb, torch.cuda.memory_allocated(self.device) / 1e9,
                self.coeff_cache.numel() * 4 / 1e9,
            )

    def remove(self, items: np.ndarray) -> DbStats:
        """Remove items at every cuckoo location, compacting each touched
        bin, then rebuild the touched bundle indices.

        An unlabeled bin is one run of roots over its caches (cache c holds
        entries c·K .. c·K + K − 1 of it), compacted as a whole.  A labeled
        bin's entries keep their caches, since each cache's label polynomial
        interpolates that cache's items: each cache is compacted on its own.
        The label polynomials stay as built and still give every remaining
        item its label."""
        self._require_mutable()
        self._placement = None  # stale after a mutation: rebind refuses
        p = self.params
        K = p.table_params.max_items_per_bin
        fpi = p.felts_per_item
        slots, _, felts = self._locations_felts(items)
        slots = slots.astype(np.int64)
        c_f, d_f = self._find_entries(slots, felts)
        hit = c_f >= 0
        hs, hc, hd = slots[hit], c_f[hit], d_f[hit]
        if not len(hs):
            return self.stats
        C = self._roots.shape[1]

        # distinct doomed positions per touched slot (duplicate (slot, felts)
        # pairs in one batch mark the same position once)
        su, inv = np.unique(hs, return_inverse=True)
        pos_key = np.unique(inv * (C * K) + hc * K + hd)
        inv_u, flat_pos = pos_key // (C * K), pos_key % (C * K)

        b = su // p.items_per_bundle - self.bundle_range[0]
        lane0 = (su % p.items_per_bundle) * fpi
        cidx = (np.arange(C * K) // K)[None, :]
        didx = (np.arange(C * K) % K)[None, :]
        lanes = lane0[:, None, None] + np.arange(fpi)[None, None, :]
        flat = self._roots[b[:, None, None], cidx[:, :, None], didx[:, :, None], lanes]
        cnt = self._counts[b, :, lane0]                                    # [T, C]
        labeled = self.label_cache is not None
        if labeled:
            keep = didx < cnt[:, cidx[0]]                                  # per-cache prefixes
        else:
            keep = np.arange(C * K)[None, :] < cnt.sum(axis=1).astype(np.int64)[:, None]
        keep[inv_u, flat_pos] = False
        if labeled:
            # stable compaction inside each cache: sort key (cache, dropped)
            order = np.argsort(cidx * 2 + ~keep, kind="stable", axis=1)
            kept_c = keep.reshape(-1, C, K).sum(axis=2)                    # [T, C]
            valid = didx < kept_c[:, cidx[0]]
        else:
            order = np.argsort(~keep, kind="stable", axis=1)
            n_kept = keep.sum(axis=1)
            valid = np.arange(C * K)[None, :] < n_kept[:, None]
        compacted = np.take_along_axis(flat, order[:, :, None], axis=1)
        compacted[~valid] = 0
        self._roots[b[:, None, None], cidx[:, :, None], didx[:, :, None], lanes] = compacted
        if labeled:
            self._counts[b[:, None, None], np.arange(C)[None, :, None], lanes] = \
                kept_c[:, :, None].astype(np.int32)
        else:
            self._set_slot_totals(su, n_kept)
        self._rebuild_bundles(set(np.unique(b).tolist()))
        self._refresh_stats(-len(pos_key))
        return self.stats

    def _rebuild_bundles(self, bundles) -> None:
        """Re-run the device build for the given bundle indices only, written
        into the resident cache, constants and chunk constants in place: every
        address stays, so the context's programs stay valid and read the new
        values."""
        for b in sorted(bundles):
            const_b, ps_b = self._build_bundle(self._roots[b], self._counts[b], self.eval_lvl,
                                               self.coeff_cache, b)
            self.const_slots[b] = const_b
            if ps_b is not None:
                self.ps_const_polys[b] = ps_b

    def _refresh_stats(self, delta_items: int) -> None:
        p = self.params
        B, C = self._counts.shape[0], self._counts.shape[1]
        lo_slot, hi_slot = self._slot_range()
        sidx = np.arange(lo_slot, hi_slot)
        sb = sidx // p.items_per_bundle - self.bundle_range[0]
        sl = (sidx % p.items_per_bundle) * p.felts_per_item
        slot_counts = self._counts[sb, :, sl].sum(axis=1)
        per_bundle = np.zeros(B, dtype=np.int64)
        for c in range(C):
            used = np.bincount(sb[self._counts[sb, c, sl] > 0], minlength=B) > 0
            per_bundle[used] += 1
        self.stats = DbStats(
            n_items=self.stats.n_items + delta_items,
            n_insertions=int(slot_counts.sum()),
            n_caches=C,
            cache_counts=per_bundle,
            max_bin_load=int(slot_counts.max()) if len(slot_counts) else 0,
        )

    # ------------------------------------------------------------------
    # checkpoint: params, the evaluation caches as uint32 arrays, the levels
    # and stats, and the KKRT sender state when that is the OPRF
    # ------------------------------------------------------------------
    def save(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)
        with open(os.path.join(path, "params.json"), "w") as f:
            f.write(self.params.to_json())
        for name in ("coeff_cache", "const_slots", "ps_const_polys", "label_cache",
                     "label0_slots"):
            x = getattr(self, name)
            if x is not None:
                np.save(os.path.join(path, f"{name}.npy"),
                        x.detach().cpu().numpy().view(np.uint32))
        meta = {
            "eval_lvl": int(self.eval_lvl),
            "result_lvl": int(self.result_lvl),
            "bundle_range": list(self.bundle_range),
            "cache_range": list(self.cache_range) if self.cache_range is not None else None,
            "n_items": self.stats.n_items,
            "n_insertions": self.stats.n_insertions,
            "n_caches": self.stats.n_caches,
            "cache_counts": self.stats.cache_counts.tolist(),
            "max_bin_load": self.stats.max_bin_load,
        }
        with open(os.path.join(path, "meta.json"), "w") as f:
            json.dump(meta, f)
        oprf = self.oprf
        if hasattr(oprf, "q_cols") and hasattr(oprf, "s_pack"):
            np.save(os.path.join(path, "oprf_q_cols.npy"), oprf.q_cols)
            np.save(os.path.join(path, "oprf_s_pack.npy"), oprf.s_pack)

    @staticmethod
    def load(path: str, oprf=None, device="cuda") -> "ReceiverDB":
        """A DB from a checkpoint of ``save`` (of either package), its
        tensors on ``device``.  Without ``oprf`` the checkpoint must hold a
        KKRT sender state, from which the OPRF is rebuilt."""
        params = PSUParams.load_file(os.path.join(path, "params.json"))
        if oprf is None:
            qc = os.path.join(path, "oprf_q_cols.npy")
            if not os.path.exists(qc):
                raise ValueError("checkpoint has no OPRF state; pass one")
            from apsu_tpu_torch.mpc.kkrt import KkrtSender

            oprf = KkrtSender.__new__(KkrtSender)
            oprf.q_cols = np.load(qc)
            oprf.s_pack = np.load(os.path.join(path, "oprf_s_pack.npy"))
            oprf.n_slots = params.table_params.table_size
        with open(os.path.join(path, "meta.json")) as f:
            meta = json.load(f)
        cr = meta.get("cache_range")
        db = ReceiverDB(params, oprf, bundle_range=tuple(meta.get("bundle_range", ())) or None,
                        cache_range=tuple(cr) if cr else None, device=device)
        for name in ("coeff_cache", "const_slots", "ps_const_polys", "label_cache",
                     "label0_slots"):
            f = os.path.join(path, f"{name}.npy")
            if os.path.exists(f):
                setattr(db, name, db.bfv.tensor(np.load(f)))
        db.eval_lvl = meta["eval_lvl"]
        db.result_lvl = meta["result_lvl"]
        db.stats = DbStats(
            n_items=meta["n_items"],
            n_insertions=meta["n_insertions"],
            n_caches=meta["n_caches"],
            cache_counts=np.asarray(meta["cache_counts"]),
            max_bin_load=meta["max_bin_load"],
        )
        return db
