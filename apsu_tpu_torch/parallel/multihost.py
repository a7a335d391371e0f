"""The multi-host DB party: its DB partitioned over worker processes (port of
``apsu_tpu/parallel/multihost.py``).

Worker w owns a (bundle-range × cache-range) partition of the DB end to end:
its part of the items, their placement, the power computation and the
evaluation.  The coordinator (``DistributedReceiver``) routes the items,
scatters each query's power slices and concatenates the result slices: no
reduction crosses workers.  The links are any Duplex (sockets between hosts,
pipes in tests); they are intra-party (one trust domain), so OPRF keys and
masks travel over them, never to the query party.  A worker given a mesh
answers through ``ShardedReceiver``.

OPRF backends: the fixed-key ECDH and debug backends ship one key to every
worker.  The slot-bound KKRT correlation is per slot, so the coordinator runs
the one interactive ``KkrtSender`` setup with the query party and ships the
per-slot key columns (``q_cols``, table_size × 64 bytes) and the choice
vector to every worker, which then evaluates F_slot(y) for its own items.

The frames are the reference's, dtypes included (residues as uint32), so a
reference coordinator drives port workers and the reverse.

Not copied from the reference: a worker's rebind releases the consumed
cache before it builds the new one (the reference builds first, so it holds
two caches at once).
"""

from __future__ import annotations

import logging
import time
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from apsu_tpu_torch.api.parties import QueryRequest, QueryResponse, Receiver, _slots_to_item_blocks
from apsu_tpu_torch.core.bfv import BfvContext
from apsu_tpu_torch.core.mod32 import to_u32
from apsu_tpu_torch.core.params import PSUParams
from apsu_tpu_torch.db.measured_levels import query_level
from apsu_tpu_torch.db.receiver_db import ReceiverDB
from apsu_tpu_torch.device import synchronize
from apsu_tpu_torch.hash.items import LocFuncs
from apsu_tpu_torch.mpc.duplex import Duplex
from apsu_tpu_torch.mpc.kkrt import KkrtSender
from apsu_tpu_torch.mpc.oprf import DebugOprf, EcdhOprfServer
from apsu_tpu_torch.mpc.prg import CsRng
from apsu_tpu_torch.parallel.mesh import row_ranges

_log = logging.getLogger("apsu_tpu_torch")


def partition_bundles(n_bundles: int, n_workers: int) -> List[Tuple[int, int]]:
    """Contiguous near-even bundle ranges, one per worker."""
    return row_ranges(n_bundles, n_workers)


def _kkrt_from_columns(q_cols, s_pack) -> KkrtSender:
    """A KkrtSender holding the key material shipped by the coordinator
    (no interactive setup of its own)."""
    oprf = KkrtSender.__new__(KkrtSender)
    oprf.q_cols = np.asarray(q_cols, dtype=np.uint8)
    oprf.s_pack = np.asarray(s_pack, dtype=np.uint8)
    oprf.n_slots = oprf.q_cols.shape[0]
    return oprf


def _allocated(device) -> int:
    return torch.cuda.memory_allocated(device) if device.type == "cuda" else 0


def db_worker(ch: Duplex, params: PSUParams, mesh=None, rng=None, device="cuda") -> None:
    """One DB-party worker: receives its partition and items, builds its DB on
    ``device``, then serves query slices and rebinds until "bye".  With
    ``mesh`` its queries run through ``ShardedReceiver`` over it."""
    rng = rng if rng is not None else CsRng()
    b0, b1, c0, c1 = (int(x) for x in ch.recv())
    kind = bytes(ch.recv()).decode()
    if kind == "kkrt":
        oprf = _kkrt_from_columns(ch.recv(), ch.recv())
    elif kind == "ecdh":
        oprf = EcdhOprfServer(rng, key=int.from_bytes(bytes(ch.recv()), "little"))
    else:
        oprf = DebugOprf(int.from_bytes(bytes(ch.recv()), "little"))
    items = ch.recv()

    def receiver(db):
        if mesh is None:
            return Receiver(params, db, rng=rng)
        from apsu_tpu_torch.parallel.runtime import ShardedReceiver

        return ShardedReceiver(params, db, mesh, rng=rng)

    t0 = time.perf_counter()
    db = ReceiverDB(params, oprf, bundle_range=(b0, b1),
                    cache_range=(c0, c1) if c0 >= 0 else None, device=device)
    db.set_data(items)
    synchronize(db.coeff_cache)
    build_ms = int((time.perf_counter() - t0) * 1e3)
    recv = receiver(db)
    # [local C, build ms]: the coordinator reads [0] as C, [1] as the build time
    ch.send(np.array([db.coeff_cache.shape[1], build_ms], dtype=np.int64))

    while True:
        op = bytes(ch.recv()).decode()
        if op == "bye":
            break
        if op == "rebind":
            # a fresh KKRT correlation for the next query: derive only the
            # OPRF-dependent tensors again from the retained placement, after
            # releasing the consumed cache (one cache on the device at a time)
            oprf2 = _kkrt_from_columns(ch.recv(), ch.recv())
            t0 = time.perf_counter()
            before = _allocated(db.device)
            del recv
            db.release_cache()
            released = _allocated(db.device)
            db = db.rebind(oprf2)
            synchronize(db.coeff_cache)
            if db.device.type == "cuda":
                _log.debug(
                    "worker rebind: device memory allocated %.4f GB before, %.4f GB after "
                    "releasing the consumed cache, %.4f GB after the rebind (cache %.4f GB)",
                    before / 1e9, released / 1e9, _allocated(db.device) / 1e9,
                    db.coeff_cache.numel() * db.coeff_cache.element_size() / 1e9)
            recv = receiver(db)
            ch.send(np.array([int((time.perf_counter() - t0) * 1e3)], dtype=np.int64))
            continue
        if op != "query":
            raise ValueError(f"unknown worker op {op!r}")
        plist = tuple(int(x) for x in ch.recv())
        powers_slice = ch.recv()               # [P, B_w, 2, L, N] uint32
        rk = ch.recv()
        resp = recv.run_query(QueryRequest(
            power_list=plist, powers_data=db.bfv.tensor(powers_slice),
            relin_key=None if isinstance(rk, bytes) else db.bfv.tensor(rk)))
        ch.send(to_u32(resp.results))          # [B_w, C_w, 2, Lr, N]
        ch.send(np.array([resp.eval_level], dtype=np.int64))
        ch.send(recv.last_mask)                # [B_w, C_w, N] uint32


class DistributedReceiver:
    """The coordinator: a drop-in Receiver for a DB partitioned over workers.

    ``run_query`` scatters per-worker power slices and concatenates the
    result slices, padding the cache axis to the global C: absent caches get
    zero ciphertexts and never-matching all-one masks (the reference's
    padding at receiver_osn.cpp:241-248)."""

    def __init__(
        self,
        params: PSUParams,
        worker_channels: Sequence[Duplex],
        items: np.ndarray,
        oprf_kind: str = "debug",
        oprf_key: Optional[int] = None,
        rng=None,
        cache_parts: int = 1,
        oprf=None,
        device="cuda",
    ):
        """``cache_parts`` > 1 splits each bundle range's cache axis over that
        many workers (``len(worker_channels)`` = bundle parts × cache_parts,
        workers ordered bundle-major).  ``oprf``: a constructed backend that
        overrides ``oprf_kind`` (the KkrtSender of the interactive setup with
        the query party, whose key columns go to every worker, or an
        EcdhOprfServer/DebugOprf to reuse a key).  ``device`` holds the
        coordinator's BFV context, which rebuilds seed-compressed uploads."""
        self.params = params
        self.chs = list(worker_channels)
        self.rng = rng if rng is not None else CsRng()
        if len(self.chs) % cache_parts:
            raise ValueError("worker count must divide into cache_parts")
        n_bparts = len(self.chs) // cache_parts
        self.cache_parts = cache_parts
        branges = partition_bundles(params.bundle_idx_count, n_bparts)
        key_bytes = b""
        if oprf is not None:
            self.oprf = oprf
            if isinstance(oprf, KkrtSender):
                oprf_kind = "kkrt"
            elif isinstance(oprf, EcdhOprfServer):
                oprf_kind = "ecdh"
                key_bytes = int(oprf.k).to_bytes(32, "little")
            else:
                oprf_kind = "debug"
                key_bytes = int(oprf.key).to_bytes(32, "little")
        else:
            if oprf_kind == "kkrt":
                raise ValueError(
                    "pass the set-up KkrtSender via oprf= (the interactive setup is a "
                    "two-party step the coordinator runs once)")
            if oprf_key is None:
                oprf_key = int.from_bytes(self.rng.bytes(16), "little")
            self.oprf = (EcdhOprfServer(self.rng, key=oprf_key) if oprf_kind == "ecdh"
                         else DebugOprf(oprf_key))
            key_bytes = int(oprf_key).to_bytes(32, "little")
        self.oprf_kind = oprf_kind
        self.bfv = BfvContext(params.seal_params, device=device)
        self.query_lvl = query_level(params, len(self.bfv.q_primes))

        # route items: every worker gets the items with >= 1 cuckoo location
        # in its bundle range (its set_data keeps exactly its own)
        tp = params.table_params
        locs = LocFuncs(tp.table_size, tp.hash_func_count).locations(items)
        bundles = locs // params.items_per_bundle                    # [n, h]
        if cache_parts > 1:
            # the global cache count from the deduplicated insertion loads:
            # the cache ranges are agreed before the workers build
            pairs = np.stack([np.repeat(np.arange(len(items)), tp.hash_func_count),
                              locs.reshape(-1)])
            loads = np.bincount(np.unique(pairs, axis=1)[1], minlength=tp.table_size)
            C_total = max(1, -(-int(loads.max()) // tp.max_items_per_bin))
            cranges = partition_bundles(C_total, cache_parts)
        else:
            cranges = [(-1, -1)]
        self.ranges = [(b0, b1, c0, c1) for b0, b1 in branges for c0, c1 in cranges]
        for ch, (b0, b1, c0, c1) in zip(self.chs, self.ranges):
            take = ((bundles >= b0) & (bundles < b1)).any(axis=1)
            ch.send(np.array([b0, b1, c0, c1], dtype=np.int64))
            ch.send(oprf_kind.encode())
            if oprf_kind == "kkrt":
                ch.send(np.ascontiguousarray(self.oprf.q_cols))
                ch.send(np.ascontiguousarray(self.oprf.s_pack))
            else:
                ch.send(key_bytes)
            ch.send(np.ascontiguousarray(items[take]))
        acks = [np.asarray(ch.recv()) for ch in self.chs]
        self.worker_C = [int(a[0]) for a in acks]
        self.worker_build_s = [(float(a[1]) / 1e3 if a.shape[0] > 1 else None) for a in acks]
        self.worker_rebind_s: Optional[List[float]] = None
        # the most caches of one assembled bundle row
        self.C = max(sum(self.worker_C[i * cache_parts:(i + 1) * cache_parts])
                     for i in range(n_bparts))
        self.last_mask: Optional[np.ndarray] = None
        self.eval_level: Optional[int] = None

    def run_query(self, req: QueryRequest, timings: Optional[dict] = None) -> QueryResponse:
        """``timings`` (optional dict): the coordinator's phase split —
        scatter_s (the power-slice sends), wait_s (blocking on the workers'
        results, their compute included), concat_s (assembly and padding)."""
        t0 = time.perf_counter()
        powers = to_u32(self.bfv.tensor(req.powers_data))        # [P, B, 2, L, N]
        rk = to_u32(self.bfv.tensor(req.relin_key)) if req.relin_key is not None else b"none"
        for ch, (b0, b1, _, _) in zip(self.chs, self.ranges):
            ch.send(b"query")
            ch.send(np.asarray(req.power_list, dtype=np.int64))
            ch.send(np.ascontiguousarray(powers[:, b0:b1]))
            ch.send(rk)
        if timings is not None:
            timings["scatter_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        raw, lvl = [], None
        for ch in self.chs:
            r = np.asarray(ch.recv())                             # [B_w, C_w, 2, Lr, N]
            lvl = int(ch.recv()[0])
            raw.append((r, np.asarray(ch.recv())))                # mask [B_w, C_w, N]
        if timings is not None:
            timings["wait_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
        # concat the cache slices of each bundle row, pad the row to the
        # global C, then concat the bundle rows
        cp = self.cache_parts
        res_parts, mask_parts = [], []
        for i in range(0, len(raw), cp):
            r = np.concatenate([x[0] for x in raw[i:i + cp]], axis=1)
            m = np.concatenate([x[1] for x in raw[i:i + cp]], axis=1)
            if r.shape[1] < self.C:
                pad = self.C - r.shape[1]
                r = np.concatenate([r, np.zeros(r.shape[:1] + (pad,) + r.shape[2:], r.dtype)],
                                   axis=1)
                m = np.concatenate([m, np.ones(m.shape[:1] + (pad, m.shape[-1]), m.dtype)],
                                   axis=1)
            res_parts.append(r)
            mask_parts.append(m)
        self.last_mask = np.concatenate(mask_parts)             # [B, C, N]
        self.eval_level = lvl
        out = QueryResponse(results=self.bfv.tensor(np.concatenate(res_parts)), eval_level=lvl)
        if timings is not None:
            timings["concat_s"] = time.perf_counter() - t0
        return out

    def rebind(self, oprf) -> None:
        """Re-key every worker's partition under a fresh slot-bound KKRT
        correlation (the serve loop's rebind): ship the new key columns;
        each worker derives its OPRF-dependent tensors again from its
        retained placement.  Returns once every worker has acknowledged."""
        if not isinstance(oprf, KkrtSender):
            raise ValueError("rebind expects a fresh KkrtSender")
        self.oprf = oprf
        for ch in self.chs:
            ch.send(b"rebind")
            ch.send(np.ascontiguousarray(oprf.q_cols))
            ch.send(np.ascontiguousarray(oprf.s_pack))
        self.worker_rebind_s = [float(np.asarray(ch.recv())[0]) / 1e3 for ch in self.chs]

    def peqt_matrix(self) -> np.ndarray:
        return _slots_to_item_blocks(self.params, self.last_mask)

    def close(self) -> None:
        for ch in self.chs:
            ch.send(b"bye")
