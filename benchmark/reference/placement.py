"""Where items land: frozen copies of the protocol's public item hashing,
and the receiver's bins and the sender's query values built from them.

The copies (location functions, the debug OPRF, the felt split and the
sender's cuckoo insertion) are the protocol's agreed functions, kept here
as they were written so that the reference depends on nothing of the
program.  Items are 128-bit values held as [n, 2] uint64 (lo, hi).
"""

from __future__ import annotations

import hashlib

import numpy as np

U64 = np.uint64


class LocFuncs:
    """The cuckoo location functions: a multiply-shift hash of the 128-bit
    item per function, a xorshift-multiply mix, then Lemire's reduction to
    [0, table_size); the constants come from a Philox stream keyed by the
    blake2b digest of the public location seed."""

    def __init__(self, table_size: int, func_count: int, seed: bytes):
        self.table_size, self.func_count = int(table_size), int(func_count)
        st = np.random.Generator(np.random.Philox(
            int.from_bytes(hashlib.blake2b(seed, digest_size=8).digest(), "little")))
        self.A = st.integers(0, 1 << 64, size=func_count, dtype=U64) | U64(1)
        self.B = st.integers(0, 1 << 64, size=func_count, dtype=U64) | U64(1)
        self.C = st.integers(0, 1 << 64, size=func_count, dtype=U64)

    def locations(self, items: np.ndarray) -> np.ndarray:
        """[n, 2] uint64 -> [n, func_count] int64 slots."""
        lo, hi = items[:, 0], items[:, 1]
        m = U64(self.table_size)
        out = []
        with np.errstate(over="ignore"):
            for i in range(self.func_count):
                v = lo * self.A[i] + hi * self.B[i] + self.C[i]
                v ^= v >> U64(33)
                v *= U64(0xFF51AFD7ED558CCD)
                v ^= v >> U64(33)
                low = (v & U64(0xFFFFFFFF)) * m >> U64(32)
                out.append(((v >> U64(32)) * m + low) >> U64(32))
        return np.stack(out, axis=1).astype(np.int64)


def _mix64(v: np.ndarray) -> np.ndarray:
    """The splitmix64 finalizer (uint64 wraparound intended)."""
    with np.errstate(over="ignore"):
        v = v + U64(0x9E3779B97F4A7C15)
        v ^= v >> U64(30)
        v = v * U64(0xBF58476D1CE4E5B9)
        v ^= v >> U64(27)
        v = v * U64(0x94D049BB133111EB)
        v ^= v >> U64(31)
    return v


def debug_oprf(items: np.ndarray, slots: np.ndarray, key: int) -> np.ndarray:
    """The shared-key slot-bound PRF of in-process runs: [n, 2] uint64."""
    k1 = _mix64(U64(key))
    k2 = _mix64(U64(key) ^ U64(0xDEADBEEF))
    s = slots.astype(U64)
    with np.errstate(over="ignore"):
        lo = _mix64(items[:, 0] ^ k1 ^ _mix64(s))
        hi = _mix64(items[:, 1] ^ k2 ^ _mix64(s ^ U64(0xABCDEF)))
        return np.stack([_mix64(lo ^ hi), _mix64(hi + lo)], axis=1)


def felts(prf: np.ndarray, count: int, bits: int) -> np.ndarray:
    """The low count·bits bits of each 128-bit value, split little-endian
    into ``count`` field elements of ``bits`` bits: [n, count] uint32."""
    out = np.empty((len(prf), count), dtype=np.uint32)
    lo, hi = prf[:, 0], prf[:, 1]
    for f in range(count):
        start = f * bits
        if start >= 64:
            chunk = hi >> U64(start - 64)
        else:
            chunk = lo >> U64(start)
            if start + bits > 64:
                chunk = chunk | (hi << U64(64 - start))
        out[:, f] = (chunk & U64((1 << bits) - 1)).astype(np.uint32)
    return out


def cuckoo_table(items: np.ndarray, locs: LocFuncs, max_attempts: int = 500) -> np.ndarray:
    """The sender's cuckoo table: each item in turn at the first empty one of
    its locations, else evicting the occupant of a location drawn from
    ``default_rng(0)``; empty slots hold junk from ``default_rng(0x9E37)``.
    Returns [table_size, 2] uint64."""
    size = locs.table_size
    all_locs = locs.locations(items)
    owner = np.full(size, -1, dtype=np.int64)
    rng = np.random.default_rng(0)
    for idx in range(len(items)):
        cur = idx
        for _ in range(max_attempts):
            cand = all_locs[cur]
            empty = cand[owner[cand] < 0]
            if empty.size:
                owner[empty[0]] = cur
                break
            slot = cand[rng.integers(0, len(cand))]
            owner[slot], cur = cur, owner[slot]
        else:
            raise RuntimeError("cuckoo insertion failed")
    table = np.random.default_rng(0x9E37).integers(0, 1 << 64, size=(size, 2), dtype=U64)
    table[owner >= 0] = items[owner[owner >= 0]]
    return table


class Layout:
    """How slots map to bundles and lanes: slot s lies in bundle s // ipb,
    its felt f in lane (s % ipb)·fpi + f."""

    def __init__(self, table_size: int, items_per_bundle: int, felts_per_item: int,
                 bits_per_felt: int, n: int, bundles: int):
        self.table_size, self.ipb, self.fpi = table_size, items_per_bundle, felts_per_item
        self.bits, self.n, self.bundles = bits_per_felt, n, bundles

    def lanes(self, slots: np.ndarray) -> tuple:
        """(bundle [m], first lane [m]) of each slot."""
        return slots // self.ipb, (slots % self.ipb) * self.fpi


def query_values(items: np.ndarray, locs: LocFuncs, layout: Layout, oprf_key: int) -> np.ndarray:
    """The sender's query values [B, N] uint32: every slot's PRF felts (junk
    slots too), lanes past the last slot 0."""
    table = cuckoo_table(items, locs)
    slots = np.arange(layout.table_size, dtype=np.int64)
    f = felts(debug_oprf(table, slots, oprf_key), layout.fpi, layout.bits)
    x = np.zeros((layout.bundles, layout.n), dtype=np.uint32)
    b, lane = layout.lanes(slots)
    for k in range(layout.fpi):
        x[b, lane + k] = f[:, k]
    return x


def receiver_bins(items: np.ndarray, locs: LocFuncs, layout: Layout, oprf_key: int,
                  max_per_bin: int) -> tuple:
    """The receiver's bins from its items (distinct rows): every item at each
    of its distinct locations, a slot's items in order of (item, location
    function), cache c holding ranks [c·K, (c+1)·K).  Returns roots
    [B, C, K, N] uint32 and counts [B, C, N] int32."""
    n, h = len(items), locs.func_count
    loc = locs.locations(items)
    keep = np.ones(loc.shape, dtype=bool)
    for j in range(1, h):
        for i in range(j):
            keep[:, j] &= loc[:, j] != loc[:, i]
    idx = np.broadcast_to(np.arange(n)[:, None], (n, h))[keep]
    slots = loc[keep]
    order = np.argsort(slots, kind="stable")
    ss = slots[order]
    rank = np.empty(len(ss), dtype=np.int64)
    rank[order] = np.arange(len(ss)) - np.searchsorted(ss, ss, side="left")
    K = max_per_bin
    cache, depth = rank // K, rank % K
    C = int(cache.max()) + 1
    f = felts(debug_oprf(items[idx], slots, oprf_key), layout.fpi, layout.bits)
    roots = np.zeros((layout.bundles, C, K, layout.n), dtype=np.uint32)
    counts = np.zeros((layout.bundles, C, layout.n), dtype=np.int32)
    b, lane = layout.lanes(slots)
    for k in range(layout.fpi):
        roots[b, cache, depth, lane + k] = f[:, k]
    load = np.bincount(slots, minlength=layout.table_size)
    sb, sl = layout.lanes(np.arange(layout.table_size))
    for c in range(C):
        fill = np.clip(load - c * K, 0, K).astype(np.int32)
        for k in range(layout.fpi):
            counts[sb, c, sl + k] = fill
    return roots, counts
