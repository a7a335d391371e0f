"""Item hashing and vectorized table-location functions (port of
``apsu_tpu/hash/items.py``; numpy only).

Items are 128-bit hashes held as ``np.uint64`` arrays of shape [n, 2]
(lo, hi words).  ``hash_item`` maps arbitrary input to that space with
Blake2b; ``LocFuncs`` are the cuckoo-table location functions: a vectorized
multiply-shift universal hash over the 128-bit value, seeded from a public
seed, so both parties (and both packages) place an item in the same slots.
Location functions need only spread well; the pseudorandomness guarantees
come from the slot-bound OPRF above them.
"""

from __future__ import annotations

import hashlib
from typing import Iterable, List

import numpy as np

ITEM_BYTES = 16


def hash_item(data) -> tuple:
    """Arbitrary input -> 128-bit value (lo, hi) via Blake2b."""
    if isinstance(data, str):
        data = data.encode()
    elif isinstance(data, int):
        data = data.to_bytes((max(data.bit_length(), 1) + 7) // 8, "little")
    h = hashlib.blake2b(data, digest_size=ITEM_BYTES).digest()
    return (
        int.from_bytes(h[:8], "little"),
        int.from_bytes(h[8:], "little"),
    )


def hash_items(items: Iterable) -> np.ndarray:
    """List of str/bytes/int -> [n, 2] uint64 (lo, hi)."""
    vals: List = items if hasattr(items, "__len__") else list(items)
    out = np.empty((len(vals), 2), dtype=np.uint64)
    for i, it in enumerate(vals):
        lo, hi = hash_item(it)
        out[i, 0] = lo
        out[i, 1] = hi
    return out


def random_items(n: int, rng: np.random.Generator) -> np.ndarray:
    """Synthetic 128-bit items (already in hash space), [n, 2] uint64."""
    return rng.integers(0, 1 << 64, size=(n, 2), dtype=np.uint64)


class LocFuncs:
    """hash_func_count vectorized multiply-shift location functions.

    loc_i(x) = high64((x_lo·A_i + x_hi·B_i + C_i) mod 2^64 scaled to table):
    a xorshift-multiply mix, then the Lemire reduction
    ``(v * table_size) >> 64`` in uint64 arithmetic split into 32-bit halves.
    """

    def __init__(self, table_size: int, func_count: int, seed: bytes = b"apsu-loc"):
        self.table_size = int(table_size)
        self.func_count = int(func_count)
        st = np.random.Generator(
            np.random.Philox(
                int.from_bytes(hashlib.blake2b(seed, digest_size=8).digest(), "little")
            )
        )
        self.A = st.integers(0, 1 << 64, size=func_count, dtype=np.uint64) | np.uint64(1)
        self.B = st.integers(0, 1 << 64, size=func_count, dtype=np.uint64) | np.uint64(1)
        self.C = st.integers(0, 1 << 64, size=func_count, dtype=np.uint64)

    def locations(self, items: np.ndarray) -> np.ndarray:
        """items [n, 2] uint64 -> [n, func_count] int64 table locations
        (per-function in-place column passes over uint64 temporaries)."""
        n = items.shape[0]
        lo = np.ascontiguousarray(items[:, 0])
        hi = np.ascontiguousarray(items[:, 1])
        out = np.empty((self.func_count, n), dtype=np.int64)
        m = np.uint64(self.table_size)
        t = np.empty(n, np.uint64)
        for i in range(self.func_count):
            v = lo * self.A[i]
            np.multiply(hi, self.B[i], out=t)
            v += t
            v += self.C[i]
            # mix before reduction (xorshift-multiply)
            np.right_shift(v, np.uint64(33), out=t)
            v ^= t
            v *= np.uint64(0xFF51AFD7ED558CCD)
            np.right_shift(v, np.uint64(33), out=t)
            v ^= t
            # Lemire map to [0, table_size): high 64 bits of v * table_size
            np.bitwise_and(v, np.uint64(0xFFFFFFFF), out=t)
            t *= m
            t >>= np.uint64(32)
            v >>= np.uint64(32)
            v *= m
            v += t
            v >>= np.uint64(32)
            out[i] = v.astype(np.int64)
        return np.ascontiguousarray(out.T)
