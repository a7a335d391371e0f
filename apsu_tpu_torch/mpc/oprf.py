"""Slot-bound OPRF layer (port of the ``OprfBackend`` interface and the
debug backend of ``apsu_tpu/mpc/oprf.py``).

Both parties replace raw items with slot-bound PRF values, PRF_slot(item)
rather than PRF(item), so equal items in different cuckoo slots never
correlate.  ``DebugOprf`` is a shared-key vectorized PRF with the same
functional behaviour (slot-bound 128-bit outputs) and no security: it
exercises the whole hash → OPRF → felts → encrypt → eval pipeline in one
process.  The interactive backends (KKRT, ECDH) are not ported yet.
"""

from __future__ import annotations

from typing import Protocol

import numpy as np


class OprfBackend(Protocol):
    def eval(self, items: np.ndarray, slots: np.ndarray) -> np.ndarray:
        """items [n, 2] uint64, slots [n] int64 -> PRF outputs [n, 2] uint64."""
        ...


def _mix64(v: np.ndarray) -> np.ndarray:
    """splitmix64 finalizer (vectorized; uint64 wraparound is intended)."""
    with np.errstate(over="ignore"):
        v = (v + np.uint64(0x9E3779B97F4A7C15)) & np.uint64(0xFFFFFFFFFFFFFFFF)
        v ^= v >> np.uint64(30)
        v = v * np.uint64(0xBF58476D1CE4E5B9)
        v ^= v >> np.uint64(27)
        v = v * np.uint64(0x94D049BB133111EB)
        v ^= v >> np.uint64(31)
    return v


class DebugOprf:
    """Shared-key slot-bound PRF: prf(slot, item) via xorshift-multiply
    rounds.  NOT oblivious — both parties hold the key."""

    def __init__(self, key: int = 0x5EED):
        self.key = int(key)
        self.k1 = np.uint64(_mix64(np.uint64(key)))
        self.k2 = np.uint64(_mix64(np.uint64(key) ^ np.uint64(0xDEADBEEF)))

    def eval(self, items: np.ndarray, slots: np.ndarray) -> np.ndarray:
        s = slots.astype(np.uint64)
        lo = _mix64(items[:, 0] ^ self.k1 ^ _mix64(s))
        hi = _mix64(items[:, 1] ^ self.k2 ^ _mix64(s ^ np.uint64(0xABCDEF)))
        # couple the halves so output depends on the full 128-bit input
        lo2 = _mix64(lo ^ hi)
        hi2 = _mix64(hi + lo)
        return np.stack([lo2, hi2], axis=1)
