"""Slot-bound OPRF layer (port of ``apsu_tpu/mpc/oprf.py``).

Both parties replace raw items with slot-bound PRF values, PRF_slot(item)
rather than PRF(item), so equal items in different cuckoo slots never
correlate.  Three backends share the ``OprfBackend`` interface:

* ``mpc/kkrt.py`` — the interactive KKRT OPRF, one correlation per session;
* ``EcdhOprfServer``/``EcdhOprfClient`` — a fixed-key ECDH OPRF whose DB
  build needs no interaction, so one resident cache answers any number of
  queries;
* ``DebugOprf`` — a shared-key vectorized PRF with the same functional
  behaviour and no security, for single-process runs.
"""

from __future__ import annotations

from typing import Protocol

import numpy as np

from apsu_tpu_torch.mpc import ec
from apsu_tpu_torch.mpc.prg import mmo_hash


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


def _slot_seeds(items: np.ndarray, slots: np.ndarray) -> np.ndarray:
    """(item, slot) -> [n, 32] hash-to-curve seeds (slot-bound)."""
    n = items.shape[0]
    seeds = np.zeros((n, 32), dtype=np.uint8)
    seeds[:, :16] = (
        np.ascontiguousarray(items, dtype=np.uint64).view(np.uint8).reshape(n, 16)
    )
    seeds[:, 16:24] = (
        np.ascontiguousarray(slots, dtype=np.uint64).view(np.uint8).reshape(n, 8)
    )
    seeds[:, 24:] = np.frombuffer(b"apsuOPRF", dtype=np.uint8)
    return seeds


def _point_digest(points: np.ndarray, slots: np.ndarray) -> np.ndarray:
    """Compressed points [n, 32] -> slot-bound 128-bit PRF outputs [n, 2]."""
    h = mmo_hash(points[:, :16], tweak=0x0E11) ^ mmo_hash(points[:, 16:], tweak=0x0E12)
    sl = np.ascontiguousarray(slots, dtype=np.uint64).view(np.uint8).reshape(-1, 8)
    h[:, :8] ^= sl
    out = mmo_hash(h, tweak=0x0E13)
    return np.ascontiguousarray(out).view(np.uint64).reshape(-1, 2)


class EcdhOprfServer:
    """Fixed-key ECDH OPRF: F(slot, item) = H2(k · H1(item ‖ slot)) (blind →
    exponentiate → unblind, the role of the C++ reference's FourQ OPRF).

    Unlike the slot-bound KKRT correlation, which binds one receiver input
    per instance and so one session, the key is a fixed scalar: the DB build
    needs no interaction and a resident server answers unlimited queries
    against one preprocessed cache.  This is the OPRF of serve-loop mode."""

    def __init__(self, rng, key: int | None = None):
        self.k = key if key is not None else ec.random_scalars(1, rng)[0]
        self._kb = ec.scalars_to_bytes([self.k])[0]

    def eval(self, items: np.ndarray, slots: np.ndarray) -> np.ndarray:
        """Local full evaluation (DB preprocessing), chunked for memory."""
        n = items.shape[0]
        out = np.empty((n, 2), dtype=np.uint64)
        CH = 1 << 18
        for o in range(0, n, CH):
            sl = np.asarray(slots[o : o + CH])
            P = ec.hash_to_point(_slot_seeds(items[o : o + CH], sl))
            kb = np.ascontiguousarray(np.broadcast_to(self._kb, P.shape))
            out[o : o + CH] = _point_digest(ec.scalar_mult(P, kb), sl)
        return out

    def serve_round(self, blinded: np.ndarray) -> np.ndarray:
        """One query-party OPRF round: k · (blinded points)."""
        pts = np.ascontiguousarray(blinded, dtype=np.uint8).reshape(-1, 32)
        kb = np.ascontiguousarray(np.broadcast_to(self._kb, pts.shape))
        return ec.scalar_mult(pts, kb)


class EcdhOprfClient:
    """Query-party end: blinds its cuckoo table with a scalar r per slot, one
    round trip, unblinds by r⁻¹.  Learns exactly F(slot, x_slot) for its
    bound inputs."""

    def __init__(self, ch, inputs_by_slot: np.ndarray, rng):
        n = inputs_by_slot.shape[0]
        slots = np.arange(n, dtype=np.int64)
        r = ec.random_scalars(n, rng)
        rb = ec.scalars_to_bytes(r)
        rinv = ec.scalars_to_bytes([pow(x, -1, ec.ORDER) for x in r])
        P = ec.hash_to_point(_slot_seeds(inputs_by_slot, slots))
        ch.send(ec.scalar_mult(P, rb))           # r·H1(x ‖ slot)
        resp = np.asarray(ch.recv(), dtype=np.uint8).reshape(n, 32)
        kP = ec.scalar_mult(resp, rinv)          # k·H1(x ‖ slot)
        self._prf = _point_digest(kP, slots)
        self._inputs = inputs_by_slot.copy()

    def eval(self, items: np.ndarray, slots: np.ndarray) -> np.ndarray:
        slots = np.asarray(slots, dtype=np.int64)
        if not np.array_equal(self._inputs[slots], np.asarray(items, dtype=np.uint64)):
            raise ValueError("ECDH OPRF client: items differ from bound inputs")
        return self._prf[slots]


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
