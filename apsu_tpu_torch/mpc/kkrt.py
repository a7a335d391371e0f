"""KKRT batched NCO-OT OPRF (eprint 2016/799 style, PRC-coded; port of
``apsu_tpu/mpc/kkrt.py``).

One OT/PRF instance is bound to every cuckoo-table slot.  The DB party ends up with the PRF KEY (it can evaluate
F_slot(y) for any y — needed because many DB items hash to each slot); the
query party gets exactly F_slot(x_slot) for the one item it placed there.

Width: 512-bit pseudorandom code (AES-based), 512 base OTs, fixed-key-AES
MMO output hashing to 128 bits.
"""

from __future__ import annotations

import numpy as np

from apsu_tpu_torch.mpc.baseot import base_ot_recv, base_ot_send
from apsu_tpu_torch.mpc.duplex import Duplex
from apsu_tpu_torch.mpc.prg import aes_code, mmo_hash, prg_bits

WIDTH = 512
CODE_BLOCKS = WIDTH // 128


def _items_to_blocks(items: np.ndarray) -> np.ndarray:
    """[n, 2] uint64 -> [n, 16] uint8."""
    return np.ascontiguousarray(items, dtype=np.uint64).view(np.uint8).reshape(-1, 16)


def _blocks_to_items(blocks: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(blocks, dtype=np.uint8).view(np.uint64).reshape(-1, 2)


def _out_hash(wide: np.ndarray, slots: np.ndarray) -> np.ndarray:
    """[n, 64] uint8 code-width values + instance slots -> [n, 16] digests."""
    acc = None
    for b in range(CODE_BLOCKS):
        h = mmo_hash(wide[:, 16 * b : 16 * (b + 1)], tweak=b + 1)
        acc = h if acc is None else acc ^ h
    # bind the slot index, then one more MMO round to break linearity
    sl = slots.astype(np.uint64)
    acc[:, :8] ^= sl.view(np.uint8).reshape(-1, 8)
    return mmo_hash(acc, tweak=0xABCD)


class KkrtSender:
    """PRF-key holder (the DB party).  After setup, evaluates F_slot(item)
    for arbitrary (item, slot) pairs."""

    def __init__(self, ch: Duplex, n_slots: int, rng: np.random.Generator):
        self.n_slots = n_slots
        s = rng.integers(0, 2, size=WIDTH).astype(np.uint8)
        ks = base_ot_recv(ch, s, rng)                    # [w, 16]
        u = ch.recv()                                    # [w, n_slots] bits
        q = np.empty((WIDTH, n_slots), dtype=np.uint8)
        for i in range(WIDTH):
            q[i] = prg_bits(ks[i].tobytes(), n_slots)
            if s[i]:
                q[i] ^= u[i]
        # per-slot key column, packed to bytes [n_slots, 64]
        self.q_cols = np.packbits(q.T, axis=-1, bitorder="little")
        self.s_pack = np.packbits(s, bitorder="little")  # [64]

    def eval(self, items: np.ndarray, slots: np.ndarray) -> np.ndarray:
        """items [n, 2] uint64, slots [n] -> PRF outputs [n, 2] uint64."""
        x = _items_to_blocks(items)
        code = aes_code(x, CODE_BLOCKS)                  # [n, 64] uint8
        masked = code & self.s_pack[None, :]
        wide = self.q_cols[np.asarray(slots, dtype=np.int64)] ^ masked
        return _blocks_to_items(_out_hash(wide, np.asarray(slots)))


class KkrtReceiver:
    """Input binder (the query party): one input per slot, learns F_slot(x)."""

    def __init__(
        self,
        ch: Duplex,
        inputs_by_slot: np.ndarray,  # [n_slots, 2] uint64 (junk for empty slots)
        rng: np.random.Generator,
    ):
        m = inputs_by_slot.shape[0]
        k0, k1 = base_ot_send(ch, WIDTH, rng)
        x = _items_to_blocks(inputs_by_slot)
        code_bits = np.unpackbits(
            aes_code(x, CODE_BLOCKS), axis=-1, bitorder="little"
        ).T                                              # [w, m]
        t0 = np.empty((WIDTH, m), dtype=np.uint8)
        u = np.empty((WIDTH, m), dtype=np.uint8)
        for i in range(WIDTH):
            t0[i] = prg_bits(k0[i].tobytes(), m)
            u[i] = t0[i] ^ prg_bits(k1[i].tobytes(), m) ^ code_bits[i]
        ch.send(u)
        t_cols = np.packbits(t0.T, axis=-1, bitorder="little")  # [m, 64]
        self._prf = _blocks_to_items(_out_hash(t_cols, np.arange(m)))
        self._inputs = inputs_by_slot.copy()

    def eval(self, items: np.ndarray, slots: np.ndarray) -> np.ndarray:
        """Must be queried with the same (item, slot) pairs bound at setup."""
        slots = np.asarray(slots, dtype=np.int64)
        if not np.array_equal(self._inputs[slots], np.asarray(items, dtype=np.uint64)):
            raise ValueError("KKRT receiver: items differ from bound inputs")
        return self._prf[slots]
