"""IKNP-style OT extension: random, chosen and one-sided flavours (port of
``apsu_tpu/mpc/otext.py``).

Semi-honest: 128 Chou–Orlandi base OTs in the reverse direction, AES-CTR
matrix expansion, packed-bit transposes, fixed-key-AES MMO instance hashing.
All matrix work is numpy over packed buffers, with no per-OT Python loop.
``ot_ext_send``/``ot_ext_recv`` pick IKNP, SoftSpoken or silent OT by the
batch size alone (``_flavor``), so both parties pick the same one, and log
the pick at debug level on the ``apsu_tpu_torch`` logger.
"""

from __future__ import annotations

import logging

import numpy as np

from apsu_tpu_torch.mpc.baseot import base_ot_recv, base_ot_send
from apsu_tpu_torch.mpc.duplex import Duplex
from apsu_tpu_torch.mpc.prg import mmo_hash, mmo_hash_indexed, prg_bits

KAPPA = 128
_log = logging.getLogger("apsu_tpu_torch")


def _cols_to_blocks(mat_bits: np.ndarray) -> np.ndarray:
    """[κ, m] bit matrix -> per-column 16-byte blocks [m, κ/8]."""
    return np.packbits(mat_bits.T, axis=-1, bitorder="little")


def iknp_send(ch: Duplex, m: int, rng):
    """Random-OT sender: returns pads (y0, y1), each [m, 16] uint8."""
    s = rng.integers(0, 2, size=KAPPA).astype(np.uint8)
    ks = base_ot_recv(ch, s, rng)                      # [κ, 16]
    u = ch.recv()                                      # [κ, m] bits uint8
    q = np.empty((KAPPA, m), dtype=np.uint8)
    for i in range(KAPPA):
        q[i] = prg_bits(ks[i].tobytes(), m)
        if s[i]:
            q[i] ^= u[i]
    qb = _cols_to_blocks(q)                            # [m, 16]
    sb = np.packbits(s, bitorder="little")             # [16]
    y0 = mmo_hash_indexed(qb)
    y1 = mmo_hash_indexed(qb ^ sb[None, :])
    return y0, y1


def iknp_recv(ch: Duplex, choices: np.ndarray, rng):
    """Random-OT receiver: returns pads y_{c_j} [m, 16] uint8."""
    r = np.asarray(choices, dtype=np.uint8)
    m = len(r)
    k0, k1 = base_ot_send(ch, KAPPA, rng)              # [κ, 16] each
    t0 = np.empty((KAPPA, m), dtype=np.uint8)
    u = np.empty((KAPPA, m), dtype=np.uint8)
    for i in range(KAPPA):
        t0[i] = prg_bits(k0[i].tobytes(), m)
        u[i] = t0[i] ^ prg_bits(k1[i].tobytes(), m) ^ r
    ch.send(u)
    return mmo_hash_indexed(_cols_to_blocks(t0))


def _flavor(m: int):
    """Extension flavour by batch size — a pure function of m so both
    parties pick the same one.  SoftSpoken's GGM setup costs a flat ~4 KB and
    2^k/k PRG expansions per virtual row, so small batches stay on IKNP and
    large ones trade compute for a k-fold cut of the correction matrix.  From
    2^19 OTs the silent extension wins: its bandwidth is a fixed LPN setup
    plus one derandomization bit per OT."""
    if m >= 1 << 19:
        return ("silent", 0)
    if m < 1024:
        return ("iknp", 0)
    if m < 16384:
        return ("softspoken", 4)
    return ("softspoken", 8)


def ot_ext_send(ch: Duplex, m: int, rng):
    """Random-OT sender with size-dispatched flavour: returns (y0, y1)."""
    name, k = _flavor(m)
    _log.debug("OT extension: %d OTs, %s k=%d (sender)", m, name, k)
    if name == "iknp":
        return iknp_send(ch, m, rng)
    if name == "silent":
        from apsu_tpu_torch.mpc.silent import silent_send

        return silent_send(ch, m, rng)
    from apsu_tpu_torch.mpc.softspoken import softspoken_send

    return softspoken_send(ch, m, rng, k=k)


def ot_ext_recv(ch: Duplex, choices: np.ndarray, rng):
    """Random-OT receiver with size-dispatched flavour: returns y_{c_j}."""
    name, k = _flavor(len(choices))
    _log.debug("OT extension: %d OTs, %s k=%d (receiver)", len(choices), name, k)
    if name == "iknp":
        return iknp_recv(ch, choices, rng)
    if name == "silent":
        from apsu_tpu_torch.mpc.silent import silent_recv

        return silent_recv(ch, choices, rng)
    from apsu_tpu_torch.mpc.softspoken import softspoken_recv

    return softspoken_recv(ch, choices, rng, k=k)


def expand_pad(pads: np.ndarray, nbytes: int) -> np.ndarray:
    """[m, 16] OT pads -> [m, nbytes] keystream via counter-tweaked MMO
    (OT messages of any width)."""
    if nbytes == 16:
        return pads
    blocks = [mmo_hash(pads, tweak=0xE100 + i) for i in range((nbytes + 15) // 16)]
    return np.concatenate(blocks, axis=1)[:, :nbytes]


def ot_send_chosen(ch: Duplex, m0: np.ndarray, m1: np.ndarray, rng) -> None:
    """Chosen-message OT sender: m0/m1 [m, W] uint8 (any width W)."""
    y0, y1 = ot_ext_send(ch, m0.shape[0], rng)
    W = m0.shape[1]
    ch.send(
        np.concatenate([m0 ^ expand_pad(y0, W), m1 ^ expand_pad(y1, W)], axis=1)
    )


def ot_recv_chosen(ch: Duplex, choices: np.ndarray, rng) -> np.ndarray:
    """Chosen-message OT receiver -> m_{c_j} [m, W] uint8."""
    y = ot_ext_recv(ch, choices, rng)
    e = ch.recv()
    W = e.shape[1] // 2
    c = np.asarray(choices, dtype=bool)
    pick = np.where(c[:, None], e[:, W:], e[:, :W])
    return pick ^ expand_pad(y, W)


def ot_send_onesided(ch: Duplex, m1: np.ndarray, rng) -> None:
    """One-sided OT: only the c=1 message exists; c=0 receivers learn
    nothing."""
    _, y1 = ot_ext_send(ch, m1.shape[0], rng)
    ch.send(m1 ^ expand_pad(y1, m1.shape[1]))


def ot_recv_onesided(ch: Duplex, choices: np.ndarray, rng) -> np.ndarray:
    """Returns m1 for rows with c=1 (other rows hold garbage)."""
    y = ot_ext_recv(ch, choices, rng)
    e = ch.recv()
    return e ^ expand_pad(y, e.shape[1])
