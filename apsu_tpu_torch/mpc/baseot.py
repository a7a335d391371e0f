"""Chou–Orlandi "Simplest OT" base oblivious transfers (port of
``apsu_tpu/mpc/baseot.py``).

The root of the OT-extension tree: n 1-out-of-2 OTs of 16-byte keys over the
native Edwards25519 batch library, semi-honest (no receiver proof).
"""

from __future__ import annotations

import hashlib

import numpy as np

from apsu_tpu_torch.mpc import ec
from apsu_tpu_torch.mpc.duplex import Duplex


def _key_from_points(points: np.ndarray, tag: bytes) -> np.ndarray:
    """[n, 32] points -> [n, 16] keys via per-index Blake2b."""
    out = np.empty((points.shape[0], 16), dtype=np.uint8)
    for i in range(points.shape[0]):
        h = hashlib.blake2b(
            tag + i.to_bytes(4, "little") + points[i].tobytes(), digest_size=16
        )
        out[i] = np.frombuffer(h.digest(), dtype=np.uint8)
    return out


def base_ot_send(ch: Duplex, n: int, rng):
    """Sender side: returns (k0, k1) key arrays [n, 16] uint8."""
    a = ec.random_scalars(1, rng)[0]
    ab = ec.scalars_to_bytes([a])
    A = ec.base_mult(ab)          # [1, 32]
    ch.send(A)
    B = ch.recv()                 # [n, 32]
    a_rep = ec.scalars_to_bytes([a] * n)
    aB = ec.scalar_mult(B, a_rep)
    aB_minus_aA = ec.scalar_mult(ec.point_sub(B, np.repeat(A, n, axis=0)), a_rep)
    k0 = _key_from_points(aB, b"co0")
    k1 = _key_from_points(aB_minus_aA, b"co0")  # same tag: keyed by point value
    return k0, k1


def base_ot_recv(ch: Duplex, choices: np.ndarray, rng):
    """Receiver side: choices [n] 0/1 -> keys k_{c_i} [n, 16] uint8."""
    n = len(choices)
    A = ch.recv()                 # [1, 32]
    b = ec.random_scalars(n, rng)
    bb = ec.scalars_to_bytes(b)
    B = ec.base_mult(bb)          # b_i·G
    A_rep = np.repeat(A, n, axis=0)
    B_choice = ec.point_add(B, A_rep)
    c = np.asarray(choices, dtype=bool)
    B_send = np.where(c[:, None], B_choice, B)
    ch.send(np.ascontiguousarray(B_send))
    bA = ec.scalar_mult(A_rep, bb)
    return _key_from_points(bA, b"co0")
