"""Silent OT extension: pseudorandom-correlation OT with ~0 per-OT bandwidth
(port of ``apsu_tpu/mpc/silent.py``).

Instead of streaming a correction matrix that grows with the OT count (IKNP 16 B/OT, SoftSpoken
κ/8k B/OT), the parties expand a SHORT correlated seed into n random OTs
locally — communication is O(t·log n) regardless of n.

Construction (semi-honest, Ferret-style — eprint 2020/924 pattern):

1. **Base COTs**: kb correlated OTs q_b = v_b ⊕ x_b·Δ from SoftSpoken's
   pre-hash state (softspoken_{send,recv}(raw=True); Δ = the extension
   sender's secret chunk indices).
2. **MPCOT** (regular noise): t GGM trees of nb = n/t leaves each.  The
   sender expands each tree fully; the receiver punctures it at a random
   α_τ via one chosen-message OT per level (message = the level's
   left/right aggregate, choice = complement of α's path bit) — all t·D
   level OTs ride ONE batched chosen-OT call.  ψ_τ = Δ ⊕ (⊕_j v_τj) lets
   the receiver finish w_τα = ψ_τ ⊕ ⊕_{j≠α} w_τj, so over the
   concatenation w = v ⊕ e·Δ with e the t-regular noise vector known to
   the receiver.
3. **LPN compression** (primal, regular noise): public sparse mixing
   indices S_j (d per output, derived from a protocol seed — both parties
   generate the identical matrix):
       x'_j = (⊕_{b∈S_j} x_b) ⊕ e_j        (pseudorandom under LPN)
       w'_j = (⊕_{b∈S_j} v_base_b) ⊕ w_j = v'_j ⊕ x'_j·Δ
4. **Hashing**: y0 = H(v'), y1 = H(v' ⊕ Δ); the receiver holds y_{x'}.
   A packed derandomization message (1 bit/OT) converts the random
   choices x' into the caller's chosen bits.

Parameters are conservative regular-LPN settings (t capped at 1344, the
Ferret large-regime weight; kb = n/16 base COTs; d = 11 mixing weight).
The fixed-cost setup means silent only BEATS SoftSpoken's 2 B/OT above
~2^19 OTs — otext's size dispatch selects it there (measured table in the
module tests / README).  The LPN mixing indices come from a seeded
deterministic generator, so both parties must run the same numpy
generation (protocol constant, like the cuckoo hash family).
"""

from __future__ import annotations

import numpy as np

from apsu_tpu_torch.mpc.duplex import Duplex
from apsu_tpu_torch.mpc.otext import ot_recv_chosen, ot_send_chosen
from apsu_tpu_torch.mpc.prg import mmo_hash_indexed
from apsu_tpu_torch.mpc.softspoken import (
    _ggm_expand_level,
    softspoken_recv,
    softspoken_send,
)

# tweak range distinct from softspoken's 0xB2xx level keys: silent trees
# reuse _ggm_expand_level's 0xB0/0xB1 child derivation (independent roots)


def silent_params(m: int):
    """(n, kb, t, d): LPN output/base/noise-weight/mixing-weight for m OTs."""
    n = 1 << max(14, (m - 1).bit_length())
    t = int(min(1344, max(256, n >> 7)))
    # regular noise needs nb = n/t a power of two: round t down
    while n % t or (n // t) & ((n // t) - 1):
        t -= 1
    kb = max(2048, n >> 4)
    return n, kb, t, 11


def _lpn_indices(n: int, kb: int, d: int) -> np.ndarray:
    """[n, d] public mixing indices from a protocol-constant seed."""
    g = np.random.Generator(
        np.random.Philox(key=[0xA95117 ^ (n << 32), kb ^ (d << 48)])
    )
    return g.integers(0, kb, size=(n, d), dtype=np.int64)


def _xor_gather(base: np.ndarray, idx: np.ndarray) -> np.ndarray:
    """[kb, 16] blocks XOR-gathered by [n, d] indices -> [n, 16]."""
    return np.bitwise_xor.reduce(base[idx], axis=1)


def silent_send(ch: Duplex, m: int, rng: np.random.Generator):
    """Random-OT sender: returns (y0, y1) [m, 16] with the receiver's
    choices DERANDOMIZED to its requested bits (flip message)."""
    n, kb, t, d = silent_params(m)
    nb = n // t
    D = nb.bit_length() - 1

    # 1. base COTs: q_b = v_b ⊕ x_b·Δ (we hold q, Δ)
    q_base, delta = softspoken_send(ch, kb, rng, k=8, raw=True)

    # 2. MPCOT sender: expand t trees, serve level aggregates via one
    # batched chosen OT, send ψ
    nodes = rng.integers(0, 256, size=(t, 1, 16), dtype=np.uint8)
    m0 = np.empty((t, D, 16), dtype=np.uint8)
    m1 = np.empty((t, D, 16), dtype=np.uint8)
    for dep in range(D):
        nodes = _ggm_expand_level(nodes, dep)
        m0[:, dep] = np.bitwise_xor.reduce(nodes[:, 0::2], axis=1)
        m1[:, dep] = np.bitwise_xor.reduce(nodes[:, 1::2], axis=1)
    ot_send_chosen(ch, m0.reshape(t * D, 16), m1.reshape(t * D, 16), rng)
    v_mp = nodes.reshape(n, 16)                       # [n, 16] leaves
    psi = delta[None, :] ^ np.bitwise_xor.reduce(
        v_mp.reshape(t, nb, 16), axis=1
    )
    ch.send(psi)

    # 3. LPN mix + 4. hash
    idx = _lpn_indices(n, kb, d)
    v_out = (_xor_gather(q_base, idx) ^ v_mp)[:m]
    y0 = mmo_hash_indexed(v_out)
    y1 = mmo_hash_indexed(v_out ^ delta[None, :])
    flip = np.unpackbits(ch.recv(), bitorder="little", count=m).astype(bool)
    y0f = np.where(flip[:, None], y1, y0)
    y1f = np.where(flip[:, None], y0, y1)
    return y0f, y1f


def silent_recv(ch: Duplex, choices: np.ndarray, rng: np.random.Generator):
    """Random-OT receiver: returns y_{c_j} [m, 16] for the given choices."""
    c = np.asarray(choices, dtype=np.uint8)
    m = len(c)
    n, kb, t, d = silent_params(m)
    nb = n // t
    D = nb.bit_length() - 1

    # 1. base COTs with random choice bits: v_b = q_b ⊕ x_b·Δ
    x_base = rng.integers(0, 2, size=kb).astype(np.uint8)
    v_base = softspoken_recv(ch, x_base, rng, k=8, raw=True)

    # 2. MPCOT receiver: puncture each tree at a random α via the level
    # OTs (choice = complement path bit), reconstruct all other leaves
    alpha = rng.integers(0, nb, size=t).astype(np.int64)
    path_bits = ((alpha[:, None] >> (D - 1 - np.arange(D))[None, :]) & 1).astype(
        np.uint8
    )  # [t, D] MSB-first
    aggs = ot_recv_chosen(ch, (1 - path_bits).reshape(-1), rng).reshape(
        t, D, 16
    )
    nodes = np.zeros((t, 1, 16), dtype=np.uint8)
    hole = np.zeros(t, dtype=np.int64)
    tidx = np.arange(t)
    for dep in range(D):
        nodes = _ggm_expand_level(nodes, dep)  # hole children are garbage
        b_off = 1 - path_bits[:, dep]
        nodes[tidx, 2 * hole] = 0
        nodes[tidx, 2 * hole + 1] = 0
        pairs = nodes.reshape(t, -1, 2, 16)
        side = np.where(
            (b_off == 1)[:, None, None], pairs[:, :, 1, :], pairs[:, :, 0, :]
        )
        known = np.bitwise_xor.reduce(side, axis=1)
        nodes[tidx, 2 * hole + b_off] = aggs[:, dep] ^ known
        hole = 2 * hole + path_bits[:, dep]
    psi = ch.recv()                                   # [t, 16]
    w_tree = nodes                                    # [t, nb, 16], hole rows 0
    w_hole = psi ^ np.bitwise_xor.reduce(w_tree, axis=1)
    w_tree[tidx, hole] = w_hole
    w_mp = w_tree.reshape(n, 16)

    # 3. LPN mix: choices x' and pads w'
    idx = _lpn_indices(n, kb, d)
    e = np.zeros(n, dtype=np.uint8)
    e[np.arange(t) * nb + alpha] = 1
    x_out = (np.bitwise_xor.reduce(x_base[idx], axis=1) ^ e)[:m]
    w_out = (_xor_gather(v_base, idx) ^ w_mp)[:m]
    y = mmo_hash_indexed(w_out)

    # 4. derandomize to the caller's chosen bits
    ch.send(np.packbits(x_out ^ c, bitorder="little"))
    return y
