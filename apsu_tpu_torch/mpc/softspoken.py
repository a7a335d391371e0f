"""SoftSpoken OT extension (Roy, CRYPTO 2022) — k-bit chunked IKNP (port
of ``apsu_tpu/mpc/softspoken.py``).

The IKNP receiver's correction matrix costs κ = 128 bits per OT; SoftSpoken with chunk size k
costs κ/k bits per OT (k=8 → 2 bytes/OT) at the price of 2^k/2 PRG
expansions per virtual row — a pure bandwidth/compute dial.

Construction (semi-honest). The κ IKNP rows are grouped into nc = κ/k
chunks.  Per chunk the receiver R (who holds the choice bits r) builds a
GGM tree of 2^k leaf seeds; the sender S holds a secret k-bit index x_c and
learns ALL leaves EXCEPT leaf x_c (punctured tree: one base OT per level on
the complement path bit + two 16-byte level-aggregate ciphertexts).  With
t_j = PRG(leaf_j, m):

  R sends   u_c = r ⊕ (⊕_j t_j)                        (m bits per CHUNK)
  R's rows  v_{c,l} = ⊕_{j : bit_l(j)=1} t_j
  S's rows  q_{c,l} = (⊕_{j : bit_l(j)≠bit_l(x_c)} t_j) ⊕ bit_l(x_c)·u_c

which satisfies q = v ⊕ x_bit·r — exactly the IKNP row correlation, with
S's secret bit-vector the concatenated x_c bits.  (u_c is one-time-padded
by the one leaf t_{x_c} that S cannot expand.)  Column hashing then
proceeds identically to otext.iknp_* (per-instance MMO), so the output
pads are drop-in interchangeable with IKNP's.

All tree levels are expanded with the fixed-key MMO hash batched across
every chunk (one AES-ECB C call per level); leaf → m-bit expansions are
AES-CTR (one C call per leaf).
"""

from __future__ import annotations

import numpy as np

from apsu_tpu_torch.mpc.baseot import base_ot_recv, base_ot_send
from apsu_tpu_torch.mpc.duplex import Duplex
from apsu_tpu_torch.mpc.otext import _cols_to_blocks
from apsu_tpu_torch.mpc.prg import mmo_hash, mmo_hash_indexed, prg_bytes

KAPPA = 128

# tweak bases for GGM child derivation and level-key encryption (distinct
# from the 0xE1xx range used by otext.expand_pad)
_TW_LEFT = 0xB0000000
_TW_RIGHT = 0xB1000000
_TW_LVLKEY = 0xB2000000


def _ggm_expand_level(nodes: np.ndarray, depth: int) -> np.ndarray:
    """[C, 2^d, 16] -> [C, 2^(d+1), 16]: children via fixed-key MMO with
    per-depth tweaks; one AES call per (side, depth) across all chunks."""
    C, w, _ = nodes.shape
    flat = nodes.reshape(C * w, 16)
    left = mmo_hash(flat, tweak=_TW_LEFT + depth)
    right = mmo_hash(flat, tweak=_TW_RIGHT + depth)
    out = np.empty((C * w, 2, 16), dtype=np.uint8)
    out[:, 0] = left
    out[:, 1] = right
    return out.reshape(C, 2 * w, 16)


def _leaf_rows(leaves: np.ndarray, mbytes: int) -> np.ndarray:
    """[W, 16] leaf seeds -> [W, mbytes] PRG rows (packed bits)."""
    out = np.empty((leaves.shape[0], mbytes), dtype=np.uint8)
    for j in range(leaves.shape[0]):
        out[j] = prg_bytes(leaves[j].tobytes(), mbytes)
    return out


def _bit_sel(k: int) -> np.ndarray:
    """[2^k, k] bool: bit l of leaf index j (little-endian)."""
    j = np.arange(1 << k, dtype=np.uint32)
    return ((j[:, None] >> np.arange(k)[None, :]) & 1).astype(bool)


def softspoken_recv(
    ch: Duplex, choices: np.ndarray, rng: np.random.Generator, k: int = 8,
    raw: bool = False,
):
    """Random-OT receiver (extension receiver R): returns pads y_{c_j}
    [m, 16] uint8.  Counterpart of otext.iknp_recv.

    raw=True returns the PRE-HASH column blocks v [m, 16] instead — the
    receiver side of the correlated-OT relation q_j = v_j ⊕ c_j·Δ that the
    silent extension (mpc/silent.py) consumes as its base COTs."""
    assert KAPPA % k == 0
    r = np.asarray(choices, dtype=np.uint8)
    m = len(r)
    nc = KAPPA // k
    mbytes = (m + 7) // 8

    # GGM trees: one root per chunk, expanded level-by-level (batched)
    nodes = rng.integers(0, 256, size=(nc, 1, 16), dtype=np.uint8)
    lvl_keys = np.empty((nc, k, 2, 16), dtype=np.uint8)  # K_d^b aggregates
    for d in range(k):
        nodes = _ggm_expand_level(nodes, d)
        lvl_keys[:, d, 0] = np.bitwise_xor.reduce(nodes[:, 0::2], axis=1)
        lvl_keys[:, d, 1] = np.bitwise_xor.reduce(nodes[:, 1::2], axis=1)

    # base OTs deliver one pad per (chunk, depth); S's choice bit is the
    # complement path bit.  Encrypt both level aggregates under the pads.
    k0, k1 = base_ot_send(ch, nc * k, rng)  # [nc*k, 16] each
    pads = np.stack([k0, k1], axis=1).reshape(nc, k, 2, 16)
    e_lvl = np.empty_like(lvl_keys)
    for d in range(k):
        for b in range(2):
            e_lvl[:, d, b] = lvl_keys[:, d, b] ^ mmo_hash(
                pads[:, d, b], tweak=_TW_LVLKEY + 2 * d + b
            )
    ch.send(e_lvl)

    # leaf expansion + aggregation
    rp = np.packbits(r, bitorder="little")  # exactly mbytes long
    sel = _bit_sel(k)  # [2^k, k]
    v = np.empty((KAPPA, mbytes), dtype=np.uint8)
    u = np.empty((nc, mbytes), dtype=np.uint8)
    for c in range(nc):
        t = _leaf_rows(nodes[c], mbytes)  # [2^k, mbytes]
        u[c] = np.bitwise_xor.reduce(t, axis=0) ^ rp
        for l in range(k):
            v[c * k + l] = np.bitwise_xor.reduce(t[sel[:, l]], axis=0)
    ch.send(u)

    vbits = np.unpackbits(v, axis=-1, bitorder="little", count=m)
    vb = _cols_to_blocks(vbits)
    return vb if raw else mmo_hash_indexed(vb)


def softspoken_send(ch: Duplex, m: int, rng: np.random.Generator, k: int = 8,
                    raw: bool = False):
    """Random-OT sender (extension sender S): returns (y0, y1) [m, 16].
    Counterpart of otext.iknp_send.

    raw=True returns (q [m, 16], Δ [16]) — the sender side of the COT
    relation q_j = v_j ⊕ c_j·Δ, for mpc/silent.py's base COTs."""
    assert KAPPA % k == 0
    nc = KAPPA // k
    mbytes = (m + 7) // 8

    # secret chunk indices; base-OT choice at depth d = complement path bit
    x = rng.integers(0, 1 << k, size=nc).astype(np.int64)
    # path bit at depth d is bit (k-1-d) of x (MSB-first tree descent)
    path_bits = ((x[:, None] >> (k - 1 - np.arange(k))[None, :]) & 1).astype(
        np.uint8
    )  # [nc, k]
    kx = base_ot_recv(ch, (1 - path_bits).reshape(-1), rng).reshape(nc, k, 16)
    e_lvl = ch.recv()  # [nc, k, 2, 16]

    # punctured-tree reconstruction, batched across chunks: after depth d we
    # know every node except the on-path one (hole_c = x >> (k-d) bits)
    nodes = np.zeros((nc, 1, 16), dtype=np.uint8)  # root unknown (hole)
    hole = np.zeros(nc, dtype=np.int64)
    cidx = np.arange(nc)
    for d in range(k):
        nodes = _ggm_expand_level(nodes, d)  # holes expand to garbage
        b_off = 1 - path_bits[:, d]  # off-path branch bit
        h0 = mmo_hash(kx[:, d], tweak=_TW_LVLKEY + 2 * d + 0)
        h1 = mmo_hash(kx[:, d], tweak=_TW_LVLKEY + 2 * d + 1)
        key = e_lvl[cidx, d, b_off] ^ np.where((b_off == 1)[:, None], h1, h0)
        # zero the two children of the hole (unknown), then the off-path
        # sibling = K_d^{b_off} ⊕ (xor of known nodes on that branch side)
        nodes[cidx, 2 * hole] = 0
        nodes[cidx, 2 * hole + 1] = 0
        pairs = nodes.reshape(nc, -1, 2, 16)
        side = np.where(
            (b_off == 1)[:, None, None], pairs[:, :, 1, :], pairs[:, :, 0, :]
        )
        agg = np.bitwise_xor.reduce(side, axis=1)
        nodes[cidx, 2 * hole + b_off] = key ^ agg
        hole = 2 * hole + path_bits[:, d]

    u = ch.recv()  # [nc, mbytes]
    sel = _bit_sel(k)
    xbits_le = ((x[:, None] >> np.arange(k)[None, :]) & 1).astype(bool)  # [nc, k]
    q = np.empty((KAPPA, mbytes), dtype=np.uint8)
    for c in range(nc):
        t = _leaf_rows(nodes[c], mbytes)
        t[hole[c]] = 0  # the punctured leaf is unknown; coefficient is 0
        for l in range(k):
            # B_l = ⊕ over leaves whose bit l differs from x's bit l
            mask = sel[:, l] != xbits_le[c, l]
            row = np.bitwise_xor.reduce(t[mask], axis=0)
            if xbits_le[c, l]:
                row = row ^ u[c]
            q[c * k + l] = row

    qbits = np.unpackbits(q, axis=-1, bitorder="little", count=m)
    qb = _cols_to_blocks(qbits)
    # s-bit vector = concatenated little-endian x bits, packed per column
    sbits = xbits_le.reshape(-1).astype(np.uint8)
    sb = np.packbits(sbits, bitorder="little")
    if raw:
        return qb, sb
    y0 = mmo_hash_indexed(qb)
    y1 = mmo_hash_indexed(qb ^ sb[None, :])
    return y0, y1
