"""OSN-based permuted equality test, the default PEQT variant (port of
``apsu_tpu/mpc/osn_peqt.py``).

The query
party programs a structured (row×column) permutation into a Benes OSN over
the flattened [C, S] block matrix held by the DB party; the parties end with
XOR shares of the permuted mask matrix; the query party folds in its own
(identically permuted) decrypted matrix so the shares become equal exactly
at matching entries; a multi-point OPRF digest comparison (Kunlun OTE-OPRF
role, here the KKRT engine with one instance per position) reveals per-entry
matches to the DB party only, in permuted coordinates.

The column permutation is recoverable by construction (π on columns, fresh
σ_j on rows within each column — apsu_OSNSender.cpp:218-277's structured
permutation); the DB party therefore learns column match flags in permuted
order, the query party learns π: identical interface to the DDH variant.
"""

from __future__ import annotations

import numpy as np

from apsu_tpu_torch.mpc.duplex import Duplex
from apsu_tpu_torch.mpc.kkrt import KkrtReceiver, KkrtSender
from apsu_tpu_torch.mpc.osn import osn_holder, osn_programmer


def _structured_perm(C: int, S: int, rng: np.random.Generator):
    """Returns (flat_perm [C·S] with perm[out]=in, col_perm [S])."""
    col_perm = rng.permutation(S)
    row_perms = np.stack([rng.permutation(C) for _ in range(S)])  # σ_j per out-col
    out_c, out_j = np.meshgrid(np.arange(C), np.arange(S), indexing="ij")
    in_c = row_perms[out_j, out_c]
    in_j = col_perm[out_j]
    perm = (in_c * S + in_j).reshape(-1)
    return perm.astype(np.int64), col_perm, row_perms


def osn_peqt_query_side(
    ch: Duplex, blocks: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    """Query party: blocks [C, S, 16] decrypted matrix.  Returns the column
    permutation π (DB-reported column j ↔ our column π[j])."""
    C, S, _ = blocks.shape
    perm, col_perm, row_perms = _structured_perm(C, S, rng)
    share = osn_programmer(ch, perm, rng)              # [C·S, 16]
    own_permuted = blocks.reshape(C * S, 16)[perm]
    w = share ^ own_permuted
    # multi-point OPRF: we hold the key, send digests of our shares
    kk = KkrtSender(ch, C * S, rng)
    digests = kk.eval(
        np.ascontiguousarray(w).view(np.uint64).reshape(-1, 2), np.arange(C * S)
    )
    ch.send(np.ascontiguousarray(digests))
    return col_perm


def osn_peqt_db_side(
    ch: Duplex, blocks: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    """DB party: blocks [C, S, 16] mask matrix.  Returns matched [S] bool in
    PERMUTED column order."""
    C, S, _ = blocks.shape
    share = osn_holder(ch, blocks.reshape(C * S, 16), rng)  # [C·S, 16]
    kk = KkrtReceiver(
        ch, np.ascontiguousarray(share).view(np.uint64).reshape(-1, 2), rng
    )
    mine = kk.eval(
        np.ascontiguousarray(share).view(np.uint64).reshape(-1, 2),
        np.arange(C * S),
    )
    theirs = ch.recv()
    eq = np.all(mine == theirs, axis=1).reshape(C, S)
    return eq.any(axis=0)
