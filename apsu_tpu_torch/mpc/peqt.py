"""Permuted private equality test, DDH variant (port of
``apsu_tpu/mpc/peqt.py``).

The behaviour of Kunlun's ``DDHPEQT``: both parties hold a [C, S] matrix of 128-bit blocks; the test reports, under a
column permutation π chosen by the PEQT *sender*, whether entries agree.
Like Kunlun's test the sender shuffles BOTH axes:
π over columns plus an independent row permutation σ_j per output column,
so the receiver learns only "some row of permuted column j matched" — never
which cache row.  The sender learns π and nothing else.

Exponentiations run on the native Edwards25519 batch library; for m = C·S
entries the cost is 3m scalar mults sender-side + 2m receiver-side.
"""

from __future__ import annotations

import numpy as np

from apsu_tpu_torch.mpc import ec
from apsu_tpu_torch.mpc.duplex import Duplex


def _blocks_to_seeds(blocks: np.ndarray) -> np.ndarray:
    """[C, S, 16]-byte blocks -> [C*S, 32] hash seeds."""
    b = np.ascontiguousarray(blocks, dtype=np.uint8).reshape(-1, 16)
    return np.concatenate([b, b ^ np.uint8(0x5A)], axis=1)


def ddh_peqt_sender(
    ch: Duplex, blocks: np.ndarray, rng: np.random.Generator
) -> np.ndarray:
    """blocks: [C, S, 16] uint8.  Returns the column permutation π (the
    receiver's reported column j corresponds to our column π[j])."""
    C, S, _ = blocks.shape
    perm = rng.permutation(S)
    # independent row shuffle per output column: σ_j (rows and columns are
    # both permuted)
    row_perms = np.stack([rng.permutation(C) for _ in range(S)])  # [S, C]
    rows = row_perms.T                                            # [C, S]
    cols = np.broadcast_to(np.arange(S), (C, S))
    k = ec.random_scalars(1, rng)[0]
    kb_all = ec.scalars_to_bytes([k] * (C * S))

    # our own values: Z[c, j] = k·H(block[σ_j(c), π(j)])
    permuted = blocks[:, perm, :][rows, cols]
    P = ec.hash_to_point(_blocks_to_seeds(permuted))
    Z = ec.scalar_mult(P, kb_all)

    # receiver's masked values: Y[c, j] = k·X[σ_j(c), π(j)]
    X = ch.recv().reshape(C, S, 32)
    Xp = np.ascontiguousarray(X[:, perm, :][rows, cols]).reshape(-1, 32)
    Y = ec.scalar_mult(Xp, kb_all)

    ch.send(np.concatenate([Y, Z], axis=0))
    return perm


def ddh_peqt_receiver(
    ch: Duplex, blocks: np.ndarray, rng: np.random.Generator,
    return_rows: bool = False,
) -> np.ndarray:
    """blocks: [C, S, 16] uint8.  Returns matched [S] bool in PERMUTED column
    order (True where some row of the permuted column pair agrees).  The row
    axis of the internal eq matrix is shuffled per column by the sender's
    σ_j, so nothing beyond the any() is learnable; return_rows=True exposes
    the raw [C, S] view for leakage tests only."""
    C, S, _ = blocks.shape
    m = C * S
    r = ec.random_scalars(1, rng)[0]
    rb = ec.scalars_to_bytes([r] * m)
    rinv = ec.scalars_to_bytes([pow(r, -1, ec.ORDER)] * m)

    P = ec.hash_to_point(_blocks_to_seeds(blocks))
    ch.send(ec.scalar_mult(P, rb))              # X = r·H(our blocks)

    YZ = ch.recv()
    Y, Z = YZ[:m], YZ[m:]
    W = ec.scalar_mult(Y, rinv)                 # k·H(our block at σ_j, π(j))
    eq = np.all(W == Z, axis=1).reshape(C, S)
    if return_rows:
        return eq
    return eq.any(axis=0)
