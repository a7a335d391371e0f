"""The PSU endgame: permuted equality test + oblivious transfer of X∖Y (port
of ``apsu_tpu/mpc/endgame.py``).

After decryption both parties hold a [C, S] matrix of per-(cache, slot) felt
blocks; a permuted PEQT tells the DB party which (permuted) columns matched
and the query party learns the permutation; a chosen-message OT then
transfers exactly the non-matching items.  CARD/CARDSUM transfer additively
masked values instead, so the DB party learns only |X∖Y| and the sum of the
values over X∖Y.

Role naming trap: the PEQT *sender* here is the PSU *query* party (it holds
the decrypted matrix and the items), the PEQT *receiver* is the DB party.
"""

from __future__ import annotations

import numpy as np

from apsu_tpu_torch.hash.encoding import items_from_felts
from apsu_tpu_torch.mpc.duplex import Duplex
from apsu_tpu_torch.mpc.osn_peqt import osn_peqt_db_side, osn_peqt_query_side
from apsu_tpu_torch.mpc.otext import ot_recv_chosen, ot_send_chosen
from apsu_tpu_torch.mpc.peqt import ddh_peqt_receiver, ddh_peqt_sender

# OT messages carry an explicit one-byte validity flag (1 = real item,
# 0 = empty slot / matched dummy) ahead of the payload, so no payload value
# is reserved in band: any item and any payload width transfer faithfully.
_VALID, _EMPTY = 1, 0


def felts_to_blocks(felt_matrix: np.ndarray, bits_per_felt: int) -> np.ndarray:
    """[C, S, fpi] felts -> [C, S, 16] uint8 blocks (both parties identical)."""
    C, S, fpi = felt_matrix.shape
    items = items_from_felts(
        felt_matrix.reshape(C * S, fpi).astype(np.uint32), bits_per_felt
    )  # [C*S, 2] uint64
    return items.view(np.uint8).reshape(C, S, 16)


def endgame_query_side(
    ch: Duplex,
    decrypted_blocks: np.ndarray,   # [C, S, 16]
    item_bytes_by_slot: np.ndarray,  # [S, 16] original items (junk at empties)
    filled: np.ndarray,             # [S] bool
    rng: np.random.Generator,
    peqt: str = "ddh",
) -> None:
    """PEQT sender + OT sender: transfers non-matching, filled items.
    peqt: "ddh" (EC-based) or "osn" (Benes switching network, the
    reference's default variant)."""
    if peqt == "osn":
        perm = osn_peqt_query_side(ch, decrypted_blocks, rng)
    else:
        perm = ddh_peqt_sender(ch, decrypted_blocks, rng)
    payload = item_bytes_by_slot[perm]
    msgs = np.zeros((payload.shape[0], payload.shape[1] + 1), dtype=np.uint8)
    msgs[:, 0] = np.where(filled[perm], _VALID, _EMPTY)
    msgs[:, 1:] = payload
    msgs[~filled[perm], 1:] = 0
    dummy = np.zeros(msgs.shape, dtype=np.uint8)  # flag byte = _EMPTY
    # receiver chooses c=1 where matched -> gets dummy; c=0 -> gets the item
    ot_send_chosen(ch, msgs, dummy, rng)


def endgame_db_side(
    ch: Duplex,
    mask_blocks: np.ndarray,        # [C, S, 16]
    rng: np.random.Generator,
    peqt: str = "ddh",
) -> np.ndarray:
    """PEQT receiver + OT receiver: returns transferred payloads [k, 16]
    uint8 (the 16-byte messages of the non-matching, filled columns)."""
    if peqt == "osn":
        matched = osn_peqt_db_side(ch, mask_blocks, rng)
    else:
        matched = ddh_peqt_receiver(ch, mask_blocks, rng)
    got = ot_recv_chosen(ch, matched.astype(np.uint8), rng)
    keep = ~matched & (got[:, 0] == _VALID)
    return np.ascontiguousarray(got[keep, 1:])


def cardsum_query_side(
    ch: Duplex,
    decrypted_blocks: np.ndarray,   # [C, S, 16]
    values_by_slot: np.ndarray,     # [S] uint64 associated values (0 at empties)
    filled: np.ndarray,             # [S] bool
    rng: np.random.Generator,
    peqt: str = "ddh",
) -> None:
    """CARD/CARDSUM endgame, query side: transfers additively-masked values so the DB
    party learns only |X∖Y| and Σ values over X∖Y."""
    if peqt == "osn":
        perm = osn_peqt_query_side(ch, decrypted_blocks, rng)
    else:
        perm = ddh_peqt_sender(ch, decrypted_blocks, rng)
    S = len(perm)
    r = rng.integers(0, 1 << 63, size=S, dtype=np.uint64)
    vals = values_by_slot[perm].astype(np.uint64)
    with np.errstate(over="ignore"):
        m0 = _u64_to_blocks(vals + r)          # not matched -> value + mask
    m1 = _u64_to_blocks(r)                      # matched -> mask only
    ot_send_chosen(ch, m0, m1, rng)
    with np.errstate(over="ignore"):
        total_mask = np.sum(r, dtype=np.uint64)
    ch.send(np.array([total_mask, np.uint64(int(np.sum(filled)))], dtype=np.uint64))


def cardsum_db_side(
    ch: Duplex,
    mask_blocks: np.ndarray,        # [C, S, 16]
    rng: np.random.Generator,
    peqt: str = "ddh",
):
    """Returns (cardinality_of_difference, value_sum_of_difference)."""
    if peqt == "osn":
        matched = osn_peqt_db_side(ch, mask_blocks, rng)
    else:
        matched = ddh_peqt_receiver(ch, mask_blocks, rng)
    got = ot_recv_chosen(ch, matched.astype(np.uint8), rng)
    rec = ch.recv()
    total_mask, n_filled = np.uint64(rec[0]), int(rec[1])
    with np.errstate(over="ignore"):
        s = np.sum(_blocks_to_u64(got), dtype=np.uint64) - total_mask
    card = n_filled - int(np.sum(matched))
    return card, int(s)


def _u64_to_blocks(v: np.ndarray) -> np.ndarray:
    out = np.zeros((len(v), 16), dtype=np.uint8)
    out[:, :8] = v.astype(np.uint64).view(np.uint8).reshape(-1, 8)
    return out


def _blocks_to_u64(b: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(b[:, :8]).view(np.uint64).reshape(-1)
