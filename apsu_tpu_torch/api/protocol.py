"""The in-process PSU protocol (port of ``run_psu`` and
``run_psu_mpc`` in ``apsu_tpu/api/protocol.py``).

Runs the whole pipeline with both parties in one process: cuckoo hashing →
slot-bound OPRF → encrypted query powers → homomorphic matching-polynomial
evaluation → decryption → equality test → transfer of the difference set.
``run_psu`` uses ``DebugOprf`` and ``DebugEndgame``, which computes the
equality test and the transfer in the clear; ``run_psu_mpc`` runs the real
protocol: the KKRT OPRF, a permuted equality test (DDH or OSN) and a
chosen-message OT, both parties as threads over an in-process duplex.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Dict, Optional

import numpy as np

from apsu_tpu_torch.api.parties import Receiver, Sender
from apsu_tpu_torch.api.session import run_db_party, run_query_party
from apsu_tpu_torch.core.params import PSUParams
from apsu_tpu_torch.db.receiver_db import ReceiverDB
from apsu_tpu_torch.mpc.duplex import pipe_pair
from apsu_tpu_torch.mpc.oprf import DebugOprf
from apsu_tpu_torch.mpc.prg import CsRng


class DebugEndgame:
    """Clear-text equality test + transfer: the receiver learns which table
    slots matched in some cache, the sender hands over every filled slot's
    item that did not."""

    def run(
        self,
        sender_blocks: np.ndarray,    # [C, S, fpi] decrypted result felts
        receiver_blocks: np.ndarray,  # [C, S, fpi] mask felts
        sender_items: np.ndarray,     # [S, 2] original items per slot (junk ok)
        sender_filled: np.ndarray,    # [S] bool
    ) -> np.ndarray:
        matched = (sender_blocks == receiver_blocks).all(axis=2).any(axis=0)  # [S]
        take = sender_filled & ~matched
        return sender_items[take]


@dataclass
class PsuResult:
    union: np.ndarray            # [m, 2] uint64: receiver items ∪ transferred
    transferred: np.ndarray      # [k, 2] items sent over (X \ Y)
    timings: Dict[str, float] = field(default_factory=dict)


def run_psu(
    params: PSUParams,
    sender_items: np.ndarray,
    receiver_items: np.ndarray,
    oprf_key: int = 0x5EED,
    sender: Optional[Sender] = None,
    receiver: Optional[Receiver] = None,
    device="cuda",
) -> PsuResult:
    """Full in-process PSU; returns the union as 128-bit item values.
    ``sender``/``receiver`` replace the parties built here (whose secrets
    come from OS entropy); ``device`` is where those parties compute."""
    timings: Dict[str, float] = {}
    oprf = DebugOprf(oprf_key)

    t0 = time.perf_counter()
    if receiver is None:
        db = ReceiverDB(params, oprf, device=device)
        db.set_data(receiver_items)
        receiver = Receiver(params, db)
    timings["db_build"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    if sender is None:
        sender = Sender(params, oprf, device=device)
    timings["sender_setup"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    req = sender.create_query(sender_items)
    timings["create_query"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    resp = receiver.run_query(req)
    timings["run_query"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    slot_matrix = sender.extract_matrix(resp)
    timings["decrypt"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    transferred = DebugEndgame().run(
        sender.peqt_matrix(slot_matrix),
        receiver.peqt_matrix(),
        sender.cuckoo.table,
        sender.cuckoo.filled,
    )
    timings["endgame"] = time.perf_counter() - t0

    union = np.unique(np.concatenate([receiver_items, transferred]), axis=0)
    return PsuResult(union=union, transferred=transferred, timings=timings)


def run_psu_mpc(
    params: PSUParams,
    sender_items: np.ndarray,
    receiver_items: np.ndarray,
    seed: int = 7,
    peqt: str = "ddh",
    device="cuda",
) -> PsuResult:
    """Full PSU with the real MPC stack — the interactive KKRT OPRF during
    the DB build, the permuted equality test ``peqt`` ("ddh" or "osn"), a
    chosen-message OT of the difference set — both parties as threads over
    one in-process duplex (the two-process deployment runs the same
    ``api.session`` flow over a socket).  Each party's secrets come from a
    CsRng keyed by ``seed``, as in the reference, so one seed gives one
    transcript in both packages.  A party that raises closes its end of the
    duplex, so the other stops at its next receive and the call raises the
    first error instead of hanging."""
    ch_q, ch_db = pipe_pair()
    timings: Dict[str, float] = {}
    out: Dict[str, np.ndarray] = {}
    errors = []

    def party(ch, fn):
        try:
            fn()
        except BaseException as e:
            errors.append(e)
            ch.close()

    def query_party():
        rng = CsRng(b"run_psu_mpc/query:%08d" % (seed,))
        run_query_party(ch_q, sender_items, rng, params=params, timings=timings,
                        peqt=peqt, device=device)

    def db_party():
        rng = CsRng(b"run_psu_mpc/db:%08d" % (seed,))
        out["transferred"] = run_db_party(ch_db, params, receiver_items, rng,
                                          timings=timings, device=device)

    tq = threading.Thread(target=party, args=(ch_q, query_party))
    tdb = threading.Thread(target=party, args=(ch_db, db_party))
    tq.start()
    tdb.start()
    tq.join()
    tdb.join()
    if errors:
        raise errors[0]
    transferred = np.ascontiguousarray(out["transferred"]).view(np.uint64).reshape(-1, 2)
    union = np.unique(np.concatenate([receiver_items, transferred]), axis=0)
    timings["bytes_on_wire"] = ch_q.bytes_sent + ch_db.bytes_sent
    return PsuResult(union=union, transferred=transferred, timings=timings)
