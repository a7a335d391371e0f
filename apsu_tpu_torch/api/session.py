"""Two-party PSU session: the typed wire flow of both parties (port of
``apsu_tpu/api/session.py``).

One function per party over a Duplex — an in-process pipe (``run_psu_mpc``)
or a TCP socket (the CLIs).  Every message is op-typed and versioned
(``net/wire.py``), and every frame is the reference's byte for byte, so a
port party and a reference party serve each other.  The sequence: params
handshake → interactive OPRF → encrypted query powers → result packages →
permuted equality test → chosen-OT transfer of X∖Y.

Wire compression: fresh symmetric query ciphertexts and relin keys travel
seed-compressed (c0 / ksk[:, 0] plus a 32-byte PRG seed); result ciphertexts
travel bit-packed at the residue entropy floor (``pack_residues``).  The
device crosses to the host at exactly three places: the query's c0, the
relinearization key, and the response.

Serve-loop mode (``serve_db_party`` with max_queries != 1): the DB party
keeps its cache resident on the device and answers successive queries.  The
fixed-key ECDH backend answers any number of queries from one resident
cache; the KKRT backend binds one correlation per query, so the client opens
a fresh correlation for each further query (``OP_REBIND``) and the DB party
derives only the OPRF-dependent tensors again from its retained placement
(``ReceiverDB.rebind``), after releasing the consumed cache.

Payloads: the OT carries each item's payload (by default its 16 bytes), so
the DB party rebuilds the union in the clear.
"""

from __future__ import annotations

import json
import logging
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from apsu_tpu_torch.api.parties import QueryRequest, QueryResponse, Receiver, Sender
from apsu_tpu_torch.core.mod32 import to_u32
from apsu_tpu_torch.core.params import PSUParams
from apsu_tpu_torch.db.receiver_db import ReceiverDB
from apsu_tpu_torch.mpc.duplex import Duplex
from apsu_tpu_torch.mpc.endgame import (
    cardsum_db_side,
    cardsum_query_side,
    endgame_db_side,
    endgame_query_side,
    felts_to_blocks,
)
from apsu_tpu_torch.mpc.kkrt import KkrtReceiver, KkrtSender
from apsu_tpu_torch.mpc.oprf import EcdhOprfClient, EcdhOprfServer
from apsu_tpu_torch.mpc.prg import CsRng
from apsu_tpu_torch.net.wire import (
    OP_BYE,
    OP_ENDGAME,
    OP_OPRF,
    OP_PARAMS,
    OP_PARAMS_REQ,
    OP_QUERY,
    OP_QUERY_DATA,
    OP_REBIND,
    OP_RESPONSE,
    OP_RESULT,
    WIRE_VERSION,
    ProtocolError,
    TypedDuplex,
    pack_residues,
    unpack_residues,
)

_log = logging.getLogger("apsu_tpu_torch")


class QueryClient:
    """Query-party session against a (possibly resident) DB server.

    Handshakes once, then issues one or more queries; each query runs the
    whole online phase (cuckoo → OPRF → encrypted powers → decrypt → PEQT →
    OT).  Multi-query KKRT sessions open a fresh correlation per query
    (OP_REBIND); ECDH sessions reuse the resident cache directly.
    """

    def __init__(
        self,
        ch: Duplex,
        rng=None,
        params: Optional[PSUParams] = None,
        oprf: str = "kkrt",
        device="cuda",
    ):
        self.t = TypedDuplex(ch)
        self.rng = rng if rng is not None else CsRng()
        self.oprf = oprf
        self.device = device
        hello = json.dumps({"version": WIRE_VERSION, "oprf": oprf}).encode()
        self.t.send_op(OP_PARAMS_REQ, hello)
        remote = PSUParams.load_json(self.t.expect(OP_PARAMS).decode())
        if params is not None and params.to_dict() != remote.to_dict():
            raise ValueError("parameter mismatch with DB party")
        self.params = remote
        self._queries = 0

    def _oprf_factory(self, table):
        ch = self.t.scoped(OP_OPRF)
        if self.oprf == "ecdh":
            return EcdhOprfClient(ch, table, self.rng)
        return KkrtReceiver(ch, table, self.rng)

    def query(
        self,
        items: np.ndarray,
        payloads: Optional[np.ndarray] = None,
        peqt: str = "ddh",
        mode: str = "union",
        values: Optional[np.ndarray] = None,
        timings: Optional[Dict[str, float]] = None,
    ) -> None:
        """One full PSU query.  The DB party ends up with the union."""
        timings = timings if timings is not None else {}
        if self._queries and self.oprf != "ecdh":
            # a slot-bound KKRT correlation binds exactly one query: open a
            # fresh one; the DB party rebinds its retained placement
            self.t.send_op(OP_REBIND, b"")
        self._queries += 1
        params, t = self.params, self.t
        snd = Sender(params, oprf=None, rng=self.rng, oprf_factory=self._oprf_factory,
                     device=self.device)
        t0 = time.perf_counter()
        mark_o = t.bytes_sent + t.bytes_received
        req = snd.create_query(items)
        timings["create_query"] = time.perf_counter() - t0
        timings["oprf_bytes"] = t.bytes_sent + t.bytes_received - mark_o

        meta = {
            "power_list": [int(x) for x in req.power_list],
            "peqt": peqt,
            "mode": mode,
            "has_rk": req.relin_key is not None,
        }
        mark = t.bytes_sent
        t.send_op(OP_QUERY, json.dumps(meta).encode())
        # seed-compressed upload: c0 residues + 32-byte a seed, ksk[:, 0] +
        # 32-byte seed for the relin key (uint32 frames, as the reference's)
        t.send_op(OP_QUERY_DATA, to_u32(req.powers_data[:, :, 0]))
        t.send_op(OP_QUERY_DATA, req.a_seed)
        if req.relin_key is not None:
            t.send_op(OP_QUERY_DATA, to_u32(req.relin_key[:, 0]))
            t.send_op(OP_QUERY_DATA, req.rk_seed)
        timings["query_upload_bytes"] = t.bytes_sent - mark

        mark = t.bytes_received
        rmeta = t.expect(OP_RESPONSE)
        packed = t.expect(OP_RESULT)
        timings["result_bytes"] = t.bytes_received - mark
        eval_level = int(rmeta[0])
        shape = tuple(int(x) for x in rmeta[1:])
        results = unpack_residues(packed, snd.bfv.levels[eval_level].primes, shape)
        t0 = time.perf_counter()
        mat = snd.extract_matrix(QueryResponse(results, eval_level))
        timings["decrypt"] = time.perf_counter() - t0

        blocks = felts_to_blocks(snd.peqt_matrix(mat), params.item_bit_count_per_felt)
        if payloads is None:
            payload_by_slot = (
                np.ascontiguousarray(snd.cuckoo.table).view(np.uint8).reshape(-1, 16)
            )
        else:
            payload_by_slot = np.zeros(
                (params.table_params.table_size, payloads.shape[1]), np.uint8
            )
            idx = snd.cuckoo.item_index
            payload_by_slot[snd.cuckoo.filled] = payloads[idx[snd.cuckoo.filled]]
        eg = t.scoped(OP_ENDGAME)
        t0 = time.perf_counter()
        mark_e = t.bytes_sent + t.bytes_received
        if mode == "union":
            endgame_query_side(
                eg, blocks, payload_by_slot, snd.cuckoo.filled, self.rng, peqt=peqt
            )
        else:
            vals = np.zeros(params.table_params.table_size, dtype=np.uint64)
            if mode == "cardsum":
                if values is None:
                    raise ValueError("cardsum mode needs per-item values")
                idx = snd.cuckoo.item_index
                vals[snd.cuckoo.filled] = values[idx[snd.cuckoo.filled]]
            cardsum_query_side(eg, blocks, vals, snd.cuckoo.filled, self.rng, peqt=peqt)
        timings["endgame"] = time.perf_counter() - t0
        timings["endgame_bytes"] = t.bytes_sent + t.bytes_received - mark_e

    def close(self) -> None:
        self.t.send_op(OP_BYE, b"")


def run_query_party(
    ch: Duplex,
    items: np.ndarray,
    rng=None,
    params: Optional[PSUParams] = None,
    payloads: Optional[np.ndarray] = None,
    timings: Optional[Dict[str, float]] = None,
    peqt: str = "ddh",
    mode: str = "union",
    values: Optional[np.ndarray] = None,
    oprf: str = "kkrt",
    device="cuda",
) -> PSUParams:
    """The small-set party, single query.  mode: "union" (transfer X∖Y),
    "card" or "cardsum".  Returns the params used.  rng sources all of this
    party's secret material; None means an OS-entropy CsRng."""
    client = QueryClient(ch, rng=rng, params=params, oprf=oprf, device=device)
    client.query(
        items, payloads=payloads, peqt=peqt, mode=mode, values=values,
        timings=timings,
    )
    client.close()
    return client.params


def serve_db_party(
    ch: Duplex,
    params: PSUParams,
    items: np.ndarray,
    rng=None,
    timings: Optional[Dict[str, float]] = None,
    db: Optional[ReceiverDB] = None,
    max_queries: Optional[int] = 1,
    workers=None,
    cache_parts: int = 1,
    device="cuda",
) -> List[np.ndarray]:
    """The large-set party: builds (or reuses) the DB on ``device``, then
    serves queries until OP_BYE or ``max_queries``.  Returns one
    transferred-payload array [k_i, W] per union query served (a (card, sum)
    tuple per CARD/CARDSUM query).

    The OPRF backend follows the client's handshake: "kkrt" (interactive
    build, exactly one query per correlation) or "ecdh" (offline build,
    unlimited queries against the resident cache).

    ``workers``: Duplex links to ``db_worker`` processes; the DB is then
    built and evaluated as their (bundle-range × cache-range) partition,
    ``cache_parts`` cache ranges to a bundle range, with this party as the
    coordinator (``parallel.multihost.DistributedReceiver``), and the
    workers are told "bye" when the session ends.  ``timings`` then also
    gets the coordinator's ``dist_*`` phase split of the last query and the
    workers' build and rebind times."""
    if cache_parts != 1 and not workers:
        raise ValueError("cache_parts splits the DB over workers; pass workers=")
    timings = timings if timings is not None else {}
    rng = rng if rng is not None else CsRng()
    t = TypedDuplex(ch)

    hello = json.loads(t.expect(OP_PARAMS_REQ).decode())
    oprf_kind = hello.get("oprf", "kkrt")
    t.send_op(OP_PARAMS, params.to_json().encode())

    rebind_src = None
    if db is not None and oprf_kind == "kkrt":
        # a slot-bound KKRT correlation binds exactly one session: the
        # resident (ECDH-built) cache cannot answer it.  Rebuild for this
        # client, from the resident DB's placement where it has one
        if db.can_rebind:
            rebind_src = db
        db = None

    t0 = time.perf_counter()
    dist = None
    if db is None:
        if oprf_kind == "ecdh":
            oprf = EcdhOprfServer(rng)
        else:
            oprf = KkrtSender(t.scoped(OP_OPRF), params.table_params.table_size, rng)
        if workers:
            from apsu_tpu_torch.parallel.multihost import DistributedReceiver

            dist = DistributedReceiver(params, workers, items, oprf=oprf, rng=rng,
                                       cache_parts=cache_parts, device=device)
            timings["worker_build_s"] = list(dist.worker_build_s)
        elif rebind_src is not None:
            db = rebind_src.rebind(oprf)
        else:
            db = ReceiverDB(params, oprf, device=device)
            db.set_data(items)
    timings["db_build"] = time.perf_counter() - t0
    recv = dist if dist is not None else Receiver(params, db, rng=rng)
    oprf_obj = recv.oprf if dist is not None else db.oprf

    transferred: List[np.ndarray] = []
    served = 0
    kkrt_consumed = False  # a served query consumes the KKRT correlation
    while max_queries is None or served < max_queries:
        try:
            op, obj = t.recv_any()
        except (ConnectionError, EOFError):
            break
        if op == OP_BYE:
            break
        if op == OP_OPRF:
            # ECDH blind-evaluation round for the next query's cuckoo table
            if not isinstance(oprf_obj, EcdhOprfServer):
                t.send_error("OPRF round on a non-ECDH session")
                raise ProtocolError("OPRF round on a non-ECDH session")
            t.send_op(OP_OPRF, oprf_obj.serve_round(np.asarray(obj)))
            continue
        if op == OP_REBIND:
            # fresh KKRT correlation for the client's next query: run the
            # interactive setup, then derive only the OPRF-dependent tensors
            # again from the retained placement
            if oprf_kind == "ecdh":
                t.send_error("OP_REBIND on an ECDH session")
                raise ProtocolError("OP_REBIND on an ECDH session")
            if dist is not None:
                t0 = time.perf_counter()
                oprf_obj = KkrtSender(t.scoped(OP_OPRF), params.table_params.table_size, rng)
                dist.rebind(oprf_obj)   # each worker releases its consumed cache first
                kkrt_consumed = False
                timings["rebind"] = time.perf_counter() - t0
                timings["worker_rebind_s"] = list(dist.worker_rebind_s)
                continue
            if not db.can_rebind:
                msg = "OP_REBIND: this DB retains no placement and cannot rebind"
                t.send_error(msg)
                raise ProtocolError(msg)
            t0 = time.perf_counter()
            oprf_obj = KkrtSender(t.scoped(OP_OPRF), params.table_params.table_size, rng)
            cuda = db.device.type == "cuda"
            before = torch.cuda.memory_allocated(db.device) if cuda else 0
            db.release_cache()   # the consumed cache goes before the new one is built
            released = torch.cuda.memory_allocated(db.device) if cuda else 0
            db = db.rebind(oprf_obj)
            if cuda:
                _log.debug(
                    "rebind: device memory allocated %.4f GB before, %.4f GB after "
                    "releasing the consumed cache, %.4f GB after the rebind (cache %.4f GB)",
                    before / 1e9, released / 1e9, torch.cuda.memory_allocated(db.device) / 1e9,
                    db.coeff_cache.numel() * db.coeff_cache.element_size() / 1e9)
            recv = Receiver(params, db, rng=rng)
            kkrt_consumed = False
            timings["rebind"] = time.perf_counter() - t0
            continue
        if op != OP_QUERY:
            t.send_error(f"unexpected op {op} (wanted OP_QUERY)")
            raise ProtocolError(f"unexpected op {op}")
        if served and oprf_kind != "ecdh" and kkrt_consumed:
            t.send_error(
                "KKRT correlation already consumed; the client must open "
                "a fresh one (OP_REBIND) before its next query"
            )
            raise ProtocolError("KKRT correlation already consumed")

        meta = json.loads(bytes(obj).decode())
        plist = tuple(int(x) for x in meta["power_list"])
        # both parties derive the fresh-query level from the shared params;
        # the c0 limb count is cross-checked by Receiver.validate_query
        ql = recv.query_lvl
        c0 = t.expect(OP_QUERY_DATA)
        a_seed = bytes(t.expect(OP_QUERY_DATA))
        if meta["has_rk"]:
            rk0 = t.expect(OP_QUERY_DATA)
            rk_seed = bytes(t.expect(OP_QUERY_DATA))
            rk = recv.bfv.relin_key_from_seed(rk0, rk_seed, level=ql).ksk
        else:
            rk = None
        powers = recv.bfv.ct_from_seed(c0, a_seed, level=ql)
        t0 = time.perf_counter()
        req = QueryRequest(power_list=plist, powers_data=powers.data, relin_key=rk)
        if dist is not None:
            dtm: Dict[str, float] = {}
            resp = dist.run_query(req, timings=dtm)
            timings.update({f"dist_{k}": v for k, v in dtm.items()})
        else:
            resp = recv.run_query(req)
        timings["run_query"] = time.perf_counter() - t0
        res_np = to_u32(resp.results)
        primes = recv.bfv.levels[resp.eval_level].primes
        t.send_op(OP_RESPONSE, np.array([resp.eval_level, *res_np.shape], np.int64))
        t.send_op(OP_RESULT, pack_residues(res_np, primes))
        timings["result_raw_bytes"] = int(res_np.nbytes)

        blocks = felts_to_blocks(recv.peqt_matrix(), params.item_bit_count_per_felt)
        eg = t.scoped(OP_ENDGAME)
        t0 = time.perf_counter()
        if meta["mode"] == "union":
            transferred.append(endgame_db_side(eg, blocks, rng, peqt=meta["peqt"]))
        else:
            transferred.append(cardsum_db_side(eg, blocks, rng, peqt=meta["peqt"]))
        timings["endgame"] = time.perf_counter() - t0
        served += 1
        kkrt_consumed = True
    if dist is not None:
        dist.close()
    return transferred


def serve_clients(
    listener,
    params: PSUParams,
    items: np.ndarray,
    rng=None,
    max_clients: Optional[int] = 1,
    queries_per_client: Optional[int] = None,
    timings: Optional[Dict[str, float]] = None,
    device="cuda",
) -> List[List[np.ndarray]]:
    """Multi-client dispatcher: build the DB once with the ECDH backend (the
    cache stays resident on ``device``), then accept successive client
    connections on ``listener`` (``mpc/duplex.py:SocketListener``) and serve
    each with ``serve_db_party``.

    ECDH clients share the resident cache (unlimited queries each); a KKRT
    handshake makes a per-session DB from the resident placement (its
    correlation binds one query).  A protocol error or disconnect on one
    connection is logged and does not end the server.  Returns the
    per-client lists of transferred payload arrays."""
    from apsu_tpu_torch.utils.log import get

    log = get()
    rng = rng if rng is not None else CsRng()
    t0 = time.perf_counter()
    db = ReceiverDB(params, EcdhOprfServer(rng), device=device)
    db.set_data(items)
    if timings is not None:
        timings["db_build"] = time.perf_counter() - t0
    out: List[List[np.ndarray]] = []
    served = 0
    while max_clients is None or served < max_clients:
        ch = listener.accept()
        try:
            out.append(
                serve_db_party(
                    ch, params, items, rng, timings=timings, db=db,
                    max_queries=queries_per_client, device=device,
                )
            )
        except (ProtocolError, ConnectionError, EOFError) as e:
            log.warning("client %d: session aborted: %s", served, e)
            out.append([])
        finally:
            ch.close()
        served += 1
    return out


def run_db_party(
    ch: Duplex,
    params: PSUParams,
    items: np.ndarray,
    rng=None,
    timings: Optional[Dict[str, float]] = None,
    db: Optional[ReceiverDB] = None,
    device="cuda",
):
    """Single-query DB party.  Returns the transferred payloads [k, W] uint8
    (the difference set X∖Y), or the (card, sum) tuple in CARD/CARDSUM
    mode."""
    out = serve_db_party(
        ch, params, items, rng=rng, timings=timings, db=db, max_queries=1, device=device
    )
    if not out:
        raise ProtocolError("client disconnected before querying")
    return out[0]
