"""Guards of the port that the reference's own tests pin, as fast port
tests: a replayed OP_QUERY on a consumed KKRT correlation is refused
(tests/test_serve_loop.py::test_kkrt_server_refuses_reused_correlation),
``validate_query`` rejects a wrong power list and a wrong degree, and a full
cuckoo table raises (tests/test_psu_e2e.py::
test_query_validation_rejects_bad_requests and
test_cuckoo_table_overflow_raises).  (The set helpers are copied here: a GPU
host may have another package named ``tests`` on its path.)"""

import json
import threading

import numpy as np
import pytest

from apsu_tpu_torch.api.parties import QueryRequest, Receiver, Sender
from apsu_tpu_torch.api.session import QueryClient, serve_db_party
from apsu_tpu_torch.core.params import PSUParams
from apsu_tpu_torch.db.receiver_db import ReceiverDB
from apsu_tpu_torch.hash.cuckoo import CuckooFullError, cuckoo_insert
from apsu_tpu_torch.mpc.duplex import pipe_pair
from apsu_tpu_torch.mpc.oprf import DebugOprf
from apsu_tpu_torch.mpc.prg import CsRng
from apsu_tpu_torch.net.wire import OP_QUERY, ProtocolError, RemoteError

SMALL = PSUParams.from_dict({  # tests/test_psu_e2e.py:small_params()
    "table_params": {"hash_func_count": 2, "table_size": 64, "max_items_per_bin": 8},
    "item_params": {"felts_per_item": 4},
    "query_params": {"ps_low_degree": 0, "query_powers": [1, 2, 3, 4, 5, 6, 7, 8]},
    "seal_params": {"plain_modulus": 65537, "poly_modulus_degree": 256,
                    "coeff_modulus_bits": [40, 40, 30]},
})


def make_sets(rng, n_db, n_query, n_common):
    db = rng.integers(0, 1 << 64, size=(n_db, 2), dtype=np.uint64)
    fresh = rng.integers(0, 1 << 64, size=(n_query - n_common, 2), dtype=np.uint64)
    common = db[rng.choice(n_db, size=n_common, replace=False)]
    query = np.concatenate([fresh, common])
    rng.shuffle(query)
    return db, query


def test_kkrt_server_refuses_reused_correlation():
    """A second OP_QUERY on a consumed KKRT correlation without an OP_REBIND
    is refused: the client gets RemoteError "consumed", the server aborts."""
    db_items, q1 = make_sets(np.random.default_rng(22), 200, 25, 8)
    ch_q, ch_db = pipe_pair()
    seen = {}

    def server():
        try:
            serve_db_party(ch_db, SMALL, db_items, CsRng(b"kkrt-refuse-test-db-0001"),
                           max_queries=None, device="cpu")
        except ProtocolError as e:
            seen["server"] = str(e)

    t = threading.Thread(target=server, daemon=True)
    t.start()
    c = QueryClient(ch_q, rng=CsRng(b"kkrt-refuse-test-cli-001"), params=SMALL, oprf="kkrt",
                    device="cpu")
    c.query(q1)
    # replay OP_QUERY without opening a fresh correlation (QueryClient.query
    # would send OP_REBIND first)
    c.t.send_op(OP_QUERY, json.dumps({"power_list": [1], "peqt": "ddh", "mode": "union",
                                      "has_rk": False}).encode())
    with pytest.raises(RemoteError, match="consumed"):
        c.t.expect(OP_QUERY)
    t.join(60)
    assert not t.is_alive() and "consumed" in seen["server"]


def test_query_validation_rejects_bad_requests():
    db_items, query = make_sets(np.random.default_rng(11), n_db=150, n_query=20, n_common=5)
    oprf = DebugOprf()
    db = ReceiverDB(SMALL, oprf, device="cpu")
    db.set_data(db_items)
    recv = Receiver(SMALL, db)
    req = Sender(SMALL, oprf, rng=np.random.default_rng(12), device="cpu").create_query(query)
    recv.validate_query(req)

    bad = QueryRequest(power_list=tuple(list(req.power_list)[:-1] + [99]),
                       powers_data=req.powers_data, relin_key=req.relin_key)
    with pytest.raises(ValueError, match="query powers"):
        recv.run_query(bad)
    bad2 = QueryRequest(power_list=req.power_list,
                        powers_data=req.powers_data[:, :, :, :, : SMALL.poly_degree // 2],
                        relin_key=req.relin_key)
    with pytest.raises(ValueError, match="degree mismatch"):
        recv.run_query(bad2)


def test_cuckoo_table_overflow_raises():
    items = np.random.default_rng(12).integers(0, 1 << 64, size=(65, 2), dtype=np.uint64)
    with pytest.raises(CuckooFullError):
        cuckoo_insert(items, table_size=64, func_count=2)
