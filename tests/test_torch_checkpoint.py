"""ReceiverDB checkpoints across the two packages, on the CPU at
small_params()-sized sets: the port writes the reference's layout byte for
byte (params.json, meta.json, uint32 .npy arrays), a checkpoint saved by
either package loads in the other, and the loaded DB's next query gives
response ciphertexts bit-identical (tolerance 0) to the saving DB's under the
same seeded parties; a checkpoint with the KKRT sender state loads without an
OPRF argument and serves a real KKRT query.  (The set helpers are copied
here: a GPU host may have another package named ``tests`` on its path.)"""

import os
import threading

import jax
import numpy as np
import pytest

from apsu_tpu.api.parties import QueryRequest as RefRequest
from apsu_tpu.api.parties import Receiver as RefReceiver
from apsu_tpu.core.params import PSUParams as RefParams
from apsu_tpu.db.receiver_db import ReceiverDB as RefDB
from apsu_tpu.mpc.kkrt import KkrtSender as RefKkrtSender
from apsu_tpu.mpc.oprf import DebugOprf as RefOprf
from apsu_tpu_torch.api.parties import Receiver, Sender
from apsu_tpu_torch.api.protocol import DebugEndgame, run_psu
from apsu_tpu_torch.core.mod32 import to_u32
from apsu_tpu_torch.core.params import PSUParams
from apsu_tpu_torch.db.receiver_db import ReceiverDB
from apsu_tpu_torch.mpc.duplex import pipe_pair
from apsu_tpu_torch.mpc.kkrt import KkrtReceiver, KkrtSender
from apsu_tpu_torch.mpc.oprf import DebugOprf

SETS = {  # tests/test_psu_e2e.py:small_params, and a PS variant of it
    "non_ps": {"table_params": {"hash_func_count": 2, "table_size": 64, "max_items_per_bin": 8},
               "query_params": {"ps_low_degree": 0, "query_powers": [1, 2, 3, 4, 5, 6, 7, 8]},
               "coeff_modulus_bits": [40, 40, 30]},
    "ps": {"table_params": {"hash_func_count": 2, "table_size": 64, "max_items_per_bin": 16},
           "query_params": {"ps_low_degree": 3, "query_powers": [1, 2, 3, 4, 8]},
           "coeff_modulus_bits": [48, 48, 48, 28]},
}


def _params(name):
    s = SETS["ps" if name == "ps" else "non_ps"]
    d = {"table_params": s["table_params"], "item_params": {"felts_per_item": 4},
         "query_params": s["query_params"],
         "seal_params": {"plain_modulus": 65537, "poly_modulus_degree": 256,
                         "coeff_modulus_bits": s["coeff_modulus_bits"]}}
    return RefParams.from_dict(d), PSUParams.from_dict(d)


def make_sets(rng, n_db, n_query, n_common):
    db = rng.integers(0, 1 << 64, size=(n_db, 2), dtype=np.uint64)
    fresh = rng.integers(0, 1 << 64, size=(n_query - n_common, 2), dtype=np.uint64)
    common = db[rng.choice(n_db, size=n_common, replace=False)]
    query = np.concatenate([fresh, common])
    rng.shuffle(query)
    return db, query


def as_set(a):
    return {(int(x), int(y)) for x, y in a}


def _u32(x):
    return np.asarray(jax.device_get(x))


def _files(path):
    return {f: open(os.path.join(path, f), "rb").read() for f in sorted(os.listdir(path))}


def _ref_request(req):
    """A port request as the reference's (uint32 numpy arrays)."""
    return RefRequest(power_list=req.power_list, powers_data=to_u32(req.powers_data),
                      relin_key=None if req.relin_key is None else to_u32(req.relin_key),
                      a_seed=req.a_seed, rk_seed=req.rk_seed)


def _transferred(params, snd, rcv, resp):
    return as_set(DebugEndgame().run(snd.peqt_matrix(snd.extract_matrix(resp)), rcv.peqt_matrix(),
                                     snd.cuckoo.table, snd.cuckoo.filled))


def test_db_checkpoint_roundtrip(tmp_path):
    """Save after the build and strip, load, serve a query from the loaded
    DB (tests/test_psu_e2e.py::test_db_checkpoint_roundtrip's flow)."""
    rng = np.random.default_rng(9)
    _, pp = _params("non_ps")
    db_items, query = make_sets(rng, n_db=260, n_query=28, n_common=13)
    oprf = DebugOprf(0x5EED)
    db = ReceiverDB(pp, oprf, device="cpu")
    db.set_data(db_items)
    db.strip()
    db.save(str(tmp_path / "ckpt"))

    loaded = ReceiverDB.load(str(tmp_path / "ckpt"), oprf=oprf, device="cpu")
    assert loaded.stats == db.stats and not loaded.can_rebind
    assert np.array_equal(to_u32(loaded.coeff_cache), to_u32(db.coeff_cache))
    res = run_psu(pp, query, db_items, receiver=Receiver(pp, loaded), device="cpu")
    dbs, qs = as_set(db_items), as_set(query)
    assert as_set(res.transferred) == qs - dbs and as_set(res.union) == dbs | qs
    with pytest.raises(ValueError, match="stripped"):
        loaded.insert_or_assign(db_items[:2])
    with pytest.raises(ValueError, match="no OPRF state"):
        ReceiverDB.load(str(tmp_path / "ckpt"), device="cpu")


@pytest.mark.parametrize("kind", ["non_ps", "ps", "labeled"])
def test_checkpoint_loads_in_the_other_package(kind, tmp_path):
    """Each package saves its stripped DB; the two directories are equal
    byte for byte; the reference's checkpoint loads in the port and the
    port's in the reference, and a seeded query gives the same response bits
    (and label results) from the port's DB and from both loaded DBs."""
    rng = np.random.default_rng(19)
    rp, pp = _params(kind)
    db_items, query = make_sets(rng, n_db=240, n_query=30, n_common=12)
    labels = None
    if kind == "labeled":
        labels = np.zeros((len(db_items), 16), dtype=np.uint8)
        labels[:, : pp.item_bit_count // 8] = rng.integers(0, 256, size=(len(db_items),
                                                                          pp.item_bit_count // 8))
    ref = RefDB(rp, RefOprf(0x5EED))
    ref.set_data(db_items, labels=labels)
    db = ReceiverDB(pp, DebugOprf(0x5EED), device="cpu")
    db.set_data(db_items, labels=labels)
    ref.strip()
    db.strip()
    ref.save(str(tmp_path / "ref"))
    db.save(str(tmp_path / "port"))
    saved = _files(tmp_path / "ref")
    assert saved == _files(tmp_path / "port")
    assert ("ps_const_polys.npy" in saved) == (kind == "ps")
    assert ("label_cache.npy" in saved) == (kind == "labeled")

    port_loaded = ReceiverDB.load(str(tmp_path / "ref"), oprf=DebugOprf(0x5EED), device="cpu")
    ref_loaded = RefDB.load(str(tmp_path / "port"), oprf=RefOprf(0x5EED))

    snd = Sender(pp, DebugOprf(0x5EED), rng=np.random.default_rng(5), device="cpu")
    req = snd.create_query(query)
    r_req = _ref_request(req)
    r_resp = RefReceiver(rp, ref_loaded, rng=np.random.default_rng(6)).run_query(r_req)
    for d in (db, port_loaded):
        rcv = Receiver(pp, d, rng=np.random.default_rng(6))
        resp = rcv.run_query(req)
        assert _transferred(pp, snd, rcv, resp) == as_set(query) - as_set(db_items)
        assert np.array_equal(_u32(r_resp.results), to_u32(resp.results))
        if kind == "labeled":
            assert np.array_equal(_u32(r_resp.label_results), to_u32(resp.label_results))


def test_kkrt_checkpoint_loads_without_oprf(tmp_path):
    """A DB built under a real KKRT correlation saves the sender state; it
    loads without an OPRF argument (the port's own KkrtSender rebuilt from
    the files, and the reference's from the same files) and answers the query
    that bound the correlation exactly."""
    rng = np.random.default_rng(29)
    rp, pp = _params("non_ps")
    db_items, query = make_sets(rng, n_db=200, n_query=24, n_common=9)
    ch_q, ch_db = pipe_pair()
    out = {}
    snd = Sender(pp, None, rng=np.random.default_rng(7),
                 oprf_factory=lambda table: KkrtReceiver(ch_q, table, np.random.default_rng(8)),
                 device="cpu")
    t = threading.Thread(target=lambda: out.setdefault(
        "kkrt", KkrtSender(ch_db, pp.table_params.table_size, np.random.default_rng(9))),
        daemon=True)
    t.start()
    req = snd.create_query(query)
    t.join(60)
    assert not t.is_alive()
    db = ReceiverDB(pp, out["kkrt"], device="cpu")
    db.set_data(db_items)
    db.strip()
    db.save(str(tmp_path / "ckpt"))
    assert {"oprf_q_cols.npy", "oprf_s_pack.npy"} <= set(os.listdir(tmp_path / "ckpt"))

    loaded = ReceiverDB.load(str(tmp_path / "ckpt"), device="cpu")
    assert isinstance(loaded.oprf, KkrtSender)
    ref_loaded = RefDB.load(str(tmp_path / "ckpt"))
    assert isinstance(ref_loaded.oprf, RefKkrtSender)
    slots = np.arange(pp.table_params.table_size) % 64
    probe = rng.integers(0, 1 << 64, size=(len(slots), 2), dtype=np.uint64)
    want = out["kkrt"].eval(probe, slots)
    assert np.array_equal(loaded.oprf.eval(probe, slots), want)
    assert np.array_equal(ref_loaded.oprf.eval(probe, slots), want)

    rcv = Receiver(pp, loaded, rng=np.random.default_rng(10))
    resp = rcv.run_query(req)
    assert _transferred(pp, snd, rcv, resp) == as_set(query) - as_set(db_items)
    r_resp = RefReceiver(rp, ref_loaded, rng=np.random.default_rng(10)).run_query(_ref_request(req))
    assert np.array_equal(_u32(r_resp.results), to_u32(resp.results))
