"""The port's in-process PSU against the JAX package, bit for bit (tolerance
0), on the same numpy-seeded inputs: the copies of hash/* and DebugOprf, the
BFV seed channel, Sender.create_query, the non-PS ReceiverDB.set_data,
compute_power_tensor and eval_matching_polys, Receiver.run_query and run_psu
with seeded parties, plus the set-algebra oracle of tests/test_psu_e2e.py.

Two parameter sets: a small one whose power DAG is one level of ct×ct
products (relinearization on the path, 30-bit eval primes) and 100K-1, the
README's quick start (every power a query source, no relinearization).  A
slow test holds the port at 1M-2048-cmp at full width (2^20 × 2048) against
the reference; it runs on the GPU host, with the port on the card.  (The
set helpers are copied here: a GPU host may have another package named
``tests`` on its path.)"""

import jax
import numpy as np
import pytest
import torch

from apsu_tpu.api.parties import Receiver as RefReceiver
from apsu_tpu.api.parties import Sender as RefSender
from apsu_tpu.api.protocol import run_psu as ref_run_psu
from apsu_tpu.core.bfv import BfvContext as RefBfv
from apsu_tpu.core.bfv import Ciphertext as RefCt
from apsu_tpu.core.bfv import RelinKey as RefRk
from apsu_tpu.core.bfv import uniform_from_seed as ref_uniform_from_seed
from apsu_tpu.core.params import PSUParams as RefParams
from apsu_tpu.db.receiver_db import ReceiverDB as RefDB
from apsu_tpu.engine.evaluator import compute_power_tensor as ref_power_tensor
from apsu_tpu.engine.evaluator import eval_matching_polys as ref_eval
from apsu_tpu.hash import cuckoo as ref_cuckoo
from apsu_tpu.hash import encoding as ref_encoding
from apsu_tpu.hash import items as ref_items
from apsu_tpu.mpc.oprf import DebugOprf as RefOprf
from apsu_tpu_torch.api.parties import QueryRequest, Receiver, Sender, _slots_to_item_blocks
from apsu_tpu_torch.api.protocol import run_psu
from apsu_tpu_torch.core.bfv import BfvContext, Ciphertext, RelinKey, uniform_from_seed
from apsu_tpu_torch.core.mod32 import to_u32
from apsu_tpu_torch.core.params import PSUParams
from apsu_tpu_torch.db.measured_levels import query_level
from apsu_tpu_torch.db.receiver_db import DbStats, ReceiverDB
from apsu_tpu_torch.engine.evaluator import compute_power_tensor, eval_matching_polys
from apsu_tpu_torch.hash import cuckoo, encoding, items
from apsu_tpu_torch.mpc.oprf import DebugOprf

DAG = {  # one-level power DAG (tests/test_psu_e2e.py:test_psu_with_power_dag's set)
    "table_params": {"hash_func_count": 3, "table_size": 128, "max_items_per_bin": 16},
    "item_params": {"felts_per_item": 4},
    "query_params": {"ps_low_degree": 0, "query_powers": [1, 2, 5, 8, 11, 14, 15, 16]},
    "seal_params": {"plain_modulus": 65537, "poly_modulus_degree": 256,
                    "coeff_modulus_bits": [48, 48, 48, 28]},
}


def make_sets(rng, n_db, n_query, n_common):
    """Random 128-bit item sets with a planted intersection (as
    tests/test_psu_e2e.py makes them)."""
    db = rng.integers(0, 1 << 64, size=(n_db, 2), dtype=np.uint64)
    fresh = rng.integers(0, 1 << 64, size=(n_query - n_common, 2), dtype=np.uint64)
    common = db[rng.choice(n_db, size=n_common, replace=False)]
    query = np.concatenate([fresh, common])
    rng.shuffle(query)
    return db, query


def check_oracle(db, query, result):
    """The set algebra of tests/test_psu_e2e.py:check_oracle."""
    as_set = lambda a: {(int(x), int(y)) for x, y in a}  # noqa: E731
    dbs, qs = as_set(db), as_set(query)
    trans, union = as_set(result.transferred), as_set(result.union)
    assert trans == qs - dbs
    assert union == dbs | qs
    assert not (trans & dbs)
    assert len(union) == len(dbs) + len(qs - dbs)


def _eq(ref_arr, port_t):
    return np.array_equal(np.asarray(jax.device_get(ref_arr)), to_u32(port_t))


def _params(name):
    if name == "dag":
        return RefParams.from_dict(DAG), PSUParams.from_dict(DAG)
    path = f"parameters/{name}.json"
    return RefParams.load_file(path), PSUParams.load_file(path)


def _sets(name):
    if name == "dag":
        return make_sets(np.random.default_rng(1), n_db=400, n_query=50, n_common=23)
    rng = np.random.default_rng(0)  # the README's quick start
    db = rng.integers(0, 1 << 64, size=(100_000, 2), dtype=np.uint64)
    query = np.concatenate([db[:3], rng.integers(0, 1 << 64, size=(5, 2), dtype=np.uint64)])
    return db, query


def _both(name, device="cpu"):
    """Reference and port side by side: the DB built from items, one query
    from a seeded Sender, one response from a seeded Receiver."""
    ref_p, port_p = _params(name)
    db_items, query = _sets(name)
    r_db = RefDB(ref_p, RefOprf())
    r_stats = r_db.set_data(db_items)
    r_snd = RefSender(ref_p, RefOprf(), rng=np.random.default_rng(21))
    r_req = r_snd.create_query(query)
    r_recv = RefReceiver(ref_p, r_db, rng=np.random.default_rng(22))
    r_resp = r_recv.run_query(r_req)

    db = ReceiverDB(port_p, DebugOprf(), device=device)
    stats = db.set_data(db_items)
    snd = Sender(port_p, DebugOprf(), rng=np.random.default_rng(21), device=device)
    req = snd.create_query(query)
    recv = Receiver(port_p, db, rng=np.random.default_rng(22))
    resp = recv.run_query(req)
    return dict(ref_p=ref_p, port_p=port_p, db_items=db_items, query=query,
                r_db=r_db, r_stats=r_stats, r_snd=r_snd, r_req=r_req, r_recv=r_recv,
                r_resp=r_resp, db=db, stats=stats, snd=snd, req=req, recv=recv, resp=resp)


@pytest.fixture(scope="module", params=["dag", "100K-1"])
def both(request):
    return _both(request.param)


# ---------------------------------------------------------------------------
# host modules: hashing, cuckoo table, felts, OPRF
# ---------------------------------------------------------------------------

def test_hash_and_oprf_copies_match_reference():
    rng_r, rng_p = np.random.default_rng(5), np.random.default_rng(5)
    r_it, p_it = ref_items.random_items(300, rng_r), items.random_items(300, rng_p)
    assert np.array_equal(r_it, p_it)
    raw = ["alice", b"bob", 12345, 0, "ünïcode"]
    assert np.array_equal(ref_items.hash_items(raw), items.hash_items(raw))
    for size, h, seed in [(409, 1, b"apsu-loc"), (3410, 3, b"apsu-loc"), (128, 3, b"other")]:
        assert np.array_equal(ref_items.LocFuncs(size, h, seed).locations(r_it),
                              items.LocFuncs(size, h, seed).locations(p_it))
    slots = np.arange(300, dtype=np.int64) * 7 % 409
    r_prf = RefOprf(0x1234).eval(r_it, slots)
    p_prf = DebugOprf(0x1234).eval(p_it, slots)
    assert np.array_equal(r_prf, p_prf)
    for fpi, bits in [(4, 16), (6, 15), (5, 16)]:
        f = encoding.felts_from_items(p_prf, fpi, bits)
        assert np.array_equal(ref_encoding.felts_from_items(r_prf, fpi, bits), f)
        assert np.array_equal(ref_encoding.items_from_felts(f, bits),
                              encoding.items_from_felts(f, bits))
    r_tab = ref_cuckoo.cuckoo_insert(r_it[:200], 256, 3)
    p_tab = cuckoo.cuckoo_insert(p_it[:200], 256, 3)
    for field in ("table", "filled", "item_index"):
        assert np.array_equal(getattr(r_tab, field), getattr(p_tab, field))
    with pytest.raises(cuckoo.CuckooFullError):
        cuckoo.cuckoo_insert(p_it[:65], table_size=64, func_count=2)


# ---------------------------------------------------------------------------
# the BFV seed channel
# ---------------------------------------------------------------------------

def test_seed_channel_matches_reference():
    ref_p, port_p = _params("dag")
    ref, port = RefBfv(ref_p.seal_params), BfvContext(port_p.seal_params, device="cpu")
    seed = bytes(range(32))
    for r_base, p_base, lead in [(ref.q, port.q, (3,)), (ref.qp, port.qp, (2, 1))]:
        assert np.array_equal(ref_uniform_from_seed(seed, r_base, lead),
                              uniform_from_seed(seed, p_base, lead))
    r_rng, p_rng = np.random.default_rng(8), np.random.default_rng(8)
    r_sk, p_sk = ref.gen_secret_key(r_rng), port.gen_secret_key(p_rng)
    for lvl in (ref.q.k, 2):
        r_rk = ref.gen_relin_key(r_sk, r_rng, a_seed=seed, level=lvl)
        p_rk = port.gen_relin_key(p_sk, p_rng, a_seed=seed, level=lvl)
        assert _eq(r_rk.ksk, p_rk.ksk)
        rebuilt = port.relin_key_from_seed(p_rk.ksk[:, 0], seed, level=lvl)
        assert _eq(ref.relin_key_from_seed(np.asarray(r_rk.ksk[:, 0]), seed, level=lvl).ksk,
                   rebuilt.ksk)
        assert torch.equal(rebuilt.ksk, p_rk.ksk)
    slots = np.random.default_rng(9).integers(0, ref.t, size=(2, ref.n), dtype=np.uint64)
    slots = slots.astype(np.uint32)
    for lvl in (None, 2):
        r_ct = ref.encrypt_symmetric(ref.encode(slots), r_sk, r_rng, a_seed=seed, level=lvl)
        p_ct = port.encrypt_symmetric(port.encode(slots), p_sk, p_rng, a_seed=seed, level=lvl)
        assert _eq(r_ct.data, p_ct.data)
        rebuilt = port.ct_from_seed(p_ct.data[..., 0, :, :], seed, level=lvl)
        assert torch.equal(rebuilt.data, p_ct.data) and rebuilt.level == p_ct.level
        assert np.array_equal(to_u32(port.decode(port.decrypt_device(rebuilt, p_sk))), slots)
    # both rngs drew the same number of values
    assert r_rng.integers(0, 1 << 62) == p_rng.integers(0, 1 << 62)


# ---------------------------------------------------------------------------
# the parties, step by step
# ---------------------------------------------------------------------------

def test_set_data_matches_reference(both):
    r_db, db = both["r_db"], both["db"]
    assert both["stats"] == DbStats(**vars(both["r_stats"]))
    assert (db.eval_lvl, db.result_lvl) == (r_db.eval_lvl, r_db.result_lvl)
    assert _eq(r_db.coeff_cache, db.coeff_cache)
    assert _eq(r_db.const_slots, db.const_slots)
    assert db.ps_const_polys is None
    # the build keeps no reference to the caller's items
    assert not any(v is both["db_items"] for v in vars(db).values())


def test_create_query_matches_reference(both):
    r_req, req, snd = both["r_req"], both["req"], both["snd"]
    assert req.power_list == tuple(r_req.power_list)
    assert req.a_seed == r_req.a_seed and req.rk_seed == r_req.rk_seed
    assert _eq(r_req.powers_data, req.powers_data)
    assert (req.relin_key is None) == (r_req.relin_key is None)
    if req.relin_key is not None:
        assert _eq(r_req.relin_key, req.relin_key)
    assert np.array_equal(both["r_snd"].sk.coeffs, snd.sk.coeffs)
    for field in ("table", "filled", "item_index"):
        assert np.array_equal(getattr(both["r_snd"].cuckoo, field), getattr(snd.cuckoo, field))


def test_power_tensor_and_eval_match_reference(both):
    r_db, db, r_req, req = both["r_db"], both["db"], both["r_req"], both["req"]
    ql = query_level(both["port_p"], len(db.bfv.q_primes))
    plan = both["recv"].plan
    r_cts = {s: RefCt(r_req.powers_data[i], is_ntt=False, level=ql)
             for i, s in enumerate(r_req.power_list)}
    cts = {s: Ciphertext(req.powers_data[i], is_ntt=False, level=ql)
           for i, s in enumerate(req.power_list)}
    r_rk = rk = None
    if req.relin_key is not None:
        r_rk, rk = RefRk(r_req.relin_key, ql), RelinKey(req.relin_key, ql)
    r_pw = ref_power_tensor(r_db.bfv, r_cts, plan.low, r_rk, r_db.eval_lvl, at_eval=False)
    pw = compute_power_tensor(db.bfv, cts, plan.low, rk, db.eval_lvl)
    assert _eq(r_pw, pw)
    B, C, N = db.coeff_cache.shape[0], db.coeff_cache.shape[1], db.coeff_cache.shape[-1]
    mask = np.random.default_rng(3).integers(0, db.bfv.t, size=(B, C, N), dtype=np.uint64)
    mask = mask.astype(np.uint32)
    r_res = ref_eval(r_db.bfv, jax.numpy.moveaxis(r_pw, 0, 1), r_db.coeff_cache,
                     r_db.const_slots, mask, r_db.eval_lvl)
    res = eval_matching_polys(db.bfv, pw.movedim(0, 1).contiguous(), db.coeff_cache,
                              db.const_slots, db.bfv.tensor(mask), db.eval_lvl)
    assert res.level == r_res.level and _eq(r_res.data, res.data)


def test_run_query_matches_reference(both):
    r_resp, resp = both["r_resp"], both["resp"]
    assert np.array_equal(both["recv"].last_mask, both["r_recv"].last_mask)
    assert resp.eval_level == r_resp.eval_level
    assert _eq(r_resp.results, resp.results)
    # the sender's decryption and the endgame's felt blocks agree too
    r_mat = both["r_snd"].extract_matrix(r_resp)
    mat = both["snd"].extract_matrix(resp)
    assert np.array_equal(r_mat, mat)
    assert np.array_equal(both["r_snd"].peqt_matrix(r_mat), both["snd"].peqt_matrix(mat))
    assert np.array_equal(both["r_recv"].peqt_matrix(), both["recv"].peqt_matrix())


def test_run_psu_matches_reference(both):
    ref_p, port_p = both["ref_p"], both["port_p"]
    db_items, query = both["db_items"], both["query"]
    want = ref_run_psu(ref_p, query, db_items,
                       sender=RefSender(ref_p, RefOprf(), rng=np.random.default_rng(31)),
                       receiver=RefReceiver(ref_p, both["r_db"], rng=np.random.default_rng(32)))
    got = run_psu(port_p, query, db_items,
                  sender=Sender(port_p, DebugOprf(), rng=np.random.default_rng(31), device="cpu"),
                  receiver=Receiver(port_p, both["db"], rng=np.random.default_rng(32)))
    assert np.array_equal(want.transferred, got.transferred)
    assert np.array_equal(want.union, got.union)
    check_oracle(db_items, query, got)


def test_run_psu_builds_its_own_parties():
    """run_psu with no parties given: the DB from items, CsRng secrets."""
    _, port_p = _params("dag")
    db_items, query = make_sets(np.random.default_rng(6), n_db=200, n_query=30, n_common=11)
    res = run_psu(port_p, query, db_items, device="cpu")
    check_oracle(db_items, query, res)
    assert set(res.timings) == {"db_build", "sender_setup", "create_query", "run_query",
                                "decrypt", "endgame"}


def test_query_validation_rejects_bad_requests(both):
    recv, req = both["recv"], both["req"]
    bad = QueryRequest(tuple(list(req.power_list)[:-1] + [99]), req.powers_data, req.relin_key)
    with pytest.raises(ValueError, match="query powers"):
        recv.run_query(bad)
    half = req.powers_data[..., : req.powers_data.shape[-1] // 2]
    with pytest.raises(ValueError, match="degree mismatch"):
        recv.run_query(QueryRequest(req.power_list, half, req.relin_key))


def test_slots_to_item_blocks_matches_reference():
    from apsu_tpu.api.parties import _slots_to_item_blocks as ref_blocks

    ref_p, port_p = _params("1M-2048-cmp")
    m = np.random.default_rng(4).integers(0, 40961, size=(5, 3, 4096)).astype(np.uint32)
    assert np.array_equal(ref_blocks(ref_p, m), _slots_to_item_blocks(port_p, m))


# ---------------------------------------------------------------------------
# full width, on the GPU host
# ---------------------------------------------------------------------------

@pytest.mark.slow
def test_run_psu_matches_reference_1m_2048_cmp():
    """run_psu at 1M-2048-cmp, 2^20 DB items × 2048 query items (1024 in the
    DB): the port (on the card where there is one) against the reference on
    the host's CPU, with the same seeded parties."""
    device = "cuda" if torch.cuda.is_available() else "cpu"
    ref_p, port_p = _params("1M-2048-cmp")
    db_items, query = make_sets(np.random.default_rng(0), n_db=1 << 20, n_query=2048,
                                n_common=1024)
    r_db = RefDB(ref_p, RefOprf())
    r_db.set_data(db_items)
    want = ref_run_psu(ref_p, query, db_items,
                       sender=RefSender(ref_p, RefOprf(), rng=np.random.default_rng(1)),
                       receiver=RefReceiver(ref_p, r_db, rng=np.random.default_rng(2)))
    del r_db
    db = ReceiverDB(port_p, DebugOprf(), device=device)
    db.set_data(db_items)
    got = run_psu(port_p, query, db_items,
                  sender=Sender(port_p, DebugOprf(), rng=np.random.default_rng(1), device=device),
                  receiver=Receiver(port_p, db, rng=np.random.default_rng(2)))
    assert np.array_equal(want.transferred, got.transferred)
    assert np.array_equal(want.union, got.union)
    check_oracle(db_items, query, got)


@pytest.mark.slow
def test_run_psu_matches_reference_1m_256_288():
    """run_psu at 1M-256-288's parameters (N=4096, 512 powers: the dot product
    over 520 planes), the DB cut to 3000 items, a 256-item query (128 in the
    DB): the port on the CPU (the kernels' plain versions) against the
    reference with the same seeded parties — one query's response and mask,
    then run_psu's transferred items and union."""
    ref_p, port_p = _params("1M-256-288")
    db_items, query = make_sets(np.random.default_rng(3), n_db=3000, n_query=256, n_common=128)
    r_db = RefDB(ref_p, RefOprf())
    r_db.set_data(db_items)
    db = ReceiverDB(port_p, DebugOprf(), device="cpu")
    db.set_data(db_items)
    r_recv = RefReceiver(ref_p, r_db, rng=np.random.default_rng(42))
    recv = Receiver(port_p, db, rng=np.random.default_rng(42))
    r_resp = r_recv.run_query(
        RefSender(ref_p, RefOprf(), rng=np.random.default_rng(41)).create_query(query))
    resp = recv.run_query(
        Sender(port_p, DebugOprf(), rng=np.random.default_rng(41), device="cpu").create_query(query))
    assert resp.results.shape[-4:] == (1, 2, 3, 4096)   # C=1 cache, 3 eval limbs
    assert np.array_equal(recv.last_mask, r_recv.last_mask)
    assert _eq(r_resp.results, resp.results)
    want = ref_run_psu(ref_p, query, db_items,
                       sender=RefSender(ref_p, RefOprf(), rng=np.random.default_rng(43)),
                       receiver=RefReceiver(ref_p, r_db, rng=np.random.default_rng(44)))
    got = run_psu(port_p, query, db_items,
                  sender=Sender(port_p, DebugOprf(), rng=np.random.default_rng(43), device="cpu"),
                  receiver=Receiver(port_p, db, rng=np.random.default_rng(44)))
    assert np.array_equal(want.transferred, got.transferred)
    assert np.array_equal(want.union, got.union)
    check_oracle(db_items, query, got)
