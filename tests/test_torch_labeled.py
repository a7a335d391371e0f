"""Labeled mode in the port against the reference, on the CPU at
small_params()-sized sets (twins of the four tests of tests/test_labeled.py):
the labeled DB's caches, the query's two response ciphertexts and the
decrypted labels bit for bit (tolerance 0) with the same seeded parties, the
label encryptor byte for byte, the value types, the capacity check; plus
``newton_interpolate`` and ``eval_matching_polys_labeled`` against the
reference at small shapes.  (The set helpers are copied here: a GPU host may
have another package named ``tests`` on its path.)"""

import jax
import numpy as np
import pytest

from apsu_tpu.api.parties import Receiver as RefReceiver
from apsu_tpu.api.parties import Sender as RefSender
from apsu_tpu.core.bfv import BfvContext as RefBfv
from apsu_tpu.core.params import PSUParams as RefParams
from apsu_tpu.db.receiver_db import ReceiverDB as RefDB
from apsu_tpu.engine.evaluator import eval_matching_polys_labeled as ref_eval_labeled
from apsu_tpu.engine.interpolate import newton_interpolate as ref_newton
from apsu_tpu.hash import items as ref_items
from apsu_tpu.mpc.oprf import DebugOprf as RefOprf
from apsu_tpu.mpc.prg import CsRng as RefCsRng
from apsu_tpu_torch.api.parties import Receiver, Sender, _slots_to_item_blocks
from apsu_tpu_torch.core.bfv import BfvContext
from apsu_tpu_torch.core.mod32 import from_u32, to_u32
from apsu_tpu_torch.core.params import PSUParams
from apsu_tpu_torch.db.receiver_db import ReceiverDB
from apsu_tpu_torch.engine.evaluator import eval_matching_polys_labeled
from apsu_tpu_torch.engine.interpolate import newton_interpolate
from apsu_tpu_torch.hash.items import Bitstring, Item, _label_key, decrypt_label, encrypt_label
from apsu_tpu_torch.mpc.oprf import DebugOprf
from apsu_tpu_torch.mpc.prg import CsRng

SMALL = {  # tests/test_psu_e2e.py:small_params()
    "table_params": {"hash_func_count": 2, "table_size": 64, "max_items_per_bin": 8},
    "item_params": {"felts_per_item": 4},
    "query_params": {"ps_low_degree": 0, "query_powers": [1, 2, 3, 4, 5, 6, 7, 8]},
    "seal_params": {"plain_modulus": 65537, "poly_modulus_degree": 256,
                    "coeff_modulus_bits": [40, 40, 30]},
}


def _u32(x):
    return np.asarray(jax.device_get(x))


def make_sets(rng, n_db, n_query, n_common):
    db = rng.integers(0, 1 << 64, size=(n_db, 2), dtype=np.uint64)
    fresh = rng.integers(0, 1 << 64, size=(n_query - n_common, 2), dtype=np.uint64)
    common = db[rng.choice(n_db, size=n_common, replace=False)]
    query = np.concatenate([fresh, common])
    rng.shuffle(query)
    return db, query


def _labels_for(items: np.ndarray, cap_bits: int) -> np.ndarray:
    """Deterministic per-item labels fitting the felt capacity (as
    tests/test_labeled.py makes them)."""
    lab = np.zeros((len(items), 16), dtype=np.uint8)
    cap_bytes = cap_bits // 8
    for i, (lo, hi) in enumerate(items):
        d = (int(lo) ^ 0xA5A5A5A5A5A5A5A5).to_bytes(8, "little") + int(hi).to_bytes(8, "little")
        lab[i, :cap_bytes] = np.frombuffer(d[:cap_bytes], dtype=np.uint8)
    return lab


def test_labeled_query_recovers_labels():
    rng = np.random.default_rng(41)
    rp, pp = RefParams.from_dict(SMALL), PSUParams.from_dict(SMALL)
    db_items, query = make_sets(rng, n_db=250, n_query=30, n_common=12)
    labels = _labels_for(db_items, pp.item_bit_count)

    ref = RefDB(rp, RefOprf())
    ref.set_data(db_items, labels=labels)
    db = ReceiverDB(pp, DebugOprf(), device="cpu")
    db.set_data(db_items, labels=labels)
    assert db.label_cache is not None and not db.can_rebind
    assert db.eval_lvl == ref.eval_lvl == db.labeled_eval_level() == ref.labeled_eval_level()
    for name in ("coeff_cache", "const_slots", "label_cache", "label0_slots"):
        assert np.array_equal(_u32(getattr(ref, name)), to_u32(getattr(db, name))), name
    assert np.array_equal(ref._roots, db._roots) and np.array_equal(ref._counts, db._counts)

    r_snd = RefSender(rp, RefOprf(), rng=RefCsRng(b"labeled-test-sender-key1"))
    r_recv = RefReceiver(rp, ref, rng=RefCsRng(b"labeled-test-receiver-k1"))
    r_resp = r_recv.run_query(r_snd.create_query(query))
    snd = Sender(pp, DebugOprf(), rng=CsRng(b"labeled-test-sender-key1"), device="cpu")
    recv = Receiver(pp, db, rng=CsRng(b"labeled-test-receiver-k1"))
    resp = recv.run_query(snd.create_query(query))
    assert resp.label_results is not None
    assert np.array_equal(_u32(r_resp.results), to_u32(resp.results))
    assert np.array_equal(_u32(r_resp.label_results), to_u32(resp.label_results))
    assert np.array_equal(r_recv.last_mask, recv.last_mask)

    mat = snd.extract_matrix(resp)
    label_rows = snd.extract_labels(resp)      # [C, S, 16]
    assert np.array_equal(label_rows, r_snd.extract_labels(r_resp))
    label_by_item = {(int(a), int(b)): bytes(l) for (a, b), l in zip(db_items.tolist(), labels)}
    match_blocks = _slots_to_item_blocks(pp, mat)
    mask_blocks = _slots_to_item_blocks(pp, recv.last_mask)
    matched = 0
    for s in np.flatnonzero(snd.cuckoo.filled):
        key = (int(snd.cuckoo.table[s, 0]), int(snd.cuckoo.table[s, 1]))
        for c in range(match_blocks.shape[0]):
            if np.array_equal(match_blocks[c, s], mask_blocks[c, s]):
                assert key in label_by_item, "false match in labeled test"
                assert bytes(label_rows[c, s]) == label_by_item[key], f"label mismatch at slot {s}"
                matched += 1
    assert matched >= 10, "planted matches not found"


def test_label_encryptor_roundtrip():
    rng = np.random.default_rng(42)
    item = rng.integers(0, 1 << 64, size=(1, 2), dtype=np.uint64)
    other = rng.integers(0, 1 << 64, size=(1, 2), dtype=np.uint64)
    label = b"secret-label-16b"
    nonce = bytes(rng.integers(0, 256, size=16, dtype=np.uint8))
    blob = encrypt_label(label, item, nonce)
    assert blob == ref_items.encrypt_label(label, item, nonce)
    assert decrypt_label(blob, item) == label == ref_items.decrypt_label(blob, item)
    assert decrypt_label(blob, other) != label
    assert ref_items._label_key(item, nonce) == _label_key(item, nonce)
    with pytest.raises(ValueError, match="16 bytes"):
        encrypt_label(label, item, nonce[:8])


def test_item_and_bitstring_types():
    a, b, c = Item.of("hello"), Item.of("hello"), Item.of("world")
    assert a == b and a != c
    assert a.to_array().shape == (1, 2)
    ra = ref_items.Item.of("hello")
    assert (a.lo, a.hi) == (ra.lo, ra.hi)
    assert np.array_equal(a.to_array(), ra.to_array())

    Bitstring(b"\x0f", 4)
    with pytest.raises(ValueError):
        Bitstring(b"\xff", 4)  # nonzero padding bits
    with pytest.raises(ValueError):
        Bitstring(b"\x00\x00", 4)  # wrong length


def test_oversized_label_rejected():
    rng = np.random.default_rng(43)
    pp = PSUParams.from_dict(SMALL)  # 4 felts × 16 bits = 64-bit capacity
    items = rng.integers(0, 1 << 64, size=(50, 2), dtype=np.uint64)
    labels = rng.integers(0, 256, size=(50, 16), dtype=np.uint8)  # full 128 bits
    db = ReceiverDB(pp, DebugOprf(), device="cpu")
    with pytest.raises(ValueError, match="capacity"):
        db.set_data(items, labels=labels)
    with pytest.raises(ValueError, match="cache_range"):
        ReceiverDB(pp, DebugOprf(), cache_range=(0, 1), device="cpu").set_data(
            items, labels=_labels_for(items, pp.item_bit_count))


def test_newton_interpolate_matches_reference():
    """Distinct x-values per lane, every count from 0 to K; the result
    interpolates the points."""
    rng = np.random.default_rng(44)
    t, C, K, N = 65537, 3, 8, 64
    roots = np.stack([np.stack([rng.choice(t - 1, K, replace=False) + 1 for _ in range(N)], -1)
                      for _ in range(C)]).astype(np.uint32)      # [C, K, N]
    vals = rng.integers(0, t, size=(C, K, N)).astype(np.uint32)
    counts = (np.arange(C * N).reshape(C, N) % (K + 1)).astype(np.int32)
    want = _u32(jax.jit(lambda r, v, c: ref_newton(r, v, c, t))(roots, vals, counts))
    got = to_u32(newton_interpolate(from_u32(roots, "cpu"), from_u32(vals, "cpu"),
                                    from_u32(counts, "cpu"), t))
    assert np.array_equal(want, got)
    for c, n in [(0, 5), (1, 8), (2, 63)]:
        for i in range(counts[c, n]):
            x = int(roots[c, i, n])
            assert sum(int(got[c, j, n]) * pow(x, j, t) for j in range(K)) % t == vals[c, i, n]
    assert not got.transpose(0, 2, 1)[counts == 0].any()   # an empty lane gives L = 0


def test_eval_matching_polys_labeled_matches_reference():
    """Random NTT-domain powers and caches at [B, D, 2, L, N] =
    [2, 8, 2, 2, 256] and C = 3 caches of 16 planes: both ciphertexts."""
    rp, pp = RefParams.from_dict(SMALL), PSUParams.from_dict(SMALL)
    ref, port = RefBfv(rp.seal_params), BfvContext(pp.seal_params, device="cpu")
    lvl, rng = ref.q.k, np.random.default_rng(45)
    B, C, D, Dp, N, t = 2, 3, 8, 16, ref.n, ref.t
    primes = np.array(ref.q_primes, dtype=np.uint64)[:, None]

    def residues(shape):
        return (rng.integers(0, 1 << 62, size=shape, dtype=np.uint64) % primes).astype(np.uint32)

    powers = residues((B, D, 2, lvl, N))
    mcache, lcache = residues((B, C, Dp, lvl, N)), residues((B, C, Dp, lvl, N))
    slots = [rng.integers(0, t, size=(B, C, N)).astype(np.uint32) for _ in range(4)]
    slots[3] = np.maximum(slots[3], 1)  # ρ ≠ 0
    r_m, r_l = ref_eval_labeled(ref, powers, mcache, slots[0], slots[1], lcache, slots[2],
                                slots[3], lvl)
    p_m, p_l = eval_matching_polys_labeled(
        port, *(from_u32(x, "cpu") for x in (powers, mcache, slots[0], slots[1], lcache,
                                             slots[2], slots[3])), lvl)
    assert p_m.level == p_l.level == lvl and not p_m.is_ntt
    assert np.array_equal(_u32(r_m.data), to_u32(p_m.data))
    assert np.array_equal(_u32(r_l.data), to_u32(p_l.data))


@pytest.mark.slow
def test_labeled_query_matches_reference_1m_2048_cmp():
    """Labeled mode at 1M-2048-cmp's parameters (2048 DB items, 64 of 128
    query items in the DB): the port's two response ciphertexts and its
    decrypted label rows equal the reference's bit for bit, and both find
    exactly the DB's items.  The labels themselves are not exact in either
    package at this set: its labeled evaluation level is all three q primes
    (82 bits), and the ρ·M(x) blinding leaves the label results less than a
    bit of noise budget where the matching results keep more than ten
    (ROADMAP.md Queue 3)."""
    rng = np.random.default_rng(46)
    path = "parameters/1M-2048-cmp.json"
    rp, pp = RefParams.load_file(path), PSUParams.load_file(path)
    db_items, query = make_sets(rng, n_db=2048, n_query=128, n_common=64)
    labels = _labels_for(db_items, pp.item_bit_count)
    ref = RefDB(rp, RefOprf())
    ref.set_data(db_items, labels=labels)
    db = ReceiverDB(pp, DebugOprf(), device="cpu")
    db.set_data(db_items, labels=labels)
    assert db.eval_lvl == ref.eval_lvl == len(db.bfv.q_primes) == 3
    for name in ("coeff_cache", "label_cache", "label0_slots"):
        assert np.array_equal(_u32(getattr(ref, name)), to_u32(getattr(db, name))), name
    r_snd = RefSender(rp, RefOprf(), rng=np.random.default_rng(47))
    r_resp = RefReceiver(rp, ref, rng=np.random.default_rng(48)).run_query(r_snd.create_query(query))
    snd = Sender(pp, DebugOprf(), rng=np.random.default_rng(47), device="cpu")
    recv = Receiver(pp, db, rng=np.random.default_rng(48))
    resp = recv.run_query(snd.create_query(query))
    assert np.array_equal(_u32(r_resp.results), to_u32(resp.results))
    assert np.array_equal(_u32(r_resp.label_results), to_u32(resp.label_results))
    assert np.array_equal(r_snd.extract_labels(r_resp), snd.extract_labels(resp))
    hit = (_slots_to_item_blocks(pp, snd.extract_matrix(resp))
           == _slots_to_item_blocks(pp, recv.last_mask)).all(axis=2).any(axis=0)
    q_row = {tuple(d): i for i, d in enumerate(db_items.tolist())}
    q_in_db = np.array([tuple(q) in q_row for q in query.tolist()])
    in_db = snd.cuckoo.filled & q_in_db[np.maximum(snd.cuckoo.item_index, 0)]
    assert np.array_equal(hit, in_db) and hit.sum() == 64
    budget = {name: port_bfv_budget(snd, getattr(resp, name))
              for name in ("results", "label_results")}
    print("noise budget bits (bundle 0, cache 0):", budget)
    assert budget["results"] > 10 and budget["label_results"] < 1
    rows = snd.extract_labels(resp)[:, np.flatnonzero(in_db)]
    want = labels[[q_row[tuple(query[i])] for i in snd.cuckoo.item_index[in_db]]]
    assert not (rows == want[None]).all(axis=2).any(), "a label decrypted exactly"


def port_bfv_budget(snd, data):
    from apsu_tpu_torch.core.bfv import Ciphertext

    return snd.bfv.noise_budget(Ciphertext(data[0, 0], is_ntt=False, level=data.shape[-2]),
                                snd.sk)
