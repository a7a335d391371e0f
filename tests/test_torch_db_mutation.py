"""The port's incremental DB mutation, partitions and rebinding against the
reference, on the CPU at small_params()-sized sets: twins of the eight tests
of tests/test_db_mutation.py, each holding the port's cache, constants, host
roots and counts and stats bit for bit against apsu_tpu's after every step
(tolerance 0), and the queries' response ciphertexts and set algebra after
them.  Two tests hold the port alone to what it does differently: it refuses
to insert into a labeled DB, and its remove keeps every remaining labeled
item at its place.  (The set helpers are copied here: a GPU host may have
another package named ``tests`` on its path.)"""

import jax
import numpy as np
import pytest
import torch

from apsu_tpu.api.parties import Receiver as RefReceiver
from apsu_tpu.api.parties import Sender as RefSender
from apsu_tpu.api.parties import _slots_to_item_blocks as ref_blocks
from apsu_tpu.core.bfv import BfvContext as RefBfv
from apsu_tpu.core.params import PSUParams as RefParams
from apsu_tpu.db.receiver_db import ReceiverDB as RefDB
from apsu_tpu.mpc.oprf import DebugOprf as RefOprf
from apsu_tpu_torch.api.parties import Receiver, Sender, _slots_to_item_blocks
from apsu_tpu_torch.api.protocol import DebugEndgame, PsuResult
from apsu_tpu_torch.core.mod32 import to_u32
from apsu_tpu_torch.core.params import PSUParams
from apsu_tpu_torch.db.receiver_db import ReceiverDB
from apsu_tpu_torch.mpc.oprf import DebugOprf


def small_params(table_size=64, max_items_per_bin=8, hash_func_count=2, n=256,
                 query_powers=(1, 2, 3, 4, 5, 6, 7, 8), ps_low_degree=0,
                 coeff_bits=(40, 40, 30), plain_modulus=65537):
    """tests/test_psu_e2e.py:small_params as a dict, for both packages."""
    d = {
        "table_params": {"hash_func_count": hash_func_count, "table_size": table_size,
                         "max_items_per_bin": max_items_per_bin},
        "item_params": {"felts_per_item": 4},
        "query_params": {"ps_low_degree": ps_low_degree, "query_powers": list(query_powers)},
        "seal_params": {"plain_modulus": plain_modulus, "poly_modulus_degree": n,
                        "coeff_modulus_bits": list(coeff_bits)},
    }
    return RefParams.from_dict(d), PSUParams.from_dict(d)


def as_set(a):
    return {(int(x), int(y)) for x, y in a}


def check_oracle(db, query, result):
    """The set algebra of tests/test_psu_e2e.py:check_oracle."""
    dbs, qs = as_set(db), as_set(query)
    trans, union = as_set(result.transferred), as_set(result.union)
    assert trans == qs - dbs
    assert union == dbs | qs
    assert not (trans & dbs)
    assert len(union) == len(dbs) + len(qs - dbs)


_REF_BFV = {}


def ref_db(rp, oprf, **kw):
    """A reference DB; DBs of one parameter set share one BfvContext, so the
    reference compiles its programs once a set."""
    key = rp.to_json()
    if key not in _REF_BFV:
        _REF_BFV[key] = RefBfv(rp.seal_params)
    return RefDB(rp, oprf, bfv=_REF_BFV[key], **kw)


def _u32(x):
    return np.asarray(jax.device_get(x))


def assert_same_db(ref, db):
    """Every tensor and host array of the two DBs equal, bit for bit."""
    assert np.array_equal(_u32(ref.coeff_cache), to_u32(db.coeff_cache))
    assert np.array_equal(_u32(ref.const_slots), to_u32(db.const_slots))
    if ref.ps_const_polys is not None or db.ps_const_polys is not None:
        assert np.array_equal(_u32(ref.ps_const_polys), to_u32(db.ps_const_polys))
    for name in ("_roots", "_counts"):
        r, p = getattr(ref, name), getattr(db, name)
        assert (r is None and p is None) or np.array_equal(r, p), name
    assert (ref.eval_lvl, ref.result_lvl) == (db.eval_lvl, db.result_lvl)
    a, b = ref.stats, db.stats
    assert (a.n_items, a.n_insertions, a.n_caches, a.max_bin_load) == (
        b.n_items, b.n_insertions, b.n_caches, b.max_bin_load)
    assert np.array_equal(a.cache_counts, b.cache_counts)


def psu_both(rp, pp, ref_db, db, query, db_items, seed):
    """One query of both DBs by the same seeded parties: the response
    ciphertexts are bit-identical, and the port's union (run_psu's endgame)
    passes the oracle."""
    r_snd = RefSender(rp, ref_db.oprf, rng=np.random.default_rng(seed))
    snd = Sender(pp, db.oprf, rng=np.random.default_rng(seed), device="cpu")
    rcv = Receiver(pp, db, rng=np.random.default_rng(seed + 1))
    r_resp = RefReceiver(rp, ref_db, rng=np.random.default_rng(seed + 1)).run_query(
        r_snd.create_query(query))
    resp = rcv.run_query(snd.create_query(query))
    assert np.array_equal(_u32(r_resp.results), to_u32(resp.results))
    transferred = DebugEndgame().run(snd.peqt_matrix(snd.extract_matrix(resp)),
                                     rcv.peqt_matrix(), snd.cuckoo.table, snd.cuckoo.filled)
    union = np.unique(np.concatenate([db_items, transferred]), axis=0)
    check_oracle(db_items, query, PsuResult(union=union, transferred=transferred))


def test_insert_remove_then_query_matches_fresh_build():
    rng = np.random.default_rng(31)
    rp, pp = small_params()
    base_items = rng.integers(0, 1 << 64, size=(220, 2), dtype=np.uint64)
    extra = rng.integers(0, 1 << 64, size=(60, 2), dtype=np.uint64)
    gone = base_items[rng.choice(220, size=40, replace=False)]

    ref = ref_db(rp, RefOprf(0x5EED))
    db = ReceiverDB(pp, DebugOprf(0x5EED), device="cpu")
    for step in (lambda d: d.set_data(base_items), lambda d: d.insert_or_assign(extra),
                 lambda d: d.remove(gone)):
        step(ref)
        step(db)
        assert_same_db(ref, db)
    assert not db.can_rebind

    final_items = np.array(sorted(as_set(np.concatenate([base_items, extra])) - as_set(gone)),
                           dtype=np.uint64)
    query = np.concatenate([
        rng.integers(0, 1 << 64, size=(20, 2), dtype=np.uint64),
        final_items[rng.choice(len(final_items), size=12, replace=False)],
        gone[:5],  # removed items must not match any more
    ])
    psu_both(rp, pp, ref, db, query, final_items, seed=40)


def test_has_item_and_idempotent_insert():
    rng = np.random.default_rng(32)
    rp, pp = small_params()
    items = rng.integers(0, 1 << 64, size=(150, 2), dtype=np.uint64)
    other = rng.integers(0, 1 << 64, size=(10, 2), dtype=np.uint64)
    ref = ref_db(rp, RefOprf())
    ref.set_data(items)
    db = ReceiverDB(pp, DebugOprf(), device="cpu")
    db.set_data(items)
    probe = np.concatenate([items[:20], other])
    got = db.has_item(probe)
    assert np.array_equal(got, ref.has_item(probe))
    assert got[:20].all() and not got[20:].any()

    before = db.stats.n_insertions
    ref.insert_or_assign(items[:20])
    db.insert_or_assign(items[:20])  # all present: no-op
    assert db.stats.n_insertions == before
    assert_same_db(ref, db)


def test_insert_grows_cache_axis():
    """Inserting past K per bin spills into a new cache; the port rebuilds
    the grown cache after releasing the old one, to the reference's bits."""
    rng = np.random.default_rng(33)
    rp, pp = small_params(table_size=64, max_items_per_bin=4, hash_func_count=2,
                          query_powers=(1, 2, 3, 4))
    items = rng.integers(0, 1 << 64, size=(80, 2), dtype=np.uint64)
    ref = ref_db(rp, RefOprf())
    ref.set_data(items)
    db = ReceiverDB(pp, DebugOprf(), device="cpu")
    db.set_data(items)
    c_before = db.stats.n_caches
    extra = rng.integers(0, 1 << 64, size=(120, 2), dtype=np.uint64)
    ref.insert_or_assign(extra)
    db.insert_or_assign(extra)
    assert db.stats.n_caches > c_before
    assert db.coeff_cache.shape[1] == db.stats.n_caches
    assert_same_db(ref, db)
    all_items = np.unique(np.concatenate([items, extra]), axis=0)
    query = np.concatenate([rng.integers(0, 1 << 64, size=(15, 2), dtype=np.uint64),
                            all_items[:10]])
    psu_both(rp, pp, ref, db, query, all_items, seed=50)


def test_stripped_db_refuses_mutation():
    rng = np.random.default_rng(34)
    _, pp = small_params()
    items = rng.integers(0, 1 << 64, size=(100, 2), dtype=np.uint64)
    db = ReceiverDB(pp, DebugOprf(), device="cpu")
    db.set_data(items)
    db.strip()
    assert db._roots is None and db._counts is None and not db.can_rebind
    for mutate in (db.insert_or_assign, db.remove, db.has_item):
        with pytest.raises(ValueError, match="stripped"):
            mutate(items[:5])


def test_rebind_matches_fresh_build():
    """rebind(oprf) over the retained placement gives the cache a fresh
    set_data gives under the new OPRF, and the reference's rebind."""
    rng = np.random.default_rng(34)
    rp, pp = small_params()
    items = rng.integers(0, 1 << 64, size=(200, 2), dtype=np.uint64)
    ref = ref_db(rp, RefOprf(0xAAA))
    ref.set_data(items)
    resident = ReceiverDB(pp, DebugOprf(0xAAA), device="cpu")
    resident.set_data(items)
    assert resident.can_rebind

    fresh = ReceiverDB(pp, DebugOprf(0xBBB), bfv=resident.bfv)
    fresh.set_data(items)
    rebound = resident.rebind(DebugOprf(0xBBB))
    ref_rebound = ref.rebind(RefOprf(0xBBB))
    assert rebound.stats == fresh.stats
    assert np.array_equal(to_u32(rebound.coeff_cache), to_u32(fresh.coeff_cache))
    assert_same_db(ref_rebound, rebound)
    assert resident.can_rebind and rebound.can_rebind

    query = np.concatenate([rng.integers(0, 1 << 64, size=(24, 2), dtype=np.uint64),
                            items[rng.choice(len(items), size=8, replace=False)]])
    psu_both(rp, pp, ref_rebound, rebound, query, items, seed=60)


def test_rebind_refuses_after_mutation_or_strip():
    rng = np.random.default_rng(35)
    _, pp = small_params()
    items = rng.integers(0, 1 << 64, size=(120, 2), dtype=np.uint64)
    db = ReceiverDB(pp, DebugOprf(), device="cpu")
    db.set_data(items)
    db.insert_or_assign(rng.integers(0, 1 << 64, size=(5, 2), dtype=np.uint64))
    assert not db.can_rebind
    with pytest.raises(ValueError):
        db.rebind(DebugOprf(1))

    db2 = ReceiverDB(pp, DebugOprf(), bfv=db.bfv, device="cpu")
    db2.set_data(items)
    db2.remove(items[:3])
    assert not db2.can_rebind

    db3 = ReceiverDB(pp, DebugOprf(), bfv=db.bfv, device="cpu")
    db3.set_data(items)
    assert db3.can_rebind
    db3.strip()
    assert not db3.can_rebind
    with pytest.raises(ValueError):
        db3.rebind(DebugOprf(2))


def test_place_data_build_partition_matches_direct():
    """Place once, then materialize each cache-range partition: bit-identical
    to a direct cache-range set_data and to the reference's partitions."""
    rng = np.random.default_rng(37)
    rp, pp = small_params(table_size=128, hash_func_count=3, max_items_per_bin=8)
    items = rng.integers(0, 1 << 64, size=(900, 2), dtype=np.uint64)

    ref_placer = ref_db(rp, RefOprf(0xCC))
    placer = ReceiverDB(pp, DebugOprf(0xCC), device="cpu")
    C_total = placer.place_data(items)
    assert C_total == ref_placer.place_data(items)
    assert C_total >= 2, "test shape must overflow into multiple caches"
    assert placer.coeff_cache is None

    for c0 in range(0, C_total, 2):
        c1 = min(C_total, c0 + 2)
        part = placer.build_partition((c0, c1))
        direct = ReceiverDB(pp, DebugOprf(0xCC), bfv=placer.bfv, cache_range=(c0, c1))
        direct.set_data(items)
        assert part.stats == direct.stats and part.cache_range == (c0, c1)
        for name in ("coeff_cache", "const_slots"):
            assert np.array_equal(to_u32(getattr(part, name)), to_u32(getattr(direct, name)))
        assert_same_db(ref_placer.build_partition((c0, c1)), part)
        with pytest.raises(ValueError, match="build-once"):
            part.insert_or_assign(items[:2])


def test_rebind_forwards_loc_seed():
    """A rebound DB keeps the resident's location seed, so a later mutation
    computes the same cuckoo locations (those of the reference, too)."""
    rng = np.random.default_rng(36)
    rp, pp = small_params()
    items = rng.integers(0, 1 << 64, size=(150, 2), dtype=np.uint64)
    seed = b"custom-loc-seed"
    ref = ref_db(rp, RefOprf(0xAAA), loc_seed=seed)
    ref.set_data(items)
    db = ReceiverDB(pp, DebugOprf(0xAAA), loc_seed=seed, device="cpu")
    db.set_data(items)
    assert_same_db(ref, db)
    rebound = db.rebind(DebugOprf(0xBBB))
    assert rebound._loc_seed == seed
    item = items[7:8]
    assert np.array_equal(db.locs.locations(item), rebound.locs.locations(item))
    assert np.array_equal(rebound.locs.locations(items), ref.locs.locations(items))
    assert not np.array_equal(ReceiverDB(pp, device="cpu").locs.locations(items),
                              rebound.locs.locations(items))


# ---------------------------------------------------------------------------
# labeled DBs: where the port differs from the reference
# ---------------------------------------------------------------------------

def _labels(items, nbytes, rng):
    lab = np.zeros((len(items), 16), dtype=np.uint8)
    lab[:, :nbytes] = rng.integers(0, 256, size=(len(items), nbytes))
    return lab


def test_insert_into_labeled_db_is_refused():
    """The port refuses insert_or_assign on a labeled DB; the DB is left as
    built.  The reference accepts it and rebuilds the matching cache only,
    so each inserted item that is queried matches, with label bytes that
    are no label given."""
    rng = np.random.default_rng(41)
    rp, pp = small_params()
    items = rng.integers(0, 1 << 64, size=(250, 2), dtype=np.uint64)
    labels = _labels(items, pp.item_bit_count // 8, rng)
    new = rng.integers(0, 1 << 64, size=(10, 2), dtype=np.uint64)
    db = ReceiverDB(pp, DebugOprf(), device="cpu")
    db.set_data(items, labels=labels)
    before = (to_u32(db.coeff_cache), to_u32(db.label_cache), db.stats)
    with pytest.raises(ValueError, match="labeled DBs are build-once for insertion"):
        db.insert_or_assign(new)
    assert np.array_equal(before[0], to_u32(db.coeff_cache))
    assert np.array_equal(before[1], to_u32(db.label_cache))
    assert before[2] == db.stats

    ref = ref_db(rp, RefOprf())
    ref.set_data(items, labels=labels)
    ref.insert_or_assign(new)
    got = _labeled_query(rp, ref, new[:5], RefOprf(), RefSender, RefReceiver, ref_blocks)
    assert set(got) == as_set(new[:5])
    assert not {bytes(lab) for lab in labels} & set(got.values())


def _present_pairs(db, items):
    """Per (item, slot) pair of ``items``: is it among its bin's entries?"""
    slots, rep, felts = db._locations_felts(items)
    c, _ = db._find_entries(slots.astype(np.int64), felts)
    return slots, rep, c >= 0


def _labeled_query(params, db, items, oprf, Snd, Rcv, blocks, **kw):
    """One query of ``items`` (inserted into the cuckoo table in that order);
    returns {item: label bytes} of the items that matched."""
    snd = Snd(params, oprf, rng=np.random.default_rng(3), **kw)
    req = snd.create_query(items)
    rcv = Rcv(params, db, rng=np.random.default_rng(4))
    resp = rcv.run_query(req)
    mb = blocks(params, np.asarray(snd.extract_matrix(resp)))
    kb = blocks(params, rcv.last_mask)
    labels = snd.extract_labels(resp)
    got = {}
    for s in np.flatnonzero(snd.cuckoo.filled):
        for c in range(mb.shape[0]):
            if np.array_equal(mb[c, s], kb[c, s]):
                got[(int(snd.cuckoo.table[s, 0]), int(snd.cuckoo.table[s, 1]))] = bytes(labels[c, s])
    return got


def test_remove_on_labeled_db_keeps_labels():
    """remove on a labeled DB compacts each cache on its own: every
    remaining (item, slot) pair stays in its cache, whose label polynomial
    (left as built) still gives the item its label, and the removed items no
    longer match.  The set (t = 7681: 12-bit felts) makes felts collide in a
    bin, so the collision-aware placement leaves a cache part-filled below
    a filled one; the reference's remove compacts such a bin as one run and
    loses the pair of the later cache, which the query then misses."""
    rng = np.random.default_rng(1)
    rp, pp = small_params(plain_modulus=7681)
    n = 1000
    items = rng.integers(0, 1 << 64, size=(n, 2), dtype=np.uint64)
    labels = _labels(items, pp.item_bit_count // 8, rng)
    want = {(int(a), int(b)): bytes(lab) for (a, b), lab in zip(items.tolist(), labels)}
    gone, kept = items[:100], items[100:]

    ref = ref_db(rp, RefOprf())
    ref.set_data(items, labels=labels)
    db = ReceiverDB(pp, DebugOprf(), device="cpu")
    db.set_data(items, labels=labels)
    assert_same_db(ref, db)
    assert np.array_equal(_u32(ref.label_cache), to_u32(db.label_cache))
    label_cache = to_u32(db.label_cache)
    ref.remove(gone)
    db.remove(gone)

    # n_items drops by the removed (item, slot) pairs, as the reference's does
    assert db.stats.n_items == ref.stats.n_items == n - 199
    assert not db.has_item(gone).any()
    assert np.array_equal(to_u32(db.label_cache), label_cache)
    slots, rep, present = _present_pairs(db, kept)
    assert present.all()
    _, _, ref_present = _present_pairs(ref, kept)
    lost = np.flatnonzero(~ref_present)
    assert len(lost) == 1, "the set must show the reference's lost pair"

    # query the item of the lost pair at that pair's slot: insert a blocker
    # first when the slot is the item's second location
    item, slot = rep[lost[0]], int(slots[lost[0]])
    locs = db.locs.locations(item[None])[0]
    query = item[None]
    if locs[0] != slot:
        cand = rng.integers(0, 1 << 64, size=(4096, 2), dtype=np.uint64)
        blocker = cand[db.locs.locations(cand)[:, 0] == locs[0]][:1]
        query = np.concatenate([blocker, query])
    query = np.concatenate([query, kept[:20], gone[:10]])
    key = (int(item[0]), int(item[1]))

    got = _labeled_query(pp, db, query, DebugOprf(), Sender, Receiver, _slots_to_item_blocks,
                         device="cpu")
    assert set(got) == as_set(query) & as_set(kept)
    assert all(got[k] == want[k] for k in got)
    assert got[key] == want[key]
    ref_got = _labeled_query(rp, ref, query, RefOprf(), RefSender, RefReceiver, ref_blocks)
    assert key not in ref_got and set(ref_got) == set(got) - {key}


def test_build_in_cache_groups_matches_reference(monkeypatch):
    """The device build one cache at a time (the smallest build groups)
    gives the reference's caches, labeled and unlabeled, and so does an
    insert that grows the cache axis; on a PS set, the chunk constants
    gathered group by group equal a build in one piece."""
    from apsu_tpu_torch.db import receiver_db

    monkeypatch.setattr(receiver_db, "BUILD_SHARE", 1 << 40)
    monkeypatch.setattr(receiver_db, "LIFT_CHUNK_BYTES", 1)
    rng = np.random.default_rng(38)
    rp, pp = small_params(table_size=64, max_items_per_bin=4, hash_func_count=2,
                          query_powers=(1, 2, 3, 4))
    items = rng.integers(0, 1 << 64, size=(150, 2), dtype=np.uint64)
    labels = _labels(items, pp.item_bit_count // 8, rng)
    ref = ref_db(rp, RefOprf())
    ref.set_data(items, labels=labels)
    db = ReceiverDB(pp, DebugOprf(), device="cpu")
    db.set_data(items, labels=labels)
    assert db.stats.n_caches > 1
    assert_same_db(ref, db)
    for name in ("label_cache", "label0_slots"):
        assert np.array_equal(_u32(getattr(ref, name)), to_u32(getattr(db, name)))

    ref = ref_db(rp, RefOprf())
    ref.set_data(items)
    db = ReceiverDB(pp, DebugOprf(), device="cpu")
    db.set_data(items)
    extra = rng.integers(0, 1 << 64, size=(120, 2), dtype=np.uint64)
    ref.insert_or_assign(extra)
    db.insert_or_assign(extra)
    assert_same_db(ref, db)
    _, ps = small_params(max_items_per_bin=16, ps_low_degree=3, query_powers=(1, 2, 3, 4, 8),
                         coeff_bits=(48, 48, 48, 28))
    many = rng.integers(0, 1 << 64, size=(700, 2), dtype=np.uint64)
    grouped = ReceiverDB(ps, DebugOprf(), device="cpu")
    grouped.set_data(many)
    monkeypatch.setattr(receiver_db, "BUILD_SHARE", 1)
    monkeypatch.setattr(receiver_db, "LIFT_CHUNK_BYTES", 1 << 40)
    whole = ReceiverDB(ps, DebugOprf(), device="cpu")
    whole.set_data(many)
    assert grouped.stats.n_caches > 1
    for name in ("coeff_cache", "const_slots", "ps_const_polys"):
        assert torch.equal(getattr(grouped, name), getattr(whole, name)), name
