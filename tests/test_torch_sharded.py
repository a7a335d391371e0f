"""The port's sharded runtime against the JAX package's and against its own
direct path, bit for bit (tolerance 0), on the CPU at tests/test_sharded.py's
sizes: the port's meshes are ``make_mesh(devices=["cpu"] * n)`` (one device
repeated: the same row partition n devices would run), the reference's its
8-device virtual CPU mesh (tests/conftest.py).

* ``ShardedEvaluator.eval_query`` (kernel 3 a block) against the JAX
  ``ShardedEvaluator`` and the port's ``eval_matching_polys``;
* ``ShardedReceiver.run_query`` on the power-DAG set and on the PS set
  (sharded wavefront and evaluation, kernel 2 a row chunk) against the
  port's ``Receiver`` under one mask seed, on 8 shards (several empty) and
  on 5 uneven ones; against the JAX ``ShardedReceiver`` in the ``slow``
  tier (~70 s of JAX compiles);
* the labeled DB: the reference answers without label results, the port
  refuses it.

(The set helpers are copied here: a GPU host may have another package named
``tests`` on its path.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apsu_tpu.api.parties import Receiver as RefReceiver
from apsu_tpu.api.parties import Sender as RefSender
from apsu_tpu.core.bfv import Ciphertext as RefCt
from apsu_tpu.core.params import PSUParams as RefParams
from apsu_tpu.db.receiver_db import ReceiverDB as RefDB
from apsu_tpu.engine.evaluator import compute_power_tensor as ref_power_tensor
from apsu_tpu.mpc.oprf import DebugOprf as RefOprf
from apsu_tpu.mpc.prg import CsRng as RefCsRng
from apsu_tpu.parallel.mesh import make_mesh as ref_make_mesh
from apsu_tpu.parallel.runtime import ShardedEvaluator as RefShardedEvaluator
from apsu_tpu.parallel.runtime import ShardedReceiver as RefShardedReceiver
from apsu_tpu_torch.api.parties import Receiver, Sender
from apsu_tpu_torch.core.bfv import Ciphertext
from apsu_tpu_torch.core.mod32 import to_u32
from apsu_tpu_torch.core.params import PSUParams
from apsu_tpu_torch.db.receiver_db import ReceiverDB
from apsu_tpu_torch.engine.evaluator import compute_power_tensor, eval_matching_polys
from apsu_tpu_torch.mpc.oprf import DebugOprf
from apsu_tpu_torch.mpc.prg import CsRng
from apsu_tpu_torch.parallel.mesh import make_mesh, row_ranges
from apsu_tpu_torch.parallel.runtime import ShardedEvaluator, ShardedReceiver, bundle_blocks


def small(table_size=64, max_items_per_bin=8, hash_func_count=2, query_powers=range(1, 9),
          ps_low_degree=0, coeff_bits=(40, 40, 30)):
    """tests/test_psu_e2e.py:small_params() at N=256, as a dict."""
    return {
        "table_params": {"hash_func_count": hash_func_count, "table_size": table_size,
                         "max_items_per_bin": max_items_per_bin},
        "item_params": {"felts_per_item": 4},
        "query_params": {"ps_low_degree": ps_low_degree, "query_powers": list(query_powers)},
        "seal_params": {"plain_modulus": 65537, "poly_modulus_degree": 256,
                        "coeff_modulus_bits": list(coeff_bits)},
    }


# tests/test_sharded.py's three sets, with its seeds and set sizes
SETS = {
    "eval": (small(table_size=128), 0, (700, 40, 15)),
    "dag": (small(table_size=128, max_items_per_bin=16,
                  query_powers=(1, 2, 5, 8, 11, 14, 15, 16), coeff_bits=(48, 48, 48, 28)),
            5, (500, 40, 15)),
    "ps": (small(table_size=96, hash_func_count=3, max_items_per_bin=28, ps_low_degree=4,
                 query_powers=(1, 2, 3, 4, 5, 10, 25), coeff_bits=(48, 48, 48, 48, 48, 30)),
           6, (800, 36, 15)),
}


def make_sets(rng, n_db, n_query, n_common):
    db = rng.integers(0, 1 << 64, size=(n_db, 2), dtype=np.uint64)
    fresh = rng.integers(0, 1 << 64, size=(n_query - n_common, 2), dtype=np.uint64)
    common = db[rng.choice(n_db, size=n_common, replace=False)]
    query = np.concatenate([fresh, common])
    rng.shuffle(query)
    return db, query


def _u32(x):
    return np.asarray(jax.device_get(x))


def _port(name):
    """The port's DB and one seeded query of set ``name`` on the CPU."""
    d, seed, sizes = SETS[name]
    params = PSUParams.from_dict(d)
    rng = np.random.default_rng(seed)
    db_items, query = make_sets(rng, *sizes)
    db = ReceiverDB(params, DebugOprf(), device="cpu")
    db.set_data(db_items)
    snd = Sender(params, DebugOprf(), rng=CsRng(b"sharded-%s-sender-key" % name.encode()),
                 device="cpu")
    return params, db_items, query, db, snd.create_query(query)


@pytest.fixture(scope="module")
def dag():
    return _port("dag")


@pytest.fixture(scope="module")
def ps():
    return _port("ps")


def test_row_ranges_and_blocks():
    assert row_ranges(24, 5) == [(0, 5), (5, 10), (10, 15), (15, 20), (20, 24)]
    assert row_ranges(3, 5) == [(0, 1), (1, 2), (2, 3), (3, 3), (3, 3)]
    assert bundle_blocks(5, 10, 6) == [(0, 1, 5, 6), (1, 2, 0, 4)]
    assert bundle_blocks(4, 22, 6) == [(0, 1, 4, 6), (1, 3, 0, 6), (3, 4, 0, 4)]
    assert bundle_blocks(6, 12, 6) == [(1, 2, 0, 6)]
    assert bundle_blocks(7, 8, 6) == [(1, 2, 1, 2)]
    mesh = make_mesh(devices=["cpu"] * 3)
    assert mesh.size == 3 and mesh.devices == (torch.device("cpu"),) * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda"):
            make_mesh()


@pytest.mark.parametrize("n_shards", [8, 5])
def test_sharded_eval_matches_reference_and_direct(n_shards):
    """tests/test_sharded.py:test_sharded_eval_matches_single_device's twin:
    the non-PS evaluation over the mesh, the JAX one on its 8 devices."""
    d, seed, sizes = SETS["eval"]
    rng = np.random.default_rng(seed)
    rp, pp = RefParams.from_dict(d), PSUParams.from_dict(d)
    db_items, query = make_sets(rng, *sizes)

    r_db = RefDB(rp, RefOprf())
    r_db.set_data(db_items)
    r_req = RefSender(rp, RefOprf(), rng=np.random.default_rng(31)).create_query(query)
    r_recv = RefReceiver(rp, r_db)
    ql = r_recv.query_lvl
    r_cts = {s: RefCt(r_req.powers_data[i], is_ntt=False, level=ql)
             for i, s in enumerate(r_req.power_list)}
    r_powers = jnp.moveaxis(ref_power_tensor(r_recv.bfv, r_cts, r_recv.plan.low, None,
                                             r_db.eval_lvl), 0, 1)
    B, C, N = rp.bundle_idx_count, r_db.coeff_cache.shape[1], rp.poly_degree
    mask = rng.integers(0, rp.seal_params.plain_modulus, size=(B, C, N),
                        dtype=np.uint64).astype(np.uint32)
    ref = _u32(RefShardedEvaluator(r_db, ref_make_mesh(8)).eval_query(
        r_powers, jnp.asarray(mask), r_db.eval_lvl))

    db = ReceiverDB(pp, DebugOprf(), device="cpu")
    db.set_data(db_items)
    req = Sender(pp, DebugOprf(), rng=np.random.default_rng(31), device="cpu").create_query(query)
    recv = Receiver(pp, db)
    cts = {s: Ciphertext(req.powers_data[i], is_ntt=False, level=ql)
           for i, s in enumerate(req.power_list)}
    powers = compute_power_tensor(db.bfv, cts, recv.plan.low, None, db.eval_lvl)
    powers = powers.movedim(0, 1).contiguous()
    assert np.array_equal(_u32(r_powers), to_u32(powers))
    direct = eval_matching_polys(db.bfv, powers, db.coeff_cache, db.const_slots,
                                 db.bfv.tensor(mask), db.eval_lvl).data
    ev = ShardedEvaluator(db, make_mesh(devices=["cpu"] * n_shards))
    out = ev.eval_query(powers, mask, db.eval_lvl)
    assert B * C < 8 and any(r0 == r1 for r0, r1 in ev.ranges) == (n_shards > B * C)
    assert np.array_equal(to_u32(out), to_u32(direct))
    assert np.array_equal(ref, to_u32(out))


@pytest.mark.parametrize("name,n_shards", [("dag", 8), ("dag", 5), ("ps", 8), ("ps", 5)])
def test_sharded_receiver_matches_direct(name, n_shards, request):
    """ShardedReceiver.run_query (sharded wavefront + sharded evaluation)
    against Receiver.run_query under one mask seed, bit for bit."""
    params, _, _, db, req = request.getfixturevalue(name)
    key = b"sharded-%s-recvr-key1" % name.encode()
    base = Receiver(params, db, rng=CsRng(key))
    want = base.run_query(req)
    shard = ShardedReceiver(params, db, make_mesh(devices=["cpu"] * n_shards), rng=CsRng(key))
    got = shard.run_query(req)
    assert got.eval_level == want.eval_level
    assert np.array_equal(shard.last_mask, base.last_mask)
    assert np.array_equal(to_u32(got.results), to_u32(want.results))
    # the shards' cache rows are views of the DB's cache on its own device
    assert shard.evaluator.shards[0][1].data_ptr() == db.coeff_cache.data_ptr()


@pytest.mark.slow
@pytest.mark.parametrize("name", ["dag", "ps"])
def test_sharded_receiver_matches_reference(name, request):
    """tests/test_sharded.py's two ShardedReceiver tests, each package on
    its own 8-device mesh, from the same items, query and mask seed."""
    params, db_items, query, db, req = request.getfixturevalue(name)
    d = SETS[name][0]
    rp = RefParams.from_dict(d)
    r_db = RefDB(rp, RefOprf())
    r_db.set_data(db_items)
    r_req = RefSender(rp, RefOprf(), rng=RefCsRng(b"sharded-%s-sender-key" % name.encode())
                      ).create_query(query)
    key = b"sharded-%s-recvr-key1" % name.encode()
    ref = RefShardedReceiver(rp, r_db, ref_make_mesh(8), rng=RefCsRng(key)).run_query(r_req)
    got = ShardedReceiver(params, db, make_mesh(devices=["cpu"] * 8), rng=CsRng(key)).run_query(req)
    assert got.eval_level == ref.eval_level
    assert np.array_equal(_u32(ref.results), to_u32(got.results))


def test_labeled_db_is_refused():
    """A reference fault not copied: the reference's ShardedReceiver answers a
    labeled DB's query without its label results (the labels vanish); the
    port refuses to shard a labeled DB."""
    d = small()
    rp, pp = RefParams.from_dict(d), PSUParams.from_dict(d)
    db_items, query = make_sets(np.random.default_rng(41), 250, 30, 12)
    labels = np.zeros((len(db_items), 16), np.uint8)
    labels[:, :8] = db_items[:, :1].view(np.uint8) & 0x3F

    r_db = RefDB(rp, RefOprf())
    r_db.set_data(db_items, labels=labels)
    r_req = RefSender(rp, RefOprf(), rng=np.random.default_rng(1)).create_query(query)
    assert RefReceiver(rp, r_db).run_query(r_req).label_results is not None
    assert RefShardedReceiver(rp, r_db, ref_make_mesh(8)).run_query(r_req).label_results is None

    db = ReceiverDB(pp, DebugOprf(), device="cpu")
    db.set_data(db_items, labels=labels)
    with pytest.raises(ValueError, match="label"):
        ShardedReceiver(pp, db, make_mesh(devices=["cpu"] * 8))
