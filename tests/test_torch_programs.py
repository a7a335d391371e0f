"""The query's programs (``apsu_tpu_torch/engine/programs.py``), the port's
counterpart of the reference's jitted programs, against the JAX package on
the CPU: two queries in a row through the programs, each bit for bit the
reference's ``Receiver.run_query`` (a small PS set, the small
one-level-DAG set, 100K-1's parameters and a small labeled DB; the PS query
at 256K-2048-com goes through the same programs in
``tests/test_torch_ps_query.py``); the keys and their fields; the DB
mutations that drop the programs; and a proxy of capture safety (no host
round trip in a program's body).  The reference's requests are the port
sender's, carried across (the senders agree bit for bit in
``tests/test_torch_psu.py``), so the reference encrypts nothing here.  Two
tests need a card: the 256K-2048-com query graphed against ``eager()`` bit
for bit with equal launch counts, and a body with a host sync refused at
capture.  (The set helpers are copied here: a GPU host may have another
package named ``tests`` on its path.)"""

import contextlib
import functools
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apsu_tpu.api.parties import QueryRequest as RefRequest
from apsu_tpu.api.parties import Receiver as RefReceiver
from apsu_tpu.api.parties import _pow_mod
from apsu_tpu.core.params import PSUParams as RefParams
from apsu_tpu.db.measured_levels import query_level
from apsu_tpu.db.receiver_db import ReceiverDB as RefDB
from apsu_tpu.mpc.oprf import DebugOprf as RefOprf
from apsu_tpu_torch.api.parties import QueryRequest, Receiver, Sender
from apsu_tpu_torch.core.bfv import BfvContext
from apsu_tpu_torch.core.mod32 import col, to_u32
from apsu_tpu_torch.core.params import PSUParams
from apsu_tpu_torch.db.receiver_db import ReceiverDB
from apsu_tpu_torch.engine import programs
from apsu_tpu_torch.mpc.oprf import DebugOprf
from apsu_tpu_torch.ops import counts

PS_PARAMS = "parameters/256K-2048-com.json"
DAG = {  # tests/test_psu_e2e.py:test_psu_with_power_dag's set
    "table_params": {"hash_func_count": 3, "table_size": 128, "max_items_per_bin": 16},
    "item_params": {"felts_per_item": 4},
    "query_params": {"ps_low_degree": 0, "query_powers": [1, 2, 5, 8, 11, 14, 15, 16]},
    "seal_params": {"plain_modulus": 65537, "poly_modulus_degree": 256,
                    "coeff_modulus_bits": [48, 48, 48, 28]},
}
PS = {  # tests/test_torch_checkpoint.py's PS variant of small_params()
    "table_params": {"hash_func_count": 2, "table_size": 64, "max_items_per_bin": 16},
    "item_params": {"felts_per_item": 4},
    "query_params": {"ps_low_degree": 3, "query_powers": [1, 2, 3, 4, 8]},
    "seal_params": {"plain_modulus": 65537, "poly_modulus_degree": 256,
                    "coeff_modulus_bits": [48, 48, 48, 28]},
}
SMALL = {  # tests/test_psu_e2e.py:small_params()
    "table_params": {"hash_func_count": 2, "table_size": 64, "max_items_per_bin": 8},
    "item_params": {"felts_per_item": 4},
    "query_params": {"ps_low_degree": 0, "query_powers": [1, 2, 3, 4, 5, 6, 7, 8]},
    "seal_params": {"plain_modulus": 65537, "poly_modulus_degree": 256,
                    "coeff_modulus_bits": [40, 40, 30]},
}

# each field of the reference's key tuples (apsu_tpu/engine/evaluator.py:221-231,
# :531-546, :634, :711, :1025-1028) by the port's name, less the knobs the port
# fixed (APSU_MUL_CHUNK, APSU_PS_INNER, merge_wf) and two constants of the
# query's path (shard None: the mesh path keys its own; batch_first True);
# the reference's chunk "size" is the port's row_chunk, all chunks being one
# program.  The shapes are in the full key, through the inputs and the DB
# tensors (programs.full_key).
REFERENCE_FIELDS = {
    "power_tensor": {"schedule", "eval_level", "srcs", "src_lvl", "rk_lvl", "at_eval"},
    "ps_power_tensors": {"low", "high", "lvl", "low_srcs", "high_srcs", "src_lvl", "rk_lvl",
                         "at_eval", "defer_relin"},
    "eval_matching": {"eval_level"},
    "eval_matching_labeled": {"eval_level"},
    "ps_rows": {"row_chunk", "ps_low_degree", "nh", "lvl", "result_level", "rk_lvl",
                "aligned"},
}


def _u32(x):
    return np.asarray(jax.device_get(x))


def _ref_request(req):
    """The port's request as the reference's."""
    rk = None if req.relin_key is None else jnp.asarray(to_u32(req.relin_key))
    return RefRequest(tuple(req.power_list), jnp.asarray(to_u32(req.powers_data)), rk)


def make_sets(rng, n_db, n_query, n_common):
    db = rng.integers(0, 1 << 64, size=(n_db, 2), dtype=np.uint64)
    fresh = rng.integers(0, 1 << 64, size=(n_query - n_common, 2), dtype=np.uint64)
    common = db[rng.choice(n_db, size=n_common, replace=False)]
    query = np.concatenate([fresh, common])
    rng.shuffle(query)
    return db, query


def _labels_for(items, cap_bits):
    lab = np.zeros((len(items), 16), dtype=np.uint8)
    for i, (lo, hi) in enumerate(items):
        d = int(lo).to_bytes(8, "little") + int(hi).to_bytes(8, "little")
        lab[i, :cap_bits // 8] = np.frombuffer(d[:cap_bits // 8], dtype=np.uint8)
    return lab


def _ps_set():
    """A dense synthetic 256K-2048-com DB in both packages and two encrypted
    requests (random slot values, the reference's keys) for each."""
    rp, pp = RefParams.load_file(PS_PARAMS), PSUParams.load_file(PS_PARAMS)
    rng = np.random.default_rng(11)
    r_db = RefDB(rp, oprf=None)
    r_db.set_synthetic_dense(rng, n_caches=1)
    db = ReceiverDB.from_arrays(pp, {
        "coeff_cache": _u32(r_db.coeff_cache), "ps_const_polys": _u32(r_db.ps_const_polys),
        "eval_lvl": r_db.eval_lvl, "result_lvl": r_db.result_lvl}, device="cpu")
    bfv, t = r_db.bfv, rp.seal_params.plain_modulus
    ql = query_level(rp, len(bfv.q_primes))
    plist = tuple(rp.query_params.query_powers)
    sk = bfv.gen_secret_key(rng)
    rk = bfv.gen_relin_key(sk, rng, level=ql)
    reqs = []
    for _ in range(2):
        qvec = rng.integers(1, t, size=(rp.bundle_idx_count, rp.poly_degree), dtype=np.uint64)
        stack = np.stack([_pow_mod(qvec, s, t).astype(np.uint32) for s in plist])
        ct = bfv.encrypt_symmetric(bfv.encode(stack), sk, rng, level=ql)
        reqs.append((RefRequest(plist, ct.data, rk.ksk),
                     QueryRequest(plist, db.bfv.tensor(_u32(ct.data)),
                                  db.bfv.tensor(_u32(rk.ksk)))))
    return rp, pp, r_db, db, reqs


@functools.lru_cache(maxsize=None)
def _item_set(name):
    """A DB built from items in both packages and two requests of one
    seeded sender each."""
    if name == "labeled":
        rp, pp = RefParams.from_dict(SMALL), PSUParams.from_dict(SMALL)
        db_items, query = make_sets(np.random.default_rng(41), 250, 30, 12)
        labels = _labels_for(db_items, pp.item_bit_count)
    else:
        if name in ("ps", "dag"):
            d = PS if name == "ps" else DAG
            rp, pp = RefParams.from_dict(d), PSUParams.from_dict(d)
        else:
            rp = RefParams.load_file(f"parameters/{name}.json")
            pp = PSUParams.load_file(f"parameters/{name}.json")
        n_query, n_common = (8, 3) if name == "100K-1" else (30, 12)
        db_items, query = make_sets(np.random.default_rng(1), 400, n_query, n_common)
        labels = None
    r_db, db = RefDB(rp, RefOprf()), ReceiverDB(pp, DebugOprf(), device="cpu")
    r_db.set_data(db_items, labels=labels)
    db.set_data(db_items, labels=labels)
    snd = Sender(pp, DebugOprf(), rng=np.random.default_rng(21), device="cpu")
    reqs = [snd.create_query(q) for q in (query, query[::-1])]
    return rp, pp, r_db, db, [(_ref_request(req), req) for req in reqs]


@pytest.fixture(scope="module", params=["ps", "dag", "100K-1", "labeled"])
def query_set(request):
    return _item_set(request.param)


def test_two_queries_match_reference(query_set):
    """(a) Two queries in a row, different requests and masks, each equal to
    the reference's; the first response stays as it was (no aliasing)."""
    rp, pp, r_db, db, reqs = query_set
    programs.drop(db.bfv)
    r_recv = RefReceiver(rp, r_db, rng=np.random.default_rng(22))
    recv = Receiver(pp, db, rng=np.random.default_rng(22))
    (r_req0, req0), (r_req1, req1) = reqs
    first = recv.run_query(req0)
    kept = first.results.clone()
    kept_l = None if first.label_results is None else first.label_results.clone()
    assert len(db.bfv.programs) == 2   # the powers and the evaluation
    second = recv.run_query(req1)
    assert len(db.bfv.programs) == 2   # equal keys share one program
    assert torch.equal(first.results, kept)
    assert kept_l is None or torch.equal(first.label_results, kept_l)
    assert not torch.equal(first.results, second.results)
    for r_req, resp in ((r_req0, first), (r_req1, second)):
        r_resp = r_recv.run_query(r_req)
        assert np.array_equal(_u32(r_resp.results), to_u32(resp.results))
        if r_resp.label_results is not None:
            assert np.array_equal(_u32(r_resp.label_results), to_u32(resp.label_results))
    with programs.eager():
        again = Receiver(pp, db, rng=np.random.default_rng(22)).run_query(req0)
    assert torch.equal(again.results, first.results)
    assert len(db.bfv.programs) == 2   # eager() builds none


def test_keys_hold_the_reference_fields(query_set):
    """(b) Each program's key holds every field of the reference's key of
    its stage that varies in the port, and its full key the device, the
    inputs' shapes and each DB tensor it reads by address."""
    rp, pp, r_db, db, reqs = query_set
    if not db.bfv.programs:
        Receiver(pp, db, rng=np.random.default_rng(0)).run_query(reqs[0][1])
    kinds = set()
    for (kind, fields), device, shapes, static in db.bfv.programs:
        names = {name for name, _ in fields}
        assert names >= REFERENCE_FIELDS[kind], (kind, names)
        if kind.startswith(("eval", "ps_rows")):
            db_tensors = (db.coeff_cache, db.const_slots, db.ps_const_polys, db.label_cache,
                          db.label0_slots)
            assert set(static) <= {programs.tensor_id(t) for t in db_tensors if t is not None}
            assert static[0] == programs.tensor_id(db.coeff_cache)
        assert device == "cpu" and shapes
        kinds.add(kind)
    assert len(kinds) == 2


def test_changed_shape_or_level_makes_a_new_program():
    """(b) One context, two DBs that differ only in C: the powers program is
    shared, the evaluation is not.  The full key separates programs: a
    changed level, B, C, plane count or DB tensor gives a new one, equal
    arguments the same one."""
    rp, pp, r_db, db, reqs = _item_set("dag")
    wide = ReceiverDB.from_arrays(pp, {
        "coeff_cache": to_u32(torch.cat([db.coeff_cache, db.coeff_cache], 1)),
        "const_slots": to_u32(torch.cat([db.const_slots, db.const_slots], 1)),
        "eval_lvl": db.eval_lvl, "result_lvl": db.result_lvl}, device="cpu", bfv=db.bfv)
    for d in (db, wide):
        resp = Receiver(pp, d, rng=np.random.default_rng(3)).run_query(reqs[0][1])
        assert resp.results.shape[1] == d.coeff_cache.shape[1]
    kinds = sorted(k[0][0] for k in db.bfv.programs)
    assert kinds == ["eval_matching", "eval_matching", "power_tensor"]

    def full(level, cache, consts, powers=3):
        B, C, N = cache.shape[0], cache.shape[1], cache.shape[-1]
        inputs = [torch.zeros((B, powers, 2, 2, N), dtype=torch.int32),
                  torch.zeros((B, C, N), dtype=torch.int32)]
        return programs.full_key(db.bfv, programs.key("eval_matching", eval_level=level),
                                 inputs, [cache, consts])

    cache, consts = db.coeff_cache, db.const_slots
    assert cache.shape[:2] == (2, 1)
    base = full(2, cache, consts)
    assert base == full(2, cache, consts)
    changed = [full(1, cache, consts),                        # level
               full(2, cache[:1], consts[:1]),                  # B
               full(2, cache.expand(2, 2, *cache.shape[2:]),    # C (a view: one address)
                    consts.expand(2, 2, *consts.shape[2:])),
               full(2, cache[:, :, :-8], consts),               # planes
               full(2, cache.clone(), consts),                  # another DB tensor
               full(2, cache, consts, powers=4)]                # the powers' shape
    assert len({base, *changed}) == 1 + len(changed)


def _query(pp, db, req, seed):
    return Receiver(pp, db, rng=np.random.default_rng(seed)).run_query(req)


def test_db_mutations_drop_the_programs():
    """(c) insert_or_assign that grows C, release_cache, rebind, strip and
    load leave the context with no program; an insert or a remove rebuilt
    in place keeps them (every address stays).  Each next query equals the
    reference's.  The DAG set's parameters, items and request, and its
    reference context, whose programs of the first shape are compiled."""
    rp, pp, r_set, _, ((r_req, req), _) = _item_set("dag")
    items, _ = make_sets(np.random.default_rng(1), 400, 30, 12)   # the set's DB items
    extra = np.random.default_rng(33).integers(0, 1 << 64, size=(410, 2), dtype=np.uint64)
    r_bfv = r_set.bfv   # one context: the reference compiles once a shape
    r_db, db = RefDB(rp, RefOprf(), bfv=r_bfv), ReceiverDB(pp, DebugOprf(), device="cpu")
    r_db.set_data(items)
    db.set_data(items)

    def matches(r_db, db, seed, kept=None):
        if kept is None:
            assert not db.bfv.programs
        else:
            assert db.bfv.programs == kept
        r_resp = RefReceiver(rp, r_db, rng=np.random.default_rng(seed)).run_query(r_req)
        assert np.array_equal(_u32(r_resp.results), to_u32(_query(pp, db, req, seed).results))
        assert db.bfv.programs
        return dict(db.bfv.programs)

    matches(r_db, db, 1)
    c_before = db.coeff_cache.shape[1]
    r_db.insert_or_assign(extra[:400])
    db.insert_or_assign(extra[:400])
    assert db.coeff_cache.shape[1] > c_before
    progs = matches(r_db, db, 2)
    c_before = db.coeff_cache.shape[1]
    r_db.insert_or_assign(extra[400:])
    db.insert_or_assign(extra[400:])
    assert db.coeff_cache.shape[1] == c_before
    progs = matches(r_db, db, 3, kept=progs)
    r_db.remove(items[:30])
    db.remove(items[:30])
    matches(r_db, db, 4, kept=progs)

    r_db, db = RefDB(rp, RefOprf(), bfv=r_bfv), ReceiverDB(pp, DebugOprf(), device="cpu")
    r_db.set_data(items)
    db.set_data(items)
    _query(pp, db, req, 4)
    assert db.bfv.programs
    db.release_cache()
    assert not db.bfv.programs
    db = db.rebind(DebugOprf(7))
    r_db = r_db.rebind(RefOprf(7))
    matches(r_db, db, 5)
    db.rebind(DebugOprf(8))
    assert not db.bfv.programs

    _query(pp, db, req, 6)
    db.strip()
    assert not db.bfv.programs
    with tempfile.TemporaryDirectory() as ckpt:
        db.save(ckpt)
        loaded = ReceiverDB.load(ckpt, oprf=DebugOprf(7), device="cpu")
    matches(r_db, loaded, 7)   # the loaded cache is the saved one


def _raise(*args, **kwargs):
    raise AssertionError("a host round trip inside a program's body")


def test_program_bodies_make_no_host_round_trip(query_set, monkeypatch):
    """(d) After the warm-up, each program's body runs again with every way
    to a host round trip patched to raise: an upload from numpy or a Python
    list, a list index, a read back to the host.  A CUDA graph can capture
    none of them."""
    rp, pp, r_db, db, reqs = query_set
    if not db.bfv.programs:
        Receiver(pp, db, rng=np.random.default_rng(0)).run_query(reqs[0][1])
    progs = list(db.bfv.programs.values())
    getitem = torch.Tensor.__getitem__

    def index(self, idx):
        parts = idx if isinstance(idx, tuple) else (idx,)
        if any(isinstance(i, (list, np.ndarray)) for i in parts):
            _raise()
        return getitem(self, idx)

    for name in ("from_numpy", "tensor", "as_tensor"):
        monkeypatch.setattr(torch, name, _raise)
    for name in ("item", "tolist", "cpu"):
        monkeypatch.setattr(torch.Tensor, name, _raise)
    monkeypatch.setattr(torch.Tensor, "__getitem__", index)
    for prog in progs:
        prog.body(db.bfv, *prog.buffers, *prog.static)
    monkeypatch.undo()
    # it catches both kinds the query's path had: an upload from numpy
    # (_scale_impl's constant columns, through mod32.col) and a list index
    monkeypatch.setattr(torch, "from_numpy", _raise)
    monkeypatch.setattr(torch.Tensor, "__getitem__", index)
    with pytest.raises(AssertionError):
        col([1, 2], "cpu")
    with pytest.raises(AssertionError):
        torch.zeros(3)[[0, 2]]


# kernel nodes of a captured 256K-2048-com query, as libcuda names them
# (cuFuncGetName), and the general build of the lift
GRAPH_NODES = [
    "_ZN38_GLOBAL__N__48bbf53d_6_ntt_cu_apsu_ntt10ntt_kernelILi12ELb0EEEvPKjPjS2_S2_S2_S2_S2_ill",
    "_ZN38_GLOBAL__N__48bbf53d_6_ntt_cu_apsu_ntt10ntt_kernelILi12ELb1EEEvPKjPjS2_S2_S2_S2_S2_ill",
    "_ZN44_GLOBAL__N__266e4ff2_11_ps_inner_cu_1eb1b1bc15ps_inner_kernelILb0EEEvNS_4ArgsE",
    "_ZN44_GLOBAL__N__71a133e6_11_eval_dot_cu_ce2b61fd15eval_dot_kernelILi4EEEvNS_4ArgsE",
    "_ZN45_GLOBAL__N__e4cafa2e_12_behz_lift_cu_fe27a9be16behz_lift_kernelILi3ELi6ELb1EEEvPKj",
    "_ZN45_GLOBAL__N__e4cafa2e_12_behz_lift_cu_fe27a9be29behz_lift_kernel_digits_scaleILi1ELi8E",
    "_ZN45_GLOBAL__N__e4cafa2e_12_behz_lift_cu_fe27a9be16behz_lift_kernelILi10ELi12ELb0EEEvPKj",
    "_ZN44_GLOBAL__N__35cf1d41_11_mont_mac_cu_5190bce415mont_mac_kernelILi0EEEvPKjNS_4GeomE",
    "_ZN50_GLOBAL__N__41bfcfc6_17_behz_scaledown_cu_4a7913bb21behz_scaledown_kernelILi3ELi6ELb1EE",
    "_ZN48_GLOBAL__N__a95526ad_15_rns_divround_cu_5ba317bb19rns_divround_kernelILi0ELi8EEEvPKj",
    "_ZN45_GLOBAL__N__f301f727_12_scale_add_cu_eb79866816scale_add_kernelILi1ELi8EEEvPKjN4behz4Rows",
    "_ZN2at6native29vectorized_elementwise_kernelILi2ENS0_15CUDAFunctor_addIlEESt5arrayIPcLm3EEEE",
    "_ZN2at6native40_GLOBAL__N__0f1a8107_8_Shape_cu_49f7391c30CatArrayBatchedCopy_vectorizedINS1_",
]


def test_graph_kernel_nodes_map_to_their_counters():
    """A captured graph's kernel nodes count where their wrappers count:
    each hand-written kernel (its builds too) to its counter, the general
    build of the lift to its own counter as well, PyTorch's to none."""
    got = dict(zip((f"{m.__name__.rsplit('.', 1)[1]}.{c}" for m, c, _ in counts.COUNTERS),
                   counts.in_graph(GRAPH_NODES)))
    assert got == {"ntt.launches": 2, "polyeval.launches": 1, "polyeval.dot_launches": 1,
                   "roofline.loop_launches": 0, "roofline.add_launches": 0,
                   "behz.lift_launches": 3, "behz.mac_launches": 1,
                   "behz.scaledown_launches": 1, "behz.divround_launches": 1,
                   "behz.lift_general_launches": 1, "behz.scaledown_general_launches": 0,
                   "ctr_mod.launches": 0, "behz.scale_add_launches": 1}


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_graphed_query_equals_eager_on_the_card():
    """On the card, the 256K-2048-com query through its CUDA graphs equals
    the same query under eager(), bit for bit, with the same launches, G5's
    (the PS constant term) among them."""
    _need_cuda()
    pp = PSUParams.load_file(PS_PARAMS)
    rp, _, r_db, cpu_db, reqs = _ps_set()
    db = ReceiverDB.from_arrays(pp, {
        "coeff_cache": to_u32(cpu_db.coeff_cache), "ps_const_polys": to_u32(cpu_db.ps_const_polys),
        "eval_lvl": cpu_db.eval_lvl, "result_lvl": cpu_db.result_lvl}, device="cuda")
    req = QueryRequest(reqs[0][1].power_list, reqs[0][1].powers_data.cuda(),
                       reqs[0][1].relin_key.cuda())
    got = {}
    for mode in ("eager", "graph", "graph", "eager"):
        with programs.eager() if mode == "eager" else contextlib.nullcontext():
            before = counts.read()
            resp = _query(pp, db, req, 9)
            torch.cuda.synchronize()
            got.setdefault(mode, []).append((resp.results.cpu(), counts.since(before)))
    eager_res, eager_n = got["eager"][0]
    for res, n in got["graph"][1:] + got["eager"]:   # the first graphed call also captured
        assert torch.equal(res, eager_res) and n == eager_n
    # G5 four times a row chunk of the PS evaluation: the constant into the
    # inner sums, its transform into their NTT form, the outer sum's
    # constant component, the mask
    g5 = eager_n[[c for _, c, _ in counts.COUNTERS].index("scale_add_launches")]
    assert g5 and g5 % 4 == 0
    assert torch.equal(got["graph"][0][0], eager_res)
    r_resp = RefReceiver(rp, r_db, rng=np.random.default_rng(9)).run_query(reqs[0][0])
    assert np.array_equal(_u32(r_resp.results), eager_res.numpy().view(np.uint32))


@pytest.mark.cuda
def test_capture_with_a_host_sync_raises():
    """A body that reads a value back to the host cannot be captured: the
    call raises, and no program is kept to be run eagerly later."""
    _need_cuda()
    bfv = BfvContext(PSUParams.from_dict(SMALL).seal_params, device="cuda")
    x = torch.arange(8, device="cuda")

    def body(bfv, x):
        return x * int(x.sum().item())

    k = programs.key("host_sync")
    for _ in range(2):
        with pytest.raises(RuntimeError):
            programs.run(bfv, k, body, [x])
        assert not bfv.programs
