"""PS parameter sets whose eval primes are 29 or 30 bits wide, or whose
ps_low_degree is above 256: the port against the JAX package.

The reference sends such sets to its XLA loop (``_use_pallas`` is false
above 2^28); the port's PS inner sums (K2's plain version here, the kernel
on the card) take every prime < 2^30 and any ph.  1M-2048-com (29, 29 and
28-bit eval primes) is the APSU paper's 2^20 × 2^11 communication-optimised
setting.  The fast test runs ``run_psu`` on a ``small_params()``-sized PS
set with the same three eval primes and ps_low_degree 10 (so K2's sums span
two 8-product chunks); a ``slow`` twin runs 1M-2048-com itself at full width
(2^20 × 2048) on the GPU host, with the port on the card.  Both compare the
query response, transferred items and union bit for bit, plus the set
algebra.  (The set helpers and ``small_params`` are copied here: a GPU host
may have another package named ``tests`` on its path.)"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apsu_tpu.api.parties import Receiver as RefReceiver
from apsu_tpu.api.parties import Sender as RefSender
from apsu_tpu.api.protocol import run_psu as ref_run_psu
from apsu_tpu.core import mod32 as ref_mod32
from apsu_tpu.core.nt import gen_ntt_primes
from apsu_tpu.core.params import PSUParams as RefParams
from apsu_tpu.db.receiver_db import ReceiverDB as RefDB
from apsu_tpu.mpc.oprf import DebugOprf as RefOprf
from apsu_tpu_torch.api.parties import Receiver, Sender
from apsu_tpu_torch.api.protocol import run_psu
from apsu_tpu_torch.core.mod32 import from_u32, prime_consts, to_u32
from apsu_tpu_torch.core.params import PSUParams
from apsu_tpu_torch.core.rns import RnsBase
from apsu_tpu_torch.db.receiver_db import ReceiverDB
from apsu_tpu_torch.mpc.oprf import DebugOprf
from apsu_tpu_torch.ops.polyeval import ps_inner_plain

PARAMS = "parameters/1M-2048-com.json"


def small_params(
    table_size=64,
    max_items_per_bin=8,
    hash_func_count=2,
    n=256,
    query_powers=(1, 2, 3, 4, 5, 6, 7, 8),
    ps_low_degree=0,
    coeff_bits=(40, 40, 30),
):
    """The parameter dict of tests/test_psu_e2e.py:small_params, for both
    packages' ``PSUParams.from_dict``."""
    return {
        "table_params": {
            "hash_func_count": hash_func_count,
            "table_size": table_size,
            "max_items_per_bin": max_items_per_bin,
        },
        "item_params": {"felts_per_item": 4},
        "query_params": {
            "ps_low_degree": ps_low_degree,
            "query_powers": list(query_powers),
        },
        "seal_params": {
            "plain_modulus": 65537,
            "poly_modulus_degree": n,
            "coeff_modulus_bits": list(coeff_bits),
        },
    }


# 1M-2048-com's coefficient modulus (eval primes of 29, 29 and 28 bits) at
# N=256, with PS inner sums of 10 products: low powers 1..10, high y, y^2, y^3
SMALL_WIDE_PS = small_params(
    table_size=96,
    max_items_per_bin=43,
    hash_func_count=3,
    query_powers=(1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 22, 33),
    ps_low_degree=10,
    coeff_bits=(48, 30, 30),
)


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


def _keep_responses(receiver):
    """Make ``receiver.run_query`` also append each response to a list."""
    kept, run = [], receiver.run_query
    receiver.run_query = lambda req: kept.append(run(req)) or kept[-1]
    return kept


def _compare(params, n_db, n_query, n_common, device):
    """run_psu at ``params`` (a parameter file or dict) from the same seeded
    sets and parties, reference on the CPU and port on ``device``: the query
    response, the transferred items and the union must agree exactly."""
    if isinstance(params, dict):
        ref_p, port_p = RefParams.from_dict(params), PSUParams.from_dict(params)
    else:
        ref_p, port_p = RefParams.load_file(params), PSUParams.load_file(params)
    db_items, query = make_sets(np.random.default_rng(0), n_db, n_query, n_common)

    r_db = RefDB(ref_p, RefOprf())
    r_db.set_data(db_items)
    db = ReceiverDB(port_p, DebugOprf(), device=device)
    db.set_data(db_items)
    ps_primes = db.bfv.levels[db.eval_lvl].primes
    assert max(ps_primes) >= 1 << 28, "the set no longer exercises the wide-prime path"

    r_recv = RefReceiver(ref_p, r_db, rng=np.random.default_rng(32))
    recv = Receiver(port_p, db, rng=np.random.default_rng(32))
    r_resps, resps = _keep_responses(r_recv), _keep_responses(recv)
    want = ref_run_psu(ref_p, query, db_items,
                       sender=RefSender(ref_p, RefOprf(), rng=np.random.default_rng(31)),
                       receiver=r_recv)
    del r_db
    got = run_psu(port_p, query, db_items,
                  sender=Sender(port_p, DebugOprf(), rng=np.random.default_rng(31),
                                device=device),
                  receiver=recv)
    (r_resp,), (resp,) = r_resps, resps
    assert resp.eval_level == r_resp.eval_level
    assert np.array_equal(np.asarray(jax.device_get(r_resp.results)), to_u32(resp.results))
    assert np.array_equal(want.transferred, got.transferred)
    assert np.array_equal(want.union, got.union)
    check_oracle(db_items, query, got)
    assert len(got.transferred) == n_query - n_common


def test_run_psu_matches_reference_1m_2048_com():
    """The fast twin of the full-width test below: 1M-2048-com's eval primes
    on a small PS set (1500 × 64 items, 32 in common), with ph - 1 = 10."""
    _compare(SMALL_WIDE_PS, 1500, 64, 32, "cpu")


@pytest.mark.slow
def test_run_psu_matches_reference_1m_2048_com_full():
    """2^20 DB items × 2048 query items (1024 in the DB), the port on the card
    where there is one."""
    _compare(PARAMS, 1 << 20, 2048, 1024, "cuda" if torch.cuda.is_available() else "cpu")


@pytest.mark.parametrize("bits,ph,nseg,C,fill", [
    ([30, 30], 311, 2, 1, None),     # 256M-1's ph at the widest primes
    ([30, 29], 311, 1, 2, "p-1"),    # every product at its largest
    ([29, 29, 28], 6, 5, 3, None),   # 1M-2048-com's eval primes and ph
])
def test_ps_inner_plain_wide_matches_mont_mul_sum(bits, ph, nseg, C, fill):
    """ps_inner_plain against the reference's own arithmetic: canonical
    mont_mul terms added one by one with add_mod, as the reference's XLA loop
    (apsu_tpu/engine/evaluator.py:927-939) adds them."""
    primes = gen_ntt_primes(bits, 64)
    B, L, N = 2, len(primes), 32
    p = np.array(primes, np.uint64).reshape(L, 1)
    rng = np.random.default_rng(ph + nseg)
    low = rng.integers(0, 1 << 30, size=(B, ph - 1, 2, L, N), dtype=np.uint64) % p
    cache5 = rng.integers(0, 1 << 30, size=(B * C, nseg, ph, L, N), dtype=np.uint64) % p
    if fill == "p-1":
        low[:] = p - 1
        cache5[:] = p - 1
    low, cache5 = low.astype(np.uint32), cache5.astype(np.uint32)

    c = prime_consts(primes)
    pc, pni = jnp.asarray(c.p).reshape(L, 1), jnp.asarray(c.p_neg_inv).reshape(L, 1)
    low_r = jnp.repeat(jnp.asarray(low), C, axis=0)   # [R, ph-1, 2, L, N]
    cache = jnp.asarray(cache5)

    @jax.jit
    def oracle(low_r, cache):
        def term(i, acc):
            pw = jax.lax.dynamic_index_in_dim(low_r, i - 1, axis=1, keepdims=False)
            pt = jax.lax.dynamic_index_in_dim(cache, i, axis=2, keepdims=False)
            return ref_mod32.add_mod(
                acc, ref_mod32.mont_mul(pw[:, None], pt[:, :, None], pc, pni), pc)

        return jax.lax.fori_loop(1, ph, term, jnp.zeros((B * C, nseg, 2, L, N), jnp.uint32))

    want = np.asarray(oracle(low_r, cache))
    base = RnsBase(primes, N, "cpu")
    got = ps_inner_plain(from_u32(low, "cpu"), from_u32(cache5, "cpu"), base, C)
    assert np.array_equal(to_u32(got), want)
