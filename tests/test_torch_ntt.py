"""The port's NTT (plain staged transform on the CPU) against
apsu_tpu.core.ntt.NttContext, bit for bit: the q, qp, Bsk and t bases of
Paterson–Stockmeyer parameter sets at N=8192 (16M-4096) and N=4096
(256K-2048-com), of the non-PS sets 1M-2048-cmp (N=4096) and 100K-1
(N=2048, no special prime), and a 30-bit prime at N=2048/4096/8192.  Slow
tests hold it against the TPU NTT kernels in interpret mode: ntt4_pallas,
ntt_pallas (the N=2048/4096 route), ntt_pair and ntt4_pallas_gl."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from apsu_tpu.core.bfv import BfvContext as RefBfv
from apsu_tpu.core.nt import gen_ntt_primes
from apsu_tpu.core.ntt import NttContext as RefNtt
from apsu_tpu.core.params import PSUParams
from apsu_tpu_torch.core.mod32 import from_u32, to_u32
from apsu_tpu_torch.core.ntt import NttContext


@functools.lru_cache(maxsize=None)
def _bases(name):
    bfv = RefBfv(PSUParams.load_file(f"parameters/{name}.json").seal_params)
    return {
        "q": (bfv.q.primes, bfv.n),
        "qp": (bfv.qp.primes, bfv.n) if bfv.qp is not None else None,
        "bsk": (bfv.bsk.primes, bfv.n),
        "t": ([bfv.t], bfv.n),
    }


CASES = [(cfg, b) for cfg in ("16M-4096", "256K-2048-com") for b in ("q", "qp", "bsk", "t")]
CASES += [("30-bit", n) for n in (2048, 4096, 8192)]
CASES += [("1M-2048-cmp", b) for b in ("q", "qp", "bsk", "t")]
CASES += [("100K-1", b) for b in ("q", "bsk", "t")]


def _primes_n(cfg, which):
    if cfg == "30-bit":
        return gen_ntt_primes([30], 2 * which), which
    return _bases(cfg)[which]


def _inputs(primes, n, seed, batch=2):
    rng = np.random.default_rng(seed)
    x = np.stack([rng.integers(0, p, size=(batch, n)) for p in primes], axis=1)
    x = x.astype(np.uint32)
    x[0, :, 0] = np.array(primes, np.uint32) - 1  # p-1 edge
    return x


@pytest.mark.parametrize("cfg,which", CASES)
def test_ntt_matches_reference(cfg, which):
    primes, n = _primes_n(cfg, which)
    ref, port = RefNtt(primes, n), NttContext(primes, n, "cpu")
    x = _inputs(primes, n, seed=len(primes) * n)
    xt = from_u32(x, "cpu")
    fwd = port.ntt(xt)
    assert np.array_equal(to_u32(fwd), np.asarray(jax.jit(ref.ntt)(jnp.asarray(x))))
    assert np.array_equal(to_u32(port.intt(xt)), np.asarray(jax.jit(ref.intt)(jnp.asarray(x))))
    assert np.array_equal(to_u32(port.intt(fwd)), x), "round trip not exact"


@pytest.mark.slow
def test_ntt_matches_ntt4_pallas_interpret():
    from apsu_tpu.ops.ntt4_pallas import Ntt4pTables, ntt4_pallas

    n = 8192
    primes = gen_ntt_primes([28, 27], 2 * n)
    tb = Ntt4pTables(primes, n)
    port = NttContext(primes, n, "cpu")
    x = _inputs(primes, n, seed=42)
    fwd = ntt4_pallas(jnp.asarray(x), tb, interpret=True)
    assert np.array_equal(to_u32(port.ntt(from_u32(x, "cpu"))), np.asarray(fwd))
    inv = ntt4_pallas(fwd, tb, inverse=True, interpret=True)
    assert np.array_equal(to_u32(port.intt(from_u32(np.asarray(fwd), "cpu"))), np.asarray(inv))


def _check_against(primes, n, fwd_fn, inv_fn, seed):
    """fwd_fn/inv_fn: numpy [..., L, N] -> numpy, the reference kernel."""
    port = NttContext(primes, n, "cpu")
    x = _inputs(primes, n, seed=seed)
    fwd = fwd_fn(x)
    assert np.array_equal(to_u32(port.ntt(from_u32(x, "cpu"))), fwd)
    assert np.array_equal(to_u32(port.intt(from_u32(fwd, "cpu"))), inv_fn(fwd))


@pytest.mark.slow
def test_ntt_matches_ntt_pallas_interpret():
    """K4: the reference's route for N=2048/4096 (any prime < 2^30), at the
    1M-2048-cmp evaluation primes and a 30-bit prime, N=4096."""
    from apsu_tpu.ops.ntt_pallas import ntt_pallas, stage_twiddles

    n = 4096
    for primes in (list(_bases("1M-2048-cmp")["q"][0][:2]), gen_ntt_primes([30], 2 * n)):
        ref = RefNtt(primes, n)
        tw_f = stage_twiddles(ref.w_pl, ref.w_sh, n, inverse=False)
        tw_i = stage_twiddles(ref.winv_pl, ref.winv_sh, n, inverse=True)
        p_np = np.asarray(ref.consts.p, dtype=np.uint32)
        ninv = np.stack([ref.ninv_pl, ref.ninv_sh], axis=1)
        _check_against(
            primes, n,
            lambda x: np.asarray(ntt_pallas(jnp.asarray(x), tw_f, p_np, interpret=True)),
            lambda y: np.asarray(ntt_pallas(jnp.asarray(y), tw_i, p_np, inverse=True,
                                            ninv_np=ninv, interpret=True)),
            seed=len(primes),
        )


@pytest.mark.slow
def test_ntt_matches_ntt_pair_interpret():
    """K5: the pair-form kernel (opt-in APSU_PAIR_NTT), N=2048."""
    from apsu_tpu.ops.ntt_pair import ntt_pair, pair_tables

    n = 2048
    primes = gen_ntt_primes([28, 27], 2 * n)
    ref = RefNtt(primes, n)
    tw_f = pair_tables(ref.w_pl, ref.w_sh, n, inverse=False)
    tw_i = pair_tables(ref.winv_pl, ref.winv_sh, n, inverse=True)
    p_np = np.asarray(ref.consts.p, dtype=np.uint32)
    ninv = np.stack([ref.ninv_pl, ref.ninv_sh], axis=1)
    _check_against(
        primes, n,
        lambda x: np.asarray(ntt_pair(jnp.asarray(x), tw_f, p_np, interpret=True)),
        lambda y: np.asarray(ntt_pair(jnp.asarray(y), tw_i, p_np, inverse=True,
                                      ninv_np=ninv, interpret=True)),
        seed=7,
    )


@pytest.mark.slow
def test_ntt_matches_ntt4_pallas_gl_interpret():
    """K6: the four-step kernel with its grid over limbs (opt-in
    APSU_NTT4P_GL), N=8192."""
    from apsu_tpu.ops.ntt4_pallas import Ntt4pTables, ntt4_pallas_gl

    n = 8192
    primes = gen_ntt_primes([28, 27], 2 * n)
    tb = Ntt4pTables(primes, n)
    _check_against(
        primes, n,
        lambda x: np.asarray(ntt4_pallas_gl(jnp.asarray(x), tb, interpret=True)),
        lambda y: np.asarray(ntt4_pallas_gl(jnp.asarray(y), tb, inverse=True, interpret=True)),
        seed=9,
    )
