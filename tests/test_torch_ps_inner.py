"""The port's PS inner sums (plain version on the CPU) against the TPU
kernels eval_ps_inner_pallas3 (K2) and its earlier versions
eval_ps_inner_pallas2 (K7) and eval_ps_inner_pallas (K8) in interpret mode,
bit for bit, plus the wrapper's operand checks."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apsu_tpu.core.nt import gen_ntt_primes
from apsu_tpu.ops.polyeval import (
    eval_ps_inner_pallas,
    eval_ps_inner_pallas2,
    eval_ps_inner_pallas3,
    plane_count as ref_plane_count,
)
from apsu_tpu_torch.core.mod32 import from_u32, prime_consts, to_u32
from apsu_tpu_torch.core.rns import RnsBase
from apsu_tpu_torch.ops.polyeval import plane_count, ps_inner


def _case(ph, nseg, C, bits=(27, 26), B=2, N=128, fill=None, seed=0):
    primes = gen_ntt_primes(list(bits), 64)
    L = len(primes)
    base = RnsBase(primes, N, "cpu")
    p = np.array(primes, np.uint64).reshape(1, 1, 1, L, 1)
    rng = np.random.default_rng(seed)
    low = rng.integers(0, 1 << 30, size=(B, ph - 1, 2, L, N), dtype=np.uint64) % p
    cache5 = rng.integers(0, 1 << 30, size=(B * C, nseg, ph, L, N), dtype=np.uint64) % p
    if fill == "p-1":
        low[:] = p - 1
        cache5[:] = p - 1
    return low.astype(np.uint32), cache5.astype(np.uint32), base


@pytest.mark.parametrize(
    "ph,nseg,C,fill",
    [(4, 14, 1, None), (9, 3, 3, None), (17, 2, 2, "p-1"), (45, 3, 2, None), (45, 2, 1, "p-1")],
)
def test_ps_inner_matches_pallas3_interpret(ph, nseg, C, fill):
    low, cache5, base = _case(ph, nseg, C, fill=fill, seed=ph * 10 + nseg)
    c = prime_consts(base.primes)
    want = eval_ps_inner_pallas3(
        jnp.asarray(low), jnp.asarray(cache5), c.p, c.p_neg_inv, C, interpret=True
    )
    got = ps_inner(from_u32(low, "cpu"), from_u32(cache5, "cpu"), base, C)
    assert np.array_equal(to_u32(got), np.asarray(want))


@pytest.mark.parametrize("kind", ["v1", "v2"])
@pytest.mark.parametrize("ph,nseg,C,fill", [(5, 4, 1, None), (9, 3, 3, None), (17, 2, 2, "p-1")])
def test_ps_inner_matches_earlier_pallas_versions(kind, ph, nseg, C, fill):
    """K7 (v2, row-resident) and K8 (v1, segment-chunked) compute K2's
    function; the port's one kernel serves all three."""
    kernel = {"v1": eval_ps_inner_pallas, "v2": eval_ps_inner_pallas2}[kind]
    low, cache5, base = _case(ph, nseg, C, fill=fill, seed=ph * 7 + nseg)
    c = prime_consts(base.primes)
    want = kernel(jnp.asarray(low), jnp.asarray(cache5), c.p, c.p_neg_inv, C, interpret=True)
    got = ps_inner(from_u32(low, "cpu"), from_u32(cache5, "cpu"), base, C)
    assert np.array_equal(to_u32(got), np.asarray(want))


def test_ps_inner_reads_strided_cache_view():
    """The evaluator hands the kernel cache_r[:, :nseg*ph] of a larger cache:
    a view strided along rows gives the same sums as a contiguous copy."""
    ph, nseg, C = 5, 3, 2
    low, cache5, base = _case(ph, nseg, C, seed=7)
    R, L, N = cache5.shape[0], cache5.shape[3], cache5.shape[4]
    big = torch.zeros((R, nseg * ph + 3, L, N), dtype=torch.int32)
    big[:, : nseg * ph] = from_u32(cache5.reshape(R, nseg * ph, L, N), "cpu")
    view = big[:, : nseg * ph].reshape(R, nseg, ph, L, N)
    assert not view.is_contiguous()
    lt = from_u32(low, "cpu")
    got = ps_inner(lt, view, base, C)
    assert torch.equal(got, ps_inner(lt, view.contiguous(), base, C))


def test_ps_inner_rejects_what_the_kernel_cannot_take():
    low, cache5, base = _case(5, 2, 1, seed=1)
    lt, ct = from_u32(low, "cpu"), from_u32(cache5, "cpu")
    too_wide = RnsBase(gen_ntt_primes([31, 26], 64), 128, "cpu")
    with pytest.raises(ValueError, match="2\\^30"):
        ps_inner(lt, ct, too_wide, 1)
    with pytest.raises(ValueError, match="bundles"):
        ps_inner(lt, ct, base, 2)
    with pytest.raises(TypeError):
        ps_inner(lt.to(torch.int64), ct, base, 1)
    with pytest.raises(ValueError, match="shape mismatch"):
        ps_inner(lt[:, :-1], ct, base, 1)
    # 29-bit primes and ph - 1 > 256 are taken (the kernel folds its sums)
    wide = RnsBase(gen_ntt_primes([29, 26], 64), 128, "cpu")
    assert ps_inner(lt, ct, wide, 1).shape == (2, 2, 2, 2, 128)
    z = torch.zeros((1, 1, 258, 2, 8), dtype=torch.int32)
    assert not ps_inner(torch.zeros((1, 257, 2, 2, 8), dtype=torch.int32), z, base, 1).any()


@pytest.mark.parametrize("K,ell", [(1304, 44), (51, 3), (4096, 0), (100, 9)])
def test_plane_count_matches_reference(K, ell):
    assert plane_count(K, ell) == ref_plane_count(K, ell)
