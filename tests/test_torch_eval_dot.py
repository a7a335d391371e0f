"""The port's matching-polynomial dot product (plain version on the CPU)
against the TPU kernel eval_dot_pallas in interpret mode and against a
straightforward Montgomery multiply-accumulate, bit for bit (tolerance 0),
plus the wrapper's operand checks.

eval_dot takes the power tensor unpadded ([B, D, 2, L, N], x^1..x^D) where
eval_dot_pallas takes the reference's padded copy ([B, Dp, 2, L, N] with a
zero plane 0 and a zero tail); with the padding zero the two compute the
same sums, so the port gets planes 1..Dp-1 of the padded tensor."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apsu_tpu.core.nt import gen_ntt_primes
from apsu_tpu.ops.polyeval import DEG_CHUNK, eval_dot_pallas
from apsu_tpu_torch.core.mod32 import add_mod, from_u32, mont_mul, prime_consts, to_u32
from apsu_tpu_torch.core.rns import RnsBase
from apsu_tpu_torch.ops.polyeval import eval_dot

TOLERANCE = 0  # integer residues: exact


def _case(Dp, bits, B=2, C=3, N=128, seed=0, fill=None):
    """Padded powers [B, Dp, 2, L, N] and cache [B, C, Dp, L, N] with the
    reference's zero-padding convention (plane 0 of the powers, plane 0 and
    the last two planes of the cache)."""
    primes = gen_ntt_primes(list(bits), 64)
    L = len(primes)
    p = np.array(primes, np.uint64).reshape(1, 1, 1, L, 1)
    rng = np.random.default_rng(seed)
    powers = rng.integers(0, 1 << 30, size=(B, Dp, 2, L, N), dtype=np.uint64) % p
    cache = rng.integers(0, 1 << 30, size=(B, C, Dp, L, N), dtype=np.uint64) % p
    if fill == "p-1":
        powers[:] = p - 1
        cache[:] = p - 1
    powers[:, 0] = 0
    cache[:, :, 0] = 0
    cache[:, :, Dp - 2:] = 0
    return powers.astype(np.uint32), cache.astype(np.uint32), primes


def _port(powers, cache, primes):
    base = RnsBase(primes, powers.shape[-1], "cpu")
    return to_u32(eval_dot(from_u32(powers[:, 1:], "cpu"), from_u32(cache, "cpu"), base))


def _mont_sum(powers, cache, primes):
    """Σ_j mont_mul(powers[:, j], cache[:, :, j]) term by term (canonical)."""
    c = prime_consts(primes)
    L = len(primes)
    p = torch.tensor(c.p.astype(np.int64)).reshape(L, 1)
    pni = torch.tensor(c.p_neg_inv.astype(np.int64)).reshape(L, 1)
    pw, ch = from_u32(powers, "cpu"), from_u32(cache, "cpu")
    acc = torch.zeros((ch.shape[0], ch.shape[1]) + tuple(pw.shape[2:]), dtype=torch.int32)
    for j in range(pw.shape[1]):
        acc = add_mod(acc, mont_mul(pw[:, None, j], ch[:, :, j, None], p, pni), p)
    return to_u32(acc)


@pytest.mark.parametrize("Dp", [DEG_CHUNK, 2 * DEG_CHUNK, 5 * DEG_CHUNK])
@pytest.mark.parametrize("fill", [None, "p-1"])
def test_eval_dot_matches_pallas_interpret(Dp, fill):
    powers, cache, primes = _case(Dp, (27, 26), seed=Dp, fill=fill)
    c = prime_consts(primes)
    L = len(primes)
    want = eval_dot_pallas(jnp.asarray(powers), jnp.asarray(cache), c.p.reshape(L, 1),
                           c.p_neg_inv.reshape(L, 1), interpret=True)
    got = _port(powers, cache, primes)
    assert int(np.abs(got.astype(np.int64) - np.asarray(want).astype(np.int64)).max()) <= TOLERANCE
    assert np.array_equal(got, np.asarray(want))


@pytest.mark.parametrize("bits,Dp,C", [
    ((29, 29), 24, 3),            # 1M-4096-cmp's eval prime width
    ((30, 30, 30), 16, 5),        # the widest prime the port takes
    ((30,), 264, 2),              # Dp > 256
    ((28, 27), 520, 1),           # 1M-256-288's plane count
])
@pytest.mark.parametrize("fill", [None, "p-1"])
def test_eval_dot_matches_mont_sum_wide(bits, Dp, C, fill):
    powers, cache, primes = _case(Dp, bits, B=1, C=C, N=64, seed=Dp + C, fill=fill)
    assert np.array_equal(_port(powers, cache, primes), _mont_sum(powers, cache, primes))


def test_eval_dot_rejects_what_the_kernel_cannot_take():
    powers, cache, primes = _case(16, (27, 26), seed=1)
    base = RnsBase(primes, 128, "cpu")
    pw, ch = from_u32(powers[:, 1:], "cpu"), from_u32(cache, "cpu")
    with pytest.raises(ValueError, match="2\\^30"):
        eval_dot(pw, ch, RnsBase(gen_ntt_primes([31, 26], 64), 128, "cpu"))
    with pytest.raises(ValueError, match="multiple of 8"):
        eval_dot(pw, ch[:, :, :15], base)
    with pytest.raises(ValueError, match="multiple of 8"):
        eval_dot(from_u32(powers, "cpu"), ch, base)  # 16 powers need 17+ planes
    with pytest.raises(TypeError):
        eval_dot(pw.to(torch.int64), ch, base)
    with pytest.raises(ValueError, match="shape mismatch"):
        eval_dot(pw[:1], ch, base)
