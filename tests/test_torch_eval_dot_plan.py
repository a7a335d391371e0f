"""K3's launch plan (``ops/polyeval.py:eval_dot_plan``) on the CPU: the blocks
it launches cover every (bundle, cache, plane 1..D, lane) exactly once and
write every output lane once; it fills the H100 with at least two blocks an
SM at the paths' shapes; its shared memory fits a block.  A numpy-uint64
model of the kernel's split reduction (``csrc/eval_dot.cu``), following the
plan, shows that no sum wraps with every residue at p - 1 on 30-bit primes,
and equals ``eval_dot_plain`` and the TPU kernel ``eval_dot_pallas`` in
interpret mode, bit for bit (tolerance 0: integer residues)."""

import jax.numpy as jnp
import numpy as np
import pytest

from apsu_tpu.core.nt import gen_ntt_primes
from apsu_tpu.ops.polyeval import eval_dot_pallas
from apsu_tpu_torch.core.mod32 import from_u32, prime_consts, to_u32
from apsu_tpu_torch.core.rns import RnsBase
from apsu_tpu_torch.ops.polyeval import (
    SMEM_PER_BLOCK,
    _dot_plan,
    eval_dot_plain,
    eval_dot_plan,
)

TOLERANCE = 0
SMS = 132  # H100 SXM
U64_MAX = np.uint64(0xFFFF_FFFF_FFFF_FFFF)

# (B, C, D, Dp, L, N) of K3's calls on the paths, as chip_smoke.py's DOT_CASES
PATHS = {
    "1M-2048-cmp": (5, 15, 72, 80, 2, 4096),
    "1M-1-32 labeled": (1, 5, 228, 232, 4, 8192),
    "1M-2048-cmp 5-shard shard": (1, 15, 72, 80, 2, 4096),
    "Dp=520": (1, 3, 519, 520, 2, 4096),
    "1M-256-288": (1, 10, 512, 520, 3, 4096),
}
EDGES = {
    "B=1, C=1, D=1": (1, 1, 1, 8, 1, 4096),
    "D=1 under 15 caches: the partials outgrow one stage": (1, 15, 1, 8, 2, 4096),
    "one plane a range under 15 caches": (1, 15, 3, 8, 2, 4096),
    "C=1, D=519": (2, 1, 519, 520, 2, 1024),
    "C above a block's caches": (2, 37, 20, 24, 1, 256),
    "plane ranges that do not divide D": (1, 2, 101, 104, 2, 512),
    "N=64": (3, 4, 13, 16, 2, 64),
    "N below the lane tile, odd tiles": (1, 3, 40, 48, 3, 192),
}


def _blocks(plan, B, C, D, N):
    """Each block's (b, caches c0..c0+nc, planes j0..j0+nj, lanes n0..n0+nt,
    cluster rank s), decoded from its grid index as csrc/eval_dot.cu does."""
    tiles, L, Z = plan.grid
    for z in range(Z):
        s, bq = z % plan.split, z // plan.split
        b, q = bq // plan.cache_chunks, bq % plan.cache_chunks
        c0 = q * plan.caches
        nc = min(plan.caches, C - c0)
        j0 = 1 + s * plan.planes
        nj = min(plan.planes, D + 1 - j0)
        for x in range(tiles):
            n0 = x * plan.tile
            for l in range(L):
                yield b, c0, nc, j0, nj, l, n0, min(plan.tile, N - n0), s


@pytest.mark.parametrize("shape", list(PATHS.values()) + list(EDGES.values()),
                         ids=list(PATHS) + list(EDGES))
def test_plan_covers_every_product_and_output_once(shape):
    B, C, D, _, L, N = shape
    plan = eval_dot_plan(B, C, D, L, N, SMS)
    assert plan.cluster == (1, 1, plan.split) and plan.grid[2] % plan.split == 0
    assert plan.grid[:2] == (-(-N // plan.tile), L)
    tiles = plan.grid[0]
    reads = np.zeros((B, C, D + 1, L, tiles), np.int64)
    writes = np.zeros((B, C, 2, L, tiles), np.int64)
    lanes = np.zeros(N, np.int64)
    for b, c0, nc, j0, nj, l, n0, nt, s in _blocks(plan, B, C, D, N):
        assert nc >= 1 and nj >= 1 and nt >= 1 and nt % 4 == 0
        reads[b, c0:c0 + nc, j0:j0 + nj, l, n0 // plan.tile] += 1
        # rank s of the cluster writes rows s, s + split, ... of the 2·nc rows
        for r in range(s, 2 * nc, plan.split):
            writes[b, c0 + r // 2, r % 2, l, n0 // plan.tile] += 1
        if b == c0 == j0 - 1 == l == 0:
            lanes[n0:n0 + nt] += 1
    assert (reads[:, :, 0] == 0).all()     # plane 0 is never read
    assert (reads[:, :, 1:] == 1).all()
    assert (writes == 1).all()
    assert (lanes == 1).all()


@pytest.mark.parametrize("name", list(PATHS))
def test_plan_fills_the_card_at_the_paths_shapes(name):
    B, C, D, _, L, N = PATHS[name]
    plan = eval_dot_plan(B, C, D, L, N, SMS)
    assert plan.grid[0] * plan.grid[1] * plan.grid[2] >= 2 * SMS


@pytest.mark.parametrize("C", [1, 3, 5, 10, 15, 16, 17, 40, 300])
@pytest.mark.parametrize("D", [1, 7, 72, 228, 519, 1311])
def test_plan_fits_a_block_and_the_kernels_checks(C, D):
    for B, L, N in [(1, 1, 64), (5, 2, 4096), (1, 4, 8192)]:
        plan = eval_dot_plan(B, C, D, L, N, SMS)
        assert plan.smem_bytes <= SMEM_PER_BLOCK
        assert 1 <= plan.caches <= 16 and 1 <= plan.split <= 8 and 1 <= plan.stages <= 16
        assert plan.cache_chunks * plan.caches >= C > (plan.cache_chunks - 1) * plan.caches
        assert plan.split * plan.planes >= D > (plan.split - 1) * plan.planes
        assert 1 <= plan.stage_planes <= plan.planes
        # the ring, which also holds the range's 2·caches rows of partial sums
        ring = max(plan.stages * plan.stage_planes * (2 + plan.caches), 2 * plan.caches)
        assert plan.smem_bytes == 256 + ring * plan.tile * 4


def _model(powers, cache, primes, plan):
    """The kernel's arithmetic in numpy uint64, following ``plan``: each plane
    range's two sums a cache folded every plan.fold_every products (high word
    brought below p by conditional subtractions), reduced by one Montgomery
    REDC, and the ranges' residues added mod p.  Asserts the bounds the
    source note claims: no u64 wrap, hi < 3p at a fold, t < 2p at the REDC."""
    B, D, _, L, N = powers.shape
    c = prime_consts(primes)
    p = c.p.astype(np.uint64).reshape(1, 1, 1, L, 1)
    pni = c.p_neg_inv.astype(np.uint64).reshape(1, 1, 1, L, 1)
    m32 = np.uint64(0xFFFF_FFFF)
    pw = powers.astype(np.uint64)[:, :, None]        # [B, D, 1, 2, L, N]
    ch = cache.astype(np.uint64)[:, :, :, None]      # [B, C, Dp, 1, L, N]

    def fold(s):
        hi = s >> np.uint64(32)
        assert (hi < 3 * p).all()
        hi = np.where(hi >= p, hi - p, hi)
        hi = np.where(hi >= p, hi - p, hi)
        return (hi << np.uint64(32)) | (s & m32)

    out = np.zeros((B, cache.shape[1], 2, L, N), np.uint64)
    for s in range(plan.split):
        j0 = 1 + s * plan.planes
        acc = np.zeros_like(out)
        for k, j in enumerate(range(j0, min(j0 + plan.planes, D + 1))):
            prod = pw[:, j - 1, None, 0] * ch[:, :, j]   # [B, C, 2, L, N], each < 2^60
            assert (acc <= U64_MAX - prod).all()
            acc = acc + prod
            if (k + 1) % plan.fold_every == 0:
                acc = fold(acc)
        acc = fold(acc)
        m = ((acc & m32) * pni) & m32
        t = (acc >> np.uint64(32)) + (((acc & m32) + m * p) >> np.uint64(32))
        assert (t < 2 * p).all()
        t = np.where(t >= p, t - p, t)
        out = out + t
        out = np.where(out >= p, out - p, out)
    return out.astype(np.uint32)


def _inputs(B, C, D, Dp, bits, N, seed, fill=None):
    primes = gen_ntt_primes(list(bits), 2 * N)
    p = np.array(primes, np.uint64).reshape(-1, 1)
    rng = np.random.default_rng(seed)
    L = len(primes)
    powers = rng.integers(0, 1 << 30, size=(B, D, 2, L, N), dtype=np.uint64) % p
    cache = rng.integers(0, 1 << 30, size=(B, C, Dp, L, N), dtype=np.uint64) % p
    if fill == "p-1":
        powers[:] = p - 1
        cache[:] = p - 1
    return powers.astype(np.uint32), cache.astype(np.uint32), primes


def _plain(powers, cache, primes):
    base = RnsBase(primes, powers.shape[-1], "cpu")
    return to_u32(eval_dot_plain(from_u32(powers, "cpu"), from_u32(cache, "cpu"), base))


@pytest.mark.parametrize("fill", ["p-1", None])
@pytest.mark.parametrize("B,C,D,Dp,N,split", [
    (1, 3, 519, 520, 64, None),     # Dp=520 at B=1: the plan splits the planes
    (2, 5, 72, 80, 128, 1),         # one range: a fold every 8 products to the end
    (1, 2, 101, 104, 64, 7),        # ranges of 15 planes, the last 11
    (1, 1, 1, 8, 64, None),         # one power
])
def test_split_reduction_never_wraps_at_30_bits(B, C, D, Dp, N, split, fill):
    powers, cache, primes = _inputs(B, C, D, Dp, (30, 30), N, seed=D, fill=fill)
    plan = (eval_dot_plan(B, C, D, 2, N, SMS) if split is None
            else _dot_plan(B, C, D, 2, N, split, 128))
    assert split is None or plan.split == split
    got = _model(powers, cache, primes, plan)
    assert np.array_equal(got, _plain(powers, cache, primes))


@pytest.mark.parametrize("B,C,D,Dp,bits,N", [   # the TPU kernel takes primes < 2^28
    (2, 3, 15, 16, (27, 26), 128),
    (1, 4, 38, 40, (27,), 256),
    (1, 2, 7, 8, (26, 25), 512),
])
def test_split_model_matches_plain_and_pallas_interpret(B, C, D, Dp, bits, N):
    powers, cache, primes = _inputs(B, C, D, Dp, bits, N, seed=Dp + C)
    cache[:, :, 0] = 0          # the reference's padding: a zero plane 0 and tail
    cache[:, :, D + 1:] = 0
    plan = eval_dot_plan(B, C, D, len(primes), N, SMS)
    assert plan.split > 1
    got = _model(powers, cache, primes, plan)
    plain = _plain(powers, cache, primes)
    c = prime_consts(primes)
    L = len(primes)
    padded = np.zeros((B, Dp, 2, L, N), np.uint32)
    padded[:, 1:D + 1] = powers
    want = np.asarray(eval_dot_pallas(jnp.asarray(padded), jnp.asarray(cache),
                                      c.p.reshape(L, 1), c.p_neg_inv.reshape(L, 1),
                                      interpret=True))
    assert int(np.abs(got.astype(np.int64) - want.astype(np.int64)).max()) <= TOLERANCE
    assert np.array_equal(got, want) and np.array_equal(plain, want)


@pytest.mark.parametrize("held", [40, 62, 92])
@pytest.mark.parametrize("name", list(PATHS))
def test_plan_keeps_every_cluster_resident_where_one_fits(name, held):
    """Given how many clusters the card holds at once, the plan leaves none
    for a second wave when any candidate avoids it (a cluster left over
    doubled K3's time on the H100)."""
    B, C, D, _, L, N = PATHS[name]
    plan = eval_dot_plan(B, C, D, L, N, SMS, resident=lambda p: held)
    clusters = plan.grid[0] * plan.grid[1] * plan.grid[2] // plan.split
    fitting = [_dot_plan(B, C, D, L, N, s, t) for t in (128, 64) for s in range(1, 9)]
    if any(p.grid[0] * p.grid[1] * p.grid[2] // p.split <= held for p in fitting):
        assert clusters <= held
