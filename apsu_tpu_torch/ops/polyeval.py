"""Kernels 2 and 3: the Paterson–Stockmeyer inner sums (``csrc/ps_inner.cu``)
and the matching-polynomial dot product (``csrc/eval_dot.cu``), each with its
plain PyTorch version, plus the DB plane layout helpers.

Kernel 2 replaces the TPU kernel
``apsu_tpu/ops/polyeval.py:eval_ps_inner_pallas3``:

    out[r, k] = Σ_{i=1..ph-1} low[r // C, i-1] ⊙_mont cache5[r, k, i]

per limb and lane, over both ciphertext components.  On the H100 it is bound
by device-memory bytes — the coefficient cache (4 GB per query at 16M-4096)
must stream through once.  A block owns a lane tile of one bundle and limb
and a chunk of that bundle's rows: it holds the tile's low powers in shared
memory (read once a block), streams the cache through a ring of shared-memory
stages by bulk asynchronous copies, in place through its row stride (the
evaluator's strided view is never copied), and reduces each 8-product u64
sum with one Montgomery reduction and no division.  It takes every prime
< 2^30 and any ph (the TPU kernel needs < 2^28).  The launcher in
``csrc/ps_inner.cu`` picks the row chunk from the card's SM count and the
kernel's occupancy.

Kernel 3 replaces ``apsu_tpu/ops/polyeval.py:eval_dot_pallas`` (the non-PS
evaluation):

    out[b, c] = Σ_{j=1..D} powers[b, j-1] ⊙_mont cache[b, c, j]

It too is bound by the bytes of the cache and the powers, each streamed
through once by bulk asynchronous copies.  A block owns a lane tile of one
bundle and limb, a chunk of its caches (their sums in registers) and one
range of the plane axis; the ranges of a tile are the blocks of one cluster,
which add their canonical partial sums through distributed shared memory.
``eval_dot_plan`` picks the split and the ring from the shape, so the B=1
shapes fill the card too.  It takes every prime < 2^30 (the TPU kernel needs
< 2^28), folding its u64 sums before they can wrap.

``ps_inner`` and ``eval_dot`` launch their kernels for CUDA tensors and run
the plain versions for CPU tensors; both are bit-identical to the reference.
"""

from __future__ import annotations

import ctypes
import functools
from typing import TYPE_CHECKING, NamedTuple

import torch

from apsu_tpu_torch.core.mod32 import I32, I64, MASK32, add_mod, mul_lo
from apsu_tpu_torch.ops import _build

if TYPE_CHECKING:
    from apsu_tpu_torch.core.rns import RnsBase

DEG_CHUNK = 8
MAX_PRIME = 1 << 30   # both kernels' operand bound: products < 2^60 (fold every 8)

# kernel launches since the last reset (set to 0 to reset); a launch captured
# into a CUDA graph is counted at each replay (``ops/counts.py``)
launches = 0  # PS kernel launches
dot_launches = 0  # dot kernel launches since the last reset


def plane_count(K: int, ps_low_degree: int) -> int:
    """Coefficient-plane count for a DB cache at max bin degree K.

    Non-PS: K+1 rounded up to DEG_CHUNK.  PS: at least (nh+1)·ph planes so
    every gather index nh·ph + i (i ≤ ℓ) lands on a real (zero) plane."""
    if ps_low_degree > 0:
        ph = ps_low_degree + 1
        nh = K // ph
        min_planes = max(K + 1, (nh + 1) * ph)
    else:
        min_planes = K + 1
    return -(-min_planes // DEG_CHUNK) * DEG_CHUNK


def _check(low, cache5, base: RnsBase, caches_per_bundle):
    if low.dtype != I32 or cache5.dtype != I32:
        raise TypeError("ps_inner needs int32 residues")
    if low.dim() != 5 or cache5.dim() != 5:
        raise ValueError("ps_inner needs low [B, ph-1, 2, L, N] and cache5 [R, nseg, ph, L, N]")
    B, ell, two, L, N = low.shape
    R, nseg, ph, Lc, Nc = cache5.shape
    if two != 2 or (Lc, Nc) != (L, N) or ell != ph - 1:
        raise ValueError(f"shape mismatch: low {tuple(low.shape)}, cache5 {tuple(cache5.shape)}")
    if R != B * caches_per_bundle:
        raise ValueError(f"cache rows {R} != bundles {B} x caches {caches_per_bundle}")
    if base.k != L or any(q >= MAX_PRIME for q in base.primes):
        raise ValueError("ps_inner needs one prime per limb, each < 2^30")


def ps_inner(low, cache5, base: RnsBase, caches_per_bundle: int) -> torch.Tensor:
    """PS inner sums.  low [B, ph-1, 2, L, N] NTT mont; cache5
    [R, nseg, ph, L, N] with R = B·caches_per_bundle (may be a strided view
    along R); ``base`` is the L-limb RNS base on the tensors' device; returns
    [R, nseg, 2, L, N] int32."""
    if low.device.type == "cpu" and cache5.device.type == "cpu":
        return ps_inner_plain(low, cache5, base, caches_per_bundle)
    return ps_inner_cuda(low, cache5, base, caches_per_bundle)


def ps_inner_cuda(low, cache5, base: RnsBase, caches_per_bundle: int) -> torch.Tensor:
    global launches
    _check(low, cache5, base, caches_per_bundle)
    if not (low.is_cuda and cache5.is_cuda and low.device == cache5.device):
        raise ValueError("ps_inner_cuda needs both tensors on one CUDA device")
    if base.device.type != "cuda" or base.p_u32.device != low.device:
        raise ValueError("the RNS base lives on another device than the inputs")
    if not low.is_contiguous():
        raise ValueError("ps_inner_cuda needs a contiguous low-power tensor")
    R, nseg, ph, L, N = cache5.shape
    inner = (ph * L * N, L * N, N, 1)
    if tuple(cache5.stride()[1:]) != inner and R * nseg > 0:
        raise ValueError(f"cache5 strides {cache5.stride()} not contiguous below the row axis")
    if R * nseg * L * N >= 1 << 62 or max(R * nseg, ph, L * N) >= 1 << 31:
        raise ValueError("ps_inner_cuda shape too large")
    # the kernel's bulk copies move 16-byte aligned runs of a lane tile
    if N % 4 or cache5.stride(0) % 4 or cache5.data_ptr() % 16 or low.data_ptr() % 16:
        raise ValueError("ps_inner_cuda needs N % 4 == 0, 16-byte aligned low and cache5, "
                         "and a cache5 row stride that is a multiple of 4")
    out = torch.empty((R, nseg, 2, L, N), dtype=I32, device=low.device)
    if out.numel() == 0:
        return out
    launches += _build.launch(
        "ps_inner", _build.lib().apsu_ps_inner, low.get_device(),
        low.data_ptr(), cache5.data_ptr(), out.data_ptr(), base.p_u32.data_ptr(),
        base.pni_u32.data_ptr(), cache5.stride(0), R, caches_per_bundle, nseg, ph, L, N,
    )
    return out


def _redc(s, p, pni):
    """Canonical s·R^{-1} mod p for int64 sums 0 ≤ s < 2^63."""
    lo = s & MASK32
    m = mul_lo(lo, pni)
    t = (s >> 32) + ((lo + m * p) >> 32)
    return torch.remainder(t, p)


def ps_inner_plain(low, cache5, base: RnsBase, caches_per_bundle: int) -> torch.Tensor:
    """int64 multiply-accumulate with REDC: raw products summed over
    DEG_CHUNK planes, each chunk folded by one Montgomery reduction into the
    canonical accumulator.  Every prime is < 2^30, so a product is < 2^60
    and a chunk of 8 sums below 2^63: the int64 sum never wraps, for any ph.
    The result is the canonical Σ a·b·R^{-1} mod p, which the reference's
    XLA loop (canonical mont_mul terms added one by one) gives too."""
    _check(low, cache5, base, caches_per_bundle)
    R, nseg, ph, L, N = cache5.shape
    dev = low.device
    p, pni = base.p_d.to(dev), base.pni_d.to(dev)
    low_r = low.repeat_interleave(caches_per_bundle, dim=0)  # [R, ph-1, 2, L, N]
    acc = torch.zeros((R, nseg, 2, L, N), dtype=I32, device=dev)
    s = torch.zeros((R, nseg, 2, L, N), dtype=I64, device=dev)
    for i in range(1, ph):
        s += low_r[:, None, i - 1].to(I64) * cache5[:, :, i, None].to(I64)
        if i % DEG_CHUNK == 0 or i == ph - 1:
            acc = add_mod(acc, _redc(s, p, pni), p)
            s.zero_()
    return acc


# ---------------------------------------------------------------------------
# Kernel 3: the non-PS matching-polynomial dot product
# ---------------------------------------------------------------------------

def _check_dot(powers, cache, base: RnsBase):
    if powers.dtype != I32 or cache.dtype != I32:
        raise TypeError("eval_dot needs int32 residues")
    if powers.dim() != 5 or cache.dim() != 5:
        raise ValueError("eval_dot needs powers [B, D, 2, L, N] and cache [B, C, Dp, L, N]")
    B, D, two, L, N = powers.shape
    Bc, C, Dp, Lc, Nc = cache.shape
    if two != 2 or (Bc, Lc, Nc) != (B, L, N):
        raise ValueError(f"shape mismatch: powers {tuple(powers.shape)}, cache {tuple(cache.shape)}")
    if Dp % DEG_CHUNK or D + 1 > Dp:
        raise ValueError(f"cache planes {Dp} must be a multiple of {DEG_CHUNK} above {D} powers")
    if base.k != L or any(q >= MAX_PRIME for q in base.primes):
        raise ValueError("eval_dot needs one prime per limb, each < 2^30")


def eval_dot(powers, cache, base: RnsBase) -> torch.Tensor:
    """Matching-polynomial dot product.  powers [B, D, 2, L, N] NTT mont
    (x^1..x^D, unpadded); cache [B, C, Dp, L, N] NTT mont coefficient planes
    (plane 0 = constant, planes > D zero padding, Dp % 8 == 0); ``base`` is
    the L-limb RNS base on the tensors' device.  Returns [B, C, 2, L, N]."""
    if powers.device.type == "cpu" and cache.device.type == "cpu":
        return eval_dot_plain(powers, cache, base)
    return eval_dot_cuda(powers, cache, base)


# K3's launch plan (csrc/eval_dot.cu checks each field it reads)
DOT_TILES = (128, 64)    # lanes a block, the larger preferred
DOT_MAX_CACHES = 16      # caches a block sums in registers
DOT_MAX_SPLIT = 8        # plane ranges a lane tile: the blocks of one portable cluster
DOT_MAX_STAGES = 16
# a 128-lane block's ring stage holds whole planes up to about DOT_STAGE_BYTES
# and its ring up to about DOT_RING_BYTES, but at least DOT_MIN_STAGES stages;
# a smaller tile takes the same planes and stages
DOT_STAGE_BYTES = 8192
DOT_RING_BYTES = 24576
DOT_MIN_STAGES = 3
DOT_LOAD_PER_SM = 3      # 128-lane blocks' worth of lanes an SM the plan aims at
DOT_FOLD_EVERY = 8       # products a u64 sum takes between folds
DOT_BARRIER_BYTES = 2 * DOT_MAX_STAGES * 8
SMEM_PER_BLOCK = 232448  # the H100's most dynamic shared memory a block
H100_SMS = 132


class DotPlan(NamedTuple):
    """How K3 cuts one call: blocks of (lane tile, limb, bundle x cache chunk
    x plane range), the plane ranges of a tile forming one cluster."""
    tile: int            # lanes a block
    cache_chunks: int    # blocks along a bundle's caches
    caches: int          # caches a block (the last chunk may hold fewer)
    split: int           # plane ranges a tile (cluster size)
    planes: int          # planes a range (the last may hold fewer)
    stage_planes: int    # planes a ring stage
    stages: int          # ring stages
    smem_bytes: int      # dynamic shared memory a block
    fold_every: int      # products between folds of a u64 sum
    grid: tuple          # (lane tiles, L, B * cache_chunks * split)
    cluster: tuple       # (1, 1, split)

    def kernel_fields(self) -> tuple:
        """The fields ``apsu_eval_dot_split`` reads, in its order."""
        return self[:8]


def _dot_plan(B: int, C: int, D: int, L: int, N: int, split: int, tile: int) -> DotPlan:
    """The plan with ``tile`` lanes a block and at most ``split`` plane
    ranges a tile."""
    chunks = -(-C // DOT_MAX_CACHES)
    caches = -(-C // chunks)
    chunks = -(-C // caches)
    split = max(1, min(split, DOT_MAX_SPLIT, D))
    planes = max(1, -(-D // split))
    split = max(1, -(-D // planes))
    slice_set = (2 + caches) * DOT_TILES[0] * 4   # bytes of one plane of a 128-lane block
    stage_planes = max(1, min(planes, DOT_STAGE_BYTES // slice_set))
    ring_stages = DOT_RING_BYTES // (stage_planes * slice_set)
    stages = min(-(-planes // stage_planes),
                 max(DOT_MIN_STAGES, min(DOT_MAX_STAGES, ring_stages)))
    ring_bytes = stages * stage_planes * (2 + caches) * tile * 4
    partial_bytes = 2 * caches * tile * 4   # the range's sums, left in the ring at the end
    return DotPlan(tile, chunks, caches, split, planes, stage_planes, stages,
                   DOT_BARRIER_BYTES + max(ring_bytes, partial_bytes), DOT_FOLD_EVERY,
                   (-(-N // tile), L, B * chunks * split), (1, 1, split))


def eval_dot_plan(B: int, C: int, D: int, L: int, N: int, sms: int = H100_SMS,
                  resident=None) -> DotPlan:
    """K3's launch plan for powers [B, D, 2, L, N] and C caches a bundle on a
    card of ``sms`` SMs; ``resident(plan)``, where given, is how many of the
    plan's clusters the card holds at once (``card_dot_plan`` asks the card).

    Every block streams at about one rate, so the plan wants all its
    clusters resident at once (a cluster left over runs as a second wave)
    and about DOT_LOAD_PER_SM 128-lane blocks' worth of lanes an SM:
    fewer leave the card's memory idle, more crowd it.  Among the lane tiles
    and plane splits it takes the plan whose clusters fit, nearest that
    load, then with its blocks spread most evenly over the SMs
    (ceil(n / sms) / (n / sms) least), then the larger tile and the fewer
    blocks.  (Fitted to K3's five path shapes on the H100, each pick timed
    in turns by ``chip_smoke.py --compare-eval-dot`` at f5d52af; the
    script now times K3 alone at those shapes, ``DOT_CASES``.)"""
    def cost(plan):
        n = plan.grid[0] * plan.grid[1] * plan.grid[2]
        fits = resident is None or n // plan.split <= resident(plan)
        load = n * plan.tile / DOT_TILES[0]
        return (not fits, abs(load - DOT_LOAD_PER_SM * sms), -(-n // sms) / (n / sms),
                -plan.tile, n)

    return min((_dot_plan(B, C, D, L, N, split, tile)
                for tile in DOT_TILES for split in range(1, DOT_MAX_SPLIT + 1)), key=cost)


@functools.lru_cache(maxsize=256)
def card_dot_plan(index: int, B: int, C: int, D: int, L: int, N: int) -> DotPlan:
    """``eval_dot_plan`` for CUDA device ``index``, with its SM count and its
    cluster occupancy at each candidate (``apsu_eval_dot_clusters``)."""
    props = torch.cuda.get_device_properties(index)

    def resident(plan):
        n = ctypes.c_int(0)
        fields = (ctypes.c_int * 8)(*plan.kernel_fields())
        with torch.cuda.device(index):
            _build.check(_build.lib().apsu_eval_dot_clusters(B, C, D, D + 1, L, N, fields,
                                                             ctypes.byref(n)),
                         "eval_dot occupancy")
        return n.value

    return eval_dot_plan(B, C, D, L, N, props.multi_processor_count, resident if D else None)


def eval_dot_cuda(powers, cache, base: RnsBase) -> torch.Tensor:
    global dot_launches
    _check_dot(powers, cache, base)
    if not (powers.is_cuda and cache.is_cuda and powers.device == cache.device):
        raise ValueError("eval_dot_cuda needs both tensors on one CUDA device")
    if base.device.type != "cuda" or base.p_u32.device != powers.device:
        raise ValueError("the RNS base lives on another device than the inputs")
    if not (powers.is_contiguous() and cache.is_contiguous()):
        raise ValueError("eval_dot_cuda needs contiguous tensors")
    B, D, _, L, N = powers.shape
    C, Dp = cache.shape[1], cache.shape[2]
    # the kernel's bulk copies move 16-byte aligned runs of a lane tile
    if N % 4 or powers.data_ptr() % 16 or cache.data_ptr() % 16:
        raise ValueError("eval_dot_cuda needs N % 4 == 0 and 16-byte aligned tensors")
    if max(B, C, Dp, L, N) >= 1 << 31:
        raise ValueError("eval_dot_cuda shape too large")
    out = torch.empty((B, C, 2, L, N), dtype=I32, device=powers.device)
    if out.numel() == 0:
        return out
    plan = card_dot_plan(powers.device.index, B, C, D, L, N)
    if plan.grid[1] > 65535 or plan.grid[2] > 65535:
        raise ValueError("eval_dot_cuda shape too large")
    dot_launches += _build.launch(
        "eval_dot", _build.lib().apsu_eval_dot_split, powers.get_device(),
        powers.data_ptr(), cache.data_ptr(), out.data_ptr(), base.p_u32.data_ptr(),
        base.pni_u32.data_ptr(), B, C, D, Dp, L, N, (ctypes.c_int * 8)(*plan.kernel_fields()),
    )
    return out


def eval_dot_plain(powers, cache, base: RnsBase) -> torch.Tensor:
    """int64 multiply-accumulate with REDC at the reference's fold points:
    raw products summed over each DEG_CHUNK-plane chunk of the padded plane
    axis (< 2^63 for primes < 2^30), each chunk folded by one Montgomery
    reduction into the canonical accumulator."""
    _check_dot(powers, cache, base)
    B, D, _, L, N = powers.shape
    C = cache.shape[1]
    dev = powers.device
    p, pni = base.p_d.to(dev), base.pni_d.to(dev)
    acc = torch.zeros((B, C, 2, L, N), dtype=I32, device=dev)
    s = torch.zeros((B, C, 2, L, N), dtype=I64, device=dev)
    for j in range(1, D + 1):
        s += powers[:, None, j - 1].to(I64) * cache[:, :, j, None].to(I64)
        if j % DEG_CHUNK == DEG_CHUNK - 1 or j == D:
            acc = add_mod(acc, _redc(s, p, pni), p)
            s.zero_()
    return acc
