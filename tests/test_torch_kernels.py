"""The hand-written CUDA kernels against their plain PyTorch versions (on the
card; these skip without one), and the wrappers' refusal to run a kernel
anywhere else.  On a GPU host without JAX:

    python -m pytest tests/test_torch_kernels.py --noconftest -q
"""

import functools
import glob

import numpy as np
import pytest
import torch

from apsu_tpu_torch.core.bfv import BfvContext, Ciphertext
from apsu_tpu_torch.core.nt import gen_ntt_primes
from apsu_tpu_torch.core.ntt import NttContext
from apsu_tpu_torch.core.params import PSUParams
from apsu_tpu_torch.core.rns import ExactLiftConv, RnsBase, ScaleDown
from apsu_tpu_torch.device import canonical
from apsu_tpu_torch.ops import ntt as ntt_op
from apsu_tpu_torch.ops import behz, ctr_mod, polyeval, roofline


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _residues(shape, primes, device, seed, fill=None):
    rng = np.random.default_rng(seed)
    p = np.array(primes, np.int64).reshape(-1, 1)
    x = rng.integers(0, 1 << 30, size=shape, dtype=np.int64) % p
    if fill == "p-1":
        x = np.broadcast_to(p - 1, shape).copy()
    return torch.from_numpy(x.astype(np.int32)).to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("n,bits", [(1024, [30]), (4096, [30, 22]), (8192, [28, 28, 27, 22])])
def test_ntt_kernel_matches_plain(n, bits):
    _need_cuda()
    primes = gen_ntt_primes(bits, 2 * n)
    tb = NttContext(primes, n, "cuda")
    for fill in (None, "p-1"):
        x = _residues((3, len(primes), n), primes, "cuda", seed=n, fill=fill)
        for inverse in (False, True):
            assert torch.equal(ntt_op.ntt_cuda(x, tb, inverse), ntt_op.ntt_plain(x, tb, inverse))
        assert torch.equal(ntt_op.ntt_cuda(ntt_op.ntt_cuda(x, tb), tb, True), x)


@pytest.mark.cuda
@pytest.mark.parametrize("logn", range(1, 14))
def test_ntt_kernel_every_size_at_30_bits(logn):
    """Every N the kernel takes, on a 30-bit prime (4p just below 2^32)."""
    _need_cuda()
    n = 1 << logn
    primes = gen_ntt_primes([30], 2 * max(n, 64))
    tb = NttContext(primes, n, "cuda")
    for fill in (None, "p-1"):
        x = _residues((5, 1, n), primes, "cuda", seed=logn, fill=fill)
        for inverse in (False, True):
            assert torch.equal(ntt_op.ntt_cuda(x, tb, inverse), ntt_op.ntt_plain(x, tb, inverse))
        assert torch.equal(ntt_op.ntt_cuda(ntt_op.ntt_cuda(x, tb), tb, True), x)


@pytest.mark.cuda
@pytest.mark.parametrize("n,lead,bits", [
    (256, (5,), [30, 29, 28]),      # 15 rows; small rows share a block
    (1024, (3,), [30, 29]),         # 6 rows
    (64, (7, 3), [29, 28]),         # 42 rows of N=64
    (8192, (3, 1), [30, 29, 28]),   # 9 rows
])
def test_ntt_kernel_ragged_row_counts(n, lead, bits):
    """Row counts that do not fill the kernel's last block of a limb."""
    _need_cuda()
    primes = gen_ntt_primes(bits, 2 * max(n, 64))
    tb = NttContext(primes, n, "cuda")
    x = _residues(lead + (len(primes), n), primes, "cuda", seed=n)
    for inverse in (False, True):
        assert torch.equal(ntt_op.ntt_cuda(x, tb, inverse), ntt_op.ntt_plain(x, tb, inverse))


@pytest.mark.cuda
@pytest.mark.parametrize("bits,ph,nseg,C,fill", [
    ([30, 30], 6, 5, 3, None),        # 30-bit primes
    ([30, 29], 6, 3, 2, "p-1"),       # every product at its largest
    ([28, 28], 311, 2, 1, None),      # ph - 1 > 256 at narrow primes
    ([30, 30], 311, 1, 2, "p-1"),     # 256M-1's ph at the widest primes
])
def test_ps_inner_kernel_wide(bits, ph, nseg, C, fill):
    _need_cuda()
    primes = gen_ntt_primes(bits, 64)
    B, L, N = 2, len(primes), 256
    base = RnsBase(primes, N, "cuda")
    low = _residues((B, ph - 1, 2, L, N), primes, "cuda", seed=ph, fill=fill)
    big = _residues((B * C, nseg * ph + 3, L, N), primes, "cuda", seed=nseg, fill=fill)
    view = big[:, : nseg * ph].reshape(B * C, nseg, ph, L, N)
    got = polyeval.ps_inner_cuda(low, view, base, C)
    assert torch.equal(got, polyeval.ps_inner_plain(low, view, base, C))


@pytest.mark.cuda
@pytest.mark.parametrize("ph,nseg,C,fill", [(4, 14, 1, None), (45, 3, 2, None), (45, 2, 3, "p-1")])
def test_ps_inner_kernel_matches_plain(ph, nseg, C, fill):
    _need_cuda()
    primes = gen_ntt_primes([27, 27, 26], 64)
    B, L, N = 2, len(primes), 256
    base = RnsBase(primes, N, "cuda")
    low = _residues((B, ph - 1, 2, L, N), primes, "cuda", seed=ph, fill=fill)
    big = _residues((B * C, nseg * ph + 5, L, N), primes, "cuda", seed=nseg, fill=fill)
    view = big[:, : nseg * ph].reshape(B * C, nseg, ph, L, N)
    got = polyeval.ps_inner_cuda(low, view, base, C)
    assert torch.equal(got, polyeval.ps_inner_plain(low, view, base, C))


@pytest.mark.cuda
@pytest.mark.parametrize("bits,N,ph,nseg,C,extra,fill", [
    ([30, 29], 256, 6, 7, 3, 5, None),          # C*nseg = 21 rows
    ([28, 27], 256, 4, 19, 7, 2, None),         # 133 rows: chunks of 3 rows, the last of 1
    ([30], 64, 6, 5, 2, 3, None),               # N below one lane tile; row stride 33*64
    ([29, 28], 4096, 45, 3, 2, 1, None),        # N = 4096
    ([28, 28, 27], 8192, 6, 4, 3, 2, "p-1"),    # N = 8192, every product at its largest
    ([30, 30], 256, 2, 9, 2, 1, "p-1"),         # ph = 2: one product a sum
    ([30], 256, 1, 3, 2, 1, None),              # ph = 1: empty sums
    ([30, 30], 4096, 311, 3, 3, 2, None),       # low planes in chunks, rows 3 a block
    ([30, 29], 128, 311, 1, 2, 0, "p-1"),       # chunked at the largest products
    ([30], 512, 66, 2, 2, 1, "p-1"),            # ph - 1 = 65: a last chunk of one plane
])
def test_ps_inner_kernel_tiling_edges(bits, N, ph, nseg, C, extra, fill):
    """The kernel's lane tiles, row chunks, stage groups and low-plane chunks
    at their edges, on strided views of a larger cache, bit for bit."""
    _need_cuda()
    primes = gen_ntt_primes(bits, 2 * N)
    B, L = 2, len(primes)
    base = RnsBase(primes, N, "cuda")
    low = _residues((B, ph - 1, 2, L, N), primes, "cuda", seed=ph + N, fill=fill)
    big = _residues((B * C, nseg * ph + extra, L, N), primes, "cuda", seed=nseg + C, fill=fill)
    view = big[:, : nseg * ph].reshape(B * C, nseg, ph, L, N)
    got = polyeval.ps_inner_cuda(low, view, base, C)
    assert torch.equal(got, polyeval.ps_inner_plain(low, view, base, C))


@pytest.mark.cuda
@pytest.mark.parametrize("R,C,nseg,ph,L,N", [
    (45, 9, 21, 6, 3, 4096),        # 1M-2048-com's warm query
    (24, 6, 29, 45, 4, 8192),       # the 16M-4096 main path
    (2, 2, 2, 311, 6, 8192),        # ph=311: the low planes in chunks
    (6, 3, 3, 311, 2, 4096),
])
def test_ps_inner_plan_covers_every_row(R, C, nseg, ph, L, N):
    """The launch shape: its row chunks cover a bundle's C*nseg rows, a
    chunked block keeps at most 8 rows, and the shared memory fits a block."""
    import ctypes

    from apsu_tpu_torch.ops import _build

    _need_cuda()
    shape = (ctypes.c_int * 6)()
    assert _build.lib().apsu_ps_inner_plan(R, C, nseg, ph, L, N, shape) == 0
    lanes, rows, chunks, occ, smem, chunked = shape
    assert lanes == 128 and occ >= 1 and smem <= 232448
    assert chunked == (ph - 1 > 64)
    assert (chunks - 1) * rows < C * nseg <= chunks * rows
    assert not chunked or rows <= 8


@pytest.mark.cuda
def test_ps_inner_cuda_refuses_unaligned_cache():
    """The bulk copies need 16-byte aligned rows: a view one element off is
    refused, not read wrong."""
    _need_cuda()
    primes = gen_ntt_primes([28], 512)
    base = RnsBase(primes, 256, "cuda")
    low = _residues((1, 3, 2, 1, 256), primes, "cuda", seed=1)
    flat = _residues((1, 2 * 4 * 256 + 1), primes, "cuda", seed=2)[0]
    cache5 = flat[1:].reshape(2, 1, 4, 1, 256)
    with pytest.raises(ValueError, match="aligned"):
        polyeval.ps_inner_cuda(low, cache5, base, 2)


@pytest.mark.cuda
@pytest.mark.parametrize("bits,B,C,D,Dp,fill,N", [
    ([28, 27], 2, 15, 72, 80, None, 512),      # the 1M-2048-cmp evaluation shape, cut in N
    ([28, 27], 1, 3, 72, 80, "p-1", 512),      # C not a multiple of the cache block
    ([30, 30], 2, 6, 13, 16, "p-1", 512),      # the widest primes
    ([29], 1, 5, 519, 520, None, 512),         # Dp > 256 at 29 bits
    ([27], 3, 1, 1, 8, None, 512),             # one power
    ([28, 27], 5, 15, 72, 80, None, 4096),     # the 1M-2048-cmp shape: 64-lane tiles
    ([30, 30], 1, 1, 1, 8, "p-1", 4096),       # B=1, C=1, D=1
    ([30, 30], 1, 15, 1, 8, "p-1", 4096),      # D=1 under 15 caches: partials above a stage
    ([28, 27], 1, 15, 3, 8, None, 4096),       # one plane a range under 15 caches
    ([29], 1, 1, 519, 520, "p-1", 1024),       # C=1, D=519: the plane axis split
    ([28, 27], 2, 37, 20, 24, None, 256),      # more caches than a block sums: 3 chunks
    ([30], 1, 2, 101, 104, "p-1", 512),        # plane ranges that do not divide D
    ([28, 27], 3, 4, 13, 16, None, 64),        # N=64, below the lane tile
    ([27, 26, 25], 1, 3, 40, 48, None, 192),   # a tile and a half of lanes
])
def test_eval_dot_kernel_matches_plain(bits, B, C, D, Dp, fill, N):
    _need_cuda()
    primes = gen_ntt_primes(bits, 2 * N)
    L = len(primes)
    base = RnsBase(primes, N, "cuda")
    powers = _residues((B, D, 2, L, N), primes, "cuda", seed=D, fill=fill)
    cache = _residues((B, C, Dp, L, N), primes, "cuda", seed=Dp + C, fill=fill)
    got = polyeval.eval_dot_cuda(powers, cache, base)
    assert torch.equal(got, polyeval.eval_dot_plain(powers, cache, base))
    # plane 0 and the padding planes are never read
    cache[:, :, 0] = 7
    cache[:, :, D + 1:] = 11
    assert torch.equal(polyeval.eval_dot_cuda(powers, cache, base), got)


@pytest.mark.cuda
@pytest.mark.parametrize("B,C,D,L,N", [
    (5, 15, 72, 2, 4096),     # 1M-2048-cmp
    (1, 5, 228, 4, 8192),     # labeled 1M-1-32
    (1, 15, 72, 2, 4096),     # a 5-shard 1M-2048-cmp shard
    (1, 3, 519, 2, 4096),     # 520 planes
    (1, 10, 512, 3, 4096),    # 1M-256-288
])
def test_eval_dot_plan_keeps_its_clusters_resident(B, C, D, L, N):
    """The card's plan for K3's path shapes: at least two blocks an SM, and
    every cluster resident at once by the card's own count."""
    import ctypes

    from apsu_tpu_torch.ops import _build

    _need_cuda()
    plan = polyeval.card_dot_plan(0, B, C, D, L, N)
    held = ctypes.c_int(0)
    fields = (ctypes.c_int * 8)(*plan.kernel_fields())
    _build.check(_build.lib().apsu_eval_dot_clusters(B, C, D, D + 1, L, N, fields,
                                                     ctypes.byref(held)), "occupancy")
    blocks = plan.grid[0] * plan.grid[1] * plan.grid[2]
    assert blocks >= 2 * torch.cuda.get_device_properties(0).multi_processor_count
    assert blocks // plan.split <= held.value


@pytest.mark.cuda
@pytest.mark.parametrize("op", roofline.OPS)
@pytest.mark.parametrize("n,outer", [(8 * 512 * 128, 2), (4 * 129 + 3, 3), (1, 1), (5, 2),
                                     (4 * 256 + 1, 1), (4 * 1023 + 2, 2)])
def test_vpu_loop_kernel_matches_plain(op, n, outer):
    """Every arm at the tool's block, counts that leave the last threads'
    chains or the last block ragged, and one element; inputs span the full
    u32 range."""
    _need_cuda()
    rng = np.random.default_rng(n)
    x = torch.from_numpy(rng.integers(0, 1 << 32, n, np.uint64).astype(np.uint32).view(np.int32))
    x = x.to("cuda")
    assert torch.equal(roofline.vpu_loop_cuda(x, op, outer), roofline.vpu_loop_plain(x, op, outer))


# K10's ragged lengths: around a vector, the small launch's 4096-element tile,
# the switch to the large launch's shape at 2^23 elements, and 1 GiB
@pytest.mark.cuda
@pytest.mark.parametrize("n", [64 * 7 * 8192, 4097, 3, 1, 4, 5, 4095, 4096, (1 << 23) - 1,
                               1 << 23, (1 << 23) + 4, (1 << 23) + 5, 1 << 28])
def test_add_one_kernel_matches_plain(n):
    _need_cuda()
    rng = np.random.default_rng(n)
    x = rng.integers(0, 1 << 32, n, np.uint64).astype(np.uint32)
    x[: min(n, 5)] = 0xFFFFFFFF   # wraps to 0
    xt = torch.from_numpy(x.view(np.int32)).to("cuda")
    assert torch.equal(roofline.add_one_cuda(xt), roofline.add_one_plain(xt))
    out = torch.empty_like(xt)
    assert roofline.add_one_cuda(xt, out) is out and torch.equal(out, roofline.add_one_plain(xt))
    if n > 1:
        with pytest.raises(ValueError, match="aligned"):
            roofline.add_one_cuda(torch.empty(n + 1, dtype=torch.int32, device="cuda")[1:])


@pytest.mark.cuda
def test_graph_ms_counts_replayed_launches():
    """A launch captured into a CUDA graph counts once at each replay, not at
    the capture."""
    _need_cuda()
    from apsu_tpu_torch.tools import graph_ms

    x = torch.zeros(4096, dtype=torch.int32, device="cuda")
    roofline.add_launches = 0
    graph_ms(lambda: roofline.add_one_cuda(x), reps=7)
    assert roofline.add_launches == 2 + 2 * 7   # two eager calls, two replays of 7


@pytest.mark.cuda
def test_launch_reads_the_current_stream_raw():
    """``_build.stream_ptr`` (the raw stream every launch takes) is
    ``torch.cuda.current_stream().cuda_stream`` on the default stream, on a
    side stream and under graph capture, and a captured launch counts no
    launch until its replay; the launch path's other two ``torch._C``
    reads agree with ``torch.cuda``'s."""
    _need_cuda()
    from apsu_tpu_torch.ops import _build

    x = torch.zeros(4096, dtype=torch.int32, device="cuda")
    out = torch.empty_like(x)
    assert torch._C._cuda_getDevice() == torch.cuda.current_device() == x.get_device()
    assert torch._C._cuda_isCurrentStreamCapturing() is False
    assert _build.stream_ptr(x.device) == torch.cuda.current_stream().cuda_stream
    side = torch.cuda.Stream()
    with torch.cuda.stream(side):
        assert _build.stream_ptr(x.device) == torch.cuda.current_stream().cuda_stream
        assert _build.stream_ptr("cuda") == side.cuda_stream
        roofline.add_one_cuda(x, out)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    roofline.add_launches = 0
    with torch.cuda.graph(graph):
        captured = (_build.stream_ptr(x.device), torch.cuda.current_stream().cuda_stream)
        capturing = torch._C._cuda_isCurrentStreamCapturing()
        roofline.add_one_cuda(x, out)
    assert captured[0] == captured[1] != torch.cuda.default_stream().cuda_stream
    assert capturing is True and roofline.add_launches == 0
    x.fill_(41)
    graph.replay()
    torch.cuda.synchronize()
    assert (out == 42).all()


@pytest.mark.cuda
def test_launch_goes_to_the_tensors_card_with_another_current():
    """A kernel on cuda:1's tensors while cuda:0 is current runs on cuda:1
    and leaves cuda:0 current."""
    _need_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    x = torch.arange(-5, 4091, dtype=torch.int32, device="cuda:1")
    with torch.cuda.device(0):
        got = roofline.add_one_cuda(x)
        looped = roofline.vpu_loop_cuda(x, "mont_mul", 2)
        assert torch.cuda.current_device() == 0
    assert got.device == x.device and torch.equal(got, roofline.add_one_plain(x))
    assert torch.equal(looped, roofline.vpu_loop_plain(x, "mont_mul", 2))


SHARD_SETS = {  # tests/test_sharded.py's PS and power-DAG sets
    "ps": {"table_params": {"hash_func_count": 3, "table_size": 96, "max_items_per_bin": 28},
           "item_params": {"felts_per_item": 4},
           "query_params": {"ps_low_degree": 4, "query_powers": [1, 2, 3, 4, 5, 10, 25]},
           "seal_params": {"plain_modulus": 65537, "poly_modulus_degree": 256,
                           "coeff_modulus_bits": [48, 48, 48, 48, 48, 30]}},
    "dag": {"table_params": {"hash_func_count": 2, "table_size": 128, "max_items_per_bin": 16},
            "item_params": {"felts_per_item": 4},
            "query_params": {"ps_low_degree": 0, "query_powers": [1, 2, 5, 8, 11, 14, 15, 16]},
            "seal_params": {"plain_modulus": 65537, "poly_modulus_degree": 256,
                            "coeff_modulus_bits": [48, 48, 48, 28]}},
}


def _sharded_against_direct(name, devices):
    """The direct query on cuda:0 and ``ShardedReceiver`` over ``devices``
    (None: every visible card) on one DB and request under one mask seed.
    Returns (direct response, sharded receiver, sharded response, launches of
    the evaluation's kernel during the sharded query)."""
    from apsu_tpu_torch.api.parties import Receiver, Sender
    from apsu_tpu_torch.db.receiver_db import ReceiverDB
    from apsu_tpu_torch.mpc.oprf import DebugOprf
    from apsu_tpu_torch.mpc.prg import CsRng
    from apsu_tpu_torch.parallel.mesh import make_mesh
    from apsu_tpu_torch.parallel.runtime import ShardedReceiver

    params = PSUParams.from_dict(SHARD_SETS[name])
    rng = np.random.default_rng(6)
    db_items = rng.integers(0, 1 << 64, size=(800, 2), dtype=np.uint64)
    query = np.concatenate([db_items[:15], rng.integers(0, 1 << 64, size=(21, 2), dtype=np.uint64)])
    db = ReceiverDB(params, DebugOprf(), device="cuda")
    db.set_data(db_items)
    req = Sender(params, DebugOprf(), rng=np.random.default_rng(1), device="cuda").create_query(query)
    want = Receiver(params, db, rng=CsRng(b"sharded-card-receiver-k1")).run_query(req)
    shard = ShardedReceiver(params, db, make_mesh(devices=devices),
                            rng=CsRng(b"sharded-card-receiver-k1"))
    counter = "launches" if name == "ps" else "dot_launches"
    before = getattr(polyeval, counter)
    got = shard.run_query(req)
    torch.cuda.synchronize()
    return want, shard, got, getattr(polyeval, counter) - before


@pytest.mark.cuda
def test_sharded_receiver_on_one_card_matches_direct():
    """A 3-shard mesh on cuda:0 (tests/test_sharded.py's PS set) answers bit
    for bit as the direct query, each shard's rows through one launch of the
    PS inner-sum kernel."""
    _need_cuda()
    want, shard, got, launched = _sharded_against_direct("ps", ["cuda:0"] * 3)
    assert [r1 - r0 for r0, r1 in shard.evaluator.ranges] == [2, 1, 1]
    assert launched == 3
    assert got.results.is_cuda and torch.equal(got.results, want.results)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ps", "dag"])
def test_sharded_receiver_across_cards_matches_direct(name):
    """Every visible card a shard (two or more): each shard's cache rows are
    copied to its card once and run there with a context of that card,
    every kernel launched on the card its tensors lie on; the response,
    gathered on cuda:0, equals the direct query's bit for bit."""
    _need_cuda()
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two or more CUDA devices")
    want, shard, got, launched = _sharded_against_direct(name, None)
    busy = [(ctx, cache) for (ctx, cache, _), (r0, r1) in
            zip(shard.evaluator.shards, shard.evaluator.ranges) if r1 > r0]
    assert len({cache.device for _, cache in busy}) == len(busy) > 1
    assert all(canonical(ctx.device) == cache.device for ctx, cache in busy)
    assert launched >= len(busy)
    assert got.results.device == want.results.device
    assert torch.equal(got.results, want.results)


# the mask draw (ops/ctr_mod.py): the kernel against its plain version at
# both cells' mask shapes (16M-4096: [4, 6, 8192], t = 2277377; 1M-2048-cmp:
# [5, 15, 4096], t = 40961), the mask's (0, t) and the labeled path's ρ,
# (1, t - 1), from counters whose blocks carry across 2^32 and 2^64
MASK_CELLS = {"16M-4096": ((4, 6, 8192), 2277377), "1M-2048-cmp": ((5, 15, 4096), 40961)}
MASK_KEY = bytes(range(3, 35))
MASK_LABELED = {  # tests/test_psu_e2e.py:small_params(), with labels
    "table_params": {"hash_func_count": 2, "table_size": 64, "max_items_per_bin": 8},
    "item_params": {"felts_per_item": 4},
    "query_params": {"ps_low_degree": 0, "query_powers": [1, 2, 3, 4, 5, 6, 7, 8]},
    "seal_params": {"plain_modulus": 65537, "poly_modulus_degree": 256,
                    "coeff_modulus_bits": [40, 40, 30]},
}


@pytest.mark.cuda
@pytest.mark.parametrize("cell", list(MASK_CELLS))
@pytest.mark.parametrize("counter", [0, (1 << 32) - 7, (1 << 64) - 7, (3 << 64) + 12345],
                         ids=["zero", "carry32", "carry64", "high"])
@pytest.mark.parametrize("offset", [0, 8])
def test_ctr_mod_kernel_matches_plain(cell, counter, offset):
    _need_cuda()
    shape, t = MASK_CELLS[cell]
    n = int(np.prod(shape))
    for lo, span in ((0, t), (1, t - 1)):
        got = ctr_mod.ctr_mod(MASK_KEY, counter, offset, lo, span, shape, "cuda")
        assert got.shape == shape and got.dtype == torch.int32
        want = ctr_mod.ctr_mod_plain(MASK_KEY, counter, offset, lo, span, n)
        assert np.array_equal(got.cpu().numpy().ravel(), want)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 511, 1000, 600_001])
def test_ctr_mod_kernel_every_offset(n):
    """Every byte offset into the first block, word counts that leave a
    block's last step ragged and one past the grid's bound (steps looped
    inside the blocks), ranges that wrap int32 arithmetic."""
    _need_cuda()
    for offset in range(16):
        for lo, span in ((0, (1 << 31) - 1), (-(1 << 31), (1 << 32) - 1), (-7, 1)):
            got = ctr_mod.ctr_mod(MASK_KEY, (1 << 64) - 100, offset, lo, span, (n,), "cuda")
            want = ctr_mod.ctr_mod_plain(MASK_KEY, (1 << 64) - 100, offset, lo, span, n)
            assert np.array_equal(got.cpu().numpy(), want), (offset, lo, span)


@pytest.mark.cuda
def test_ctr_mod_kernel_keeps_a_host_copy():
    """A kept draw is one launch whose kernel also stores the words into
    fresh host memory: whole once ``done`` is, and left as it was by later
    kept draws, past the end of a slab of rows; a draw that is not kept
    makes no host copy."""
    _need_cuda()
    ks = ctr_mod.KeyStream(MASK_KEY, "cuda")
    shape, t = MASK_CELLS["1M-2048-cmp"]
    n = int(np.prod(shape))
    launches, kept = ctr_mod.launches, []
    for i in range(ctr_mod.SLAB + 3):
        out, host = ks.draw(7 + 3 * i, 8, 0, t, shape, keep=True)
        ks.done.synchronize()
        assert host.dtype == np.uint32 and host.shape == shape
        assert np.array_equal(host, out.cpu().numpy().view(np.uint32))
        want = ctr_mod.ctr_mod_plain(MASK_KEY, 7 + 3 * i, 8, 0, t, n)
        assert np.array_equal(host.ravel(), want)
        kept.append((host, want))
    assert ks.draw(5, 0, 1, t - 1, shape)[1] is None
    assert ctr_mod.launches - launches == ctr_mod.SLAB + 4
    assert all(np.array_equal(h.ravel(), w) for h, w in kept)


class _HostDraws:
    """A ``CsRng``'s stream behind an object that is no ``CsRng``: a receiver
    given it draws its masks on the host, as a Generator's."""

    def __init__(self, rng):
        self.integers = rng.integers


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["ps", "dag", "labeled"])
def test_receiver_draws_its_mask_on_the_card(name):
    """A ``CsRng`` receiver on the card draws each query's mask with one
    launch of the kernel (``prepare.mask.device`` counts it): its masks, and
    ρ's, are the host draw of the same stream, so its responses equal those
    of a receiver that draws on the host, bit for bit; each ``last_mask``
    is in host memory and stays as it was through the next query."""
    from apsu_tpu_torch.api.parties import Receiver, Sender
    from apsu_tpu_torch.db.receiver_db import ReceiverDB
    from apsu_tpu_torch.mpc.oprf import DebugOprf
    from apsu_tpu_torch.mpc.prg import CsRng
    from apsu_tpu_torch.utils.stopwatch import GLOBAL

    _need_cuda()
    params = PSUParams.from_dict(MASK_LABELED if name == "labeled" else SHARD_SETS[name])
    rng = np.random.default_rng(8)
    items = rng.integers(0, 1 << 64, size=(250, 2), dtype=np.uint64)
    labels = None
    if name == "labeled":
        labels = rng.integers(0, 256, size=(250, 16), dtype=np.uint8)
        labels[:, params.item_bit_count // 8:] = 0
    db = ReceiverDB(params, DebugOprf(), device="cuda")
    db.set_data(items, labels=labels)
    snd = Sender(params, DebugOprf(), rng=np.random.default_rng(2), device="cuda")
    reqs = [snd.create_query(items[:16]), snd.create_query(items[16:28])]
    key = b"card-mask-receiver-key-32-bytes!"
    card = Receiver(params, db, rng=CsRng(key))
    host = Receiver(params, db, rng=_HostDraws(CsRng(key)))
    launches, drawn = ctr_mod.launches, GLOBAL.counts().get("prepare.mask.device", 0)
    kept = []
    for req in reqs * 2:
        got, want = card.run_query(req), host.run_query(req)
        mask = card.last_mask
        assert mask.dtype == np.uint32 and np.array_equal(mask, host.last_mask)
        kept.append((mask, mask.copy()))
        assert got.results.is_cuda and torch.equal(got.results, want.results)
        if name == "labeled":
            assert torch.equal(got.label_results, want.label_results)
    assert all(np.array_equal(m, c) for m, c in kept)
    per_query = 2 if name == "labeled" else 1   # ρ too
    assert ctr_mod.launches - launches == 4 * per_query
    assert GLOBAL.counts()["prepare.mask.device"] - drawn == 4


# the glue kernels G1-G4 (ops/behz.py): a parameter set's contexts on the
# card, each kernel against its plain version on the same CUDA tensors; every
# level and the widened Bsk of a multiply-sum, residues random, all p - 1 and
# all 0; "ps" is SHARD_SETS' (9 q limbs, 12 Bsk limbs: the kernels' largest)
GLUE_SETS = ["256K-2048-com", "1M-2048-cmp", "16M-4096", "256M-1", "ps"]
FILLS = [None, "p-1", "zero"]


def _glue_ctx(name):
    _need_cuda()
    params = (PSUParams.from_dict(SHARD_SETS[name]) if name in SHARD_SETS
              else PSUParams.load_file(f"parameters/{name}.json"))
    return BfvContext(params.seal_params, "cuda")


def _glue_residues(shape, primes, seed, fill):
    x = _residues(shape, primes, "cuda", seed, fill=None if fill == "zero" else fill)
    return torch.zeros_like(x) if fill == "zero" else x


# a stand-in for every (q limbs, Bsk limbs) pair that G3 and the lift are
# built for exactly (ops/behz.py:exact_pairs)
EXACT = "every exact pair"


@functools.lru_cache(maxsize=None)
def _exact_pair_primes():
    """For each exact pair, (q primes, Bsk primes, t, N) of the first
    parameter file that reaches it (at a level, with the multiply's Bsk or a
    multiply-sum's widened one)."""
    found = {}
    for f in sorted(glob.glob("parameters/*.json")):
        host = BfvContext(PSUParams.load_file(f).seal_params, "cpu")
        for lvl in range(1, host.q.k + 1):
            for extra in range(7):
                bsk = host._mul_ctx(lvl, extra)["bsk"]
                found.setdefault((lvl, bsk.k), (host.q_primes[:lvl], bsk.primes, host.t, host.n))
    assert set(found) == behz.exact_pairs()
    return tuple(found.values())


def _exact_pair_bases():
    """For each exact pair, (q, Bsk, t) on the card."""
    _need_cuda()
    return [(RnsBase(qs, n, "cuda"), RnsBase(bs, n, "cuda"), t)
            for qs, bs, t, n in _exact_pair_primes()]


def _general_launches():
    return behz.lift_general_launches, behz.scaledown_general_launches


@pytest.mark.cuda
@pytest.mark.parametrize("name", GLUE_SETS + [EXACT])
@pytest.mark.parametrize("fill", FILLS)
def test_behz_lift_kernel_matches_plain(name, fill):
    """G1 in its three modes: the lift (both forms, and the Bsk form alone,
    from strided views: one run of rows, two read in place, three copied),
    to_mont / from_mont of every base, the digits.  The lift also on every
    exact build, and on the general build only for "ps" (9 q limbs)."""
    if name == EXACT:
        before = _general_launches()
        for q, bsk, _ in _exact_pair_bases():
            lift = ExactLiftConv(q, bsk)
            x = _glue_residues((2, 3, 3, q.k, q.n), q.primes, q.k, fill)
            for v in (x, x[:, 1:]):
                for want_q in (True, False):
                    got, want = behz.lift_cuda(v, lift, want_q), behz.lift_plain(v, lift, want_q)
                    assert torch.equal(got[1], want[1])
                    assert (got[0] is None) == (not want_q)
                    if want_q:
                        assert torch.equal(got[0], want[0])
        assert _general_launches() == before
        return
    bfv = _glue_ctx(name)
    general = behz.lift_general_launches
    for lvl in range(2, bfv.q.k + 1):
        for extra in (0, 5):
            mc = bfv._mul_ctx(lvl, extra)
            q, bsk = bfv.levels[lvl], mc["bsk"]
            full = _glue_residues((2, 3, 3, q.k, q.n), q.primes, lvl, fill)
            for x in (full, full[:, :, 2], full[:, 1:], full[:, ::2, 1:]):
                for want_q in (True, False):
                    got = behz.lift_cuda(x, mc["lift"], want_q)
                    want = behz.lift_plain(x, mc["lift"], want_q)
                    assert torch.equal(got[1], want[1])
                    assert (got[0] is None) == (not want_q)
                    if want_q:
                        assert torch.equal(got[0], want[0])
            for base in (q, bsk):
                y = _glue_residues((3, base.k, base.n), base.primes, base.k, fill)
                for inverse in (False, True):
                    assert torch.equal(behz.scale_cuda(y, base, inverse),
                                       behz.scale_plain(y, base, inverse))
        if bfv.special is not None:
            qp = bfv._qp_level(lvl)
            c2 = _glue_residues((3, 3, lvl, bfv.n), bfv.q_primes[:lvl], lvl, fill)[:, 2]
            assert torch.equal(behz.digits_cuda(c2, qp, lvl), behz.digits_plain(c2, qp, lvl))
    assert (behz.lift_general_launches > general) == (name == "ps")


@pytest.mark.cuda
@pytest.mark.parametrize("name", GLUE_SETS)
@pytest.mark.parametrize("fill", FILLS)
def test_mont_mac_kernel_matches_plain(name, fill):
    """G2's tensor mode at one term (the power wavefront) and at M = 1 and
    11 with the rhs broadcast over a bundle's caches (the PS outer sum), in
    q and in the widened Bsk; its key-switch mode at every level below and
    at the key's.  Term axes that differ, neither of them 1, are refused."""
    bfv = _glue_ctx(name)
    lvl = bfv.q.k
    for M in (1, 11):
        mc = bfv._mul_ctx(lvl, max(1, (M - 1).bit_length()))
        for base in (bfv.levels[lvl], mc["bsk"]):
            a = _glue_residues((2, 3, M, 2, base.k, base.n), base.primes, M, fill)
            b = _glue_residues((2, 1, M, 2, base.k, base.n), base.primes, M + 1, fill)
            for fa, fb in ((a, b), (a[:, 1], b[:, 0]), (a[0, :, :1], b[0, 0, :1][None]),
                           (a[:, :, 0][..., None, :, :, :], a[:, :, -1][..., None, :, :, :])):
                assert torch.equal(behz.mont_mac_cuda(fa, fb, base),
                                   behz.mont_mac_plain(fa, fb, base))
            if M > 1:
                with pytest.raises(ValueError, match="term axes"):
                    behz.mont_mac_cuda(a[..., :3, :, :, :], b[..., :5, :, :, :], base)
    if bfv.special is None:
        return
    for lvl in range(1, bfv.q.k + 1):
        qp, klvl = bfv._qp_level(lvl), bfv.q.k
        ksk = _glue_residues((klvl, 2, klvl + 1, bfv.n), bfv.q_primes + [bfv.special], 7, fill)
        d = _glue_residues((lvl, 3, lvl + 1, bfv.n), qp.primes, lvl, fill)
        assert torch.equal(behz.keyswitch_mac_cuda(d, ksk, qp, lvl, klvl),
                           behz.keyswitch_mac_plain(d, ksk, qp, lvl, klvl))


@pytest.mark.cuda
@pytest.mark.parametrize("name", GLUE_SETS + [EXACT])
@pytest.mark.parametrize("fill", FILLS)
def test_behz_scaledown_kernel_matches_plain(name, fill):
    """G3 at every level, with the multiply's Bsk and the widened one; on
    every exact build, and on the general build only for "ps" (9 q limbs)."""
    general = behz.scaledown_general_launches
    if name == EXACT:
        cases = [(q, bsk, ScaleDown(q, bsk, t)) for q, bsk, t in _exact_pair_bases()]
    else:
        bfv = _glue_ctx(name)
        cases = [(bfv.levels[lvl], mc["bsk"], mc["scale"]) for lvl in range(1, bfv.q.k + 1)
                 for mc in (bfv._mul_ctx(lvl, 0), bfv._mul_ctx(lvl, 5))]
    for q, bsk, sd in cases:
        x_q = _glue_residues((2, 3, q.k, q.n), q.primes, q.k, fill)
        x_b = _glue_residues((2, 3, bsk.k, q.n), bsk.primes, q.k + 1, fill)
        assert torch.equal(behz.scaledown_cuda(x_q, x_b, sd), behz.scaledown_plain(x_q, x_b, sd))
    assert (behz.scaledown_general_launches > general) == (name == "ps")


@pytest.mark.cuda
@pytest.mark.parametrize("name", GLUE_SETS)
@pytest.mark.parametrize("fill", FILLS)
def test_rns_divround_kernel_matches_plain(name, fill):
    """G4: the mod-switch from every level to every lower one, on a
    contiguous tensor and on a view; the key-switch mod-down at every level,
    with the ciphertext a 3-component view, its rows contiguous or a slice
    of a middle axis."""
    bfv = _glue_ctx(name)
    for top in range(2, bfv.q.k + 1):
        x = _glue_residues((2, 3, top, bfv.n), bfv.q_primes[:top], top, fill)
        for target in range(1, top):
            for v in (x, x[:, 1:]):
                assert torch.equal(behz.mod_switch_cuda(v, bfv.div_drop, top, target),
                                   behz.mod_switch_plain(v, bfv.div_drop, top, target))
    if bfv.special is None:
        return
    for lvl in range(1, bfv.q.k + 1):
        qp, div = bfv._qp_level(lvl), bfv._div_p_level(lvl)
        u = _glue_residues((2, 3, 2, lvl + 1, bfv.n), qp.primes, lvl, fill)
        data = _glue_residues((2, 3, 3, lvl, bfv.n), bfv.q_primes[:lvl], lvl + 1, fill)
        for uv, dv in ((u, data), (u[:, 1:], data[:, 1:])):
            assert torch.equal(behz.keyswitch_div_cuda(uv, dv, qp, div),
                               behz.keyswitch_div_plain(uv, dv, qp, div))


# G5 at the PS cells' constant term: (rows R = bundles x caches, the
# evaluation level's limbs) of each cell's _ps_rows, nh + 1 planes from its
# parameters
SCALE_ADD_CELLS = {"16M-4096": (24, 4), "1M-2048-com": (45, 3)}


def _scale_add_cases(bfv, name):
    """(level, R, P) of the calls to hold G5 at: every level at a small
    shape, and a cell's own [R, nh + 1] at its evaluation level."""
    cases = [(lvl, 2, 3) for lvl in range(1, bfv.q.k + 1)]
    if name in SCALE_ADD_CELLS:
        pp = PSUParams.load_file(f"parameters/{name}.json")
        R, lvl = SCALE_ADD_CELLS[name]
        nh = pp.table_params.max_items_per_bin // (pp.query_params.ps_low_degree + 1)
        cases.append((lvl, R, nh + 1))
    return cases


@pytest.mark.cuda
@pytest.mark.parametrize("name", GLUE_SETS + ["1M-2048-com"])
@pytest.mark.parametrize("fill", FILLS)
def test_scale_add_kernel_matches_plain(name, fill):
    """G5 in its three modes against its plain versions on the same CUDA
    tensors, at every level ("ps": 9 limbs, the MAXQ build) and at the PS
    cells' [R, nh + 1, 2, L, N]: Δ·c alone; added into component 0 of the
    inner sums (a view of one run, and of two when the planes are a slice),
    with the Montgomery form of planes 1..nh and without; the adds into
    acc[:, 1:]'s component 0 (two runs) and tot[:, :2].  Each writes its
    view and nothing else; a view of three runs is refused."""
    bfv = _glue_ctx(name)
    for lvl, R, P in _scale_add_cases(bfv, name):
        ds, primes, n = bfv.delta[lvl], bfv.q_primes[:lvl], bfv.n
        c = torch.randint(0, bfv.t, (R, P + 1, n), dtype=torch.int32, device="cuda",
                          generator=torch.Generator("cuda").manual_seed(lvl))
        if fill:
            c[:, :, : n // 2] = 0 if fill == "zero" else bfv.t - 1
        cs = c[:, 1:]   # [R, P, N], a view of two runs
        assert torch.equal(behz.delta_cuda(cs, ds), behz.delta_plain(cs, ds))
        for lead in (0, 1):   # the planes [R, P] whole, or a slice of [R, P + 1]
            full = _glue_residues((R, P + lead, 2, lvl, n), primes, lvl + lead, fill)
            for skip in (1, None):
                x, want = full.clone(), full.clone()
                before = behz.scale_add_launches
                _, got_m = behz.delta_add_cuda(x[:, lead:, 0], cs, ds, skip)
                _, want_m = behz.delta_add_plain(want[:, lead:, 0], cs, ds, skip)
                assert behz.scale_add_launches == before + 1
                assert torch.equal(x, want)
                assert got_m is None if skip is None else torch.equal(got_m, want_m)
        acc = _glue_residues((R, P, 2, lvl, n), primes, lvl + 2, fill)
        y = _glue_residues((R, P - 1, lvl, n), primes, lvl + 3, fill)
        x, want = acc.clone(), acc.clone()
        behz.add_into_cuda(x[:, 1:, 0], y, ds)
        behz.add_into_plain(want[:, 1:, 0], y, ds)
        assert torch.equal(x, want)
        tot = _glue_residues((R, 3, lvl, n), primes, lvl + 4, fill)
        z, want = tot.clone(), tot.clone()
        behz.add_into_cuda(z[:, :2], acc[:, 0], ds)
        behz.add_into_plain(want[:, :2], acc[:, 0], ds)
        assert torch.equal(z, want)
    three = torch.zeros((2, 3, 4, bfv.q.k, bfv.n), dtype=torch.int32, device="cuda")[:, 1:, 1:]
    with pytest.raises(ValueError, match="in place"):
        behz.add_into_cuda(three, three.clone(), bfv.delta[bfv.q.k])


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["256K-2048-com", "16M-4096"])
def test_glue_on_the_card_matches_the_cpu(name):
    """multiply -> relinearize -> mod_switch_to and multiply_sum on the card
    (G1-G4 between K1's transforms) against the same calls on the CPU (the
    plain versions), bit for bit, and the card launches every glue kernel."""
    _need_cuda()
    sp = PSUParams.load_file(f"parameters/{name}.json").seal_params
    ctxs = {dev: BfvContext(sp, dev) for dev in ("cpu", "cuda")}
    outs = {}
    for dev, bfv in ctxs.items():
        rng = np.random.default_rng(5)
        sk = bfv.gen_secret_key(rng)
        rk = bfv.gen_relin_key(sk, rng)
        slots = np.random.default_rng(6).integers(0, bfv.t, size=(3, 2, bfv.n), dtype=np.uint64)
        ct = bfv.encrypt_symmetric(bfv.encode(slots.astype(np.uint32)), sk, rng)
        before = [behz.lift_launches, behz.mac_launches, behz.scaledown_launches,
                  behz.divround_launches]
        prod = bfv.multiply(Ciphertext(ct.data[0], False, ct.level),
                            Ciphertext(ct.data[1], False, ct.level))
        rel = bfv.relinearize(prod, rk)
        sw = bfv.mod_switch_to(rel, 1)
        msum = bfv.multiply_sum(Ciphertext(ct.data[:2], False, ct.level),
                                Ciphertext(ct.data[1:], False, ct.level))
        after = [behz.lift_launches, behz.mac_launches, behz.scaledown_launches,
                 behz.divround_launches]
        outs[dev] = [t.cpu() for t in (prod.data, rel.data, sw.data, msum.data)]
        if dev == "cuda":
            assert all(a > b for a, b in zip(after, before))
    for got, want in zip(outs["cuda"], outs["cpu"]):
        assert torch.equal(got, want)


def test_kernel_wrappers_refuse_cpu_tensors():
    primes = gen_ntt_primes([28], 2 * 1024)
    tb = NttContext(primes, 1024, "cpu")
    x = _residues((2, 1, 1024), primes, "cpu", seed=0)
    with pytest.raises(ValueError, match="CUDA"):
        ntt_op.ntt_cuda(x, tb)
    low = _residues((1, 3, 2, 1, 1024), primes, "cpu", seed=1)
    cache5 = _residues((1, 2, 4, 1, 1024), primes, "cpu", seed=2)
    with pytest.raises(ValueError, match="CUDA"):
        polyeval.ps_inner_cuda(low, cache5, RnsBase(primes, 1024, "cpu"), 1)
    powers = _residues((1, 3, 2, 1, 1024), primes, "cpu", seed=3)
    cache = _residues((1, 2, 8, 1, 1024), primes, "cpu", seed=4)
    with pytest.raises(ValueError, match="CUDA"):
        polyeval.eval_dot_cuda(powers, cache, RnsBase(primes, 1024, "cpu"))


def test_glue_kernel_wrappers_refuse_cpu_tensors():
    """G1-G5's CUDA wrappers raise on CPU tensors of the right shapes."""
    bfv = BfvContext(PSUParams.load_file("parameters/256K-2048-com.json").seal_params, "cpu")
    lvl = bfv.q.k
    mc = bfv._mul_ctx(lvl)
    q, bsk, qp = bfv.q, mc["bsk"], bfv._qp_level(lvl)
    x = _residues((2, q.k, q.n), q.primes, "cpu", seed=0)
    fa = _residues((2, 1, 2, q.k, q.n), q.primes, "cpu", seed=1)
    cases = [
        lambda: behz.lift_cuda(x, mc["lift"]),
        lambda: behz.scale_cuda(x, q),
        lambda: behz.digits_cuda(x, qp, lvl),
        lambda: behz.mont_mac_cuda(fa, fa, q),
        lambda: behz.keyswitch_mac_cuda(
            _residues((lvl, 2, qp.k, q.n), qp.primes, "cpu", seed=2), bfv.gen_relin_key(
                bfv.gen_secret_key(np.random.default_rng(0)), np.random.default_rng(1)).ksk,
            qp, lvl, lvl),
        lambda: behz.scaledown_cuda(_residues((3, q.k, q.n), q.primes, "cpu", seed=3),
                                    _residues((3, bsk.k, q.n), bsk.primes, "cpu", seed=4),
                                    mc["scale"]),
        lambda: behz.keyswitch_div_cuda(
            _residues((2, 2, qp.k, q.n), qp.primes, "cpu", seed=5),
            _residues((2, 3, q.k, q.n), q.primes, "cpu", seed=6), qp, bfv._div_p_level(lvl)),
        lambda: behz.mod_switch_cuda(x, bfv.div_drop, lvl, 1),
        lambda: behz.delta_cuda(x[:, 0], bfv.delta[lvl]),
        lambda: behz.delta_add_cuda(x.clone(), x[:, 0], bfv.delta[lvl]),
        lambda: behz.add_into_cuda(x.clone(), x, bfv.delta[lvl]),
    ]
    for case in cases:
        with pytest.raises(ValueError, match="CUDA"):
            case()


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    params = PSUParams.load_file("parameters/256K-2048-com.json")
    with pytest.raises(RuntimeError, match="cuda"):
        BfvContext(params.seal_params)  # device="cuda" is the default
    with pytest.raises(RuntimeError, match="cuda"):
        RnsBase([12289], 1024)
    with pytest.raises(RuntimeError, match="cuda"):
        NttContext([12289], 1024)
