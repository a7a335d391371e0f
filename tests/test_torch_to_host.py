"""``core/mod32.py:to_u32``, the response's copy to host memory.

On the CPU it is ``.cpu().numpy().astype(np.uint32)``: memory of its own,
no counter moved.  On a card (``cuda`` tests, skipped without one) it is one
DMA into a pinned block of torch's host cache, returned as a uint32 view for
int32: bit for bit the old path's at the cells' response shapes, on a
strided view and on int64; a kept result unchanged by later calls and by
its source's overwrite and release; dropped results reusing the block
(``to_host.grown`` still) while ``to_host.pinned`` counts every call; and a
graphed ``Receiver.run_query`` response on a small PS set through it.  (No
JAX here: the card tests compare with the old path in plain PyTorch.)"""

import numpy as np
import pytest
import torch

from apsu_tpu_torch.api.parties import Receiver, Sender
from apsu_tpu_torch.core.mod32 import to_u32
from apsu_tpu_torch.core.params import PSUParams
from apsu_tpu_torch.db.receiver_db import ReceiverDB
from apsu_tpu_torch.engine import programs
from apsu_tpu_torch.mpc.oprf import DebugOprf
from apsu_tpu_torch.utils.stopwatch import GLOBAL

COUNTERS = ("to_host.pinned", "to_host.grown")
# the responses of 16M-4096, 1M-2048-cmp and 1M-2048-com: [B, C, 2, Lr, N]
CELL_SHAPES = [(4, 6, 2, 2, 8192), (5, 15, 2, 2, 4096), (5, 9, 2, 2, 4096)]
PS = {  # tests/test_torch_programs.py's small PS set
    "table_params": {"hash_func_count": 2, "table_size": 64, "max_items_per_bin": 16},
    "item_params": {"felts_per_item": 4},
    "query_params": {"ps_low_degree": 3, "query_powers": [1, 2, 3, 4, 8]},
    "seal_params": {"plain_modulus": 65537, "poly_modulus_degree": 256,
                    "coeff_modulus_bits": [48, 48, 48, 28]},
}


def _counts():
    c = GLOBAL.counts()
    return {k: c.get(k, 0) for k in COUNTERS}


def _old(x):
    return x.detach().cpu().numpy().astype(np.uint32)


def _same(got, want, c_contiguous=True):
    assert got.dtype == np.uint32 and got.flags.c_contiguous >= c_contiguous
    assert got.shape == want.shape and np.array_equal(got, want)


def _words(shape, dtype=torch.int32, device="cpu", seed=0):
    """Every bit pattern of ``dtype`` likely: negatives stand for words
    at or above 2^31."""
    g = torch.Generator().manual_seed(seed)
    lo, hi = (-2**31, 2**31) if dtype == torch.int32 else (-2**40, 2**40)
    return torch.randint(lo, hi, shape, generator=g, dtype=dtype).to(device)


@pytest.mark.parametrize("dtype", [torch.int32, torch.int64])
def test_cpu_path_returns_the_old_copy(dtype):
    """A CPU tensor, whole and as a strided view, gives what it gave
    before, in memory the tensor does not share; no counter moves."""
    before = _counts()
    x = _words((3, 5, 7), dtype)
    for src in (x, x.transpose(0, 2)):
        want = src.numpy().astype(np.uint32)
        got = to_u32(src)
        _same(got, want, c_contiguous=False)   # astype keeps a view's order
        src.fill_(7)
        assert np.array_equal(got, want), "the result aliases the tensor"
    assert _counts() == before


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CELL_SHAPES)
def test_card_path_equals_the_old_path(shape):
    """At each cell's response shape, on a strided view and on int64: the
    old path's values, uint32 and C-contiguous."""
    _need_cuda()
    x = _words(shape, device="cuda")
    for src in (x, x.transpose(2, 3), x[:, ::2], _words(shape, torch.int64, "cuda", 1)):
        _same(to_u32(src), _old(src))


@pytest.mark.cuda
def test_card_result_outlives_its_source_and_later_calls():
    """A kept result holds its block: 8 more calls of the shape, and its
    source overwritten and freed, leave it as it was."""
    _need_cuda()
    shape = CELL_SHAPES[1]
    x = _words(shape, device="cuda")
    kept, want = to_u32(x), _old(x)
    for i in range(8):
        to_u32(_words(shape, device="cuda", seed=i + 1))
    x.fill_(-1)
    del x
    torch.cuda.empty_cache()
    _words(shape, device="cuda", seed=99).neg_()
    torch.cuda.synchronize()
    _same(kept, want)


@pytest.mark.cuda
def test_dropped_results_reuse_the_block():
    """With each result dropped, the first call may grow the cache and no
    later call does; every call counts as pinned."""
    _need_cuda()
    x = _words(CELL_SHAPES[0], device="cuda")
    to_u32(x)
    before = _counts()
    for _ in range(16):
        to_u32(x)
    after = _counts()
    assert after["to_host.grown"] == before["to_host.grown"]
    assert after["to_host.pinned"] == before["to_host.pinned"] + 16


@pytest.mark.cuda
def test_graphed_response_through_the_card_path():
    """A small PS set's query on the card, replayed from its programs:
    ``to_u32`` of the response equals the old path's, and equals the eager
    query's under the same mask seed."""
    _need_cuda()
    pp = PSUParams.from_dict(PS)
    rng = np.random.default_rng(1)
    items = rng.integers(0, 1 << 64, size=(400, 2), dtype=np.uint64)
    query = np.concatenate([rng.integers(0, 1 << 64, size=(18, 2), dtype=np.uint64),
                            items[:12]])
    db = ReceiverDB(pp, DebugOprf(), device="cuda")
    db.set_data(items)
    req = Sender(pp, DebugOprf(), rng=np.random.default_rng(21), device="cpu").create_query(query)

    def run(seed):
        return Receiver(pp, db, rng=np.random.default_rng(seed)).run_query(req).results

    run(5)   # captures the programs
    before = _counts()
    graphed = run(9)
    got = to_u32(graphed)
    assert _counts()["to_host.pinned"] == before["to_host.pinned"] + 1
    _same(got, _old(graphed))
    with programs.eager():
        _same(got, _old(run(9)))
