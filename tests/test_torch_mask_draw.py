"""The receiver's mask draw (``ops/ctr_mod.py``, ``CsRng.reserve``,
``Receiver._draw``) on the CPU, where the kernel's plain version makes the
words: a reservation anywhere in a ``CsRng``'s stream, among its other
draws, leaves the stream the reference's; a numpy model of the kernel's
arithmetic (its AES tables, the cut at any byte offset, the modulo by a
reciprocal) equals the plain version at counters that carry; a ``CsRng``
receiver's masks are the benchmark's independent rebuild and the reference
receiver's under the same key, ρ and every later draw included; query i's
``last_mask`` survives query i + 1; and a ``numpy.random.Generator``
receiver still draws on the host.  The kernel itself is held against the
plain version on the card (``tests/test_torch_kernels.py``).  (The set
helpers are copied here: a GPU host may have another package named
``tests`` on its path.)"""

import functools
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apsu_tpu.api.parties import QueryRequest as RefRequest
from apsu_tpu.api.parties import Receiver as RefReceiver
from apsu_tpu.core.params import PSUParams as RefParams
from apsu_tpu.db.receiver_db import ReceiverDB as RefDB
from apsu_tpu.mpc.oprf import DebugOprf as RefOprf
from apsu_tpu.mpc.prg import CsRng as RefRng
from apsu_tpu_torch.api.parties import Receiver, Sender
from apsu_tpu_torch.core.mod32 import to_u32
from apsu_tpu_torch.core.params import PSUParams
from apsu_tpu_torch.db.receiver_db import ReceiverDB
from apsu_tpu_torch.engine import programs
from apsu_tpu_torch.mpc.oprf import DebugOprf
from apsu_tpu_torch.mpc.prg import CsRng
from apsu_tpu_torch.ops import ctr_mod

REPO = Path(__file__).resolve().parents[1]
KEY = bytes(range(32))
M32 = np.uint32(0xFFFFFFFF)
PS = {  # tests/test_torch_programs.py's small PS set
    "table_params": {"hash_func_count": 2, "table_size": 64, "max_items_per_bin": 16},
    "item_params": {"felts_per_item": 4},
    "query_params": {"ps_low_degree": 3, "query_powers": [1, 2, 3, 4, 8]},
    "seal_params": {"plain_modulus": 65537, "poly_modulus_degree": 256,
                    "coeff_modulus_bits": [48, 48, 48, 28]},
}
DAG = {  # tests/test_torch_programs.py's one-level-DAG set (no PS)
    "table_params": {"hash_func_count": 3, "table_size": 128, "max_items_per_bin": 16},
    "item_params": {"felts_per_item": 4},
    "query_params": {"ps_low_degree": 0, "query_powers": [1, 2, 5, 8, 11, 14, 15, 16]},
    "seal_params": {"plain_modulus": 65537, "poly_modulus_degree": 256,
                    "coeff_modulus_bits": [48, 48, 48, 28]},
}
SMALL = {  # tests/test_psu_e2e.py:small_params(), labeled here
    "table_params": {"hash_func_count": 2, "table_size": 64, "max_items_per_bin": 8},
    "item_params": {"felts_per_item": 4},
    "query_params": {"ps_low_degree": 0, "query_powers": [1, 2, 3, 4, 5, 6, 7, 8]},
    "seal_params": {"plain_modulus": 65537, "poly_modulus_degree": 256,
                    "coeff_modulus_bits": [40, 40, 30]},
}


def _u32(x):
    return np.asarray(jax.device_get(x))


# ---------------------------------------------------------------------------
# CsRng.reserve among the other draws
# ---------------------------------------------------------------------------

# each step: (what the port does, what the reference does at the same place);
# a reservation is checked by making its words with the plain version
STEPS = {
    "aligned": [("reserve", 8 * 96), ("bytes", 32), ("reserve", 8 * 40), ("integers", 7)],
    "unaligned": [("bytes", 5), ("reserve", 8 * 33), ("bytes", 3), ("reserve", 8 * 17),
                  ("permutation", 9)],
    "mid_block": [("bytes", 8), ("reserve", 8 * 50), ("spawn", 0), ("reserve", 13),
                  ("normal", 5), ("reserve", 8 * 3)],
    "back_to_back": [("reserve", 8 * 3), ("reserve", 8 * 5), ("reserve", 11), ("bytes", 21),
                     ("permutation", 40), ("reserve", 8 * 64), ("integers", 300)],
}
SPAN = 2277377   # 16M-4096's t


def _step(rng, ref, what, n):
    """One step on both streams: (the port's draw, the reference's)."""
    if what == "reserve":
        key, counter, offset = rng.reserve(n)
        assert key == KEY and 0 <= offset < 16
        if n % 8:   # not whole words: the reference passes over the bytes
            return None, ref.bytes(n) and None
        got = ctr_mod.ctr_mod_plain(key, counter, offset, 0, SPAN, n // 8)
        want = ref.integers(0, SPAN, size=n // 8, dtype=np.uint64).astype(np.uint32)
        return got.view(np.uint32), want
    if what == "bytes":
        return rng.bytes(n), ref.bytes(n)
    if what == "integers":
        return rng.integers(-3, 1 << 30, size=n), ref.integers(-3, 1 << 30, size=n)
    if what == "permutation":
        return rng.permutation(n), ref.permutation(n)
    if what == "normal":
        return rng.normal(0.0, 3.2, size=n), ref.normal(0.0, 3.2, size=n)
    return rng.spawn().bytes(40), ref.spawn().bytes(40)


@pytest.mark.parametrize("steps", list(STEPS.values()), ids=list(STEPS))
def test_reserve_leaves_the_reference_stream(steps):
    """Reserving bytes at block-aligned and unaligned places, among the
    other draws, gives the stream of the reference drawing straight on."""
    rng, ref = CsRng(KEY), RefRng(KEY)
    for what, n in steps:
        got, want = _step(rng, ref, what, n)
        assert np.array_equal(np.asarray(got), np.asarray(want)), (what, n)
    assert rng.bytes(37) == ref.bytes(37)   # and on after the last step


def test_reserve_returns_the_block_and_offset():
    rng = CsRng(KEY[:16])   # a short key is zero-padded, as the stream's
    rng.bytes(21)
    key, counter, offset = rng.reserve(100)
    assert (key, counter, offset) == (KEY[:16] + b"\0" * 16, 1, 5)
    assert rng.reserve(0)[1:] == (7, 9)


# ---------------------------------------------------------------------------
# the kernel's arithmetic, modelled in numpy
# ---------------------------------------------------------------------------

def _ror(x, s):
    return ((x >> np.uint32(s)) | (x << np.uint32(32 - s))) & M32


def _aes_model(rk, hi, lo):
    """The kernel's AES: Te0 and its rotations, the S-box as Te0's byte 1,
    big-endian columns; [n] counters -> [n, 4] little-endian keystream words."""
    T = ctr_mod.te0()
    byte = lambda x, k: (x >> np.uint32(k)) & np.uint32(0xFF)
    s = [(hi >> np.uint64(32)).astype(np.uint32), (hi & np.uint64(M32)).astype(np.uint32),
         (lo >> np.uint64(32)).astype(np.uint32), (lo & np.uint64(M32)).astype(np.uint32)]
    s = [s[c] ^ rk[c] for c in range(4)]
    for r in range(1, 14):
        s = [T[byte(s[c], 24)] ^ _ror(T[byte(s[(c + 1) % 4], 16)], 8)
             ^ _ror(T[byte(s[(c + 2) % 4], 8)], 16) ^ _ror(T[byte(s[(c + 3) % 4], 0)], 24)
             ^ rk[4 * r + c] for c in range(4)]
    sb = lambda x: byte(T[x], 8)
    out = [((sb(byte(s[c], 24)) << np.uint32(24)) | (sb(byte(s[(c + 1) % 4], 16)) << np.uint32(16))
            | (sb(byte(s[(c + 2) % 4], 8)) << np.uint32(8)) | sb(byte(s[(c + 3) % 4], 0)))
           ^ rk[56 + c] for c in range(4)]
    return np.stack(out, axis=1).byteswap()


def _kernel_model(key, counter, offset, lo, span, n):
    """The kernel's words: blocks from ``counter`` with a 128-bit carry, a
    word cut at byte ``offset + 8i`` from two 32-bit funnel shifts, the
    modulo by mu = floor((2^64 - 1) / span) with one correction."""
    nblocks = (offset + 8 * n + 15) // 16 + 1
    ctr = [(counter + j) % (1 << 128) for j in range(nblocks)]
    hi = np.array([c >> 64 for c in ctr], np.uint64)
    lo64 = np.array([c & ctr_mod.M64 for c in ctr], np.uint64)
    ks = _aes_model(ctr_mod.round_keys(key), hi, lo64).reshape(-1).astype(np.uint64)
    p = offset + 8 * np.arange(n)
    q, sh = p >> 2, np.uint64(8) * (p & 3).astype(np.uint64)
    funnel = lambda a, b: ((a | (b << np.uint64(32))) >> sh) & np.uint64(M32)
    v = (funnel(ks[q + 1], ks[q + 2]) << np.uint64(32)) | funnel(ks[q], ks[q + 1])
    mu = ctr_mod.M64 // span
    r = np.array([int(x) - ((int(x) * mu) >> 64) * span for x in v], dtype=object)
    assert all(0 <= x < 2 * span for x in r)
    r = np.array([x - span if x >= span else x for x in r], np.int64)
    return ((r + lo) & 0xFFFFFFFF).astype(np.uint32).view(np.int32)


def test_tables_are_aes():
    s = ctr_mod.sbox()
    assert (s[0x00], s[0x01], s[0x53], s[0xFF]) == (0x63, 0x7C, 0xED, 0x16)
    assert len(set(s)) == 256
    # FIPS-197 appendix A.3's key expansion: its first derived and last words
    rk = ctr_mod.round_keys(bytes.fromhex(
        "603deb1015ca71be2b73aef0857d77811f352c073b6108d72d9810a30914dff4"))
    assert rk[8] == 0x9BA35411
    assert rk[56:].tolist() == [0xFE4890D1, 0xE6188D0B, 0x046DF344, 0x706C631E]


@pytest.mark.parametrize("counter", [0, (1 << 32) - 3, (1 << 64) - 3, (5 << 64) + (1 << 32) - 2,
                                     (1 << 128) - 2],
                         ids=["zero", "carry32", "carry64", "carry_hi", "wrap128"])
@pytest.mark.parametrize("offset", [0, 3, 8, 15])
def test_kernel_model_matches_plain(counter, offset):
    key = bytes(range(100, 132))
    for lo, span in ((0, SPAN), (1, SPAN - 1), (0, 40961), (-5, 11), (0, 1), (0, (1 << 31) - 1)):
        want = ctr_mod.ctr_mod_plain(key, counter, offset, lo, span, 9)
        assert np.array_equal(_kernel_model(key, counter, offset, lo, span, 9), want)


def test_ctr_mod_on_the_cpu_and_its_checks():
    got = ctr_mod.ctr_mod(KEY, 3, 8, 1, 99, (2, 3, 5), "cpu")
    assert got.dtype == torch.int32 and got.shape == (2, 3, 5)
    assert np.array_equal(got.numpy().ravel(), ctr_mod.ctr_mod_plain(KEY, 3, 8, 1, 99, 30))
    for bad in ((KEY[:16], 0, 0, 0, 5), (KEY, -1, 0, 0, 5), (KEY, 0, 16, 0, 5),
                (KEY, 0, 0, 0, 0), (KEY, 0, 0, 1, 1 << 31), (KEY, 1 << 128, 0, 0, 5)):
        with pytest.raises(ValueError):
            ctr_mod.ctr_mod(*bad, (4,), "cpu")


def test_key_stream_keeps_its_words_on_the_cpu():
    """On the CPU a kept draw's host copy is a uint32 view of the words
    themselves, and no event stands for a copy."""
    ks = ctr_mod.KeyStream(KEY, "cpu")
    out, host = ks.draw(3, 8, 1, 99, (2, 3, 5), keep=True)
    assert host.dtype == np.uint32 and np.shares_memory(host, out.numpy())
    assert np.array_equal(host, out.numpy()) and ks.done is None
    again, none = ks.draw(3, 8, 1, 99, (2, 3, 5))
    assert none is None and torch.equal(again, out)


# ---------------------------------------------------------------------------
# the receiver
# ---------------------------------------------------------------------------

def _mask_draws():
    """``benchmark/reference/matching.py:mask_draws``, loaded by path."""
    spec = importlib.util.spec_from_file_location(
        "bench_reference_matching", REPO / "benchmark" / "reference" / "matching.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.mask_draws


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


@functools.lru_cache(maxsize=None)
def _item_set(name):
    """A DB from items in both packages and three requests of one seeded
    sender, each as the reference's too."""
    d = {"ps": PS, "dag": DAG, "labeled": SMALL}[name]
    rp, pp = RefParams.from_dict(d), PSUParams.from_dict(d)
    db_items, query = make_sets(np.random.default_rng(1), 250, 30, 12)
    labels = _labels_for(db_items, pp.item_bit_count) if name == "labeled" else None
    r_db, db = RefDB(rp, RefOprf()), ReceiverDB(pp, DebugOprf(), device="cpu")
    r_db.set_data(db_items, labels=labels)
    db.set_data(db_items, labels=labels)
    snd = Sender(pp, DebugOprf(), rng=np.random.default_rng(21), device="cpu")
    reqs = [snd.create_query(q) for q in (query, query[::-1], query[5:])]
    r_reqs = [RefRequest(tuple(r.power_list), jnp.asarray(to_u32(r.powers_data)),
                         jnp.asarray(to_u32(r.relin_key)) if r.relin_key is not None else None)
              for r in reqs]
    return name, rp, pp, r_db, db, list(zip(r_reqs, reqs))


@pytest.fixture(scope="module", params=["ps", "dag", "labeled"])
def item_set(request):
    return _item_set(request.param)


def test_csrng_receiver_masks_are_the_references(item_set):
    """Three queries of a ``CsRng`` receiver: each mask the benchmark's
    rebuild from the key (unlabeled: the receiver draws only masks) and the
    reference receiver's under the same key, each response the reference's
    (a labeled one with its ρ), and the rng's stream after them (what the
    session's OPRF and endgame draw next) the reference's."""
    name, rp, pp, r_db, db, reqs = item_set
    key = b"mask-draw-receiver-key-32-bytes!"
    recv, r_recv = Receiver(pp, db, rng=CsRng(key)), RefReceiver(rp, r_db, rng=RefRng(key))
    t, mask_draws = pp.seal_params.plain_modulus, _mask_draws()
    for ordinal, (r_req, req) in enumerate(reqs):
        resp, r_resp = recv.run_query(req), r_recv.run_query(r_req)
        mask = recv.last_mask
        assert mask.dtype == np.uint32
        assert np.array_equal(mask, _u32(r_recv.last_mask))
        if name != "labeled":
            assert np.array_equal(mask, mask_draws(key, ordinal, mask.shape, t))
        assert np.array_equal(to_u32(resp.results), _u32(r_resp.results))
        if name == "labeled":
            assert np.array_equal(to_u32(resp.label_results), _u32(r_resp.label_results))
    assert np.array_equal(recv.rng.permutation(77), r_recv.rng.permutation(77))
    assert recv.rng.bytes(45) == r_recv.rng.bytes(45)


def test_labeled_rho_is_drawn_as_the_references(monkeypatch):
    """The labeled path draws ρ in [1, t) right after the mask, through the
    same reservation, as the reference's ``integers(1, t)``."""
    _, _, pp, _, db, reqs = _item_set("labeled")
    seen = []
    real = programs.matching_labeled

    def spy(bfv, powers, cache, const_slots, mask, label_cache, label0_slots, rho, lvl):
        seen.append(rho.clone())
        return real(bfv, powers, cache, const_slots, mask, label_cache, label0_slots, rho, lvl)

    monkeypatch.setattr(programs, "matching_labeled", spy)
    key = b"labeled-rho-key-32"
    recv, ref = Receiver(pp, db, rng=CsRng(key)), RefRng(key)
    t = pp.seal_params.plain_modulus
    recv.run_query(reqs[0][1])
    shape = recv.last_mask.shape
    want_mask = ref.integers(0, t, size=shape, dtype=np.uint64).astype(np.uint32)
    want_rho = ref.integers(1, t, size=shape, dtype=np.uint64).astype(np.uint32)
    assert np.array_equal(recv.last_mask, want_mask)
    assert np.array_equal(seen[0].numpy().view(np.uint32), want_rho)
    assert seen[0].min() >= 1 and seen[0].max() < t


def test_last_mask_survives_the_next_query(item_set):
    _, _, pp, _, db, reqs = item_set
    recv = Receiver(pp, db, rng=CsRng(b"survives-the-next-query"))
    recv.run_query(reqs[0][1])
    first = recv.last_mask
    kept = first.copy()
    recv.run_query(reqs[1][1])
    assert np.array_equal(first, kept)
    assert not np.array_equal(recv.last_mask, kept)


def test_generator_receiver_draws_on_the_host(item_set, monkeypatch):
    """A ``numpy.random.Generator`` receiver draws its mask with the
    generator, on the host, and never reaches ``ctr_mod``."""
    _, _, pp, _, db, reqs = item_set

    def refuse(*a, **k):
        raise AssertionError("a Generator receiver reached ctr_mod")

    monkeypatch.setattr(ctr_mod, "KeyStream", refuse)
    recv = Receiver(pp, db, rng=np.random.default_rng(5))
    recv.run_query(reqs[0][1])
    want = np.random.default_rng(5).integers(0, pp.seal_params.plain_modulus,
                                             size=recv.last_mask.shape, dtype=np.uint64)
    assert np.array_equal(recv.last_mask, want.astype(np.uint32))
