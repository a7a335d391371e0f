"""Kernels 9 and 10 of the port (``ops/roofline.py``, plain versions on the
CPU) against the reference tools' Pallas bodies in interpret mode, bit for bit
(tolerance 0), plus ``mul_wide``, the wrappers' checks, the two measuring
tools' output on the CPU, and ``chip_smoke.py``'s launch counts and bounds
(its counters are ``ops/counts.py``'s, its peaks and K2/K3 work the
benchmark yardstick's).

The reference's K9 bodies are closures inside ``tools/vpu_roofline.py:main``
and cannot be imported, so they are rebuilt here from ``apsu_tpu.core.mod32``
as that file writes them (``:69-99``, with ``P`` and ``PNI`` as at
``:65-67``); K10 is ``tools/ntt4p_gl_ab.py:trivial`` (``:62-82``) with its
block specs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from apsu_tpu.core import mod32 as ref_mod32
from apsu_tpu_torch.core.mod32 import from_u32, mul_wide, to_u32
from apsu_tpu_torch.ops import roofline
from apsu_tpu_torch.tools import ntt4p_gl_ab, vpu_roofline

TOLERANCE = 0   # u32 integers: exact
P, REPS = roofline.P, roofline.REPS
PNI = (-pow(P, -1, 1 << 32)) % (1 << 32)


def _ref_body(op):
    def kernel(x_ref, o_ref):
        x = x_ref[...]
        acc = x
        for _ in range(REPS):
            if op == "mul32":
                acc = acc * x + jnp.uint32(1)
            elif op == "mul_wide":
                hi, lo = ref_mod32.mul_wide(acc, x)
                acc = hi ^ lo
            elif op == "mont_mul":
                acc = ref_mod32.mont_mul(acc, x, jnp.uint32(P), jnp.uint32(PNI))
            else:
                acc = ref_mod32.shoup_mul_lazy(acc, x, x, jnp.uint32(P))
        o_ref[...] = acc
    return kernel


def _tool_input(shape, seed=0):
    """The reference tool's draw, with every value of [P, 2^28) planted."""
    x = np.random.default_rng(seed).integers(1, 1 << 28, shape, np.uint64).astype(np.uint32)
    above_p = np.arange(P, 1 << 28, dtype=np.uint32)
    x.reshape(-1)[: above_p.size] = above_p
    return x


@pytest.mark.parametrize("op", roofline.OPS)
def test_vpu_loop_matches_reference_kernel(op):
    shape = (8, 8, 128)
    x = _tool_input(shape)
    f = pl.pallas_call(_ref_body(op), out_shape=jax.ShapeDtypeStruct(shape, jnp.uint32),
                       interpret=True)
    want = np.asarray(jax.jit(lambda v: f(f(v)))(jnp.asarray(x)))   # chained twice
    got = to_u32(roofline.vpu_loop(from_u32(x, "cpu"), op, outer=2))
    assert np.abs(got.astype(np.int64) - want.astype(np.int64)).max() <= TOLERANCE
    assert np.array_equal(got, want)
    if op != "mont_mul":   # these arms pass 2^31: negative int32 in the port
        assert (want >= 1 << 31).any()


def test_add_one_matches_reference_trivial():
    B, L, rb = 8, 2, 8
    x = np.random.default_rng(3).integers(0, 1 << 32, (B, L, 64 * 128), np.uint64).astype(np.uint32)
    x[0, 0] = 0xFFFFFFFF   # a row that wraps to 0
    x[1, 1, :5] = [0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0, 1]

    def triv_kernel(x_ref, o_ref):
        o_ref[...] = x_ref[...] + jnp.uint32(1)

    xr = jnp.asarray(x).reshape(B // rb, rb, L, 64, 128)
    spec = pl.BlockSpec((1, rb, L, 64, 128), lambda b: (b, 0, 0, 0, 0))
    want = np.asarray(pl.pallas_call(
        triv_kernel, grid=(B // rb,), in_specs=[spec], out_specs=spec,
        out_shape=jax.ShapeDtypeStruct(xr.shape, jnp.uint32),
        compiler_params=pltpu.CompilerParams(dimension_semantics=("parallel",)),
        interpret=True,
    )(xr)).reshape(x.shape)
    got = to_u32(roofline.add_one(from_u32(x, "cpu")))
    assert np.array_equal(got, want)
    assert (got[0, 0] == 0).all()
    out = torch.empty((B, L, 64 * 128), dtype=torch.int32)
    assert roofline.add_one(from_u32(x, "cpu"), out=out) is out
    assert np.array_equal(to_u32(out), want)


def test_mul_wide_matches_reference_full_range():
    rng = np.random.default_rng(5)
    edge = np.array([0, 1, 2, 0xFFFF, 0x10000, 0x7FFFFFFF, 0x80000000, 0xFFFFFFFE, 0xFFFFFFFF],
                    np.uint32)
    a = np.concatenate([np.repeat(edge, edge.size), rng.integers(0, 1 << 32, 4096, np.uint64)
                        .astype(np.uint32)])
    b = np.concatenate([np.tile(edge, edge.size), rng.integers(0, 1 << 32, 4096, np.uint64)
                        .astype(np.uint32)])
    hi_r, lo_r = jax.jit(ref_mod32.mul_wide)(jnp.asarray(a), jnp.asarray(b))
    hi, lo = mul_wide(from_u32(a, "cpu"), from_u32(b, "cpu"))
    assert np.array_equal(hi.numpy().astype(np.uint32), np.asarray(hi_r))
    assert np.array_equal(lo.numpy().astype(np.uint32), np.asarray(lo_r))
    want = a.astype(object) * b.astype(object)
    assert [int(h) << 32 | int(low) for h, low in zip(hi.tolist(), lo.tolist())] == list(want)


def test_mont_mul_folded_carry_equals_reference_redc():
    """The kernel's mont_mul step takes the high word of acc*x + m*p (mod
    2^64) for the reference's hi + hi(m*p) + (lo != 0) (mod 2^32); both agree
    on full-range u32 operands, where the sum passes 2^64."""
    rng = np.random.default_rng(9)
    acc = [int(v) for v in rng.integers(0, 1 << 32, 2048, np.uint64)] + [0, 1, (1 << 32) - 1]
    x = [int(v) for v in rng.integers(0, 1 << 32, 2048, np.uint64)] + [(1 << 32) - 1] * 3
    M32, M64 = (1 << 32) - 1, (1 << 64) - 1
    folded = []
    for a, b in zip(acc, x):
        w = a * b
        m = (w & M32) * PNI & M32
        t = ((w + m * P) & M64) >> 32
        folded.append(t - P if t >= P else t)
    assert max(a * b + (((a * b & M32) * PNI & M32) * P) for a, b in zip(acc, x)) > M64
    want = roofline._step("mont_mul", torch.tensor(acc, dtype=torch.int64),
                          torch.tensor(x, dtype=torch.int64))
    assert want.tolist() == folded


M32 = (1 << 32) - 1


def _mont_step_model(acc, x, p=P, pni=PNI):
    """The kernel's mont_mul step (``csrc/roofline.cu:mont_step``) in numpy
    uint64, instruction by instruction: w = acc*x (mul.wide), m = lo(w)*pni
    (mul.lo), t = hi(m*p + w mod 2^64) (the mad.lo.cc / madc.hi pair, one
    IMAD.HI.U32 with w as its 64-bit addend), u = t - p (u32 wrap), min(t,
    u)."""
    w = acc.astype(np.uint64) * x.astype(np.uint64)
    m = ((w & np.uint64(M32)) * np.uint64(pni)) & np.uint64(M32)
    v = m * np.uint64(p) + w   # may pass 2^64: numpy wraps, as the card
    t = v >> np.uint64(32)
    u = (t - np.uint64(p)) & np.uint64(M32)
    return np.minimum(t, u).astype(np.uint32)


def test_mont_step_model_matches_reference_mont_mul():
    """acc = 2t, x = 2^31 puts t = hi(acc*x) itself through the conditional
    subtraction (lo = 0, so m = 0): t at 0, p - 1, p, 2p - 1 and beyond; then
    the planted [P, 2^28) values and full-range u32 operands."""
    ts = np.array([0, 1, P - 1, P, P + 1, 2 * P - 1, 2 * P, (1 << 31) - 1], np.uint64)
    acc = [(2 * ts) & M32, _tool_input((4, 8, 128)).reshape(-1),
           np.random.default_rng(4).integers(0, 1 << 32, 8192, np.uint64)]
    x = [np.full(ts.size, 1 << 31, np.uint64), _tool_input((4, 8, 128), seed=1).reshape(-1),
         np.random.default_rng(5).integers(0, 1 << 32, 8192, np.uint64)]
    acc, x = (np.concatenate(a).astype(np.uint32) for a in (acc, x))
    want = np.asarray(jax.jit(ref_mod32.mont_mul)(jnp.asarray(acc), jnp.asarray(x),
                                                    jnp.uint32(P), jnp.uint32(PNI)))
    got = _mont_step_model(acc, x)
    assert np.array_equal(got, want)
    # the first cases reach each side of the subtraction at its edges
    assert got[: ts.size].tolist() == [int(t - P) if t >= P else int(t) for t in ts]
    planted = _tool_input((4, 8, 128)).reshape(-1)
    assert ((planted >= P) & (planted < 1 << 28)).sum() == (1 << 28) - P


@pytest.mark.parametrize("p", [P, 1, 3, (1 << 31) - 1, 1 << 31, M32])
def test_min_is_the_conditional_subtraction(p):
    """min(t, t - p mod 2^32) == (t >= p ? t - p : t) for every u32 t and
    p < 2^32: the kernel's one-instruction select."""
    t = np.concatenate([np.array([0, 1, p - 1, p, p + 1, 2 * p - 1, 2 * p, 1 << 31, M32],
                                 np.uint64) & np.uint64(M32),
                        np.random.default_rng(p & 0xFFFF).integers(0, 1 << 32, 4096, np.uint64)])
    u = (t - np.uint64(p)) & np.uint64(M32)
    assert np.array_equal(np.minimum(t, u), np.where(t >= np.uint64(p), t - np.uint64(p), t))


def test_launch_checks_the_error_and_counts_outside_capture(monkeypatch):
    """``_build.launch`` passes the device's raw current stream last, raises
    on a nonzero return (``cudaGetLastError``), and returns 1 to count a
    launch, 0 while the stream is captured (it counts at each replay)."""
    from apsu_tpu_torch.ops import _build

    for name, fn in [("_cuda_getDevice", lambda: 0), ("_cuda_isCurrentStreamCapturing", lambda: False),
                     ("_cuda_getCurrentRawStream", lambda idx: 1234 + idx)]:
        monkeypatch.setattr(torch._C, name, fn, raising=False)
    seen = []
    assert _build.launch("k", lambda *a: seen.append(a) or 0, 0, 7, 8) == 1
    assert seen == [(7, 8, 1234)]
    with pytest.raises(RuntimeError, match="k launch failed: cudaError 700"):
        _build.launch("k", lambda *a: 700, 0)
    monkeypatch.setattr(torch._C, "_cuda_isCurrentStreamCapturing", lambda: True)
    assert _build.launch("k", lambda *a: 0, 0) == 0


def test_wrappers_check_their_operands():
    x = torch.zeros(16, dtype=torch.int32)
    with pytest.raises(TypeError, match="int32"):
        roofline.vpu_loop(x.to(torch.int64), "mul32")
    with pytest.raises(ValueError, match="contiguous"):
        roofline.vpu_loop(torch.zeros((4, 8), dtype=torch.int32).t(), "mul32")
    with pytest.raises(ValueError, match="unknown op"):
        roofline.vpu_loop(x, "mul64")
    with pytest.raises(ValueError, match="outer"):
        roofline.vpu_loop(x, "mul32", outer=0)
    with pytest.raises(ValueError, match="does not match"):
        roofline.add_one(x, out=torch.zeros(8, dtype=torch.int32))
    with pytest.raises(ValueError, match="apart"):
        roofline.add_one(x, out=x)
    # the kernels' own entries take CUDA tensors only
    with pytest.raises(ValueError, match="CUDA"):
        roofline.vpu_loop_cuda(x, "mul32")
    with pytest.raises(ValueError, match="CUDA"):
        roofline.add_one_cuda(x)


def test_vpu_roofline_measure_on_cpu():
    res = vpu_roofline.measure("cpu", shape=(1, 8, 128), outer=2, stream_elems=1027)
    assert res["tool"] == "vpu_roofline" and res["device"] == "cpu"
    assert [a["arm"] for a in res["arms"]] == list(roofline.OPS)
    for a in res["arms"]:
        assert a["steps"] == 1024 * REPS * 2
        assert a["ms"] is None and a["ops_per_s"] is None   # no device time on the CPU
        # the bound is the hand count's busier pipe at one pipe's INT32 rate
        assert a["bound_ms"] == pytest.approx(
            a["steps"] * max(a["min_per_step"].values()) / vpu_roofline.INT32_OPS_PER_S * 1e3)
    assert [max(a["min_per_step"].values()) for a in res["arms"]] == [1, 1, 3, 3]
    s = res["stream"]
    assert s["bytes_a_window"] == 16 * 2 * 1027 * 4 and s["ms"] is None


def test_ntt4p_gl_ab_measure_on_cpu():
    res = ntt4p_gl_ab.measure("cpu", Ls=(2, 3), Bs=(2,), n=256)
    assert res["tool"] == "ntt4p_gl_ab" and res["reps"] >= 1
    assert [(r["L"], r["B"], r["planes"]) for r in res["rows"]] == [(2, 2, 4), (3, 2, 6)]
    for r in res["rows"]:
        assert r["bit_identical"] and r["add_one_identical"]
        assert r["l2_resident"] and r["ntt_ms"] is None


def test_tools_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        vpu_roofline.measure()
    with pytest.raises(RuntimeError, match="cuda"):
        ntt4p_gl_ab.measure()


def test_tool_defaults_are_the_reference_grid():
    """The tools' defaults are the reference's shapes."""
    import inspect

    assert inspect.signature(vpu_roofline.measure).parameters["shape"].default == (8, 512, 128)
    assert inspect.signature(vpu_roofline.measure).parameters["outer"].default == 256
    sig = inspect.signature(ntt4p_gl_ab.measure).parameters
    assert sig["Ls"].default == (4, 7, 14) and sig["Bs"].default == (64, 256)
    assert sig["n"].default == 8192


def _chip_smoke():
    """``chip_smoke.py`` loaded by its path, as the card's runs import it."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent.parent / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke_counts", path)
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_reset_zeroes_every_counter():
    """``chip_smoke.reset_launches`` zeroes every counter of
    ``ops/counts.COUNTERS`` (M1's and K9/K10's too), and ``launch_counts``
    reads each."""
    from apsu_tpu_torch.ops import counts

    smoke = _chip_smoke()
    saved = counts.read()

    def set_all():
        for i, (mod, counter, _) in enumerate(counts.COUNTERS):
            setattr(mod, counter, i + 1)

    try:
        set_all()
        smoke.reset_launches()
        assert counts.read() == [0] * len(saved)
        set_all()
        assert list(smoke.launch_counts().values()) == list(range(1, len(saved) + 1))
    finally:
        for (mod, counter, _), v in zip(counts.COUNTERS, saved):
            setattr(mod, counter, v)


def test_chip_smoke_traced_names_cover_every_counter():
    """Each counter of ``ops/counts.COUNTERS`` has its ``kernels``-line name
    and a traced ``__global__`` function that its pattern names, M1's
    ``ctr_mod_kernel`` among them."""
    from apsu_tpu_torch.ops import counts

    smoke = _chip_smoke()
    table = smoke.counters()
    assert [(m, c) for m, c, _, _ in table] == [(m, c) for m, c, _ in counts.COUNTERS]
    assert [name for _, _, name, _ in table] == [
        "ntt", "ps_inner", "eval_dot", "vpu_loop", "add_one", "behz_lift", "mont_mac",
        "behz_scaledown", "rns_divround", "behz_lift_general", "behz_scaledown_general",
        "ctr_mod", "scale_add"]
    traced = smoke.traced_names()
    for (*_, pattern), (*_, kernel) in zip(counts.COUNTERS, table):
        assert kernel in traced and f"{len(kernel)}{kernel}" in pattern
    assert "ctr_mod_kernel" in traced and len(traced) == len(set(traced))


@pytest.mark.parametrize("work, shapes, want", [
    # K2 at 16M-4096's warm query; K3 at 1M-2048-cmp's (chip_smoke's own
    # copies of the arithmetic gave these before it took the yardstick's)
    pytest.param("ps_work", ((4, 44, 2, 4, 8192), (24, 29, 45, 4, 8192)),
                 (1.2664294017910447, "bytes"), id="ps"),
    pytest.param("dot_work", ((5, 72, 2, 2, 4096), (5, 15, 80, 2, 4096)),
                 (0.061329958208955225, "bytes"), id="dot"),
])
def test_chip_smoke_bounds_come_from_the_yardstick(work, shapes, want):
    """``chip_smoke.py``'s K2 and K3 bounds are the benchmark yardstick's
    ``bound_s`` over its ``ps_work``/``dot_work``, to the last digit."""
    smoke = _chip_smoke()
    assert smoke.bound_ms(*getattr(smoke.yardstick, work)(*shapes)) == want
