"""Kernels 9 and 10 of the port (``ops/roofline.py``, plain versions on the
CPU) against the reference tools' Pallas bodies in interpret mode, bit for bit
(tolerance 0), plus ``mul_wide``, the wrappers' checks and the two measuring
tools' output on the CPU.

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
