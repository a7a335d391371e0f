"""The plain versions of the glue kernels G1-G5 (``apsu_tpu_torch/ops/behz.py``)
against the reference's own functions on the same seeded numpy inputs, bit
for bit: the lift, to_mont/from_mont and relinearization's digits (G1), the
BEHZ tensor and the key-switch sum (G2), the scale-down (G3), the key-switch
mod-down and the mod-switch (G4), the plaintext scaling and the adds of the
PS evaluation's constant term (G5).  G1-G4 run on three contexts: small
parameters (N=256), 1M-2048-cmp's (N=4096) and 256M-1's 30-bit primes at
N=2048; G5 on small, 1M-2048-cmp, 1M-2048-com (29/29/28-bit primes) and
16M-4096's chain and t at N=2048; with random residues, every residue p - 1,
and every residue 0;
and the lift's m~ correction and Shenoy-Kumaresan's alpha at their
thresholds.  The kernels themselves are held against these plain versions on
the card (``tests/test_torch_kernels.py``, ``chip_smoke.py``).  Without a
card, a numpy model of G3's and the lift's arithmetic (their lazy 64-bit
sums and reduce64, over the packed tables) is held against the plain
versions, every parameter file's worst-case sum against 2^64, and the
kernels' list of exact builds against every parameter file."""

import functools
import glob
import json
import re
from dataclasses import replace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from apsu_tpu.core import mod32 as rmod
from apsu_tpu.core.bfv import BfvContext as RefBfv
from apsu_tpu.core.bfv import Ciphertext as RefCt
from apsu_tpu.core.bfv import _msum_tensor as ref_msum_tensor
from apsu_tpu.core.params import PSUParams as RefParams
from apsu_tpu.core.params import SealParams as RefSeal
from apsu_tpu_torch.core import rns
from apsu_tpu_torch.core.bfv import BfvContext
from apsu_tpu_torch.core.mod32 import shoup_mul, sub_mod, to_u32
from apsu_tpu_torch.core.params import PSUParams, SealParams
from apsu_tpu_torch.ops import behz

SMALL = {
    "table_params": {"hash_func_count": 2, "table_size": 64, "max_items_per_bin": 8},
    "item_params": {"felts_per_item": 4},
    "query_params": {"ps_low_degree": 0, "query_powers": [1, 2, 3, 4, 5, 6, 7, 8]},
    "seal_params": {"plain_modulus": 65537, "poly_modulus_degree": 256,
                    "coeff_modulus_bits": [40, 40, 30]},
}
SETS = ["small", "1M-2048-cmp", "256M-1 at N=2048"]
FILLS = [None, "p-1", "zero"]


@functools.lru_cache(maxsize=None)
def ctxs(name):
    """(reference, port) contexts of one of ``SETS``, the port on the CPU."""
    if name == "small":
        # its last prime made the special one, as a relinearizing set's is
        ref_sp = replace(RefParams.from_dict(SMALL).seal_params, has_special=True)
        port_sp = replace(PSUParams.from_dict(SMALL).seal_params, has_special=True)
    elif " at N=" in name:
        # a parameter file's q chain, plain modulus and special prime at a
        # smaller N (256M-1's: two 30-bit primes and a 29-bit one; 2N | p - 1
        # for N = 8192, so also for N = 2048)
        file, n = name.split(" at N=")
        sp = PSUParams.load_file(f"parameters/{file}.json").seal_params
        fields = dict(poly_modulus_degree=int(n), plain_modulus=sp.plain_modulus,
                      coeff_modulus=sp.coeff_modulus,
                      ref_coeff_modulus_bits=sp.ref_coeff_modulus_bits,
                      has_special=sp.has_special)
        ref_sp, port_sp = RefSeal(**fields), SealParams(**fields)
    else:
        ref_sp = RefParams.load_file(f"parameters/{name}.json").seal_params
        port_sp = PSUParams.load_file(f"parameters/{name}.json").seal_params
    return RefBfv(ref_sp), BfvContext(port_sp, device="cpu")


def _residues(shape, primes, seed, fill=None):
    """numpy uint32 residues of ``primes`` along axis -2."""
    p = np.array(primes, np.uint64).reshape(-1, 1)
    if fill == "zero":
        return np.zeros(shape, np.uint32)
    if fill == "p-1":
        return np.broadcast_to(p - 1, shape).astype(np.uint32)
    x = np.random.default_rng(seed).integers(0, 1 << 62, size=shape, dtype=np.uint64)
    return (x % p).astype(np.uint32)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x).view(np.int32))


def _eq(ref, port):
    return np.array_equal(np.asarray(jax.device_get(ref)), to_u32(port))


def _jit(f, *args):
    return jax.jit(f)(*args)


def _struct_fields(header, struct):
    """(name, shape) of each u32 field of ``struct`` in csrc/behz.cuh, in
    order, its array bounds given by name (MAXQ ...) or number."""
    body = re.search(r"struct %s \{(.*?)\n\};" % struct, header, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    limits = {"MAXQ": behz.MAXQ, "MAXB": behz.MAXB, "MAXL": behz.MAXL}
    fields = []
    for decl in re.findall(r"uint32_t ([^;]*);", body):
        for name, dims in re.findall(r"(\w+)((?:\[\w+\])*)", decl):
            shape = tuple(limits.get(d) or int(d) for d in re.findall(r"\[(\w+)\]", dims))
            fields.append((name, shape or (1,)))
    return fields


def test_table_layouts_match_the_kernels_header():
    """Each constant table has the fields of its struct in csrc/behz.cuh, in
    its order and with its shapes (the lazy sums' fields appended last), and the
    struct's size."""
    header = open("apsu_tpu_torch/csrc/behz.cuh").read()
    for struct, layout in (("LiftTable", rns.LIFT_LAYOUT), ("ModTable", rns.MOD_LAYOUT),
                           ("ScaleTable", rns.SCALE_LAYOUT), ("DivTable", rns.DIV_LAYOUT),
                           ("DeltaTable", rns.DELTA_LAYOUT)):
        words = sum(int(np.prod(shape)) for _, shape in layout)
        assert f"sizeof({struct}) == {words} * 4" in header
        assert _struct_fields(header, struct) == list(layout)
    for a, b in (("MAXQ", behz.MAXQ), ("MAXB", behz.MAXB), ("MAXL", behz.MAXL)):
        assert f"constexpr int {a} = {b};" in header
    _, port = ctxs("small")
    mc = port._mul_ctx(port.q.k)
    for table, layout in ((port.q.to_mont_table, rns.LIFT_LAYOUT),
                          (mc["lift"].table, rns.LIFT_LAYOUT), (port.q.mod_table, rns.MOD_LAYOUT),
                          (mc["scale"].table, rns.SCALE_LAYOUT),
                          (port.div_drop[port.q.k].table, rns.DIV_LAYOUT),
                          (port.delta[port.q.k].table, rns.DELTA_LAYOUT)):
        assert table.dtype == np.uint32 and table.size == sum(
            int(np.prod(shape)) for _, shape in layout)


def test_contexts_have_the_same_bases():
    for name in SETS:
        ref, port = ctxs(name)
        assert ref.q_primes == port.q_primes and ref.special == port.special
        for lvl in range(1, port.q.k + 1):
            for extra in (0, 4):
                assert ref._mul_ctx(lvl, extra)["bsk"].primes == \
                    port._mul_ctx(lvl, extra)["bsk"].primes


# ---------------------------------------------------------------------------
# G1
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SETS)
@pytest.mark.parametrize("fill", FILLS)
def test_lift_matches_reference(name, fill):
    """(q.to_mont(x), bsk.to_mont(ExactLiftConv(x))) at the top level and
    level 2, with the multiply's Bsk and a multiply-sum's widened one."""
    ref, port = ctxs(name)
    for lvl in sorted({2, port.q.k}):
        for extra in (0, 4):
            rmc, pmc = ref._mul_ctx(lvl, extra), port._mul_ctx(lvl, extra)
            rq, rb = ref.levels[lvl], rmc["bsk"]
            x = _residues((2, 2, lvl, port.n), port.q_primes[:lvl], lvl + extra, fill)
            want_q, want_b = _jit(lambda v: (rq.to_mont(v), rb.to_mont(rmc["lift"](v))), x)
            got_q, got_b = behz.lift_plain(_t(x), pmc["lift"])
            assert _eq(want_q, got_q) and _eq(want_b, got_b)
            assert behz.lift_plain(_t(x), pmc["lift"], want_q=False)[0] is None


def _lift_at(port, lvl, rr_targets, seed):
    """Plain residues x [len(rr_targets), lvl, N] whose m~ correction
    r = [-y * Q^-1] mod 2^16 (before centring) is rr_targets[row] in every
    lane: the residues above the first are random, and the first is chosen
    so that the 16-bit sum y = sum_i c_i * qhat_i lands where r needs it."""
    lift = port._mul_ctx(lvl)["lift"]
    q = lift.src
    mt, n = 1 << 16, port.n
    x = _residues((len(rr_targets), lvl, n), q.primes, seed).astype(np.uint64)
    c_mul = [mt * inv % p for inv, p in zip(q.phat_inv, q.primes)]
    c = [x[:, i] * np.uint64(c_mul[i]) % np.uint64(q.primes[i]) for i in range(lvl)]
    rest = sum(((c[i] & np.uint64(0xFFFF)) * np.uint64(lift.phat_mod_mt[i]))
               for i in range(1, lvl)) % np.uint64(mt)
    # r = -s, s = y * Q^-1 mod 2^16  =>  y = -r * Q mod 2^16
    y = (-np.array(rr_targets, np.int64)[:, None] * (q.prod % mt)) % mt
    low = (y.astype(np.uint64) - rest) % np.uint64(mt) * np.uint64(
        pow(lift.phat_mod_mt[0], -1, mt)) % np.uint64(mt)
    p0 = q.primes[0]
    high = np.random.default_rng(seed + 1).integers(0, (p0 - mt) >> 16, size=low.shape,
                                                     dtype=np.uint64)
    c0 = (high << np.uint64(16)) | low                         # < p0, low bits fixed
    x[:, 0] = c0 * np.uint64(pow(c_mul[0], -1, p0)) % np.uint64(p0)
    return x.astype(np.uint32)


@pytest.mark.parametrize("name", SETS)
def test_lift_correction_at_its_thresholds(name):
    """The centred m~ correction r at 2^15 - 1, 2^15 (the first negative),
    2^15 + 1, 0 and 2^16 - 1: the lift equals the reference's."""
    ref, port = ctxs(name)
    lvl = port.q.k
    targets = [0x7FFF, 0x8000, 0x8001, 0, 0xFFFF]
    x = _lift_at(port, lvl, targets, seed=3)
    lift = port._mul_ctx(lvl)["lift"]
    c = shoup_mul(_t(x), *lift.mt_phat_inv_sh, lift.src.p_d).to(torch.int64)
    c16 = sum((c[:, i] & 0xFFFF) * lift.phat_mod_mt[i] for i in range(lvl))
    rr = ((1 << 16) - ((c16 & 0xFFFF) * lift.q_inv_mt & 0xFFFF)) & 0xFFFF
    assert rr.tolist() == [[t] * port.n for t in targets]
    rmc = ref._mul_ctx(lvl)
    want = _jit(lambda v: ref._mul_ctx(lvl)["bsk"].to_mont(rmc["lift"](v)), x)
    assert _eq(want, behz.lift_plain(_t(x), port._mul_ctx(lvl)["lift"])[1])


@pytest.mark.parametrize("name", SETS)
@pytest.mark.parametrize("fill", FILLS)
def test_scale_matches_reference(name, fill):
    """to_mont and from_mont of q, Bsk and Q·P."""
    ref, port = ctxs(name)
    lvl = port.q.k
    bases = [(ref.q, port.q), (ref._mul_ctx(lvl)["bsk"], port._mul_ctx(lvl)["bsk"])]
    bases.append((ref.qp, port.qp))
    for rb, pb in bases:
        x = _residues((3, pb.k, port.n), pb.primes, pb.k, fill)
        assert _eq(_jit(rb.to_mont, x), behz.scale_plain(_t(x), pb))
        assert _eq(_jit(rb.from_mont, x), behz.scale_plain(_t(x), pb, inverse=True))


@pytest.mark.parametrize("name", SETS)
@pytest.mark.parametrize("fill", FILLS)
def test_digits_match_reference(name, fill):
    """Relinearization's digits of c2 in Q·P, Montgomery form, at the top
    level and one below."""
    ref, port = ctxs(name)
    for lvl in sorted({1, port.q.k}):
        rqp, k = ref._qp_level(lvl), lvl
        c = _residues((2, 3, lvl, port.n), port.q_primes[:lvl], lvl, fill)
        want = _jit(lambda v: rqp.to_mont(jnp.stack([v[..., 2, i: i + 1, :] for i in range(k)])),
                    c)
        assert _eq(want, behz.digits_plain(_t(c)[..., 2, :, :], port._qp_level(lvl), k))


# ---------------------------------------------------------------------------
# G2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SETS)
@pytest.mark.parametrize("fill", FILLS)
@pytest.mark.parametrize("M", [1, 11])
def test_mont_mac_matches_reference(name, fill, M):
    """Σ_m tensor(fa[m], fb[m]) in q and in the (⌈log2 M⌉-widened) Bsk, the
    rhs broadcast over two caches, against the reference's ``_msum_tensor``
    (which adds the INTT and from_mont: the port's, exact, are applied)."""
    ref, port = ctxs(name)
    lvl = port.q.k
    extra = max(1, (M - 1).bit_length())
    for rbase, pbase in ((ref.q, port.q), (ref._mul_ctx(lvl, extra)["bsk"],
                                           port._mul_ctx(lvl, extra)["bsk"])):
        fa = _residues((2, 2, M, 2, pbase.k, port.n), pbase.primes, M, fill)
        fb = _residues((2, 1, M, 2, pbase.k, port.n), pbase.primes, M + 1, fill)
        want = _jit(lambda a, b: ref_msum_tensor(rbase, a, b, M), fa, fb)
        got = pbase.from_mont(pbase.ntt.intt(behz.mont_mac_plain(_t(fa), _t(fb), pbase)))
        assert _eq(want, got)


@pytest.mark.parametrize("name", SETS)
@pytest.mark.parametrize("fill", FILLS)
def test_keyswitch_mac_matches_reference(name, fill):
    """Σ_i d_i ⊙ ksk_i with the key read at a level below its own (limb
    columns {0..lvl-1, special}) and at its own, against the reference's
    mont_mul / add_mod chain of ``relinearize``."""
    ref, port = ctxs(name)
    klvl = port.q.k
    ksk = _residues((klvl, 2, klvl + 1, port.n), port.q_primes + [port.special], 9, fill)
    for lvl in sorted({1, klvl}):
        rqp = ref._qp_level(lvl)
        d = _residues((lvl, 2, lvl + 1, port.n), rqp.primes, lvl, fill)
        cols = list(range(lvl)) + [klvl]

        def ref_u(dd, kk):
            key = kk[:lvl][:, :, cols, :].reshape((lvl, 1, 2, lvl + 1, port.n))
            terms = rmod.mont_mul(dd[..., None, :, :], key, rqp.p_d, rqp.pni_d)
            u = terms[0]
            for i in range(1, lvl):
                u = rmod.add_mod(u, terms[i], rqp.p_d)
            return u

        got = behz.keyswitch_mac_plain(_t(d), _t(ksk), port._qp_level(lvl), lvl, klvl)
        assert _eq(_jit(ref_u, d, ksk), got)


# ---------------------------------------------------------------------------
# G3
# ---------------------------------------------------------------------------

def _ref_scaledown(ref, lvl, extra):
    rmc = ref._mul_ctx(lvl, extra)
    q, bsk = ref.levels[lvl], rmc["bsk"]

    def run(xq, xb):
        xt_q = rmod.shoup_mul(q.from_mont(xq), *rmc["t_sh_q"], q.p_d)
        xt_b = rmod.shoup_mul(bsk.from_mont(xb), *rmc["t_sh_bsk"], bsk.p_d)
        y_b = rmod.shoup_mul(rmod.sub_mod(xt_b, rmc["conv"](xt_q), bsk.p_d),
                             *rmc["qinv_sh_bsk"], bsk.p_d)
        return rmc["sk_conv"](y_b)

    return run


@pytest.mark.parametrize("name", SETS)
@pytest.mark.parametrize("fill", FILLS)
def test_scaledown_matches_reference(name, fill):
    """From the INTT'd Montgomery tensor in q and Bsk to plain q, at the
    top level and level 1, with the multiply's Bsk and a widened one."""
    ref, port = ctxs(name)
    for lvl in sorted({1, port.q.k}):
        for extra in (0, 4):
            sd = port._mul_ctx(lvl, extra)["scale"]
            xq = _residues((2, 3, lvl, port.n), sd.q.primes, lvl, fill)
            xb = _residues((2, 3, sd.bsk.k, port.n), sd.bsk.primes, lvl + 1, fill)
            got = behz.scaledown_plain(_t(xq), _t(xb), sd)
            assert _eq(_jit(_ref_scaledown(ref, lvl, extra), xq, xb), got)


def _scaledown_at(port, lvl, alphas, seed):
    """Montgomery inputs (x_q, x_b) whose Shenoy-Kumaresan alpha is
    alphas[row] in every lane: x_q and Bsk's limbs below m_sk random, x_b's
    m_sk limb solved for from them."""
    sd = port._mul_ctx(lvl)["scale"]
    q, bsk, sk = sd.q, sd.bsk, sd.sk_conv
    msk, n, rows = sk.m_sk, port.n, len(alphas)
    xq = _t(_residues((rows, q.k, n), q.primes, seed))
    xb = _t(_residues((rows, bsk.k, n), bsk.primes, seed + 1))
    xt_q = shoup_mul(behz.scale_plain(xq, q, True), *sd.t_sh_q, q.p_d)
    conv_sk = sd.conv(xt_q)[:, -1].to(torch.int64)
    xt_b = shoup_mul(behz.scale_plain(xb, bsk, True), *sd.t_sh_bsk, bsk.p_d)
    y_b = shoup_mul(sub_mod(xt_b, sd.conv(xt_q), bsk.p_d), *sd.qinv_sh_bsk, bsk.p_d)
    yhat_sk = sk.conv_b_to_sk(y_b[:, :-1])[:, 0].to(torch.int64)
    alpha = torch.tensor(alphas, dtype=torch.int64)[:, None]
    y_sk = (yhat_sk - alpha * (sk.B.prod % msk)) % msk
    xt_sk = (y_sk * (q.prod % msk) + conv_sk) % msk
    x_sk = xt_sk * (pow(port.t, -1, msk) * (1 << 32) % msk) % msk
    xb[:, -1] = x_sk.to(torch.int32)
    return xq, xb


@pytest.mark.parametrize("name", SETS)
def test_scaledown_alpha_at_its_threshold(name):
    """Shenoy-Kumaresan's alpha just below, at and above (m_sk + 1) / 2 (where
    it turns negative), at 0 and at m_sk - 1: the scale-down equals the
    reference's."""
    ref, port = ctxs(name)
    lvl = port.q.k
    sd = port._mul_ctx(lvl)["scale"]
    half, msk = sd.sk_conv.msk_half, sd.sk_conv.m_sk
    alphas = [half - 1, half, half + 1, 0, msk - 1]
    xq, xb = _scaledown_at(port, lvl, alphas, seed=5)
    sk = sd.sk_conv
    xt_q = shoup_mul(behz.scale_plain(xq, sd.q, True), *sd.t_sh_q, sd.q.p_d)
    xt_b = shoup_mul(behz.scale_plain(xb, sd.bsk, True), *sd.t_sh_bsk, sd.bsk.p_d)
    y_b = shoup_mul(sub_mod(xt_b, sd.conv(xt_q), sd.bsk.p_d), *sd.qinv_sh_bsk, sd.bsk.p_d)
    diff = sub_mod(sk.conv_b_to_sk(y_b[:, :-1]), y_b[:, -1:], sk.msk_d)
    got_alpha = shoup_mul(diff, *sk.prodB_inv_sk_sh, sk.msk_d)
    assert got_alpha[:, 0].tolist() == [[a] * port.n for a in alphas]
    want = _jit(_ref_scaledown(ref, lvl, 0), to_u32(xq), to_u32(xb))
    assert _eq(want, behz.scaledown_plain(xq, xb, sd))


# ---------------------------------------------------------------------------
# G3 and G1's lift as the kernels compute them: lazy 64-bit sums and one
# reduce64 an output limb (csrc/behz.cuh, behz_scaledown.cu, behz_lift.cu)
# ---------------------------------------------------------------------------

M32 = np.uint64(0xFFFFFFFF)


def _fields(table, layout):
    """A packed table's fields by name, as uint64 arrays of their shapes."""
    out, at = {}, 0
    for name, shape in layout:
        size = int(np.prod(shape))
        out[name] = table[at: at + size].astype(np.uint64).reshape(shape)
        at += size
    return out


def _col(v):
    return v.reshape(-1, 1)


def _shoup_np(x, c, c_sh, p):
    """behz.cuh's shoup in u32 arithmetic: x * c - hi(x * c_sh) * p, canonical."""
    t = (x * c - ((x * c_sh) >> np.uint64(32)) * p) & M32
    return np.where(t >= p, t - p, t)


def _min_sub(t, p):
    return np.minimum(t, (t - p) & M32)


def _reduce64_np(s, c32, c32_sh, one_sh, p):
    """behz.cuh's reduce64: hi * (2^32 mod p) and lo by one Shoup product
    each, then canonical."""
    hi, lo = s >> np.uint64(32), s & M32
    a = (hi * c32 - ((hi * c32_sh) >> np.uint64(32)) * p) & M32
    b = (lo - ((lo * one_sh) >> np.uint64(32)) * p) & M32
    return _min_sub(_min_sub(a, p) + _min_sub(b, p), p)


def scaledown_model(x_q, x_b, table, lq, lb):
    """G3's arithmetic on uint64 arrays of residues [..., Lq, N] and
    [..., Lb, N] (Montgomery), over its packed table."""
    f = _fields(table, rns.SCALE_LAYOUT)
    nb = lb - 1
    y = [_shoup_np(x_q[..., i, :], f["yq"][i], f["yq_sh"][i], f["q"][i]) for i in range(lq)]
    w = []
    for j in range(lb):
        s = x_b[..., j, :] * f["wx"][j]
        for i in range(lq):
            s = s + y[i] * f["wy"][i, j]
        w.append(_reduce64_np(s, f["b32"][j], f["b32_sh"][j], f["b_one_sh"][j], f["b"][j]))
    sa = sum(w[j] * f["ak"][j] for j in range(lb))
    msk = f["b"][nb]
    alpha = _reduce64_np(sa, f["b32"][nb], f["b32_sh"][nb], f["b_one_sh"][nb], msk)
    neg = alpha >= f["msk_half"][0]
    a_abs = np.where(neg, msk - alpha, alpha)
    out = []
    for i in range(lq):
        s = a_abs * np.where(neg, f["pbq"][i], f["npbq"][i])
        for j in range(nb):
            s = s + w[j] * f["mb"][j, i]
        out.append(_reduce64_np(s, f["q32"][i], f["q32_sh"][i], f["q_one_sh"][i], f["q"][i]))
    return np.stack(out, axis=-2).astype(np.uint32)


def lift_model(x, table, lq, lb):
    """G1's lift on uint64 residues [..., Lq, N] over its packed table:
    (q.to_mont(x), bsk.to_mont(ExactLiftConv(x)))."""
    f = _fields(table, rns.LIFT_LAYOUT)
    out_q = [_shoup_np(x[..., i, :], f["qm"][i], f["qm_sh"][i], f["q"][i]) for i in range(lq)]
    c = [_shoup_np(x[..., i, :], f["c"][i], f["c_sh"][i], f["q"][i]) for i in range(lq)]
    c16 = sum((ci & np.uint64(0xFFFF)) * f["phat_mt"][i] for i, ci in enumerate(c)) & M32
    s = ((c16 & np.uint64(0xFFFF)) * f["q_inv_mt"][0]) & np.uint64(0xFFFF)
    rr = (np.uint64(0x10000) - s) & np.uint64(0xFFFF)
    neg = rr >= np.uint64(0x8000)
    r_abs = np.where(neg, np.uint64(0x10000) - rr, rr)
    out_b = []
    for j in range(lb):
        acc = r_abs * np.where(neg, f["kn"][j], f["k"][j])
        for i in range(lq):
            acc = acc + c[i] * f["ma"][i, j]
        out_b.append(_reduce64_np(acc, f["b32"][j], f["b32_sh"][j], f["b_one_sh"][j],
                                  f["b"][j]))
    return (np.stack(out_q, axis=-2).astype(np.uint32),
            np.stack(out_b, axis=-2).astype(np.uint32))


@pytest.mark.parametrize("name", SETS)
@pytest.mark.parametrize("fill", FILLS)
def test_scaledown_model_matches_plain(name, fill):
    """G3's lazy sums and reductions equal ``scaledown_plain`` bit for bit at
    every level, with the multiply's Bsk and a widened one, and with
    Shenoy-Kumaresan's alpha at its thresholds."""
    _, port = ctxs(name)
    for lvl in range(1, port.q.k + 1):
        for extra in (0, 5):
            sd = port._mul_ctx(lvl, extra)["scale"]
            xq = _residues((2, 3, lvl, port.n), sd.q.primes, lvl, fill)
            xb = _residues((2, 3, sd.bsk.k, port.n), sd.bsk.primes, lvl + 1, fill)
            want = to_u32(behz.scaledown_plain(_t(xq), _t(xb), sd))
            got = scaledown_model(xq.astype(np.uint64), xb.astype(np.uint64), sd.table, lvl,
                                  sd.bsk.k)
            assert np.array_equal(got, want)
    lvl = port.q.k
    sd = port._mul_ctx(lvl)["scale"]
    half, msk = sd.sk_conv.msk_half, sd.sk_conv.m_sk
    xq, xb = _scaledown_at(port, lvl, [half - 1, half, half + 1, 0, msk - 1], seed=5)
    got = scaledown_model(to_u32(xq).astype(np.uint64), to_u32(xb).astype(np.uint64),
                          sd.table, lvl, sd.bsk.k)
    assert np.array_equal(got, to_u32(behz.scaledown_plain(xq, xb, sd)))


@pytest.mark.parametrize("name", SETS)
@pytest.mark.parametrize("fill", FILLS)
def test_lift_model_matches_plain(name, fill):
    """The lift's lazy sums and reductions equal ``lift_plain`` bit for bit
    at every level, with the multiply's Bsk and a widened one, and with the
    m~ correction at its thresholds."""
    _, port = ctxs(name)
    for lvl in range(1, port.q.k + 1):
        for extra in (0, 5):
            lift = port._mul_ctx(lvl, extra)["lift"]
            x = _residues((2, 3, lvl, port.n), lift.src.primes, lvl + extra, fill)
            want_q, want_b = behz.lift_plain(_t(x), lift)
            got_q, got_b = lift_model(x.astype(np.uint64), lift.table, lvl, lift.dst.k)
            assert np.array_equal(got_q, to_u32(want_q)) and np.array_equal(got_b, to_u32(want_b))
    lvl = port.q.k
    lift = port._mul_ctx(lvl)["lift"]
    x = _lift_at(port, lvl, [0x7FFF, 0x8000, 0x8001, 0, 0xFFFF], seed=3)
    got_b = lift_model(x.astype(np.uint64), lift.table, lvl, lift.dst.k)[1]
    assert np.array_equal(got_b, to_u32(behz.lift_plain(_t(x), lift)[1]))


@functools.lru_cache(maxsize=None)
def _every_mul_ctx():
    """(file, level, extra_bits, the port's multiply context) of every
    parameter file at every level, with the multiply's Bsk and the widened
    Bsk of every multiply-sum a path can ask for: extra_bits up to
    ⌈log2 nh⌉ of the largest PS evaluation's outer sum (nh high powers)."""
    files = sorted(glob.glob("parameters/*.json"))
    most = 0
    for f in files:
        d = json.load(open(f))
        low = d["query_params"]["ps_low_degree"]
        if low:
            nh = d["table_params"]["max_items_per_bin"] // (low + 1)
            most = max(most, max(1, (nh - 1).bit_length()))
    out = []
    for f in files:
        port = BfvContext(PSUParams.load_file(f).seal_params, device="cpu")
        for lvl in range(1, port.q.k + 1):
            for extra in range(most + 1):
                out.append((f, lvl, extra, port._mul_ctx(lvl, extra)))
    return out


def test_exact_builds_cover_every_parameter_file():
    """Every (q limbs, Bsk limbs) pair that a parameter file reaches is one
    that G3 and the lift are built for exactly (``behz.exact_pairs()``,
    csrc/behz.cuh's BEHZ_EXACT_PAIRS), and the list has no pair that none
    reaches; the tests' 9-limb chain takes the general build."""
    reached = {(lvl, mc["bsk"].k) for _, lvl, _, mc in _every_mul_ctx()}
    assert reached == behz.exact_pairs()
    assert all(lq <= behz.MAXQ and lb <= behz.MAXB for lq, lb in reached)


def test_lazy_sums_fit_64_bits():
    """The largest u64 sum G3 and the lift can form, every input at its
    largest residue, stays below 2^64 on every parameter file, level and
    Bsk (and below 2^63, so the bound is not a near miss)."""
    worst = 0
    for _, lvl, _, mc in _every_mul_ctx():
        f = {k: v.astype(object) for k, v in _fields(mc["scale"].table, rns.SCALE_LAYOUT).items()}
        q, b = f["q"][:lvl], f["b"][: mc["bsk"].k]
        lb, nb = len(b), len(b) - 1
        for j in range(lb):
            worst = max(worst, (b[j] - 1) * f["wx"][j]
                        + sum((q[i] - 1) * f["wy"][i, j] for i in range(lvl)))
        worst = max(worst, sum((b[j] - 1) * f["ak"][j] for j in range(lb)))
        for i in range(lvl):
            worst = max(worst, (b[nb] - 1) // 2 * max(f["pbq"][i], f["npbq"][i])
                        + sum((b[j] - 1) * f["mb"][j, i] for j in range(nb)))
        g = {k: v.astype(object) for k, v in _fields(mc["lift"].table, rns.LIFT_LAYOUT).items()}
        for j in range(lb):
            worst = max(worst, (1 << 15) * max(g["k"][j], g["kn"][j])
                        + sum((q[i] - 1) * g["ma"][i, j] for i in range(lvl)))
    assert worst < 1 << 63


# ---------------------------------------------------------------------------
# G4
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", SETS)
@pytest.mark.parametrize("fill", FILLS)
def test_keyswitch_div_matches_reference(name, fill):
    """(c0, c1) + round(from_mont(u) / P) at the top level and level 1,
    the ciphertext a 3-component tensor."""
    ref, port = ctxs(name)
    for lvl in sorted({1, port.q.k}):
        rqp, rdiv, rq = ref._qp_level(lvl), ref._div_p_level(lvl), ref.levels[lvl]
        u = _residues((2, 2, lvl + 1, port.n), rqp.primes, lvl, fill)
        data = _residues((2, 3, lvl, port.n), port.q_primes[:lvl], lvl + 1, fill)

        def ref_new(uu, dd):
            v = rqp.from_mont(uu)
            return rmod.add_mod(dd[..., :2, :, :], rdiv(v[..., :lvl, :], v[..., lvl:, :]),
                                rq.p_d)

        got = behz.keyswitch_div_plain(_t(u), _t(data), port._qp_level(lvl),
                                       port._div_p_level(lvl))
        assert _eq(_jit(ref_new, u, data), got)


@pytest.mark.parametrize("name", SETS)
@pytest.mark.parametrize("fill", FILLS)
def test_mod_switch_matches_reference(name, fill):
    """The rounded drops from every level to every lower one against the
    reference's ``mod_switch_to``."""
    ref, port = ctxs(name)
    for top in range(2, port.q.k + 1):
        x = _residues((2, 2, top, port.n), port.q_primes[:top], top, fill)
        for target in range(1, top):
            want = ref.mod_switch_to(RefCt(jnp.asarray(x), is_ntt=False, level=top), target)
            got = behz.mod_switch_plain(_t(x), port.div_drop, top, target)
            assert _eq(want.data, got)


# behz._rows: where G1 and G4 find each row of an operand on the card
# (csrc/behz.cuh's Rows); [4, 5, 2, 3, 8] stands for [rows, nh+1, comp, L, N]
ROW_VIEWS = {
    "contiguous": lambda b: b,
    "middle slice": lambda b: b[:, 1:],                          # the PS inner[:, 1:]
    "bundle blocks": lambda b: b[:, 1:].reshape(2, 2, 4, 2, 3, 8),   # its cpb > 1 form
    "broadcast": lambda b: b[:1].expand(3, 5, 2, 3, 8),
    "one row": lambda b: b[:1, :1, :1],
    "three runs": lambda b: b[:, 1::2],
}


@pytest.mark.parametrize("view", ROW_VIEWS)
def test_rows_address_views_in_place(view):
    """Each row r of a view's leading axes starts (r // inner) * outer +
    (r % inner) * stride past its first element; a view whose leading axes
    form at most two runs of uniform stride is read in place, one of three
    runs is copied."""
    x = ROW_VIEWS[view](torch.arange(4 * 5 * 2 * 3 * 8, dtype=torch.int32).reshape(4, 5, 2, 3, 8))
    y, rows, (inner, stride, outer) = behz._rows(x, 2)
    assert torch.equal(y, x) and rows == x[..., 0, 0].numel()
    assert (y.data_ptr() == x.data_ptr()) == (view != "three runs")
    want = y.reshape(rows, 3, 8)
    for r in range(rows):
        off = y.storage_offset() + (r // inner) * outer + (r % inner) * stride
        assert torch.equal(y.as_strided((3, 8), y.stride()[-2:], off), want[r])


def test_in_place_operands_are_read_where_they_lie():
    """G5 writes into its first operand where it lies: ``_in_place`` takes
    what ``_rows`` reads in place and refuses what it would copy (three
    runs of leading axes, lanes not contiguous)."""
    base = torch.arange(4 * 5 * 2 * 3 * 8, dtype=torch.int32).reshape(4, 5, 2, 3, 8)
    for view, f in ROW_VIEWS.items():
        x = f(base)
        if view == "three runs":
            with pytest.raises(ValueError, match="in place"):
                behz._in_place(x, 2, "g5")
        else:
            y, rows, where = behz._in_place(x, 2, "g5")
            assert y.data_ptr() == x.data_ptr() and (rows, where) == behz._rows(x, 2)[1:]
    with pytest.raises(ValueError, match="in place"):
        behz._in_place(base.transpose(-1, -2), 2, "g5")


# ---------------------------------------------------------------------------
# G5
# ---------------------------------------------------------------------------

G5_SETS = ["small", "1M-2048-cmp", "1M-2048-com", "16M-4096 at N=2048"]
# the constants c at t - 1 or 0, every residue p - 1, or the ciphertexts'
# planes a slice of a middle axis (its component 0 a view of two runs)
G5_FILLS = ["random", "c=t-1", "c=0", "p-1", "view"]


def _ref_g5(ref, lvl):
    """The reference's lines of the PS constant term at level ``lvl``
    (apsu_tpu/engine/evaluator.py:941-972): Δ·c, component 0 plus Δ·c,
    Montgomery Δ·c of planes 1.., acc[:, 1:]'s component 0 plus y, and
    tot[:, :2] plus component 0 of the ciphertexts."""
    q = ref.levels[lvl]

    def run(ct, c, y, tot):
        dm = ref._scale_impl(c, lvl)
        return (dm, rmod.add_mod(ct[:, :, 0], dm, q.p_d), q.to_mont(dm[:, 1:]),
                rmod.add_mod(ct[:, 1:, 0], y, q.p_d), rmod.add_mod(tot[:, :2], ct[:, 0], q.p_d))

    return run


@pytest.mark.parametrize("name", G5_SETS)
@pytest.mark.parametrize("fill", G5_FILLS)
def test_scale_add_matches_reference(name, fill):
    """G5's plain versions at the top level and level 1, on ciphertexts
    [R, P, 2, L, N] and constants c [R, P, N] < t: ``delta`` is the
    reference's ``_scale_impl``; ``delta_add`` into component 0 (with the
    Montgomery form of planes 1.. and without) and ``add_into`` (into
    component 0 of ct[:, 1:], into tot[:, :2]) write the reference's sums
    into the views they are given and nothing else."""
    ref, port = ctxs(name)
    t, n, R, P = port.t, port.n, 2, 3
    rng = np.random.default_rng(P * n + t)
    c = {"c=t-1": np.full((R, P, n), t - 1), "c=0": np.zeros((R, P, n))}.get(
        fill, rng.integers(0, t, size=(R, P, n))).astype(np.uint32)
    res = "p-1" if fill == "p-1" else None
    for lvl in sorted({1, port.q.k}):
        ds, primes = port.delta[lvl], port.q_primes[:lvl]
        lead = 1 if fill == "view" else 0
        full = _residues((R, P + lead, 2, lvl, n), primes, lvl, res)
        ct = full[:, lead:]
        y = _residues((R, P - 1, lvl, n), primes, lvl + 1, res)
        tot = _residues((R, 3, lvl, n), primes, lvl + 2, res)
        dm, c0, mont, lhs0, tot2 = _jit(_ref_g5(ref, lvl), ct, c, y, tot)
        assert _eq(dm, behz.delta_plain(_t(c), ds))
        for skip in (1, None):
            x = _t(full).clone()
            xv = x[:, lead:]
            got, got_mont = behz.delta_add_plain(xv[:, :, 0], _t(c), ds, skip)
            assert got.data_ptr() == xv[:, :, 0].data_ptr() and _eq(c0, xv[:, :, 0])
            assert _eq(mont, got_mont) if skip else got_mont is None
            assert np.array_equal(to_u32(xv[:, :, 1]), ct[:, :, 1])
            assert np.array_equal(to_u32(x[:, :lead]), full[:, :lead])
        x = _t(full).clone()
        behz.add_into_plain(x[:, lead:][:, 1:, 0], _t(y), ds)
        assert _eq(lhs0, x[:, lead:][:, 1:, 0])
        x[:, lead:][:, 1:, 0] = _t(ct[:, 1:, 0])
        assert np.array_equal(to_u32(x), full)
        z = _t(tot).clone()
        assert behz.add_into_plain(z[:, :2], _t(ct)[:, 0], ds).data_ptr() == z.data_ptr()
        assert _eq(tot2, z[:, :2]) and np.array_equal(to_u32(z[:, 2]), tot[:, 2])


def scale_add_model(m, x, table, lq, period, skip):
    """G5's scale-add as the kernel computes it, on uint64 arrays over its
    packed table: m [rows, N] < t, x [rows, Lq, N] -> (x + Δ·m, the
    Montgomery form of Δ·m of the rows r with r % period >= skip, in order)."""
    f = _fields(table, rns.DELTA_LAYOUT)
    t = f["t"][0]
    rm = _shoup_np(m, f["rt"][0], f["rt_sh"][0], t)
    rem = np.where(rm + f["h"][0] >= t, rm + f["h"][0] - t, rm + f["h"][0])
    out_x, out_m = [], []
    for j in range(lq):
        qj = f["q"][j]
        d = np.where(f["hq"][j] >= rem, f["hq"][j] - rem, f["hq"][j] + qj - rem)
        v = _shoup_np(d, f["tinv"][j], f["tinv_sh"][j], qj)
        s = x[:, j] + v
        out_x.append(np.where(s >= qj, s - qj, s))
        out_m.append(_shoup_np(v, f["r1"][j], f["r1_sh"][j], qj))
    keep = np.arange(m.shape[0]) % period >= skip
    return (np.stack(out_x, axis=1).astype(np.uint32),
            np.stack(out_m, axis=1)[keep].astype(np.uint32))


@pytest.mark.parametrize("name", G5_SETS)
def test_scale_add_model_matches_plain(name):
    """G5's arithmetic over its packed table (``DeltaScale.table``) equals
    ``delta_add_plain`` bit for bit at every level, c at 0, t - 1 and
    random, x at p - 1 and random: the table holds the plain version's
    constants."""
    _, port = ctxs(name)
    t, n, R, P = port.t, port.n, 3, 4
    c = np.random.default_rng(t).integers(0, t, size=(R, P, n)).astype(np.uint32)
    c[0], c[1, :, : n // 2] = t - 1, 0
    for lvl in range(1, port.q.k + 1):
        ds = port.delta[lvl]
        x = _residues((R, P, lvl, n), port.q_primes[:lvl], lvl)
        x[2] = _residues((P, lvl, n), port.q_primes[:lvl], 0, "p-1")
        xt = _t(x).clone()
        _, mont = behz.delta_add_plain(xt, _t(c), ds, 1)
        got_x, got_m = scale_add_model(c.reshape(R * P, n).astype(np.uint64),
                                       x.reshape(R * P, lvl, n).astype(np.uint64), ds.table,
                                       lvl, P, 1)
        assert np.array_equal(got_x, to_u32(xt).reshape(R * P, lvl, n))
        assert np.array_equal(got_m, to_u32(mont).reshape(R * (P - 1), lvl, n))
