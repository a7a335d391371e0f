"""RNS bases and base-conversion operators for the BFV multiply pipeline
(port of ``apsu_tpu/core/rns.py``).

* ``BaseConv`` is FastBConv (Bajard–Eynard–Hasan–Zucca): the uncorrected CRT
  recombination, overshooting by α·Q with 0 ≤ α < k;
* ``ExactLiftConv`` is the m̃-corrected lift (m̃ = 2^16) used for BEHZ
  multiply operands: x ∈ [0, Q) lifts to x or x − Q;
* ``ShenoyKumaresanConv`` is the exact conversion back from Bsk to q through
  the m_sk channel;
* ``ExactDiv`` is exact (rounded) division by one of the base's own moduli —
  the mod-down of key switching and mod-switch;
* ``DeltaScale`` holds the constants of BFV's plaintext scaling
  round(Q·m/t) mod q_j.

Residue tensors ``[..., k, N]`` are PLAIN (non-Montgomery) int32 at the
boundaries of every operator; Montgomery factors are folded into constants.
Each operator's ``__call__`` is the plain int64 arithmetic, the step the glue
kernels' plain versions (``ops/behz.py``) are composed of; the classes also
hold the kernels' constant tables (``table``, ``RnsBase.to_mont_table`` ...):
u32 arrays in the field order of ``csrc/behz.cuh``, which each launch passes
to its kernel by value.
"""

from __future__ import annotations

import functools
from typing import Sequence

import numpy as np
import torch

from apsu_tpu_torch.core.mod32 import (
    I32,
    I64,
    add_mod,
    col,
    from_u32,
    prime_consts,
    shoup_mul,
    shoup_pair,
    sub_mod,
)
from apsu_tpu_torch.core.ntt import NttContext
from apsu_tpu_torch.device import resolve
from apsu_tpu_torch.ops import behz
from apsu_tpu_torch.ops.behz import MAXB, MAXL, MAXQ

R32 = 1 << 32
# each table's fields in csrc/behz.cuh's order, as (name, shape) of u32 words
LIFT_LAYOUT = (("q", (MAXQ,)), ("qm", (MAXQ,)), ("qm_sh", (MAXQ,)), ("c", (MAXQ,)),
               ("c_sh", (MAXQ,)), ("phat_mt", (MAXQ,)), ("q_inv_mt", (1,)), ("b", (MAXB,)),
               ("m", (MAXQ, MAXB)), ("m_sh", (MAXQ, MAXB)), ("a", (MAXB,)), ("a_sh", (MAXB,)),
               ("k", (MAXB,)), ("k_sh", (MAXB,)), ("ma", (MAXQ, MAXB)), ("kn", (MAXB,)),
               ("b32", (MAXB,)), ("b32_sh", (MAXB,)), ("b_one_sh", (MAXB,)))
MOD_LAYOUT = (("p", (MAXL,)), ("pni", (MAXL,)))
SCALE_LAYOUT = (("q", (MAXQ,)), ("yq", (MAXQ,)), ("yq_sh", (MAXQ,)), ("b", (MAXB,)),
                ("xb", (MAXB,)), ("xb_sh", (MAXB,)), ("m", (MAXQ, MAXB)), ("m_sh", (MAXQ, MAXB)),
                ("qinv", (MAXB,)), ("qinv_sh", (MAXB,)), ("zb", (MAXB,)), ("zb_sh", (MAXB,)),
                ("mb", (MAXB, MAXQ)), ("mb_sh", (MAXB, MAXQ)), ("msk_b", (MAXB,)),
                ("msk_b_sh", (MAXB,)), ("pbinv", (1,)), ("pbinv_sh", (1,)), ("msk_half", (1,)),
                ("pbq", (MAXQ,)), ("pbq_sh", (MAXQ,)), ("wx", (MAXB,)), ("wy", (MAXQ, MAXB)),
                ("ak", (MAXB,)), ("npbq", (MAXQ,)), ("q32", (MAXQ,)), ("q32_sh", (MAXQ,)),
                ("q_one_sh", (MAXQ,)), ("b32", (MAXB,)), ("b32_sh", (MAXB,)),
                ("b_one_sh", (MAXB,)))
DIV_LAYOUT = (("q", (MAXQ,)), ("rinv", (MAXQ,)), ("rinv_sh", (MAXQ,)), ("one_sh", (MAXQ,)),
              ("half", (MAXQ,)), ("half_q", (MAXQ, MAXQ)), ("dinv", (MAXQ, MAXQ)),
              ("dinv_sh", (MAXQ, MAXQ)))
DELTA_LAYOUT = (("q", (MAXQ,)), ("t", (1,)), ("rt", (1,)), ("rt_sh", (1,)), ("h", (1,)),
                ("hq", (MAXQ,)), ("tinv", (MAXQ,)), ("tinv_sh", (MAXQ,)), ("r1", (MAXQ,)),
                ("r1_sh", (MAXQ,)))


def pack_table(layout, **fields) -> np.ndarray:
    """A kernel's constant table: u32 words in ``layout``'s order, each field
    given as a (possibly smaller) array written into the leading corner of
    its slot, the rest zero."""
    unknown = set(fields) - {name for name, _ in layout}
    if unknown:
        raise KeyError(f"no such table fields: {sorted(unknown)}")
    out = []
    for name, shape in layout:
        slot = np.zeros(shape, np.uint32)
        if name in fields:
            v = np.asarray(fields[name], np.uint64)
            if v.size and int(v.max()) >= R32:
                raise ValueError(f"table field {name} does not fit 32 bits")
            if len(shape) == 1:
                slot[: v.size] = v.reshape(-1)
            else:
                slot[: v.shape[0], : v.shape[1]] = v
        out.append(slot.reshape(-1))
    return np.concatenate(out)


def _shoup_fields(name, consts, primes) -> dict:
    """Table fields ``name`` (c mod p) and ``name_sh`` (⌊c·2^32/p⌋) per limb."""
    c = np.array([int(v) % int(p) for v, p in zip(consts, primes)], dtype=np.uint32)
    return {name: c, name + "_sh": shoup_pair(c, np.array(primes, dtype=np.uint32))}


def _reduce_fields(name, primes) -> dict:
    """Table fields of ``behz.cuh``'s reduce64 per limb: ``name``32 (2^32 mod
    p), ``name``32_sh and ``name``_one_sh (⌊2^32/p⌋)."""
    one = shoup_pair(np.ones(len(primes), np.uint32), np.array(primes, dtype=np.uint32))
    return {**_shoup_fields(name + "32", [R32 % p for p in primes], primes),
            name + "_one_sh": one}


def shoup_cols(consts, primes, device):
    """Per-limb constant columns (c, c') as [k, 1] int64 tensors for
    shoup_mul."""
    c = np.array([v % p for v, p in zip(consts, primes)], dtype=np.uint32)
    sh = shoup_pair(c, np.array(primes, dtype=np.uint32))
    return col(c, device), col(sh, device)


class RnsBase:
    """A prime basis {p_1..p_k} with CRT constants and an NTT context."""

    def __init__(self, primes: Sequence[int], n: int, device="cuda"):
        self.primes = [int(p) for p in primes]
        self.k = len(self.primes)
        self.n = n
        self.device = resolve(device)
        self._ntt: NttContext | None = None  # lazy: table build is O(k·N) host work
        self.prod = 1
        for p in self.primes:
            self.prod *= p
        self.phat = [self.prod // p for p in self.primes]
        self.phat_inv = [pow(ph % p, -1, p) for ph, p in zip(self.phat, self.primes)]
        c = prime_consts(self.primes)
        dev = self.device
        self.p_d = col(c.p, dev)
        self.pni_d = col(c.p_neg_inv, dev)
        # the same constants as uint32 bits for the kernels
        if dev.type == "cuda":
            self.p_u32 = from_u32(c.p, dev)
            self.pni_u32 = from_u32(c.p_neg_inv, dev)
        R = 1 << 32
        self.r1_sh = shoup_cols([R % p for p in self.primes], self.primes, dev)
        self.rinv_sh = shoup_cols([pow(R, -1, p) for p in self.primes], self.primes, dev)
        self.phat_inv_sh = shoup_cols(self.phat_inv, self.primes, dev)

    # the glue kernels' tables, built at a kernel's first launch: G1's
    # per-limb constant multiply by R (to_mont) and R^{-1} (from_mont), G2's
    # primes
    @functools.cached_property
    def to_mont_table(self) -> np.ndarray:
        return pack_table(LIFT_LAYOUT, b=self.primes,
                          **_shoup_fields("a", [R32 % p for p in self.primes], self.primes))

    @functools.cached_property
    def from_mont_table(self) -> np.ndarray:
        return pack_table(LIFT_LAYOUT, b=self.primes,
                          **_shoup_fields("a", [pow(R32, -1, p) for p in self.primes],
                                          self.primes))

    @functools.cached_property
    def mod_table(self) -> np.ndarray:
        c = prime_consts(self.primes)
        return pack_table(MOD_LAYOUT, p=c.p, pni=c.p_neg_inv)

    @property
    def ntt(self) -> NttContext:
        if self._ntt is None:
            self._ntt = NttContext(self.primes, self.n, self.device)
        return self._ntt

    # -- residue decomposition of big ints (host) ---------------------------
    def compose(self, x: np.ndarray) -> np.ndarray:
        """Residues [..., k, N] -> big-int object array [..., N] in [0, prod)."""
        out = np.zeros(x.shape[:-2] + (x.shape[-1],), dtype=object)
        for i, p in enumerate(self.primes):
            coef = self.phat[i] * self.phat_inv[i] % self.prod
            out = out + x[..., i, :].astype(object) * coef
        return out % self.prod

    def to_mont(self, x):
        """x·R mod p (Shoup by the constant R mod p; G1 on the card)."""
        return behz.scale(x, self)

    def from_mont(self, x):
        """x·R^{-1} mod p (Shoup by the constant R^{-1} mod p; G1 on the card)."""
        return behz.scale(x, self, inverse=True)


def _phat_mod_dst(src: RnsBase, dst: RnsBase):
    m = np.zeros((src.k, dst.k), dtype=np.uint32)
    for i, ph in enumerate(src.phat):
        for j, d in enumerate(dst.primes):
            m[i, j] = ph % d
    sh = shoup_pair(m, np.array(dst.primes, np.uint32)[None, :])
    dev = dst.device
    return col(m, dev, (src.k, dst.k, 1)), col(sh, dev, (src.k, dst.k, 1))


class BaseConv:
    """FastBConv from base ``src`` to base ``dst``:
    out_j = Σ_i [x_i · p̂_i^{-1}]_{p_i} · [p̂_i]_{d_j}  (mod d_j),
    which represents x + α·(src.prod) for some 0 ≤ α < src.k."""

    def __init__(self, src: RnsBase, dst: RnsBase):
        self.src = src
        self.dst = dst
        self.phat_mod_dst, self.phat_mod_dst_sh = _phat_mod_dst(src, dst)

    def __call__(self, x):
        """x: [..., ks, N] plain residues -> [..., kd, N] plain residues."""
        src, dst = self.src, self.dst
        y = shoup_mul(x, *src.phat_inv_sh, src.p_d)  # [..., ks, N]
        out = torch.zeros(x.shape[:-2] + (dst.k, x.shape[-1]), dtype=I32, device=x.device)
        for i in range(src.k):
            term = shoup_mul(
                y[..., i: i + 1, :], self.phat_mod_dst[i], self.phat_mod_dst_sh[i], dst.p_d
            )
            out = add_mod(out, term, dst.p_d)
        return out


class ExactLiftConv:
    """m̃-corrected base conversion (the role of SEAL's sm_mrq step): lifts
    x ∈ [0, Q) into dst as x + u·Q with u ∈ {−1, 0}.

    With m̃ = 2^16, c_i = [m̃·x·p̂_i^{-1}]_{p_i} make y = Σ c_i·p̂_i =
    m̃·x + (α−β)·Q; the centered r = [−y·Q^{-1}]_{m̃} makes each dst residue
    (y + r·Q)·m̃^{-1} represent x or x − Q."""

    def __init__(self, src: RnsBase, dst: RnsBase):
        mt = 1 << 16
        self.src = src
        self.dst = dst
        Q = src.prod
        dev = dst.device
        self.mt_phat_inv_sh = shoup_cols(
            [mt * inv % p for inv, p in zip(src.phat_inv, src.primes)],
            src.primes, src.device,
        )
        self.phat_mod_dst, self.phat_mod_dst_sh = _phat_mod_dst(src, dst)
        self.phat_mod_mt = [ph % mt for ph in src.phat]
        self.q_inv_mt = pow(Q % mt, -1, mt)
        self.mtinv_sh = shoup_cols([pow(mt, -1, d) for d in dst.primes], dst.primes, dev)
        self.q_mtinv_sh = shoup_cols(
            [Q % d * pow(mt, -1, d) % d for d in dst.primes], dst.primes, dev
        )

    @functools.cached_property
    def table(self) -> np.ndarray:
        """G1's: src's to_mont for the q output, and the lift with dst's R
        folded into its two last constants (the output is dst.to_mont of
        the lift).  The first design (``csrc/compare/glue_pr12_lift.cu`` at
        f5d52af) reads ``m`` then ``a`` and ``k``; the kernel's one lazy sum
        a limb reads ``ma`` (``m`` times ``a``), ``k`` and ``kn`` (−``k``)
        and reduce64's constants."""
        src, dst, mt = self.src, self.dst, 1 << 16
        qs, bs, Q = src.primes, dst.primes, src.prod
        m = np.array([[ph % d for d in bs] for ph in src.phat], dtype=np.uint32)
        a = [pow(mt, -1, d) * R32 % d for d in bs]
        k = [Q % d * pow(mt, -1, d) * R32 % d for d in bs]
        return pack_table(
            LIFT_LAYOUT, q=qs, phat_mt=self.phat_mod_mt, q_inv_mt=[self.q_inv_mt], b=bs, m=m,
            m_sh=shoup_pair(m, np.array(bs, np.uint32)[None, :]),
            **_shoup_fields("qm", [R32 % p for p in qs], qs),
            **_shoup_fields("c", [mt * inv % p for inv, p in zip(src.phat_inv, qs)], qs),
            ma=[[ph % d * a_j % d for d, a_j in zip(bs, a)] for ph in src.phat],
            kn=[(d - k_j) % d for d, k_j in zip(bs, k)],
            **_shoup_fields("a", a, bs), **_shoup_fields("k", k, bs), **_reduce_fields("b", bs))

    def __call__(self, x):
        """x: [..., ks, N] plain residues mod src -> [..., kd, N] plain
        residues of x + u·Q, u ∈ {−1, 0}."""
        src, dst = self.src, self.dst
        c = shoup_mul(x, *self.mt_phat_inv_sh, src.p_d)
        out = torch.zeros(x.shape[:-2] + (dst.k, x.shape[-1]), dtype=I32, device=x.device)
        c16 = torch.zeros(x.shape[:-2] + (1, x.shape[-1]), dtype=I64, device=x.device)
        mask16 = 0xFFFF
        for i in range(src.k):
            ci = c[..., i: i + 1, :]
            term = shoup_mul(ci, self.phat_mod_dst[i], self.phat_mod_dst_sh[i], dst.p_d)
            out = add_mod(out, term, dst.p_d)
            c16 = c16 + (ci.to(I64) & mask16) * self.phat_mod_mt[i]
        # r = [−y·Q^{-1}]_{m̃}, centered into [−m̃/2, m̃/2)
        s = ((c16 & mask16) * self.q_inv_mt) & mask16
        r = ((1 << 16) - s) & mask16
        neg = r >= (1 << 15)
        r_abs = torch.where(neg, (1 << 16) - r, r)  # [..., 1, N]
        a1 = shoup_mul(out, *self.mtinv_sh, dst.p_d)
        corr = shoup_mul(r_abs, *self.q_mtinv_sh, dst.p_d)
        return torch.where(neg, sub_mod(a1, corr, dst.p_d), add_mod(a1, corr, dst.p_d))


class ShenoyKumaresanConv:
    """Exact conversion from Bsk = B ∪ {m_sk} back to q:
    ŷ_q = FastBConv(y_B → q), ŷ_sk = FastBConv(y_B → m_sk),
    α = [(ŷ_sk − y_sk)·prod(B)^{-1}]_{m_sk} (centered), out = ŷ_q − α·[prod(B)]_q."""

    def __init__(self, bsk: RnsBase, q: RnsBase, n: int):
        self.bsk = bsk
        self.q = q
        dev = q.device
        b_primes = bsk.primes[:-1]
        self.m_sk = bsk.primes[-1]
        self.B = RnsBase(b_primes, n, dev)
        self.conv_b_to_q = BaseConv(self.B, q)
        self.conv_b_to_sk = BaseConv(self.B, RnsBase([self.m_sk], n, dev))
        msk = self.m_sk
        self.prodB_inv_sk_sh = shoup_cols([pow(self.B.prod % msk, -1, msk)], [msk], dev)
        self.msk_d = col([msk], dev)
        self.prodB_mod_q_sh = shoup_cols([self.B.prod % p for p in q.primes], q.primes, dev)
        self.msk_half = (self.m_sk + 1) // 2

    def __call__(self, y):
        """y: [..., kb+1, N] plain residues in Bsk -> [..., kq, N] mod q."""
        y_b = y[..., :-1, :]
        y_sk = y[..., -1:, :]
        yhat_q = self.conv_b_to_q(y_b)                      # [..., kq, N]
        yhat_sk = self.conv_b_to_sk(y_b)                    # [..., 1, N]
        diff = sub_mod(yhat_sk, y_sk, self.msk_d)
        alpha = shoup_mul(diff, *self.prodB_inv_sk_sh, self.msk_d)
        # alpha is centered: values >= msk/2 represent alpha - m_sk (negative)
        neg = alpha >= self.msk_half
        alpha_abs = torch.where(neg, self.msk_d - alpha, alpha.to(I64))  # [..., 1, N]
        q = self.q
        term = shoup_mul(alpha_abs, *self.prodB_mod_q_sh, q.p_d)  # plain
        out_minus = sub_mod(yhat_q, term, q.p_d)
        out_plus = add_mod(yhat_q, term, q.p_d)
        return torch.where(neg, out_plus, out_minus)


class ScaleDown:
    """BEHZ's scale-down of a tensor product x (in q and in Bsk): the t/Q fast
    floor in Bsk, y = (t·x_B − FastBConv(t·x_q → Bsk))·Q^{-1}, then the
    Shenoy–Kumaresan conversion of y back to q.  ``__call__`` takes plain
    residues; ``table`` is G3's (``csrc/behz_scaledown.cu``), which takes
    Montgomery ones, so its first constants carry R^{-1}."""

    def __init__(self, q: RnsBase, bsk: RnsBase, t: int):
        dev = q.device
        self.q, self.bsk, self.t = q, bsk, t
        self.conv = BaseConv(q, bsk)
        self.sk_conv = ShenoyKumaresanConv(bsk, q, q.n)
        self.t_sh_q = shoup_cols([t] * q.k, q.primes, dev)
        self.t_sh_bsk = shoup_cols([t] * bsk.k, bsk.primes, dev)
        self.qinv_sh_bsk = shoup_cols([pow(q.prod % p, -1, p) for p in bsk.primes],
                                      bsk.primes, dev)

    @functools.cached_property
    def table(self) -> np.ndarray:
        """G3's: the first design (``csrc/compare/glue_pr12_scaledown.cu`` at
        f5d52af) reads the fields up to ``pbq_sh``; the kernel takes one lazy
        sum for each output, whose constants fold the steps between: w_j =
        x_b,j·wx_j + Σ_i y_i·wy_ij is z_j (j below m_sk, the fast floor times
        B̂_j^{-1}) or y_sk, α = Σ_j w_j·ak_j, and out_i = Σ_j z_j·mb_ji +
        |α|·(pbq_i or npbq_i)."""
        q, bsk, sk, t = self.q, self.bsk, self.sk_conv, self.t
        qs, bs, B, msk = q.primes, bsk.primes, sk.B, sk.m_sk
        m = np.array([[ph % d for d in bs] for ph in q.phat], dtype=np.uint32)
        mb = np.array([[ph % p for p in qs] for ph in B.phat], dtype=np.uint32)
        # Q^{-1} (times B̂_j^{-1} below m_sk) mod b_j, and prod(B)^{-1} mod m_sk
        f = [pow(q.prod % d, -1, d) * (inv if j < B.k else 1) % d
             for j, (d, inv) in enumerate(zip(bs, B.phat_inv + [1]))]
        pbinv = pow(B.prod % msk, -1, msk)
        return pack_table(
            SCALE_LAYOUT, q=qs, b=bs, m=m, m_sh=shoup_pair(m, np.array(bs, np.uint32)[None, :]),
            mb=mb, mb_sh=shoup_pair(mb, np.array(qs, np.uint32)[None, :]),
            msk_half=[sk.msk_half],
            **_shoup_fields("yq", [t * pow(R32, -1, p) * inv for p, inv in zip(qs, q.phat_inv)],
                            qs),
            **_shoup_fields("xb", [t * pow(R32, -1, d) for d in bs], bs),
            **_shoup_fields("qinv", [pow(q.prod % d, -1, d) for d in bs], bs),
            **_shoup_fields("zb", B.phat_inv, B.primes),
            **_shoup_fields("msk_b", [ph % msk for ph in B.phat], [msk] * B.k),
            **_shoup_fields("pbinv", [pow(B.prod % msk, -1, msk)], [msk]),
            **_shoup_fields("pbq", [B.prod % p for p in qs], qs),
            wx=[t * pow(R32, -1, d) * f_j % d for d, f_j in zip(bs, f)],
            wy=[[(-ph) * f_j % d for d, f_j in zip(bs, f)] for ph in q.phat],
            ak=[ph % msk * pbinv % msk for ph in B.phat] + [-pbinv % msk],
            npbq=[-B.prod % p for p in qs], **_reduce_fields("q", qs),
            **_reduce_fields("b", bs))

    def __call__(self, x_q, x_b):
        """x_q [..., kq, N], x_b [..., kb, N] plain -> [..., kq, N] plain."""
        q, bsk = self.q, self.bsk
        xt_q = shoup_mul(x_q, *self.t_sh_q, q.p_d)
        xt_b = shoup_mul(x_b, *self.t_sh_bsk, bsk.p_d)
        y_b = shoup_mul(sub_mod(xt_b, self.conv(xt_q), bsk.p_d), *self.qinv_sh_bsk, bsk.p_d)
        return self.sk_conv(y_b)


class ExactDiv:
    """Round-to-nearest division of an RNS integer by one of its own moduli
    d: x + ⌊d/2⌋ first, then the exact floor(x/d) mod q_j =
    (x_j − [x_d]_{q_j})·d^{-1} mod q_j."""

    def __init__(self, q: RnsBase, d: int):
        self.q = q
        self.d = int(d)
        dev = q.device
        self.d_inv_sh = shoup_cols([pow(self.d % p, -1, p) for p in q.primes], q.primes, dev)
        half = self.d >> 1
        self.half_mod_q = col([half % p for p in q.primes], dev)
        self.half = half
        self.one_sh = shoup_cols([1] * q.k, q.primes, dev)

    @functools.cached_property
    def table(self) -> np.ndarray:
        """G4's: the chain q_0..q_{k-1}, d; row dd of the matrices divides by
        limb dd (every dd >= 1), so a mod-switch from this base's level + 1
        down to any level reads this one table."""
        primes = self.q.primes + [self.d]
        k = len(primes)
        half_q = np.zeros((k, k), np.uint64)
        dinv = np.zeros((k, k), np.uint64)
        for dd in range(1, k):
            for j in range(dd):
                half_q[dd, j] = (primes[dd] >> 1) % primes[j]
                dinv[dd, j] = pow(primes[dd], -1, primes[j])
        return pack_table(
            DIV_LAYOUT, q=primes, half=[p >> 1 for p in primes], half_q=half_q, dinv=dinv,
            dinv_sh=shoup_pair(dinv.astype(np.uint32), np.array(primes, np.uint32)[None, :]),
            one_sh=shoup_pair(np.ones(k, np.uint32), np.array(primes, np.uint32)),
            **_shoup_fields("rinv", [pow(R32, -1, p) for p in primes], primes))

    def __call__(self, x_q, x_d):
        """x_q: [..., kq, N] residues mod q; x_d: [..., 1, N] residue mod d."""
        q = self.q
        x_q = add_mod(x_q, self.half_mod_q, q.p_d)
        s = x_d.to(I64) + self.half
        x_d = torch.where(s >= self.d, s - self.d, s)
        # reduce x_d (integer < d) modulo each q_j: Shoup by the constant 1
        xd_q = shoup_mul(x_d, *self.one_sh, q.p_d)
        num = sub_mod(x_q, xd_q, q.p_d)
        return shoup_mul(num, *self.d_inv_sh, q.p_d)


class DeltaScale:
    """The constants of BFV's plaintext scaling Δ·m = round(Q·m/t) mod q_j
    at one level q (``core/bfv.py:_scale_impl``): (h − rem)·t^{-1} mod q_j
    with rem = (r·m + h) mod t, r = Q mod t, h = t >> 1.  The columns are
    uploaded here, once (an upload per call could not be captured into a
    CUDA graph), for the plain version (``ops/behz.py:delta_plain``);
    ``table`` is G5's (``csrc/scale_add.cu``)."""

    def __init__(self, q: RnsBase, t: int):
        self.q, self.t = q, int(t)
        self.h = self.t >> 1
        self.rt = q.prod % self.t
        self.rt_sh = int(shoup_pair(np.uint32(self.rt), np.uint32(self.t)))
        self.tinv = [pow(self.t % p, -1, p) for p in q.primes]
        self.hq = col([self.h % p for p in q.primes], q.device)
        self.tinv_sh = shoup_cols(self.tinv, q.primes, q.device)

    @functools.cached_property
    def table(self) -> np.ndarray:
        qs = self.q.primes
        return pack_table(
            DELTA_LAYOUT, q=qs, t=[self.t], rt=[self.rt], rt_sh=[self.rt_sh], h=[self.h],
            hq=[self.h % p for p in qs], **_shoup_fields("tinv", self.tinv, qs),
            **_shoup_fields("r1", [R32 % p for p in qs], qs))
