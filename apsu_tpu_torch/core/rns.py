"""RNS bases and base-conversion operators for the BFV multiply pipeline
(port of ``apsu_tpu/core/rns.py``).

* ``BaseConv`` is FastBConv (Bajard–Eynard–Hasan–Zucca): the uncorrected CRT
  recombination, overshooting by α·Q with 0 ≤ α < k;
* ``ExactLiftConv`` is the m̃-corrected lift (m̃ = 2^16) used for BEHZ
  multiply operands: x ∈ [0, Q) lifts to x or x − Q;
* ``ShenoyKumaresanConv`` is the exact conversion back from Bsk to q through
  the m_sk channel;
* ``ExactDiv`` is exact (rounded) division by one of the base's own moduli —
  the mod-down of key switching and mod-switch.

Residue tensors ``[..., k, N]`` are PLAIN (non-Montgomery) int32 at the
boundaries of every operator; Montgomery factors are folded into constants.
"""

from __future__ import annotations

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
        """x·R mod p (Shoup by the constant R mod p)."""
        return shoup_mul(x, *self.r1_sh, self.p_d)

    def from_mont(self, x):
        """x·R^{-1} mod p (Shoup by the constant R^{-1} mod p)."""
        return shoup_mul(x, *self.rinv_sh, self.p_d)


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
