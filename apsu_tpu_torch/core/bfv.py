"""RNS-BFV on int32 residue tensors (port of ``apsu_tpu/core/bfv.py``).

* Ciphertext data is ``[..., n_components, L, N]`` int32: PLAIN residues in
  the coefficient domain, Montgomery-form residues in the NTT domain
  (``Ciphertext.is_ntt``).
* ct×ct multiply is BEHZ: operands lifted exactly into an auxiliary base Bsk
  (``ExactLiftConv``), tensor in the NTT domain over q ∪ Bsk, t/Q fast floor,
  Shenoy–Kumaresan conversion back to q.
* Relinearization is RNS-gadget key switching with one digit per data limb
  and a special prime P; keys restrict exactly to any level prefix.
* Decryption is the BEHZ {t, γ} scale-and-round (``decrypt_device``); the
  host big-int CRT path (``decrypt``, ``noise_budget``) is the golden
  reference for tests.
* Fresh symmetric ciphertexts and relinearization keys can take their
  uniform ``a`` rows from a public 32-byte seed (``uniform_from_seed``), so
  the wire carries c0 / ksk[:, 0] plus the seed.

Randomness is drawn on the host from a ``numpy.random.Generator`` (or a
``CsRng``) in the reference's order, so one seed gives bit-identical keys,
ciphertexts and masks in both packages.  Every method runs eagerly.  The
glue of the multiply, multiply-sum, relinearization and mod-switch runs
through ``ops/behz.py`` (kernels G1–G4 on the card, their plain versions
on the CPU), with kernel 1's transforms between them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import List, Optional

import numpy as np
import torch

from apsu_tpu_torch.core import nt
from apsu_tpu_torch.core.mod32 import (
    I32,
    I64,
    add_mod,
    col,
    from_u32,
    mont_mul,
    neg_mod,
    shoup_mul,
    shoup_pair,
    sub_mod,
    to_u32,
)
from apsu_tpu_torch.core.params import SealParams
from apsu_tpu_torch.core.rns import (DeltaScale, ExactDiv, ExactLiftConv, RnsBase, ScaleDown,
                                     shoup_cols)
from apsu_tpu_torch.device import canonical, resolve
from apsu_tpu_torch.ops import behz

NOISE_STDDEV = 3.2  # SEAL default error stddev
BSK_BITS = 28       # Bsk prime width (the reference's APSU_BSK_BITS default)


def _msum_tensor(base: RnsBase, fa, fb):
    """Σ_m tensor(fa[m], fb[m]) in one RNS base's NTT-Montgomery domain
    (kernel G2), INTT'd back to Montgomery coeff residues [..., 3, Lb, N].
    fa, fb: [..., M, 2, Lb, N] NTT mont (broadcastable)."""
    return base.ntt.intt(behz.mont_mac(fa, fb, base))


def uniform_from_seed(seed: bytes, base: RnsBase, shape_lead=()) -> np.ndarray:
    """Deterministic uniform residues [..., k, N] (numpy uint32) from a
    public seed: AES-CTR bytes viewed as uint64, reduced mod each limb prime
    — identical on both parties and in both packages."""
    from apsu_tpu_torch.mpc.prg import prg_bytes

    shape = tuple(shape_lead) + (base.k, base.n)
    total = int(np.prod(shape))
    u = prg_bytes(seed, 8 * total).view(np.uint64).reshape(shape)
    out = np.empty(shape, np.uint32)
    for i, p in enumerate(base.primes):
        out[..., i, :] = (u[..., i, :] % np.uint64(p)).astype(np.uint32)
    return out


def smul(x, c: int, m: int):
    """x·c mod m for a scalar modulus m (Shoup by a scalar constant)."""
    return shoup_mul(x, c, int(shoup_pair(np.uint32(c), np.uint32(m))), m)


@dataclass
class Ciphertext:
    data: torch.Tensor  # [..., k, L, N] int32 (k components, optional batch)
    is_ntt: bool        # True: NTT domain, Montgomery form; False: coeff, plain
    level: int          # number of active data limbs (prefix of q chain)

    @property
    def size(self) -> int:
        return self.data.shape[-3]


class SecretKey:
    """Ternary secret with NTT-form caches per base.  ``coeffs`` is the
    reference's int8 array in {-1, 0, 1} of shape [N], so a reference key
    carries across as ``SecretKey(ref_sk.coeffs)``."""

    def __init__(self, coeffs: np.ndarray):
        self.coeffs = np.asarray(coeffs, dtype=np.int8)
        self._ntt_cache = {}

    def ntt_mont(self, base: RnsBase) -> torch.Tensor:
        key = id(base)
        if key not in self._ntt_cache:
            res = np.zeros((base.k, base.n), dtype=np.uint32)
            s64 = self.coeffs.astype(np.int64)
            for i, p in enumerate(base.primes):
                res[i] = np.where(s64 >= 0, s64, s64 + p).astype(np.uint32)
            x = from_u32(res, base.device)
            self._ntt_cache[key] = base.ntt.ntt(base.to_mont(x))
        return self._ntt_cache[key]


class RelinKey:
    """RNS-gadget key-switching keys for s² → s (one digit per data limb)."""

    def __init__(self, ksk: torch.Tensor, level: int):
        # ksk: [n_digits, 2, L_qp, N] NTT-domain Montgomery form, int32
        self.ksk = ksk
        self.level = level

    @classmethod
    def from_numpy(cls, ksk: np.ndarray, level: int, device) -> "RelinKey":
        """A key from the reference's uint32 array (e.g. ``ref_rk.ksk``)."""
        return cls(from_u32(np.asarray(ksk), resolve(device)), level)


class BfvContext:
    def __init__(self, sp: SealParams, device="cuda"):
        self.device = resolve(device)
        dev = self.device
        self.sp = sp
        self.n = sp.poly_modulus_degree
        self.t = sp.plain_modulus
        self.q_primes = list(sp.data_modulus)
        self.special = sp.special_modulus
        n = self.n

        self.q = RnsBase(self.q_primes, n, dev)
        self.t_base = RnsBase([self.t], n, dev)

        # per-level bases for mod-switch (level L = first L primes)
        self.levels: List[RnsBase] = [None] * (len(self.q_primes) + 1)
        self.levels[len(self.q_primes)] = self.q
        for lvl in range(1, len(self.q_primes)):
            self.levels[lvl] = RnsBase(self.q_primes[:lvl], n, dev)

        if self.special is not None:
            self.qp = RnsBase(self.q_primes + [self.special], n, dev)
            self.div_p = ExactDiv(self.q, self.special)
        else:
            self.qp = None
            self.div_p = None

        k = self.q.k
        self._mul_ctx_cache = {}
        self.bsk = self._mul_ctx(k)["bsk"]

        # mod-switch dividers: drop limb j+1 -> level j
        self.div_drop: List[Optional[ExactDiv]] = [None] * (len(self.q_primes) + 1)
        for lvl in range(1, len(self.q_primes)):
            self.div_drop[lvl + 1] = ExactDiv(self.levels[lvl], self.q_primes[lvl])
        # the plaintext scaling's constants at every level (_scale_impl, G5),
        # uploaded once here (an upload per call could not be captured into a
        # CUDA graph)
        self.delta: List[Optional[DeltaScale]] = [None] + [
            DeltaScale(b, self.t) for b in self.levels[1:]]
        # the query's programs (engine/programs.py), the counterpart of the
        # reference's _jit_cache
        self.programs = {}

    def _mul_ctx(self, level: int, extra_bits: int = 0):
        """Per-level BEHZ multiply machinery (Bsk base sized to Q_level).

        ``extra_bits`` widens the auxiliary base for tensor-domain
        accumulation (``multiply_sum_fused``): summing M products grows the
        tensor by ceil(log2 M) bits."""
        key = level if extra_bits == 0 else (level, extra_bits)
        if key not in self._mul_ctx_cache:
            base = self.levels[level]
            n = self.n
            dev = self.device
            # operands are lifted exactly, so the tensor is < 2·N·Q² and the
            # scaled value < 2·N·t·Q + k
            need_bits = (
                base.prod.bit_length()
                + math.ceil(math.log2(n))
                + self.t.bit_length()
                + 4
                + extra_bits
            )
            width = BSK_BITS
            nb = max(level, math.ceil(need_bits / width)) + 1  # +1 = m_sk
            exclude = self.q_primes + [self.t] + ([self.special] if self.special else [])
            while True:
                primes = nt.gen_ntt_primes([width] * nb, 2 * n, exclude=exclude)
                b_prod = math.prod(primes[:-1])
                if b_prod.bit_length() > need_bits:  # prod(B) covers the bound
                    break
                nb += 1
            bsk = RnsBase(primes, n, dev)
            self._mul_ctx_cache[key] = {
                "bsk": bsk,
                "lift": ExactLiftConv(base, bsk),
                "scale": ScaleDown(base, bsk, self.t),
            }
        return self._mul_ctx_cache[key]

    def _qp_level(self, level: int) -> RnsBase:
        """Key base Q_level · P for leveled key switching (lazy)."""
        if level == self.q.k:
            return self.qp
        key = ("qp", level)
        if key not in self._mul_ctx_cache:
            self._mul_ctx_cache[key] = RnsBase(
                self.q_primes[:level] + [self.special], self.n, self.device
            )
        return self._mul_ctx_cache[key]

    def _div_p_level(self, level: int) -> ExactDiv:
        if level == self.q.k:
            return self.div_p
        key = ("div_p", level)
        if key not in self._mul_ctx_cache:
            self._mul_ctx_cache[key] = ExactDiv(self.levels[level], self.special)
        return self._mul_ctx_cache[key]

    def on(self, device) -> "BfvContext":
        """This context's parameters on ``device``: itself when it lives
        there, else one copy for each other device, built once and kept (a
        context's tables live on one device; a mesh shard runs on its own)."""
        dev = canonical(device)
        if dev == canonical(self.device):
            return self
        peers = self.__dict__.setdefault("_peers", {})
        if dev not in peers:
            peers[dev] = BfvContext(self.sp, device=dev)
        return peers[dev]

    def tensor(self, x) -> torch.Tensor:
        """int32 residue tensor on this context's device from a tensor or a
        numpy array of residues (< 2^31)."""
        if isinstance(x, torch.Tensor):
            return x.to(device=self.device, dtype=I32)
        return from_u32(np.asarray(x), self.device)

    # ------------------------------------------------------------------
    # batch encoding (CRT slot packing mod t)
    # ------------------------------------------------------------------
    def encode(self, values) -> torch.Tensor:
        """Slot values [..., N] < t  ->  plaintext poly [..., N] plain."""
        x = self.tensor(values)
        tb = self.t_base
        pm = tb.to_mont(x[..., None, :])
        return tb.from_mont(tb.ntt.intt(pm))[..., 0, :]

    def decode(self, poly) -> torch.Tensor:
        x = self.tensor(poly)
        tb = self.t_base
        vm = tb.ntt.ntt(tb.to_mont(x[..., None, :]))
        return tb.from_mont(vm)[..., 0, :]

    # ------------------------------------------------------------------
    # key generation
    # ------------------------------------------------------------------
    def gen_secret_key(self, rng) -> SecretKey:
        s = rng.integers(-1, 2, size=self.n).astype(np.int8)
        return SecretKey(s)

    def _sample_error(self, rng, base: RnsBase, shape_lead=()):
        e = np.rint(rng.normal(0.0, NOISE_STDDEV, size=shape_lead + (self.n,))).astype(
            np.int64
        )
        out = np.zeros(shape_lead + (base.k, self.n), dtype=np.uint32)
        for i, p in enumerate(base.primes):
            out[..., i, :] = np.mod(e, p).astype(np.uint32)
        return from_u32(out, self.device)

    def _sample_uniform(self, rng, base: RnsBase, shape_lead=()):
        out = np.zeros(shape_lead + (base.k, self.n), dtype=np.uint32)
        for i, p in enumerate(base.primes):
            out[..., i, :] = rng.integers(0, p, size=shape_lead + (self.n,), dtype=np.uint64)
        return from_u32(out, self.device)

    def gen_relin_key(
        self, sk: SecretKey, rng, a_seed: Optional[bytes] = None, level: Optional[int] = None
    ) -> RelinKey:
        """ksk_i = (-(a_i·s + e_i) + P·g_i·s², a_i) mod Q_l·P, NTT/Montgomery,
        with g_i = q̂_i·[q̂_i^{-1}]_{q_i} the CRT basis element of Q_level.
        With ``a_seed`` the a_i rows expand from the seed and ``rng`` draws
        only the errors."""
        if self.qp is None:
            raise ValueError("no special prime: relinearization unavailable")
        lvl = level if level is not None else self.q.k
        base = self.levels[lvl]
        qp = self._qp_level(lvl)
        P = self.special
        pg_monts = []
        for i in range(lvl):
            g = base.phat[i] * base.phat_inv[i]  # integer < Q_l
            pg_monts.append([((P * g % p) << 32) % p for p in qp.primes])  # Montgomery form
        pg_mont = col(pg_monts, self.device, (lvl, qp.k, 1))
        if a_seed is not None:
            a = self.tensor(uniform_from_seed(a_seed, qp, (lvl,)))
        else:
            a = self._sample_uniform(rng, qp, shape_lead=(lvl,))  # plain coeff
        e = self._sample_error(rng, qp, shape_lead=(lvl,))

        s_ntt = sk.ntt_mont(qp)
        s2_ntt = mont_mul(s_ntt, s_ntt, qp.p_d, qp.pni_d)
        a_ntt = qp.ntt.ntt(qp.to_mont(a))
        as_ntt = mont_mul(a_ntt, s_ntt, qp.p_d, qp.pni_d)
        e_ntt = qp.ntt.ntt(qp.to_mont(e))
        k0 = add_mod(
            neg_mod(add_mod(as_ntt, e_ntt, qp.p_d), qp.p_d),
            mont_mul(s2_ntt, pg_mont, qp.p_d, qp.pni_d),
            qp.p_d,
        )
        return RelinKey(torch.stack([k0, a_ntt], dim=1), level=lvl)  # [kdig, 2, kqp, N]

    def relin_key_from_seed(self, k0, a_seed: bytes, level: Optional[int] = None) -> RelinKey:
        """Rebuild a seed-compressed relin key from k0 = ksk[:, 0]
        [kdig, Lqp, N] (NTT mont) and the public seed of the a_i rows."""
        lvl = level if level is not None else self.q.k
        qp = self._qp_level(lvl)
        a = self.tensor(uniform_from_seed(a_seed, qp, (lvl,)))
        return RelinKey(torch.stack([self.tensor(k0), qp.ntt.ntt(qp.to_mont(a))], dim=1), lvl)

    # ------------------------------------------------------------------
    # encrypt / decrypt
    # ------------------------------------------------------------------
    def encrypt_symmetric(
        self, pt_poly, sk: SecretKey, rng, a_seed: Optional[bytes] = None,
        level: Optional[int] = None,
    ) -> Ciphertext:
        """pt_poly: [..., N] plaintext polynomial(s) mod t -> fresh symmetric
        ciphertexts [..., 2, L, N] at ``level`` (default: full chain).  With
        ``a_seed`` the uniform component expands from the seed and ``rng``
        draws only the error."""
        lvl = level if level is not None else self.q.k
        q = self.levels[lvl]
        pt = self.tensor(pt_poly)
        lead = tuple(pt.shape[:-1])
        if a_seed is not None:
            a = self.tensor(uniform_from_seed(a_seed, q, lead))
        else:
            a = self._sample_uniform(rng, q, shape_lead=lead)
        e = self._sample_error(rng, q, shape_lead=lead)
        a_ntt = q.ntt.ntt(q.to_mont(a))
        as_coeff = q.from_mont(q.ntt.intt(mont_mul(a_ntt, sk.ntt_mont(q), q.p_d, q.pni_d)))
        dm = self._scale_impl(pt, lvl)  # round(Q_l·m/t) mod q_i (plain)
        c0 = add_mod(neg_mod(add_mod(as_coeff, e, q.p_d), q.p_d), dm, q.p_d)
        return Ciphertext(torch.stack([c0, a], dim=-3), is_ntt=False, level=lvl)

    def ct_from_seed(self, c0, a_seed: bytes, level: Optional[int] = None) -> Ciphertext:
        """Rebuild seed-compressed fresh symmetric ciphertexts from c0
        [..., L, N] (plain coeff residues) and the public seed."""
        lvl = level if level is not None else self.q.k
        c0 = self.tensor(c0)
        a = self.tensor(uniform_from_seed(a_seed, self.levels[lvl], tuple(c0.shape[:-2])))
        return Ciphertext(torch.stack([c0, a], dim=-3), is_ntt=False, level=lvl)

    def decrypt_device(self, ct: Ciphertext, sk: SecretKey) -> torch.Tensor:
        """BEHZ {t, γ} scale-and-round decryption: m = round(t·x/Q) mod t
        from RNS residues with an auxiliary modulus γ.  Returns plaintext
        polys [..., N] on the device."""
        x = self._dot_with_secret(ct, sk)  # [..., L, N] plain coeff
        base = self.levels[ct.level]
        t = self.t
        gamma = self._gamma
        Ql = base.prod
        # y_j = [x_j · γ·t·(Q/q_j)^{-1}]_{q_j}
        A_sh = shoup_cols(
            [gamma * t % p * base.phat_inv[j] % p for j, p in enumerate(base.primes)],
            base.primes, self.device,
        )
        y = shoup_mul(x, *A_sh, base.p_d)

        # FastBConv of γ·t·x mod Q into {t, γ} (+ αQ overshoot, absorbed by
        # the γ-centering below)
        def conv_to(m):
            acc = torch.zeros(x.shape[:-2] + (x.shape[-1],), dtype=I32, device=x.device)
            for j in range(base.k):
                acc = add_mod(acc, smul(y[..., j, :], base.phat[j] % m, m), m)
            return acc

        r_t = conv_to(t)
        r_g = conv_to(gamma)
        v_t = smul(r_t, (-pow(Ql % t, -1, t)) % t, t)
        v_g = smul(r_g, (-pow(Ql % gamma, -1, gamma)) % gamma, gamma)

        # center v_γ and fold: m = (v_t − ρ)·γ^{-1} mod t
        neg = v_g > (gamma >> 1)
        rho_neg = gamma - v_g.to(I64)  # |ρ| when negative
        diff = torch.where(
            neg,
            add_mod(v_t, smul(rho_neg, 1, t), t),
            sub_mod(v_t, smul(v_g, 1, t), t),
        )
        return smul(diff, pow(gamma % t, -1, t), t)

    @property
    def _gamma(self) -> int:
        """Auxiliary decryption modulus γ: coprime to t and every q_j, ~2^29."""
        if not hasattr(self, "_gamma_val"):
            g = (1 << 29) - 1
            while True:
                if nt.is_prime(g) and g != self.t and g not in self.q_primes:
                    break
                g -= 2
            self._gamma_val = g
        return self._gamma_val

    def decrypt(self, ct: Ciphertext, sk: SecretKey) -> np.ndarray:
        """The plaintext polynomial(s) mod t by host big-int CRT (numpy
        uint32, [..., N]): round(t·x/Q_l) mod t per coefficient."""
        x = to_u32(self._dot_with_secret(ct, sk))   # [..., L, N] plain coeff
        base = self.levels[ct.level]
        big = base.compose(x)   # object ints in [0, Q_l), [..., N]
        Ql, t = base.prod, self.t
        half = Ql // 2
        flat = big.reshape(-1)
        out = np.empty(flat.shape, dtype=np.uint64)
        for i in range(flat.shape[0]):
            out[i] = ((int(flat[i]) * t + half) // Ql) % t
        return out.reshape(big.shape).astype(np.uint32)

    def noise_budget(self, ct: Ciphertext, sk: SecretKey) -> float:
        """Bits of invariant-noise budget left (SEAL semantics), over every
        coefficient on the host."""
        x = to_u32(self._dot_with_secret(ct, sk))
        base = self.levels[ct.level]
        big = base.compose(x)
        Ql = base.prod
        max_frac = 0
        for v in big.reshape(-1):
            tx = int(v) * self.t
            frac = tx - (tx + Ql // 2) // Ql * Ql  # centered remainder of tx mod Q_l
            max_frac = max(max_frac, abs(frac))
        if max_frac == 0:
            return float(Ql.bit_length())
        return max(0.0, math.log2(Ql) - 1.0 - math.log2(max_frac))

    def _dot_with_secret(self, ct: Ciphertext, sk: SecretKey) -> torch.Tensor:
        base = self.levels[ct.level]
        s_ntt = sk.ntt_mont(base)
        data = ct.data
        if not ct.is_ntt:
            data = base.ntt.ntt(base.to_mont(data))
        acc = data[..., 0, :, :]
        spow = s_ntt
        for i in range(1, ct.size):
            acc = add_mod(acc, mont_mul(data[..., i, :, :], spow, base.p_d, base.pni_d), base.p_d)
            if i + 1 < ct.size:
                spow = mont_mul(spow, s_ntt, base.p_d, base.pni_d)
        return base.from_mont(base.ntt.intt(acc))

    # ------------------------------------------------------------------
    # homomorphic ops
    # ------------------------------------------------------------------
    def _base(self, ct: Ciphertext) -> RnsBase:
        return self.levels[ct.level]

    def to_ntt(self, ct: Ciphertext) -> Ciphertext:
        if ct.is_ntt:
            return ct
        base = self._base(ct)
        return replace(ct, data=base.ntt.ntt(base.to_mont(ct.data)), is_ntt=True)

    def from_ntt(self, ct: Ciphertext) -> Ciphertext:
        if not ct.is_ntt:
            return ct
        base = self._base(ct)
        return replace(ct, data=base.from_mont(base.ntt.intt(ct.data)), is_ntt=False)

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        assert a.is_ntt == b.is_ntt and a.level == b.level
        return replace(a, data=add_mod(a.data, b.data, self._base(a).p_d))

    def scale_plain(self, pt, level: int) -> torch.Tensor:
        """round(Q_l·m/t) mod q_j for plaintext m [..., N]: plain residues
        [..., L, N] (SEAL's add-plain scaling, exact in RNS)."""
        return self._scale_impl(self.tensor(pt), level)

    def add_plain(self, ct: Ciphertext, pt_poly) -> Ciphertext:
        """Add Δ·pt to c0 (pt_poly: [..., N] plaintext polynomial mod t)."""
        base = self._base(ct)
        dm = self._scale_impl(self.tensor(pt_poly), ct.level)
        if ct.is_ntt:
            dm = base.ntt.ntt(base.to_mont(dm))
        data = ct.data.clone()
        data[..., 0, :, :] = add_mod(ct.data[..., 0, :, :], dm, base.p_d)
        return replace(ct, data=data)

    def Q_at(self, level: int) -> int:
        return self.levels[level].prod

    def mul_plain_ntt(self, ct: Ciphertext, pt_ntt_mont) -> Ciphertext:
        """ct (NTT) ⊙ a plaintext already lifted, NTT'd and in Montgomery
        form ([L, N])."""
        assert ct.is_ntt
        base = self._base(ct)
        return replace(ct, data=mont_mul(ct.data, self.tensor(pt_ntt_mont), base.p_d, base.pni_d))

    def _scale_impl(self, m, level: int):
        """round(Q_l·m/t) mod q_j for plaintext m [..., N] (plain residues
        [..., L, N]):  ≡ (h − rem)·t^{-1} (mod q_j), rem = (r·m + h) mod t,
        r = Q_l mod t, h = t >> 1 (G5 on the card, ``ops/behz.py:delta``)."""
        return behz.delta(m, self.delta[level])

    def lift_plaintext_ntt(self, pt_poly, level: Optional[int] = None) -> torch.Tensor:
        """Plaintext poly mod t [..., N] -> NTT-domain Montgomery [..., L, N] mod q."""
        base = self.levels[level or self.q.k]
        x = self.tensor(pt_poly)[..., None, :]
        x = x.expand(x.shape[:-2] + (base.k, self.n))
        return base.ntt.ntt(base.to_mont(x))

    def operand_forms(self, data, level: int):
        """The two NTT-Montgomery forms a BEHZ multiply needs of one
        coeff-domain ciphertext: (f_q, f_bsk), both from one lift (G1)."""
        mc = self._mul_ctx(level)
        q, bsk = self.levels[level], mc["bsk"]
        x_q, x_b = behz.lift(data, mc["lift"])
        return q.ntt.ntt(x_q), bsk.ntt.ntt(x_b)

    def tensor_scaledown_fused(self, fa_q, fa_b, fb_q, fb_b, level: int):
        """BEHZ ct×ct from pre-transformed operands (see ``operand_forms``):
        tensor in both bases (G2), INTT, t/Q fast floor and Shenoy–Kumaresan
        (G3).  Returns 3-component plain coeff residues [..., 3, Lq, N]."""
        mc = self._mul_ctx(level)
        q, bsk = self.levels[level], mc["bsk"]
        x_q = _msum_tensor(q, fa_q[..., None, :, :, :], fb_q[..., None, :, :, :])
        x_b = _msum_tensor(bsk, fa_b[..., None, :, :, :], fb_b[..., None, :, :, :])
        return behz.scaledown(x_q, x_b, mc["scale"])

    def multiply(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """BEHZ ct×ct multiply -> 3-component ciphertext (no relinearization)."""
        assert a.level == b.level, "multiply needs matching levels"
        lvl = a.level
        fa = self.operand_forms(self.from_ntt(a).data, lvl)
        fb = self.operand_forms(self.from_ntt(b).data, lvl)
        return Ciphertext(self.tensor_scaledown_fused(*fa, *fb, lvl), is_ntt=False, level=lvl)

    def square(self, a: Ciphertext) -> Ciphertext:
        return self.multiply(a, a)

    def multiply_sum(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        """Σ_m a[m]·b[m] over the batch axis at position -4, with one BEHZ
        scale-down for the whole sum (lazy BEHZ: the products accumulate in
        the NTT domain of q ∪ a Bsk widened by ⌈log2 M⌉ bits).  a, b:
        [..., M, 2, L, N] at one level; returns the 3-component sum."""
        assert a.level == b.level, "multiply_sum needs matching levels"
        lvl = a.level
        q = self.levels[lvl]
        xa = self.from_ntt(a).data
        M = int(xa.shape[-4])
        fb_q, fb_bsk = self.premul_sum_rhs(b, M)
        data = self.multiply_sum_fused(q.ntt.ntt(q.to_mont(xa)), xa, fb_q, fb_bsk, lvl, M)
        return Ciphertext(data, is_ntt=False, level=lvl)

    def premul_sum_rhs(self, b: Ciphertext, m_terms: int):
        """NTT-Montgomery forms (fb_q, fb_bsk) of a multiply-sum rhs, in q
        and in the (level, ⌈log2 M⌉)-widened Bsk base."""
        lvl = b.level
        extra = max(1, (m_terms - 1).bit_length())
        mc = self._mul_ctx(lvl, extra)
        q, bsk = self.levels[lvl], mc["bsk"]
        x_q, x_b = behz.lift(self.from_ntt(b).data, mc["lift"])
        return q.ntt.ntt(x_q), bsk.ntt.ntt(x_b)

    def multiply_sum_fused(self, fa_q, xa_coeff, fb_q, fb_bsk, level, m_terms):
        """Σ_m a[m]·b[m] with one scale-down for the whole sum (lazy BEHZ).
        ``fa_q`` [..., M, 2, Lq, N] is the lhs in NTT-Montgomery q form,
        ``xa_coeff`` the same lhs as plain coeff residues, ``fb_q``/``fb_bsk``
        the rhs from ``premul_sum_rhs``.  Returns [..., 3, Lq, N] plain."""
        extra = max(1, (m_terms - 1).bit_length())
        mc = self._mul_ctx(level, extra)
        q, bsk = self.levels[level], mc["bsk"]
        fa_b = bsk.ntt.ntt(behz.lift(xa_coeff, mc["lift"], want_q=False)[1])
        x_q = _msum_tensor(q, fa_q, fb_q)
        x_b = _msum_tensor(bsk, fa_b, fb_bsk)
        return behz.scaledown(x_q, x_b, mc["scale"])

    def relinearize(self, ct: Ciphertext, rk: RelinKey) -> Ciphertext:
        """3-component -> 2-component via RNS-gadget key switching: the
        digits of c2 in Q·P (G1), Σ_i d_i ⊙ ksk_i (G2) between K1's NTT and
        INTT, then ÷ P rounded and + (c0, c1) (G4)."""
        assert ct.size == 3 and not ct.is_ntt
        lvl = ct.level
        klvl = rk.level
        assert lvl <= klvl, "relin key generated below the ciphertext level"
        qp = self._qp_level(lvl)
        data = ct.data
        # keys restrict exactly to any prefix level: digit rows 0..lvl-1 and
        # limb columns {0..lvl-1, special} (the special column sits at klvl)
        d_ntt = qp.ntt.ntt(behz.digits(data[..., 2, :, :], qp, lvl))  # [k, ..., Lqp, N]
        u = qp.ntt.intt(behz.keyswitch_mac(d_ntt, rk.ksk, qp, lvl, klvl))  # [..., 2, Lqp, N]
        new = behz.keyswitch_div(u, data, qp, self._div_p_level(lvl))
        return Ciphertext(new, is_ntt=False, level=lvl)

    def mod_switch_to(self, ct: Ciphertext, target_level: int) -> Ciphertext:
        ct = self.from_ntt(ct)
        if ct.level == target_level:
            return ct
        data = behz.mod_switch(ct.data, self.div_drop, ct.level, target_level)
        return Ciphertext(data, is_ntt=False, level=target_level)
