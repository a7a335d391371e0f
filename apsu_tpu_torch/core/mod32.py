"""Modular arithmetic over < 2^30 primes on int32 residue tensors.

Port of ``apsu_tpu/core/mod32.py``.  Residues are stored as ``torch.int32``
(canonical, < 2^30, so the bits equal the reference's ``uint32``); every
product widens to ``int64``.  The formulas mirror the reference's: where it
relies on uint32 wraparound (``mul_lo``, the Shoup difference) the int64 code
masks with ``& MASK32``, and 32x32-bit products that could exceed int64 are
split into 16-bit halves.  Results are canonical, so they equal the
reference's bit for bit.

Constant columns (``p``, ``-p^{-1}``, Shoup companions) are ``int64`` tensors
of shape ``[..., L, 1]`` that broadcast against ``[..., L, N]`` residues.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

MASK32 = 0xFFFFFFFF
MASK16 = 0xFFFF
I32 = torch.int32
I64 = torch.int64


class PrimeConst(NamedTuple):
    """Host-precomputed per-prime constants (numpy uint32, shape [L])."""

    p: np.ndarray          # the primes
    p_neg_inv: np.ndarray  # -p^{-1} mod 2^32 (Montgomery factor)
    r2: np.ndarray         # R^2 mod p (to enter Montgomery form)
    r1: np.ndarray         # R mod p == mont(1)


def prime_consts(primes) -> PrimeConst:
    ps = [int(q) for q in primes]
    R = 1 << 32
    p = np.array(ps, dtype=np.uint32)
    p_neg_inv = np.array([(-pow(q, -1, R)) % R for q in ps], dtype=np.uint32)
    r2 = np.array([R * R % q for q in ps], dtype=np.uint32)
    r1 = np.array([R % q for q in ps], dtype=np.uint32)
    return PrimeConst(p=p, p_neg_inv=p_neg_inv, r2=r2, r1=r1)


def col(values, device, shape=None) -> torch.Tensor:
    """int64 constant tensor (default shape [k, 1]) on ``device``."""
    arr = np.asarray(values, dtype=np.int64)
    t = torch.from_numpy(arr.copy()).to(device)
    return t.reshape(shape if shape is not None else (-1, 1))


def from_u32(x, device) -> torch.Tensor:
    """numpy uint32 residues -> int32 tensor on ``device`` (values < 2^31)."""
    arr = np.ascontiguousarray(np.asarray(x, dtype=np.uint32))
    return torch.from_numpy(arr.view(np.int32).copy()).to(device)


def to_u32(x: torch.Tensor) -> np.ndarray:
    """int32 residue tensor -> numpy uint32 (the reference's dtype)."""
    return x.detach().cpu().numpy().astype(np.uint32)


def _w(x) -> torch.Tensor:
    return x.to(I64) if isinstance(x, torch.Tensor) else x


# ---------------------------------------------------------------------------
# 32-bit products in int64 lanes
# ---------------------------------------------------------------------------

def mul_lo(a, b):
    """Low 32 bits of a·b for a, b < 2^32 (the uint32 wraparound multiply):
    b splits into 16-bit halves so no int64 product overflows."""
    a, b = _w(a), _w(b)
    return (a * (b & MASK16) + (((a * (b >> 16)) & MASK16) << 16)) & MASK32


def mul_hi(a, b):
    """High 32 bits of a·b for a, b < 2^32, exact:
    ⌊a·b/2^32⌋ = ⌊(a·b_hi + ⌊a·b_lo/2^16⌋) / 2^16⌋."""
    a, b = _w(a), _w(b)
    return (a * (b >> 16) + ((a * (b & MASK16)) >> 16)) >> 16


def mul_wide(a, b):
    """Full 32x32 -> 64-bit product as a (hi, lo) pair of int64 values in
    [0, 2^32).  The operands are taken as u32 bits: an int32 holding a value
    >= 2^31 is negative, so it is masked before ``mul_hi``/``mul_lo``, which
    are only exact on [0, 2^32)."""
    a, b = _w(a) & MASK32, _w(b) & MASK32
    return mul_hi(a, b), mul_lo(a, b)


# ---------------------------------------------------------------------------
# Montgomery arithmetic
# ---------------------------------------------------------------------------

def mont_mul(a, b, p, p_neg_inv):
    """Montgomery product a·b·R^{-1} mod p (a, b < p < 2^30).

    REDC: m = lo(ab)·(-p^{-1}) mod 2^32, t = (ab + m·p) / 2^32 < 2p — exact
    in int64 (ab < 2^60, m·p < 2^62) — then one conditional subtraction."""
    ab = _w(a) * _w(b)
    m = mul_lo(ab & MASK32, p_neg_inv)
    t = (ab + m * p) >> 32
    return torch.where(t >= p, t - p, t).to(I32)


def mont_sqr(a, p, p_neg_inv):
    return mont_mul(a, a, p, p_neg_inv)


def add_mod(a, b, p):
    s = _w(a) + _w(b)
    return torch.where(s >= p, s - p, s).to(I32)


def sub_mod(a, b, p):
    a, b = _w(a), _w(b)
    return torch.where(a >= b, a - b, a + p - b).to(I32)


def neg_mod(a, p):
    a = _w(a)
    return torch.where(a == 0, a, p - a).to(I32)


# ---------------------------------------------------------------------------
# Shoup multiplication by a precomputed constant (Harvey 2014): for c < p and
# c' = ⌊c·2^32/p⌋, any x < 2^32 gives q = hi(x·c'), t = (x·c − q·p) mod 2^32
# in [0, 2p).  No Montgomery factor: shoup_mul(x, c) is x·c mod p.
# ---------------------------------------------------------------------------

def shoup_pair(c: np.ndarray, p: np.ndarray):
    """Host precompute: c' = ⌊c·2^32 / p⌋ for constant(s) c < p."""
    c64 = np.asarray(c, np.uint64)
    p64 = np.asarray(p, np.uint64)
    return ((c64 << np.uint64(32)) // p64).astype(np.uint32)


def shoup_mul_lazy(x, c, c_sh, p):
    """x·c mod p in [0, 2p) as int64 (x any value < 2^32, c < p)."""
    x = _w(x)
    q = mul_hi(x, c_sh)
    return (x * c - q * p) & MASK32


def shoup_mul(x, c, c_sh, p):
    """Canonical x·c mod p (int32)."""
    t = shoup_mul_lazy(x, c, c_sh, p)
    return torch.where(t >= p, t - p, t).to(I32)


def to_mont(x, p, p_neg_inv, r2):
    """Enter Montgomery form: x·R mod p (mont_mul with R²)."""
    return mont_mul(x, r2, p, p_neg_inv)


def from_mont(x, p, p_neg_inv):
    """Leave Montgomery form: x·R^{-1} mod p == mont_mul(x, 1)."""
    return mont_mul(x, 1, p, p_neg_inv)


# ---------------------------------------------------------------------------
# Host-side (numpy uint64) mirrors for table building and golden tests
# ---------------------------------------------------------------------------

def np_to_mont(x: np.ndarray, p: int) -> np.ndarray:
    return ((x.astype(np.uint64) << np.uint64(32)) % np.uint64(p)).astype(np.uint32)


def np_from_mont(x: np.ndarray, p: int) -> np.ndarray:
    rinv = pow(1 << 32, -1, int(p))
    return (
        (x.astype(np.uint64) * np.uint64(rinv)) % np.uint64(p)
    ).astype(np.uint32)


def np_mulmod(a: np.ndarray, b: np.ndarray, p: int) -> np.ndarray:
    return (
        (a.astype(np.uint64) * b.astype(np.uint64)) % np.uint64(p)
    ).astype(np.uint32)
