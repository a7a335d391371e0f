"""Batched monic polynomial from roots, and Newton interpolation, over Z_t
(port of ``apsu_tpu/engine/interpolate.py``).

The whole DB partition is one tensor: roots ``[..., K, N]`` with a per-lane
valid count, and ∏(x − r_k) is built by K masked monomial-multiply steps,
each an elementwise Montgomery op over every lane.  Lanes with fewer than K
roots keep their polynomial for the padded steps, so an empty bin yields
M(x) = 1 (never zero — no false matches).  ``newton_interpolate`` builds the labeled DB's label
polynomials the same way: divided differences, then the Newton-to-monomial
expansion, each a loop of masked full-lane steps.
"""

from __future__ import annotations

import torch

from apsu_tpu_torch.core.mod32 import I32, add_mod, mont_mul, mont_sqr, neg_mod, prime_consts, sub_mod


def polyn_with_roots(roots: torch.Tensor, counts: torch.Tensor, t: int) -> torch.Tensor:
    """roots: [..., K, N] int32 felts mod t; counts: [..., N] valid roots per
    lane.  Returns coefficients [..., K+1, N] mod t (plain form),
    little-endian degree order (coeffs[..., j, :] is the x^j coefficient).

    Step k multiplies by (x − r_k): before it the polynomial has degree ≤ k,
    so only planes 0..k+1 change — the same values as the reference's
    full-width step, with the zero planes above left untouched."""
    c = prime_consts([t])
    p, pni, r2 = int(c.p[0]), int(c.p_neg_inv[0]), int(c.r2[0])
    K = roots.shape[-2]
    lead = roots.shape[:-2]
    n = roots.shape[-1]
    dev = roots.device

    # roots to Montgomery once, so each step is one mont_mul (plain × mont = plain)
    roots_m = mont_mul(roots, r2, p, pni)
    coeffs = torch.zeros(lead + (K + 1, n), dtype=I32, device=dev)
    coeffs[..., 0, :] = 1
    for k in range(K):
        r = roots_m[..., k, None, :]
        cur = coeffs[..., : k + 1, :]                       # degree ≤ k
        rc = mont_mul(cur, r, p, pni)
        new = torch.empty(lead + (k + 2, n), dtype=I32, device=dev)
        new[..., 0, :] = neg_mod(rc[..., 0, :], p)
        new[..., 1: k + 1, :] = sub_mod(cur[..., :k, :], rc[..., 1:, :], p)
        new[..., k + 1, :] = cur[..., k, :]
        valid = (k < counts)[..., None, :]
        coeffs[..., : k + 2, :] = torch.where(valid, new, coeffs[..., : k + 2, :])
    return coeffs


def newton_interpolate(roots: torch.Tensor, values: torch.Tensor, counts: torch.Tensor,
                       t: int) -> torch.Tensor:
    """roots: [..., K, N] int32 x-values, distinct within each lane's valid
    prefix (the DB build rejects per-lane felt collisions); values:
    [..., K, N] int32 y-values mod t; counts: [..., N] valid points per lane.
    Returns coefficients [..., K, N] mod t, little-endian degree order, of
    the unique polynomial L of degree < count with L(roots_i) = values_i
    (an empty lane gives L = 0).

    1. Divided differences: step j (1 ≤ j < K) sets c_i ← (c_i − c_{i−1}) /
       (x_i − x_{i−j}) on rows j ≤ i < count, all from the step's old
       values, the inverse a Fermat power x^{t−2} in Montgomery form
       (inv(0) = 0).  Rows below j are never touched by step j, so only
       rows j..K−1 are computed.
    2. Newton to monomial: L ← L·(x − x_i) + c_i for i = count−1 .. 0."""
    c = prime_consts([t])
    p, pni, r2 = int(c.p[0]), int(c.p_neg_inv[0]), int(c.r2[0])
    K = roots.shape[-2]
    dev = roots.device
    roots_m = mont_mul(roots, r2, p, pni)  # Montgomery form
    cnt = counts[..., None, :]
    one_m = (1 << 32) % t

    def inv_mont(x_m):
        e = t - 2
        acc = torch.full_like(x_m, one_m)
        base = x_m
        while e:
            if e & 1:
                acc = mont_mul(acc, base, p, pni)
            e >>= 1
            if e:
                base = mont_sqr(base, p, pni)
        return acc

    # 1. divided differences (plain-form coefficients c_i)
    cfs = values.to(I32).clone()
    for j in range(1, K):
        diff = sub_mod(cfs[..., j:, :], cfs[..., j - 1: K - 1, :], p)        # c_i − c_{i−1}
        denom_m = sub_mod(roots_m[..., j:, :], roots_m[..., : K - j, :], p)  # x_i − x_{i−j}
        new = mont_mul(diff, inv_mont(denom_m), p, pni)                      # plain × mont
        idx = torch.arange(j, K, device=dev)[:, None]
        cfs[..., j:, :] = torch.where(idx < cnt, new, cfs[..., j:, :])

    # 2. Newton -> monomial: poly = poly·(x − x_i) + c_i, i = K−1 .. 0
    poly = torch.zeros(roots.shape, dtype=I32, device=dev)
    for i in range(K - 1, -1, -1):
        r = roots_m[..., i, None, :]
        shifted = torch.roll(poly, 1, dims=-2)
        shifted[..., 0, :] = 0
        new = sub_mod(shifted, mont_mul(poly, r, p, pni), p)
        new[..., 0, :] = add_mod(new[..., 0, :], cfs[..., i, :], p)
        poly = torch.where((i < counts)[..., None, :], new, poly)
    return poly
