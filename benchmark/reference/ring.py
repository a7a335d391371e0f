"""Plain BFV decryption and batch decoding in int64 PyTorch.

Residues are canonical (0 ≤ x < p) and every prime here is below 2^31, so a
product of two residues fits an int64.  The transforms are textbook
radix-2 decimation in time over a bit-reversed input; nothing is shared
with the program's kernels or tables.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def _factors(n: int) -> list:
    out, d = [], 2
    while d * d <= n:
        if n % d == 0:
            out.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n > 1:
        out.append(n)
    return out


def smallest_generator(p: int) -> int:
    """The smallest generator of the multiplicative group mod the prime p."""
    fs = _factors(p - 1)
    for g in range(2, p):
        if all(pow(g, (p - 1) // f, p) != 1 for f in fs):
            return g
    raise ValueError(f"{p} has no generator")


def bit_reverse(n: int) -> np.ndarray:
    """The bit-reversal permutation of range(n), n a power of two."""
    bits = n.bit_length() - 1
    idx = np.arange(n)
    out = np.zeros(n, dtype=np.int64)
    for b in range(bits):
        out |= ((idx >> b) & 1) << (bits - 1 - b)
    return out


class Negacyclic:
    """Evaluation of polynomials mod (x^n + 1, p) at the odd powers of ψ, a
    primitive 2n-th root of unity: ``forward(a)[..., j] = a(ψ^(2j+1))``."""

    def __init__(self, p: int, n: int, device, psi: int | None = None):
        if (p - 1) % (2 * n):
            raise ValueError(f"{p} has no primitive {2 * n}-th root of unity")
        self.p, self.n = p, n
        psi = psi if psi is not None else pow(smallest_generator(p), (p - 1) // (2 * n), p)
        self.psi = psi
        omega = psi * psi % p
        pows = lambda base, count: torch.tensor(  # noqa: E731
            [pow(base, k, p) for k in range(count)], dtype=torch.int64, device=device)
        self.twist = pows(psi, n)
        ninv = pow(n, -1, p)
        self.untwist = pows(pow(psi, -1, p), n) * ninv % p
        self.brv = torch.from_numpy(bit_reverse(n)).to(device)
        self.stages = [self._stage(omega, n, device), self._stage(pow(omega, -1, p), n, device)]

    def _stage(self, omega: int, n: int, device) -> list:
        out, size = [], 2
        while size <= n:
            w = pow(omega, n // size, self.p)
            out.append(torch.tensor([pow(w, j, self.p) for j in range(size // 2)],
                                    dtype=torch.int64, device=device))
            size *= 2
        return out

    def _dft(self, x: torch.Tensor, inverse: bool) -> torch.Tensor:
        p, n = self.p, self.n
        lead = x.shape[:-1]
        x = x[..., self.brv]
        for tw in self.stages[inverse]:
            h = tw.numel()
            y = x.reshape(*lead, n // (2 * h), 2, h)
            u, v = y[..., 0, :], y[..., 1, :] * tw % p
            x = torch.stack(((u + v) % p, (u - v) % p), dim=-2).reshape(*lead, n)
        return x

    def forward(self, a: torch.Tensor) -> torch.Tensor:
        return self._dft(a * self.twist % self.p, inverse=False)

    def inverse(self, a_hat: torch.Tensor) -> torch.Tensor:
        return self._dft(a_hat, inverse=True) * self.untwist % self.p


@functools.lru_cache(maxsize=32)
def negacyclic(p: int, n: int, device: str) -> Negacyclic:
    return Negacyclic(p, n, torch.device(device))


def decrypt(ct: torch.Tensor, secret: np.ndarray, primes, t: int) -> torch.Tensor:
    """Plaintext polynomials [..., N] mod t of the BFV ciphertexts ``ct``
    [..., 2, L, N] (coefficient residues over the first L of ``primes``)
    under the ternary ``secret`` [N]: round(t·(c0 + c1·s)/Q) mod t.

    By the CRT, c0 + c1·s ≡ Σ_j y_j·(Q/q_j) (mod Q) with
    y_j = x_j·(Q/q_j)^-1 mod q_j, so t·x/Q ≡ Σ_j y_j·t/q_j (mod t); each
    y_j·t splits exactly into a quotient and a remainder of q_j, and only
    the remainders' fractions are summed in float64."""
    dev = ct.device
    L, N = ct.shape[-2], ct.shape[-1]
    qs = [int(q) for q in primes[:L]]
    Q = math.prod(qs)
    s = torch.from_numpy(np.asarray(secret, dtype=np.int64)).to(dev)
    whole = torch.zeros(ct.shape[:-3] + (N,), dtype=torch.int64, device=dev)
    frac = torch.zeros(ct.shape[:-3] + (N,), dtype=torch.float64, device=dev)
    for j, q in enumerate(qs):
        ring = negacyclic(q, N, str(dev))
        c0 = ct[..., 0, j, :].to(torch.int64)
        c1 = ct[..., 1, j, :].to(torch.int64)
        c1s = ring.inverse(ring.forward(c1) * ring.forward(s % q) % q)
        x = (c0 + c1s) % q
        y = x * (pow(Q // q % q, -1, q)) % q
        whole += y * t // q
        frac += (y * t % q).to(torch.float64) / q
    return (whole + torch.floor(frac + 0.5).to(torch.int64)) % t


def decode(poly: torch.Tensor, t: int) -> torch.Tensor:
    """Slot values [..., N] of plaintext polynomials [..., N] mod t: slot i
    holds the polynomial at ψ^(2·bitrev(i)+1), ψ the smallest generator's
    (t−1)/2N-th power: the slot order of the batch encoding that both
    parties of the protocol agree on."""
    N = poly.shape[-1]
    ring = negacyclic(t, N, str(poly.device))
    return ring.forward(poly.to(torch.int64) % t)[..., ring.brv]
