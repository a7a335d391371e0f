"""Cryptographically secure RNG and seed expansion (port of
``apsu_tpu/mpc/prg.py:CsRng`` and ``prg_bytes``).

``cryptography`` is imported inside the functions that use it, so the rest of
the package (and any caller that passes a ``numpy.random.Generator``) runs on
a host without it.
"""

from __future__ import annotations

import os

import numpy as np


class CsRng:
    """Cryptographically secure RNG exposing the ``numpy.random.Generator``
    subset the framework draws from (``integers`` / ``permutation`` /
    ``bytes`` / ``normal``), backed by AES-256-CTR keyed from OS entropy.
    Deterministic tests pass an explicit key of at least 16 bytes."""

    def __init__(self, key: bytes | None = None):
        from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

        if key is None:
            key = os.urandom(32)
        if len(key) < 16:
            raise ValueError("CsRng key must be at least 128 bits")
        self._enc = Cipher(
            algorithms.AES(key.ljust(32, b"\0")[:32]), modes.CTR(b"\0" * 16)
        ).encryptor()

    def bytes(self, n: int) -> bytes:
        return self._enc.update(b"\0" * int(n))

    def spawn(self) -> "CsRng":
        """Independent child stream (forward-secure split)."""
        return CsRng(self.bytes(32))

    def _u64(self, count: int) -> np.ndarray:
        return np.frombuffer(self.bytes(8 * count), dtype=np.uint64)

    def integers(self, low, high=None, size=None, dtype=np.int64, endpoint=False):
        if high is None:
            low, high = 0, low
        lo, hi = int(low), int(high) + (1 if endpoint else 0)
        span = hi - lo
        if span <= 0:
            raise ValueError("low >= high")
        n = int(np.prod(size)) if size is not None else 1
        # 64-bit draw mod span: bias < span/2^64 ≤ 2^-34 for every range the
        # protocol uses (≤ 30-bit moduli) — cryptographically negligible
        u = self._u64(n) % np.uint64(span)
        out = (u.astype(np.int64) + lo).astype(dtype)
        if size is None:
            return out.reshape(())[()]
        return out.reshape(size)

    def permutation(self, n: int) -> np.ndarray:
        # argsort of 128-bit random keys: collision probability ≤ n²/2^129
        a, b = self._u64(int(n)), self._u64(int(n))
        return np.lexsort((b, a)).astype(np.int64)

    def normal(self, loc: float = 0.0, scale: float = 1.0, size=None) -> np.ndarray:
        n = int(np.prod(size)) if size is not None else 1
        m = (n + 1) // 2
        # Box-Muller from 53-bit uniforms (u1 offset avoids log(0))
        u1 = (self._u64(m) >> np.uint64(11)).astype(np.float64) / (1 << 53)
        u2 = (self._u64(m) >> np.uint64(11)).astype(np.float64) / (1 << 53)
        r = np.sqrt(-2.0 * np.log1p(-u1))
        theta = 2.0 * np.pi * u2
        z = np.concatenate([r * np.cos(theta), r * np.sin(theta)])[:n]
        z = loc + scale * z
        if size is None:
            return z[0]
        return z.reshape(size)


def prg_bytes(seed: bytes, n: int) -> np.ndarray:
    """Expand a 16/32-byte seed to n pseudorandom bytes (AES-CTR)."""
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

    key = seed.ljust(16, b"\0")[:16] if len(seed) < 32 else seed[:32]
    if len(key) not in (16, 32):
        key = key.ljust(32, b"\0")
    enc = Cipher(algorithms.AES(key), modes.CTR(b"\0" * 16)).encryptor()
    return np.frombuffer(enc.update(b"\0" * n), dtype=np.uint8).copy()
