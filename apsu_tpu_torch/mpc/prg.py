"""AES-backed PRG, correlation-robust hashing and the party RNG (port of
``apsu_tpu/mpc/prg.py``).

Every hot loop is one C call through the ``cryptography`` package's OpenSSL
backend over a large numpy buffer: AES-CTR for seed expansion, AES-ECB under
a fixed public key for the Matyas–Meyer–Oseas hash of the OT extensions, and
AES under derived public keys for KKRT's pseudorandom code.  ``cryptography``
is imported inside the functions that use it, so the rest of the package (and
any caller that passes a ``numpy.random.Generator``) runs on a host without
it.
"""

from __future__ import annotations

import os

import numpy as np

_FIXED_KEY = bytes(range(16))


class CsRng:
    """Cryptographically secure RNG exposing the ``numpy.random.Generator``
    subset the framework draws from (``integers`` / ``permutation`` /
    ``bytes`` / ``normal``), backed by AES-256-CTR keyed from OS entropy.
    Deterministic tests pass an explicit key of at least 16 bytes.

    ``reserve`` hands the next bytes of the stream to a drawer that makes
    them elsewhere (the receiver's mask, on the card: ``ops/ctr_mod.py``);
    every draw after it reads on from the byte after them, so the stream is
    the same whichever bytes were made where."""

    def __init__(self, key: bytes | None = None):
        if key is None:
            key = os.urandom(32)
        if len(key) < 16:
            raise ValueError("CsRng key must be at least 128 bits")
        self._key = key.ljust(32, b"\0")[:32]
        self._pos = 0   # the bytes of the stream drawn or reserved so far
        self._enc = self._enter()

    def _enter(self):
        """An AES-CTR encryptor positioned at byte ``_pos`` of the stream."""
        from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

        block, skip = divmod(self._pos, 16)
        enc = Cipher(algorithms.AES(self._key), modes.CTR(block.to_bytes(16, "big"))).encryptor()
        enc.update(b"\0" * skip)
        return enc

    def bytes(self, n: int) -> bytes:
        if self._enc is None:   # the first draw after a reservation
            self._enc = self._enter()
        self._pos += int(n)
        return self._enc.update(b"\0" * int(n))

    def reserve(self, n: int) -> tuple:
        """Pass over the next ``n`` bytes of the stream without making them:
        ``(key, counter, offset)``, the 32-byte AES-256 key, the number of
        the CTR block that holds their first byte and that byte's place in
        it (0-15).  ``ops/ctr_mod.py`` makes them from these."""
        counter, offset = divmod(self._pos, 16)
        self._pos += int(n)
        self._enc = None
        return self._key, counter, offset

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


def prg_bits(seed: bytes, nbits: int) -> np.ndarray:
    """n pseudorandom bits as a uint8 0/1 array."""
    nbytes = (nbits + 7) // 8
    return np.unpackbits(prg_bytes(seed, nbytes))[:nbits]


def _ecb(key: bytes, blocks: np.ndarray) -> np.ndarray:
    """AES-ECB under ``key`` over [n, 16·w] uint8 rows (one C call)."""
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

    enc = Cipher(algorithms.AES(key), modes.ECB()).encryptor()
    return np.frombuffer(enc.update(blocks.tobytes()), dtype=np.uint8).reshape(blocks.shape)


def aes_ecb_fixed(blocks: np.ndarray) -> np.ndarray:
    """AES-ECB under the fixed key over [n, 16] uint8 blocks (one C call)."""
    return _ecb(_FIXED_KEY, np.ascontiguousarray(blocks, dtype=np.uint8))


def mmo_hash(blocks: np.ndarray, tweak: int = 0) -> np.ndarray:
    """Matyas–Meyer–Oseas: H(x) = AES_fk(x ⊕ t) ⊕ (x ⊕ t), vectorized.

    blocks: [n, 16] uint8.  The tweak is an 8-byte little-endian counter
    XORed into the first 8 bytes — instance separation for OT pads.
    """
    x = np.ascontiguousarray(blocks, dtype=np.uint8).copy()
    if tweak:
        t = np.frombuffer(int(tweak).to_bytes(8, "little"), dtype=np.uint8)
        x[:, :8] ^= t
    return aes_ecb_fixed(x) ^ x


def mmo_hash_indexed(blocks: np.ndarray) -> np.ndarray:
    """Per-row-index tweaked MMO: H(i, x_i) for rows i (OT instance binding)."""
    x = np.ascontiguousarray(blocks, dtype=np.uint8).copy()
    n = x.shape[0]
    idx = np.arange(n, dtype=np.uint64)
    x[:, :8] ^= idx.view(np.uint8).reshape(n, 8)
    return aes_ecb_fixed(x) ^ x


def aes_code(inputs: np.ndarray, width_blocks: int) -> np.ndarray:
    """Pseudorandom code C(x): [n, 16] -> [n, 16·width_blocks] uint8.

    KKRT's code (eprint 2016/799 uses a PRC): output block w is AES of the
    input block under the public key ``bytes([w + 1]) * 16``, XORed with the
    input.
    """
    x = np.ascontiguousarray(inputs, dtype=np.uint8)
    return np.concatenate(
        [_ecb(bytes([w + 1]) * 16, x) ^ x for w in range(width_blocks)], axis=1
    )


def pack_bits_rows(bits: np.ndarray) -> np.ndarray:
    """[r, c] 0/1 uint8 -> [r, ceil(c/8)] packed (little-endian bit order)."""
    return np.packbits(bits, axis=-1, bitorder="little")


def unpack_bits_rows(packed: np.ndarray, c: int) -> np.ndarray:
    return np.unpackbits(packed, axis=-1, bitorder="little", count=c)
