"""Item hashing and vectorized table-location functions (port of
``apsu_tpu/hash/items.py``; numpy only).

Items are 128-bit hashes held as ``np.uint64`` arrays of shape [n, 2]
(lo, hi words).  ``hash_item`` maps arbitrary input to that space with
Blake2b; ``LocFuncs`` are the cuckoo-table location functions: a vectorized
multiply-shift universal hash over the 128-bit value, seeded from a public
seed, so both parties (and both packages) place an item in the same slots.
Location functions need only spread well; the pseudorandomness guarantees
come from the slot-bound OPRF above them.

``Bitstring`` and ``Item`` are the value types, and ``encrypt_label`` /
``decrypt_label`` the label encryptor: AES-CTR under a key stretched from
(item, nonce), so only a party that knows an item can read its label.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass
from typing import Iterable, List

import numpy as np

ITEM_BYTES = 16


def hash_item(data) -> tuple:
    """Arbitrary input -> 128-bit value (lo, hi) via Blake2b."""
    if isinstance(data, str):
        data = data.encode()
    elif isinstance(data, int):
        data = data.to_bytes((max(data.bit_length(), 1) + 7) // 8, "little")
    h = hashlib.blake2b(data, digest_size=ITEM_BYTES).digest()
    return (
        int.from_bytes(h[:8], "little"),
        int.from_bytes(h[8:], "little"),
    )


def hash_items(items: Iterable) -> np.ndarray:
    """List of str/bytes/int -> [n, 2] uint64 (lo, hi)."""
    vals: List = items if hasattr(items, "__len__") else list(items)
    out = np.empty((len(vals), 2), dtype=np.uint64)
    for i, it in enumerate(vals):
        lo, hi = hash_item(it)
        out[i, 0] = lo
        out[i, 1] = hi
    return out


def random_items(n: int, rng: np.random.Generator) -> np.ndarray:
    """Synthetic 128-bit items (already in hash space), [n, 2] uint64."""
    return rng.integers(0, 1 << 64, size=(n, 2), dtype=np.uint64)


Label = bytes
EncryptedLabel = bytes


@dataclass(frozen=True)
class Bitstring:
    """A value of an exact bit length: ``data`` holds ceil(bit_count/8)
    bytes, the unused high bits of its last byte zero."""

    data: bytes
    bit_count: int

    def __post_init__(self):
        if len(self.data) != (self.bit_count + 7) // 8:
            raise ValueError("data length inconsistent with bit_count")
        rem = self.bit_count % 8
        if rem and (self.data[-1] >> rem):
            raise ValueError("padding bits of the last byte must be zero")


@dataclass(frozen=True)
class Item:
    """A 128-bit item value; ``Item.of`` hashes arbitrary input (Blake2b)."""

    lo: int
    hi: int

    @staticmethod
    def of(data) -> "Item":
        lo, hi = hash_item(data)
        return Item(lo, hi)

    def to_array(self) -> np.ndarray:
        return np.array([[self.lo, self.hi]], dtype=np.uint64)


HashedItem = Item  # post-OPRF values share the representation


def _label_key(item: np.ndarray, nonce: bytes, stretch: int = 2) -> bytes:
    """Key-stretched per-item label key: ``stretch`` rounds of Blake2b over
    the item's 16 bytes and the nonce."""
    seed = np.ascontiguousarray(item, dtype=np.uint64).tobytes() + nonce
    k = seed
    for _ in range(max(1, stretch)):
        k = hashlib.blake2b(k, digest_size=32, person=b"apsu-lblkey").digest()
    return k


def encrypt_label(label: bytes, item: np.ndarray, nonce: bytes) -> bytes:
    """AES-CTR encrypt a label under a key derived from (item, nonce); the
    16-byte nonce is prepended, so decryption needs only the item."""
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

    if len(nonce) != 16:
        raise ValueError("nonce must be 16 bytes")
    enc = Cipher(algorithms.AES(_label_key(item, nonce)), modes.CTR(nonce)).encryptor()
    return nonce + enc.update(bytes(label))


def decrypt_label(blob: bytes, item: np.ndarray) -> bytes:
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

    nonce, ct = bytes(blob[:16]), bytes(blob[16:])
    dec = Cipher(algorithms.AES(_label_key(item, nonce)), modes.CTR(nonce)).decryptor()
    return dec.update(ct)


class LocFuncs:
    """hash_func_count vectorized multiply-shift location functions.

    loc_i(x) = high64((x_lo·A_i + x_hi·B_i + C_i) mod 2^64 scaled to table):
    a xorshift-multiply mix, then the Lemire reduction
    ``(v * table_size) >> 64`` in uint64 arithmetic split into 32-bit halves.
    """

    def __init__(self, table_size: int, func_count: int, seed: bytes = b"apsu-loc"):
        self.table_size = int(table_size)
        self.func_count = int(func_count)
        st = np.random.Generator(
            np.random.Philox(
                int.from_bytes(hashlib.blake2b(seed, digest_size=8).digest(), "little")
            )
        )
        self.A = st.integers(0, 1 << 64, size=func_count, dtype=np.uint64) | np.uint64(1)
        self.B = st.integers(0, 1 << 64, size=func_count, dtype=np.uint64) | np.uint64(1)
        self.C = st.integers(0, 1 << 64, size=func_count, dtype=np.uint64)

    def locations(self, items: np.ndarray) -> np.ndarray:
        """items [n, 2] uint64 -> [n, func_count] int64 table locations
        (per-function in-place column passes over uint64 temporaries)."""
        n = items.shape[0]
        lo = np.ascontiguousarray(items[:, 0])
        hi = np.ascontiguousarray(items[:, 1])
        out = np.empty((self.func_count, n), dtype=np.int64)
        m = np.uint64(self.table_size)
        t = np.empty(n, np.uint64)
        for i in range(self.func_count):
            v = lo * self.A[i]
            np.multiply(hi, self.B[i], out=t)
            v += t
            v += self.C[i]
            # mix before reduction (xorshift-multiply)
            np.right_shift(v, np.uint64(33), out=t)
            v ^= t
            v *= np.uint64(0xFF51AFD7ED558CCD)
            np.right_shift(v, np.uint64(33), out=t)
            v ^= t
            # Lemire map to [0, table_size): high 64 bits of v * table_size
            np.bitwise_and(v, np.uint64(0xFFFFFFFF), out=t)
            t *= m
            t >>= np.uint64(32)
            v >>= np.uint64(32)
            v *= m
            v += t
            v >>= np.uint64(32)
            out[i] = v.astype(np.int64)
        return np.ascontiguousarray(out.T)
