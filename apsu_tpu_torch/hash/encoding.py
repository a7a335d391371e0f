"""PRF outputs -> field elements (port of ``apsu_tpu/hash/encoding.py``).

An item's effective value is the low ``felts_per_item · bits_per_felt`` bits
of its 128-bit (slot-bound) PRF output, split little-endian into
``felts_per_item`` chunks of ``bits_per_felt = floor(log2(t))`` bits each.
Every chunk value is < 2^bits_per_felt ≤ t, hence a valid plaintext slot.
"""

from __future__ import annotations

import numpy as np


def felts_from_items(
    items: np.ndarray, felts_per_item: int, bits_per_felt: int
) -> np.ndarray:
    """items [n, 2] uint64 (lo, hi) -> [n, felts_per_item] uint32 felts."""
    n = items.shape[0]
    total_bits = felts_per_item * bits_per_felt
    if total_bits > 128:
        raise ValueError("item bit count exceeds 128")
    out = np.empty((n, felts_per_item), dtype=np.uint32)
    lo = items[:, 0]
    hi = items[:, 1]
    for f in range(felts_per_item):
        start = f * bits_per_felt
        # extract bits [start, start + bits_per_felt) of the 128-bit value
        if start >= 64:
            chunk = hi >> np.uint64(start - 64)
        else:
            chunk = lo >> np.uint64(start)
            if start + bits_per_felt > 64:
                chunk = chunk | (hi << np.uint64(64 - start))
        out[:, f] = (chunk & np.uint64((1 << bits_per_felt) - 1)).astype(np.uint32)
    return out


def items_from_felts(felts: np.ndarray, bits_per_felt: int) -> np.ndarray:
    """Inverse of felts_from_items (reconstructs matched values)."""
    n, fpi = felts.shape
    lo = np.zeros(n, dtype=np.uint64)
    hi = np.zeros(n, dtype=np.uint64)
    for f in range(fpi):
        start = f * bits_per_felt
        v = felts[:, f].astype(np.uint64)
        if start >= 64:
            hi |= v << np.uint64(start - 64)
        else:
            lo |= (v << np.uint64(start)) & np.uint64(0xFFFFFFFFFFFFFFFF)
            if start + bits_per_felt > 64:
                hi |= v >> np.uint64(64 - start)
    return np.stack([lo, hi], axis=1)
