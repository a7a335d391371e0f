"""Cuckoo hashing for the query side (small set) — port of
``apsu_tpu/hash/cuckoo.py``: insert every item at one of its
``hash_func_count`` locations with random-walk eviction (500 attempts, no
stash), and remember which original item fills each slot.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from apsu_tpu_torch.hash.items import LocFuncs


class CuckooFullError(RuntimeError):
    pass


@dataclass
class CuckooTable:
    table: np.ndarray        # [table_size, 2] uint64 item values (junk where empty)
    filled: np.ndarray       # [table_size] bool
    item_index: np.ndarray   # [table_size] int64: original index or -1

    @property
    def table_size(self) -> int:
        return self.table.shape[0]


def cuckoo_insert(
    items: np.ndarray,
    table_size: int,
    func_count: int,
    locs: LocFuncs | None = None,
    max_attempts: int = 500,
    seed: int = 0,
) -> CuckooTable:
    """Insert [n, 2] items; raises CuckooFullError on failure."""
    n = items.shape[0]
    if n > table_size:
        raise CuckooFullError(f"{n} items cannot fit a table of {table_size}")
    locs = locs or LocFuncs(table_size, func_count)
    all_locs = locs.locations(items)  # [n, h]
    table_item = np.full(table_size, -1, dtype=np.int64)
    rng = np.random.default_rng(seed)

    for idx in range(n):
        cur = idx
        for _attempt in range(max_attempts):
            candidates = all_locs[cur]
            empty = candidates[table_item[candidates] < 0]
            if empty.size:
                table_item[empty[0]] = cur
                break
            # evict a random occupant
            slot = candidates[rng.integers(0, len(candidates))]
            victim = table_item[slot]
            table_item[slot] = cur
            cur = victim
        else:
            raise CuckooFullError("cuckoo eviction limit reached")

    filled = table_item >= 0
    table = np.empty((table_size, 2), dtype=np.uint64)
    # junk values for empty slots: random, so their PRFs never match anything
    junk = np.random.default_rng(seed ^ 0x9E37).integers(
        0, 1 << 64, size=(table_size, 2), dtype=np.uint64
    )
    table[:] = junk
    table[filled] = items[table_item[filled]]
    return CuckooTable(table=table, filled=filled, item_index=table_item)
