"""CSV input/output (port of ``apsu_tpu/cli/csv_io.py``): one item per
line, an optional label after a comma (labels are unused in the union
protocol)."""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from apsu_tpu_torch.hash.items import hash_items

BLOCK = 16


def read_items_csv(path: str) -> List[str]:
    out = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            out.append(line.split(",")[0])
    return out


def encode_payloads(strings: List[str]) -> np.ndarray:
    """utf-8 item strings -> [n, W] uint8 payload blocks.

    Items of any length: W = 2-byte length prefix + longest item, rounded
    up to 16-byte blocks; the OT endgame carries any width.
    """
    enc = [s.encode() for s in strings]
    longest = max((len(b) for b in enc), default=0)
    W = max(BLOCK, ((longest + 2 + BLOCK - 1) // BLOCK) * BLOCK)
    out = np.zeros((len(enc), W), dtype=np.uint8)
    for i, b in enumerate(enc):
        if len(b) > 0xFFFE:
            raise ValueError(f"item longer than 65534 bytes: {strings[i][:40]!r}…")
        out[i, 0] = len(b) & 0xFF
        out[i, 1] = len(b) >> 8
        out[i, 2 : 2 + len(b)] = np.frombuffer(b, dtype=np.uint8)
    return out


def decode_payloads(blocks: np.ndarray) -> List[str]:
    out = []
    for row in blocks:
        n = int(row[0]) | (int(row[1]) << 8)
        if n > len(row) - 2:  # garbage / sentinel remnants
            continue
        out.append(bytes(row[2 : 2 + n]).decode(errors="replace"))
    return out


def load_csv(path: str) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """-> (items [n,2] uint64 hashes, payloads [n,16] uint8, originals)."""
    strings = read_items_csv(path)
    return hash_items(strings), encode_payloads(strings), strings


def write_union_csv(path: str, strings: List[str]) -> None:
    with open(path, "w") as f:
        for s in strings:
            f.write(s + "\n")
