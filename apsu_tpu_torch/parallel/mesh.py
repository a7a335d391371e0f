"""The device mesh of the sharded query (port of ``apsu_tpu/parallel/mesh.py``).

The reference's mesh is a ``jax.sharding.Mesh``: one process drives many
devices, and the cache's flattened (bundle × cache) row axis shards over
them.  Here a ``Mesh`` is an ordered tuple of ``torch.device``s, one per
shard; shard i owns the contiguous row range ``row_ranges(rows, n)[i]``
(near-even, the split of ``multihost.partition_bundles``), runs its rows on
its own device and the results are concatenated in row order.  PyTorch needs
no equal shapes, so uneven ranges replace the reference's zero-row padding.

A device may repeat: a mesh of k shards on one card runs the same k-way
partition as k cards would, which is how one card checks it.  The reference's
``bundle_sharding``/``replicated`` (``NamedSharding`` specs) have no
counterpart: a shard's tensors are moved to its device explicitly.  The
multi-process axis is ``parallel/multihost.py``'s, over sockets.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Sequence, Tuple

import torch

from apsu_tpu_torch.device import canonical, resolve


def row_ranges(rows: int, n: int) -> List[Tuple[int, int]]:
    """``n`` contiguous near-even ranges covering [0, rows): the first
    ``rows % n`` ranges hold one row more (empty ranges when rows < n)."""
    base, extra = divmod(rows, n)
    out, r = [], 0
    for i in range(n):
        size = base + (1 if i < extra else 0)
        out.append((r, r + size))
        r += size
    return out


@dataclass(frozen=True)
class Mesh:
    """Ordered shard devices along one named axis."""

    devices: Tuple[torch.device, ...]
    axis: str = "bundle"

    @property
    def size(self) -> int:
        return len(self.devices)

    def row_ranges(self, rows: int) -> List[Tuple[int, int]]:
        return row_ranges(rows, self.size)


def make_mesh(n_devices: Optional[int] = None, devices: Optional[Sequence] = None,
              axis: str = "bundle") -> Mesh:
    """A mesh over ``devices`` (any torch devices, repeats allowed; e.g.
    ``["cpu"] * 8``), or over the first ``n_devices`` visible CUDA devices
    (all of them by default), which raises when CUDA is absent."""
    if devices is None:
        resolve("cuda")
        count = torch.cuda.device_count()
        devices = [f"cuda:{i}" for i in range(n_devices or count)]
        if len(devices) > count:
            raise ValueError(f"{len(devices)} devices asked for, {count} visible")
    elif n_devices is not None:
        devices = list(devices)[:n_devices]
    devs = tuple(canonical(resolve(d)) for d in devices)
    if not devs:
        raise ValueError("a mesh needs at least one device")
    return Mesh(devs, axis)
