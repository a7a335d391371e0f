"""Oblivious switching network (share translation) over the Beneš router
(port of ``apsu_tpu/mpc/osn.py``).

The *programmer* knows a permutation π, the *holder* knows the value vector
x; afterwards they hold XOR shares of π(x).  Every switch consumes one
chosen 1-of-2 OT whose messages are the holder's wire-mask corrections
(straight / cross), batched into one OT-extension run over all switches.

The network is arbitrary-size (``native/benes.cpp``, AS-Waksman with 2/3-wire
base cases): n is used exactly, not padded to a power of two.  Both parties
derive the same switch → OT-index enumeration from the permutation-free
topology.  The straight-path correction of every switch is derived from the
OT pad y0 (the holder's next-level wire masks are mask_in ⊕ expand(y0)), so
only the cross correction travels: 32 bytes a switch.  Routes can be cached
on disk through ``APSU_BENES_CACHE_DIR``.

The router is the port's own copy of the reference's ``benes.cpp``, compiled
by ``g++`` on first use (``ops/_build.py:build_host``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
from functools import lru_cache
from pathlib import Path
from typing import List, Tuple

import numpy as np

from apsu_tpu_torch.mpc.duplex import Duplex
from apsu_tpu_torch.mpc.otext import expand_pad, ot_ext_recv, ot_ext_send
from apsu_tpu_torch.ops import _build

_SRC = Path(__file__).resolve().parent / "native" / "benes.cpp"


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build_host(_SRC)))
    vp, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.benes_any_topology.argtypes = [i64, vp, vp, vp]
    lib.benes_any_topology.restype = i64
    lib.benes_any_route.argtypes = [vp, i64, vp]
    lib.benes_any_route.restype = i64
    return lib


def _levels(n: int) -> int:
    return 2 * max(1, (n - 1).bit_length()) - 1


@lru_cache(maxsize=16)
def benes_topology(
    n: int,
) -> Tuple[int, List[Tuple[np.ndarray, np.ndarray, np.ndarray]]]:
    """Permutation-independent network of n wires: returns
    (n_switches, per-level [(a_idx, b_idx, ot_idx)]) where ot_idx is each
    switch's rank in the canonical emission order (= its OT instance)."""
    if n < 2:
        raise ValueError("a Beneš network needs at least 2 wires")
    cap = _levels(n) * ((n + 1) // 2)
    lev = np.zeros(cap, dtype=np.int64)
    a = np.zeros(cap, dtype=np.int64)
    b = np.zeros(cap, dtype=np.int64)
    cnt = _lib().benes_any_topology(n, lev.ctypes.data, a.ctypes.data, b.ctypes.data)
    per_level = []
    for L in range(_levels(n)):
        sel = np.nonzero(lev[:cnt] == L)[0]
        if len(sel):
            per_level.append((a[sel].copy(), b[sel].copy(), sel))
    return int(cnt), per_level


def benes_route(perm: np.ndarray) -> np.ndarray:
    """perm [n] (perm[out] = in, any n >= 2) -> settings [n_switches] uint8
    aligned to ``benes_topology(n)``'s OT enumeration.

    Routes are cached to APSU_BENES_CACHE_DIR when set, keyed by the
    permutation's digest."""
    n = len(perm)
    p = np.ascontiguousarray(perm, dtype=np.int64)

    cache_dir = os.environ.get("APSU_BENES_CACHE_DIR")
    cache_path = None
    if cache_dir:
        digest = hashlib.sha256(p.tobytes()).hexdigest()[:32]
        cache_path = os.path.join(cache_dir, f"benes-{n}-{digest}.npy")
        if os.path.exists(cache_path):
            return np.load(cache_path)

    cap = _levels(n) * ((n + 1) // 2)
    out = np.zeros(cap, dtype=np.uint8)
    cnt = _lib().benes_any_route(p.ctypes.data, n, out.ctypes.data)
    if cnt < 0:
        raise ValueError("benes_any_route: input is not a permutation")
    out = out[:cnt].copy()
    if cache_path:
        os.makedirs(cache_dir, exist_ok=True)
        np.save(cache_path, out)
    return out


def _expand_pads(pads: np.ndarray) -> np.ndarray:
    """[k, 16] OT pads -> [k, 32] correction keystream."""
    return expand_pad(pads, 32)


def osn_holder(ch: Duplex, values: np.ndarray, rng) -> np.ndarray:
    """Holder of x [n, 16] uint8; returns its share [n, 16] of π(x)
    (the programmer's π, unknown here)."""
    n = values.shape[0]
    n_sw, per_level = benes_topology(n)

    # one OT-extension batch for all switches (we are the OT sender); the
    # straight-path pads y0 become the wire-mask chain, so only the cross
    # corrections travel (32 B/switch instead of 64)
    y0, y1 = ot_ext_send(ch, n_sw, rng)
    p0 = _expand_pads(y0)
    p1 = _expand_pads(y1)

    # wire-mask chain: cur starts random; switched wires advance via the
    # straight pads (m0 == expand(y0) needs no transmission), pass-through
    # wires of a level keep their mask
    mask0 = rng.integers(0, 256, size=(n, 16), dtype=np.uint8)
    cur = mask0.copy()
    e1 = np.empty((n_sw, 32), dtype=np.uint8)
    for a, b, idx in per_level:
        r_in_a, r_in_b = cur[a], cur[b]
        r_out_a = r_in_a ^ p0[idx, :16]
        r_out_b = r_in_b ^ p0[idx, 16:]
        m1 = np.concatenate([r_in_b ^ r_out_a, r_in_a ^ r_out_b], axis=1)
        e1[idx] = m1 ^ p1[idx]
        cur[a] = r_out_a
        cur[b] = r_out_b
    ch.send(e1)
    # masked inputs
    ch.send(values ^ mask0)
    return cur


def osn_programmer(ch: Duplex, perm: np.ndarray, rng) -> np.ndarray:
    """Programmer of π (perm[out] = in over n elements); returns its
    share [n, 16]: share_prog ⊕ share_holder = x[π]."""
    n = len(perm)
    n_sw, per_level = benes_topology(n)
    settings = benes_route(perm)  # [n_sw]

    y = ot_ext_recv(ch, settings, rng)  # [n_sw, 16]
    e1 = ch.recv()                      # [n_sw, 32] cross corrections only
    pe = _expand_pads(y)
    # straight switches (c=0): correction IS expand(y0); cross: unmask e1
    corr = np.where(settings.astype(bool)[:, None], e1 ^ pe, pe)

    v = ch.recv().copy()                # masked inputs [n, 16]
    for a, b, idx in per_level:
        c = corr[idx]                   # per-switch correction (32B)
        swap = settings[idx].astype(bool)
        va, vb = v[a], v[b]
        new_a = np.where(swap[:, None], vb, va) ^ c[:, :16]
        new_b = np.where(swap[:, None], va, vb) ^ c[:, 16:]
        v[a] = new_a
        v[b] = new_b
    return v
