"""ctypes binding of the native Edwards25519 batch library (port of
``apsu_tpu/mpc/ec.py``).

The library is the port's own copy, ``mpc/native/ec25519.cpp``, compiled by
``g++`` on first use into ``apsu_tpu_torch/_build/<hash>/``
(``ops/_build.py:build_host``); a failed build or a failed self-test raises.
All entry points take numpy batches: points are compressed 32-byte rows of an
[n, 32] uint8 array, scalars 32-byte little-endian rows.
"""

from __future__ import annotations

import ctypes
from functools import lru_cache
from pathlib import Path

import numpy as np

from apsu_tpu_torch.ops import _build

# group order ℓ of the prime-order subgroup
ORDER = 2**252 + 27742317777372353535851937790883648493

_SRC = Path(__file__).resolve().parent / "native" / "ec25519.cpp"


@lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(_build.build_host(_SRC)))
    vp, n = ctypes.c_void_p, ctypes.c_long
    for name, args in (
        ("ge_scalarmult_batch", [vp, vp, vp, n]),
        ("ge_base_mult_batch", [vp, vp, n]),
        ("ge_hash_to_point_batch", [vp, vp, n]),
        ("ge_add_batch", [vp, vp, vp, n]),
        ("ge_sub_batch", [vp, vp, vp, n]),
    ):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, None
    lib.ge_selftest.argtypes, lib.ge_selftest.restype = [], ctypes.c_int
    if not lib.ge_selftest():
        raise RuntimeError("ec25519 self-test failed")
    return lib


def _check(points: np.ndarray) -> np.ndarray:
    a = np.ascontiguousarray(points, dtype=np.uint8)
    if a.ndim != 2 or a.shape[1] != 32:
        raise ValueError(f"expected [n, 32] uint8 rows, got {a.shape}")
    return a


def scalars_to_bytes(scalars) -> np.ndarray:
    """ints mod ORDER -> [n, 32] little-endian bytes."""
    out = np.zeros((len(scalars), 32), dtype=np.uint8)
    for i, s in enumerate(scalars):
        out[i] = np.frombuffer(int(s % ORDER).to_bytes(32, "little"), dtype=np.uint8)
    return out


def random_scalars(n: int, rng) -> list:
    """[n] python ints uniform in [1, ORDER)."""
    return [int.from_bytes(rng.bytes(32), "little") % (ORDER - 1) + 1 for _ in range(n)]


def _out(n: int) -> np.ndarray:
    return np.empty((n, 32), dtype=np.uint8)


def scalar_mult(points: np.ndarray, scalars_b: np.ndarray) -> np.ndarray:
    points, scalars_b = _check(points), _check(scalars_b)
    if scalars_b.shape[0] != points.shape[0]:
        raise ValueError("one scalar per point")
    out = _out(points.shape[0])
    _lib().ge_scalarmult_batch(out.ctypes.data, points.ctypes.data, scalars_b.ctypes.data,
                               points.shape[0])
    return out


def base_mult(scalars_b: np.ndarray) -> np.ndarray:
    scalars_b = _check(scalars_b)
    out = _out(scalars_b.shape[0])
    _lib().ge_base_mult_batch(out.ctypes.data, scalars_b.ctypes.data, scalars_b.shape[0])
    return out


def hash_to_point(seeds: np.ndarray) -> np.ndarray:
    seeds = _check(seeds)
    out = _out(seeds.shape[0])
    _lib().ge_hash_to_point_batch(out.ctypes.data, seeds.ctypes.data, seeds.shape[0])
    return out


def _pairwise(fn, ps: np.ndarray, qs: np.ndarray) -> np.ndarray:
    ps, qs = _check(ps), _check(qs)
    if ps.shape != qs.shape:
        raise ValueError("point batches differ in length")
    out = _out(ps.shape[0])
    fn(out.ctypes.data, ps.ctypes.data, qs.ctypes.data, ps.shape[0])
    return out


def point_add(ps: np.ndarray, qs: np.ndarray) -> np.ndarray:
    return _pairwise(_lib().ge_add_batch, ps, qs)


def point_sub(ps: np.ndarray, qs: np.ndarray) -> np.ndarray:
    return _pairwise(_lib().ge_sub_batch, ps, qs)
