"""The table of peaks and the work each kernel must do, from the shapes.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet): HBM3 at 3.35 TB/s; the
INT32 rate is 132 SMs × 64 INT32 lanes × 1.98 GHz boost (Hopper white
paper).  A kernel's bound is the larger of its bytes at the HBM rate and its
32-bit multiplies at the INT32 rate.  Each input byte counts as read once
and each output byte as written once, whatever the kernel reads again.
"""

from __future__ import annotations

import math

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9


def bound_s(nbytes: float, mults: float) -> float:
    return max(nbytes / HBM_BYTES_PER_S, mults / INT32_OPS_PER_S)


def ps_work(low_shape, cache_shape) -> tuple:
    """Bytes and 32-bit multiplies of the PS inner sums (K2): cache planes
    1..ph−1 of every segment, the low powers and the output moved once; one
    32×32→64 product per plane, lane and component (2 components), 2
    multiplies each.  ``low_shape`` [B, ℓ, 2, L, N], ``cache_shape``
    [R, segments, ph, ...]."""
    B, ell, _, L, N = low_shape
    R, nseg, ph = cache_shape[:3]
    nbytes = (R * nseg * (ph - 1) * L * N + B * ell * 2 * L * N + R * nseg * 2 * L * N) * 4
    return nbytes, 4 * R * nseg * (ph - 1) * L * N


def dot_work(powers_shape, cache_shape) -> tuple:
    """Bytes and 32-bit multiplies of the matching dot product (K3): cache
    planes 1..D of every cache, the powers and the output moved once; one
    product per plane, lane and component, 2 multiplies each.
    ``powers_shape`` [B, D, 2, L, N], ``cache_shape`` [B, C, ...]."""
    B, D, _, L, N = powers_shape
    C = cache_shape[1]
    nbytes = (B * C * D * L * N + B * D * 2 * L * N + B * C * 2 * L * N) * 4
    return nbytes, 4 * B * C * D * L * N


def ps_shapes(cache_shape, ps_low_degree: int, max_per_bin: int) -> tuple:
    """K2's (low powers, segmented cache) shapes from the DB's cache
    [B, C, planes, L, N]: ℓ low powers, ceil((K+1)/(ℓ+1)) segments of ℓ+1."""
    B, C, _, L, N = cache_shape
    ph = ps_low_degree + 1
    return [B, ps_low_degree, 2, L, N], [B * C, math.ceil((max_per_bin + 1) / ph), ph, L, N]


def dot_shapes(cache_shape, max_per_bin: int) -> tuple:
    """K3's (powers, cache) shapes: the K powers x^1..x^K of every bundle."""
    B, C, _, L, N = cache_shape
    return [B, max_per_bin, 2, L, N], list(cache_shape)


def roofline_pct(bound: float, measured: float) -> float:
    return 100.0 * bound / measured
