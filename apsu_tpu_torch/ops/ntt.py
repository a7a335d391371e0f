"""Kernel 1: the negacyclic NTT over RNS limbs (``csrc/ntt.cu``) and its
plain PyTorch version.

Replaces the TPU kernel ``apsu_tpu/ops/ntt4_pallas.py:ntt4_pallas`` (the
default for every transform at N=8192 with primes < 2^28).  On the H100 the
transform is bound by device-memory bytes (each residue read and written
once) with the integer work close behind.  Each thread holds 16 residues of
a row and runs up to four stages on them in registers between exchanges
through bank-conflict-free shared memory, so a row of 8192 needs three
exchanges instead of one shared-memory round trip per stage; butterflies
are lazy Shoup products on ``__umulhi`` with one canonicalization at the
end.  It takes any power-of-two N up to 8192 and any prime < 2^30, so it
also covers the other TPU NTT kernels (``ntt_pallas``, ``ntt_pair``,
``ntt4_pallas_gl``).

``ntt(x, tables, inverse)`` launches the kernel for a CUDA tensor and runs the
plain staged transform for a CPU tensor; both give canonical residues
bit-identical to ``apsu_tpu.core.ntt.NttContext.ntt/intt``.
"""

from __future__ import annotations

import torch

from apsu_tpu_torch.core.mod32 import I32, I64, shoup_mul_lazy
from apsu_tpu_torch.ops import _build

# kernel launches since the last reset (set to 0 to reset); a launch captured
# into a CUDA graph is counted at each replay (``ops/counts.py``)
launches = 0

MAX_LOGN = 13  # 32 KB row in shared memory


def ntt(x: torch.Tensor, tb, inverse: bool = False) -> torch.Tensor:
    """Forward (or inverse) NTT of ``x`` [..., L, N] int32 canonical residues
    with the tables of ``tb`` (an ``NttContext`` on ``x``'s device)."""
    if x.device.type == "cpu":
        return ntt_plain(x, tb, inverse)
    return ntt_cuda(x, tb, inverse)


def ntt_cuda(x: torch.Tensor, tb, inverse: bool = False) -> torch.Tensor:
    global launches
    n, L = tb.n, tb.L
    if not x.is_cuda:
        raise ValueError("ntt_cuda needs a CUDA tensor")
    if x.dtype != I32:
        raise TypeError(f"ntt_cuda needs int32 residues, got {x.dtype}")
    if x.dim() < 2 or x.shape[-2] != L or x.shape[-1] != n:
        raise ValueError(f"ntt_cuda needs [..., {L}, {n}], got {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("ntt_cuda needs a contiguous, 16-byte aligned tensor")
    if not (1 <= tb.logn <= MAX_LOGN) or max(tb.primes) >= 1 << 30:
        raise ValueError("ntt_cuda takes N <= 8192 and primes < 2^30")
    if tb.w_pl_u32.device != x.device:
        raise ValueError("NTT tables live on another device than the input")
    rows = x.numel() // n
    if rows >= 1 << 31:
        raise ValueError("too many rows for one launch")
    out = torch.empty_like(x)
    if rows == 0:
        return out
    if inverse:
        tw, tw_sh = tb.winv_pl_u32, tb.winv_sh_u32
    else:
        tw, tw_sh = tb.w_pl_u32, tb.w_sh_u32
    launches += _build.launch(
        "ntt", _build.lib().apsu_ntt, x.get_device(),
        x.data_ptr(), out.data_ptr(), tw.data_ptr(), tw_sh.data_ptr(),
        tb.p_u32.data_ptr(), tb.ninv_pl_u32.data_ptr(),
        tb.ninv_sh_u32.data_ptr(), rows, L, tb.logn, int(inverse),
    )
    return out


def ntt_plain(x: torch.Tensor, tb, inverse: bool = False) -> torch.Tensor:
    """Staged Harvey transform in int64 (the counterpart of the reference's
    ``core/ntt.py`` staged path): lazy Shoup butterflies, values in [0, 4p)
    between forward stages ([0, 2p) inverse), canonical output (int32)."""
    n, L = tb.n, tb.L
    lead = x.shape[:-2]
    p = tb.p_col.reshape(L, 1, 1)
    two_p = p + p
    x = x.to(I64)
    if not inverse:
        w, wsh = tb.w_pl, tb.w_sh
        for s in range(tb.logn):
            m = 1 << s
            t = n >> (s + 1)
            xs = x.reshape(lead + (L, m, 2, t))
            tw = w[:, m: 2 * m].reshape(L, m, 1)
            tws = wsh[:, m: 2 * m].reshape(L, m, 1)
            u = xs[..., 0, :]
            u = torch.where(u >= two_p, u - two_p, u)
            v = shoup_mul_lazy(xs[..., 1, :], tw, tws, p)
            x = torch.stack([u + v, (u + two_p) - v], dim=-2).reshape(lead + (L, n))
        p = tb.p_col
        x = torch.where(x >= 2 * p, x - 2 * p, x)
        return torch.where(x >= p, x - p, x).to(I32)
    w, wsh = tb.winv_pl, tb.winv_sh
    for s in reversed(range(tb.logn)):
        m = 1 << s
        t = n >> (s + 1)
        xs = x.reshape(lead + (L, m, 2, t))
        tw = w[:, m: 2 * m].reshape(L, m, 1)
        tws = wsh[:, m: 2 * m].reshape(L, m, 1)
        u = xs[..., 0, :]
        v = xs[..., 1, :]
        a = u + v
        a = torch.where(a >= two_p, a - two_p, a)
        b = shoup_mul_lazy((u + two_p) - v, tw, tws, p)
        x = torch.stack([a, b], dim=-2).reshape(lead + (L, n))
    p = tb.p_col
    x = shoup_mul_lazy(x, tb.ninv_pl_col, tb.ninv_sh_col, p)
    return torch.where(x >= p, x - p, x).to(I32)
