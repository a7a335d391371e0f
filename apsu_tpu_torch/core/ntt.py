"""Negacyclic NTT over RNS limbs — table context (port of
``apsu_tpu/core/ntt.py:NttContext``).

The tables are built by the reference's numpy code: forward twiddles
``W[j] = ψ^{bitrev(j)}`` (ψ a primitive 2N-th root), inverse twiddles
``W[j]^{-1}``, N^{-1}, each with its Shoup companion ``⌊w·2^32/p⌋``.  The
transform itself lives in ``ops/ntt.py``: the CUDA kernel for CUDA tensors,
the plain staged transform for CPU tensors.  Data stays in Montgomery form
throughout (Shoup multiplies by PLAIN twiddles preserve the form of the
variable operand).
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from apsu_tpu_torch.core import nt
from apsu_tpu_torch.core.mod32 import PrimeConst, col, from_u32, prime_consts, shoup_pair
from apsu_tpu_torch.device import resolve
from apsu_tpu_torch.ops import ntt as ntt_op


class NttContext:
    """Tables for a fixed (primes, N) pair on one device."""

    def __init__(self, primes: Sequence[int], n: int, device="cuda"):
        assert n & (n - 1) == 0, "N must be a power of two"
        self.primes = [int(p) for p in primes]
        self.n = n
        self.logn = n.bit_length() - 1
        self.L = len(self.primes)
        self.device = resolve(device)
        self.consts: PrimeConst = prime_consts(self.primes)

        brev = nt.bit_reverse_perm(n)
        w_pl = np.zeros((self.L, n), dtype=np.uint32)
        winv_pl = np.zeros((self.L, n), dtype=np.uint32)
        ninv_pl = np.zeros((self.L,), dtype=np.uint32)
        for l, p in enumerate(self.primes):
            psi = nt.root_of_unity(2 * n, p)
            psi_inv = pow(psi, -1, p)
            psi_pows = np.empty(n, dtype=np.uint64)
            ipsi_pows = np.empty(n, dtype=np.uint64)
            cur, icur = 1, 1
            for i in range(n):
                psi_pows[i] = cur
                ipsi_pows[i] = icur
                cur = cur * psi % p
                icur = icur * psi_inv % p
            w_pl[l] = psi_pows[brev].astype(np.uint32)
            winv_pl[l] = ipsi_pows[brev].astype(np.uint32)
            ninv_pl[l] = pow(n, -1, p)
        ps = np.array(self.primes, np.uint32)
        w_sh = shoup_pair(w_pl, ps[:, None])
        winv_sh = shoup_pair(winv_pl, ps[:, None])
        ninv_sh = shoup_pair(ninv_pl, ps)

        dev = self.device
        # int64 tables for the plain staged transform
        self.p_col = col(self.primes, dev)
        self.w_pl = col(w_pl, dev, (self.L, n))
        self.w_sh = col(w_sh, dev, (self.L, n))
        self.winv_pl = col(winv_pl, dev, (self.L, n))
        self.winv_sh = col(winv_sh, dev, (self.L, n))
        self.ninv_pl_col = col(ninv_pl, dev)
        self.ninv_sh_col = col(ninv_sh, dev)
        # the same tables as uint32 bits for the kernel
        if dev.type == "cuda":
            self.p_u32 = from_u32(ps, dev)
            self.w_pl_u32 = from_u32(w_pl, dev)
            self.w_sh_u32 = from_u32(w_sh, dev)
            self.winv_pl_u32 = from_u32(winv_pl, dev)
            self.winv_sh_u32 = from_u32(winv_sh, dev)
            self.ninv_pl_u32 = from_u32(ninv_pl, dev)
            self.ninv_sh_u32 = from_u32(ninv_sh, dev)

    def ntt(self, x: torch.Tensor) -> torch.Tensor:
        """Forward negacyclic NTT over the last axis. x: [..., L, N] mont."""
        return ntt_op.ntt(x.contiguous(), self)

    def intt(self, x: torch.Tensor) -> torch.Tensor:
        """Inverse transform (exact reversal of the forward stages) + N^{-1}."""
        return ntt_op.ntt(x.contiguous(), self, inverse=True)
