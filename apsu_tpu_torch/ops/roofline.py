"""Kernels 9 and 10: the ceiling probes (``csrc/roofline.cu``) and their
plain PyTorch versions.

Kernel 9, ``vpu_loop``, replaces the TPU kernel
``tools/vpu_roofline.py:run_kernel``: per element, ``outer`` times over,
``x = acc`` and then ``REPS`` dependent steps ``acc = step(acc, x)`` of one of
four products (``OPS``) on u32 values with wraparound.  It is bound by integer
instruction issue; ``apsu_tpu_torch.tools.vpu_roofline`` times it to measure
the card's rate for each product.

Kernel 10, ``add_one``, replaces ``tools/ntt4p_gl_ab.py:trivial``: ``x + 1``
with u32 wraparound.  It is bound by device-memory bytes;
``apsu_tpu_torch.tools.vpu_roofline`` times it for the streaming rate and
``apsu_tpu_torch.tools.ntt4p_gl_ab`` for the per-call floor.

Tensors are int32 holding u32 bits (any value, negative where the u32 is
>= 2^31).  Each wrapper launches its kernel for a CUDA tensor and runs the
plain version, in int64 and bit-identical, for a CPU tensor.
"""

from __future__ import annotations

import torch

from apsu_tpu_torch.core.mod32 import I32, I64, MASK32, mul_hi, mul_lo, mul_wide
from apsu_tpu_torch.ops import _build

REPS = 64                          # dependent steps per outer round (the kernel's constant)
P = (1 << 28) - 57                 # the reference tool's prime
PNI = (-pow(P, -1, 1 << 32)) % (1 << 32)
OPS = ("mul32", "mul_wide", "mont_mul", "shoup_lazy")   # the C entry's op codes, in order

# kernel launches since the last reset (set to 0 to reset); a launch captured
# into a CUDA graph is counted at each replay (``ops/counts.py``)
loop_launches = 0   # vpu_loop kernel launches
add_launches = 0    # add_one kernel launches


def _check(x: torch.Tensor, name: str) -> None:
    if x.dtype != I32:
        raise TypeError(f"{name} needs int32 (u32 bits), got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError(f"{name} needs a contiguous tensor")


def _op_code(op: str) -> int:
    if op not in OPS:
        raise ValueError(f"unknown op {op!r}; one of {OPS}")
    return OPS.index(op)


def vpu_loop(x: torch.Tensor, op: str, outer: int = 1) -> torch.Tensor:
    """``outer`` chained rounds of ``REPS`` dependent ``op`` steps on every
    element of ``x`` (int32 u32 bits); returns a new tensor of ``x``'s shape."""
    if not x.is_cpu:
        return vpu_loop_cuda(x, op, outer)
    _check(x, "vpu_loop")
    _op_code(op)
    if outer < 1:
        raise ValueError("vpu_loop needs outer >= 1")
    return vpu_loop_plain(x, op, outer)


def vpu_loop_cuda(x: torch.Tensor, op: str, outer: int = 1) -> torch.Tensor:
    global loop_launches
    if not x.is_cuda:
        raise ValueError("vpu_loop_cuda needs a CUDA tensor")
    _check(x, "vpu_loop_cuda")
    code = _op_code(op)
    if outer < 1 or outer >= 1 << 31:
        raise ValueError("vpu_loop_cuda needs 1 <= outer < 2^31")
    out = torch.empty_like(x)
    if x.numel() == 0:
        return out
    loop_launches += _build.launch("vpu_loop", _build.lib().apsu_vpu_loop, x.get_device(),
                                   x.data_ptr(), out.data_ptr(), x.numel(), code, P, PNI, outer)
    return out


def _step(op: str, acc: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """One step on int64 u32 values (the TPU kernel bodies' arithmetic)."""
    if op == "mul32":
        return (mul_lo(acc, x) + 1) & MASK32
    if op == "mul_wide":
        hi, lo = mul_wide(acc, x)
        return hi ^ lo
    if op == "mont_mul":
        hi, lo = mul_wide(acc, x)
        t = (hi + mul_hi(mul_lo(lo, PNI), P) + (lo != 0).to(I64)) & MASK32
        return torch.where(t >= P, t - P, t)
    q = mul_hi(acc, x)   # shoup_lazy: x is both the constant and its companion
    return (mul_lo(acc, x) - mul_lo(q, P)) & MASK32


def vpu_loop_plain(x: torch.Tensor, op: str, outer: int = 1) -> torch.Tensor:
    _op_code(op)
    acc = x.to(I64) & MASK32
    for _ in range(outer):
        xs = acc
        for _ in range(REPS):
            acc = _step(op, acc, xs)
    return acc.to(I32)   # the int64 -> int32 cast keeps the low 32 bits


def add_one(x: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """``x + 1`` with u32 wraparound (int32 bits), into ``out`` if given (a
    separate tensor of ``x``'s shape, dtype and device) or a new tensor."""
    if not x.is_cpu:
        return add_one_cuda(x, out)
    _check(x, "add_one")
    res = add_one_plain(x)
    if out is None:
        return res
    _check_out(x, out, "add_one")
    return out.copy_(res)


def _check_out(x: torch.Tensor, out: torch.Tensor, name: str) -> None:
    _check(out, name)
    if out.shape != x.shape or out.device != x.device:
        raise ValueError(f"out {tuple(out.shape)} on {out.device} does not match "
                         f"x {tuple(x.shape)} on {x.device}")
    nbytes = x.numel() * 4
    if x.data_ptr() < out.data_ptr() + nbytes and out.data_ptr() < x.data_ptr() + nbytes:
        raise ValueError(f"{name} needs out apart from x")


def add_one_cuda(x: torch.Tensor, out: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel on a CUDA tensor; a new ``out`` is apart from ``x``, of its
    shape, and aligned by the allocator, so only a given one is checked."""
    global add_launches
    if not x.is_cuda:
        raise ValueError("add_one_cuda needs a CUDA tensor")
    _check(x, "add_one_cuda")
    if out is None:
        out = torch.empty_like(x)
    else:
        _check_out(x, out, "add_one_cuda")
    xp, op, n = x.data_ptr(), out.data_ptr(), x.numel()
    if xp % 16 or op % 16:
        raise ValueError("add_one_cuda needs 16-byte aligned tensors")
    if n:
        add_launches += _build.launch("add_one", _build.lib().apsu_add_one, x.get_device(),
                                      xp, op, n)
    return out


def add_one_plain(x: torch.Tensor) -> torch.Tensor:
    return ((x.to(I64) + 1) & MASK32).to(I32)
