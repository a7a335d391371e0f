"""The receiver's mask draw on the card (``csrc/ctr_mod.cu``) and its plain
version: words of an AES-256-CTR keystream, each reduced into a range.

``ctr_mod(key, counter, offset, lo, span, shape, device)`` returns int32
``out`` of ``shape`` with ``out[i] = (le_u64(ks[8i : 8i + 8]) mod span) +
lo``, where ``ks`` is the AES-256-CTR keystream under ``key`` from the
128-bit big-endian ``counter`` (``cryptography``'s ``modes.CTR``) with its
first ``offset`` bytes (0-15) skipped.  These are exactly the words that
``mpc/prg.py:CsRng.integers(lo, lo + span)`` draws at that place of its
stream, so a drawer that ``CsRng.reserve``s the bytes and makes them here
gets the same bits as one that draws them on the host.

The reference has no kernel here: it draws the mask on the host
(``apsu_tpu/api/parties.py``, ``Receiver._prepare``).  For a CUDA device
the kernel writes the words straight into a device tensor, and for a kept
draw (``KeyStream.draw(keep=True)``, the receiver's mask) into pinned host
memory too; for the CPU the plain version runs ``cryptography``'s AES-CTR
and numpy's modulo.  The
kernel's tables come from here: ``te0`` (AES's first round table, from the
S-box, on each card once) and ``round_keys`` (AES-256's key expansion, once
a ``KeyStream``).
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from apsu_tpu_torch.device import canonical
from apsu_tpu_torch.ops import _build

# kernel launches since the last reset (set to 0 to reset); a launch captured
# into a CUDA graph is counted at each replay (``ops/counts.py``)
launches = 0
# kept draws that one allocation of device and pinned buffers serves
SLAB = 16

M64 = (1 << 64) - 1


def _xtime(b: int) -> int:
    """b·x in AES's field GF(2^8) mod x^8 + x^4 + x^3 + x + 1."""
    return ((b << 1) ^ (0x1B if b & 0x80 else 0)) & 0xFF


def _rotl8(b: int, k: int) -> int:
    return ((b << k) | (b >> (8 - k))) & 0xFF


@functools.lru_cache(maxsize=None)
def sbox() -> tuple:
    """AES's S-box: the affine map of each byte's inverse in GF(2^8)."""
    s = [0x63] * 256
    p = q = 1
    while True:
        p ^= _xtime(p)                       # p ·= 3, a generator of the group
        q ^= q << 1                          # q /= 3 (q ·= 3's inverse)
        q ^= q << 2
        q ^= q << 4
        q &= 0xFF
        if q & 0x80:
            q ^= 0x09
        s[p] = q ^ _rotl8(q, 1) ^ _rotl8(q, 2) ^ _rotl8(q, 3) ^ _rotl8(q, 4) ^ 0x63
        if p == 1:
            return tuple(s)


@functools.lru_cache(maxsize=None)
def te0() -> np.ndarray:
    """AES's round table Te0 [256] uint32: (2·S[x], S[x], S[x], 3·S[x]) from
    the high byte down; Te1-Te3 are its rotations right by 8, 16, 24 bits.
    Read-only, as the cache hands it to every caller."""
    s = np.array(sbox(), np.uint32)
    s2 = np.array([_xtime(int(v)) for v in s], np.uint32)
    out = (s2 << 24) | (s << 16) | (s << 8) | (s2 ^ s)
    out.flags.writeable = False
    return out


def _sub_word(w: int) -> int:
    s = sbox()
    return (s[w >> 24] << 24) | (s[(w >> 16) & 0xFF] << 16) | (s[(w >> 8) & 0xFF] << 8) | \
        s[w & 0xFF]


def round_keys(key: bytes) -> np.ndarray:
    """AES-256's 60 round-key words [60] uint32 (big-endian columns) of a
    32-byte key."""
    w = [int.from_bytes(key[4 * i: 4 * i + 4], "big") for i in range(8)]
    rcon = 1
    for i in range(8, 60):
        t = w[i - 1]
        if i % 8 == 0:
            t = _sub_word(((t << 8) | (t >> 24)) & 0xFFFFFFFF) ^ (rcon << 24)
            rcon = _xtime(rcon)
        elif i % 8 == 4:
            t = _sub_word(t)
        w.append(w[i - 8] ^ t)
    return np.array(w, np.uint32)


@functools.lru_cache(maxsize=None)
def _te0_on(index: int) -> torch.Tensor:
    """Te0 on card ``index`` as int32, for every key."""
    return torch.from_numpy(te0().view(np.int32).copy()).to(torch.device("cuda", index))


def _check(counter: int, offset: int, lo: int, span: int) -> None:
    if not 0 <= counter < 1 << 128:
        raise ValueError("the counter is a 128-bit block number")
    if not 0 <= offset < 16:
        raise ValueError("the offset lies inside the first block (0-15)")
    if not 1 <= span < 1 << 32 or lo < -(1 << 31) or lo + span - 1 >= 1 << 31:
        raise ValueError(f"words in [{lo}, {lo + span}) do not fit int32")


class KeyStream:
    """The words of the module docstring under one key on one device.  On a
    card the round keys are expanded once, here, and each draw is one call
    into the kernel's library (``csrc/ctr_mod.cu``).  A kept draw's kernel
    also stores each word into pinned host memory, and ``done`` is recorded
    after it.  A kept draw's device words and host copy are a fresh row of a
    slab of ``SLAB`` rows (one allocation for ``SLAB`` draws; each row
    handed out holds its slab, so no row is written twice); a slab is let go
    only after ``done``, so never while the kernel may still store into it."""

    def __init__(self, key: bytes, device):
        self.done = None    # on a card, the event after the last kept draw
        if len(key) != 32:
            raise ValueError("ctr_mod takes an AES-256 key of 32 bytes")
        self.key = key
        self.device = canonical(device)
        if self.device.type == "cuda":
            te, rk = _te0_on(self.device.index), round_keys(key)
            self._tables = (te, rk, te.data_ptr(), rk.ctypes.data)
            self._entry = _build.lib().apsu_ctr_mod
            self._ranges = {}   # (lo, span) -> the kernel's lo, span and reciprocal
            self._rows = []     # the unused rows of the slab
            self._slab = None   # the slab's shape, its words a row, done's handle

    def draw(self, counter: int, offset: int, lo: int, span: int, shape,
             keep: bool = False) -> tuple:
        """(words, host): the ``prod(shape)`` words from ``counter`` and
        ``offset`` as an int32 tensor of ``shape`` on the device (the
        kernel's on a card, the plain version's on the CPU), and with
        ``keep`` their uint32 copy in host memory (a view of the words on
        the CPU; on a card, whole once ``done`` is), else None."""
        global launches
        _check(counter, offset, lo, span)
        if self.device.type == "cpu":
            out = torch.from_numpy(ctr_mod_plain(self.key, counter, offset, lo, span,
                                                 math.prod(shape)).reshape(shape))
            return out, (out.numpy().view(np.uint32) if keep else None)
        if keep:
            shape = tuple(shape)
            if not self._rows or self._slab[0] != shape:
                self._new_slab(shape)
            out, out_ptr, host, host_ptr = self._rows.pop()
            n, done = self._slab[1:]
        else:
            out, host = torch.empty(shape, dtype=torch.int32, device=self.device), None
            out_ptr, host_ptr, n, done = out.data_ptr(), None, out.numel(), None
        if n:
            r = self._ranges.get((lo, span))
            if r is None:
                r = self._ranges[(lo, span)] = (lo & 0xFFFFFFFF, span, M64 // span)
            index = self.device.index
            err = self._entry(*self._tables[2:], counter >> 64, counter & M64, offset, *r,
                              out_ptr, host_ptr, n, done, index,
                              torch._C._cuda_getCurrentRawStream(index))
            if err > 0:
                _build.check(err, "ctr_mod")
            launches += err == 0    # -1: captured, counted at each replay (ops/counts.py)
        return out, host

    def _new_slab(self, shape) -> None:
        """``SLAB`` fresh rows of ``shape``, each (device words, address,
        host copy, address), once the last slab's kernels have ended."""
        if self.done is None:
            self.done = torch.cuda.Event()
            self.done.record(torch.cuda.current_stream(self.device))   # made at its record
        self.done.synchronize()
        n = math.prod(shape)
        dev = torch.empty((SLAB, *shape), dtype=torch.int32, device=self.device)
        pinned = torch.empty((SLAB, *shape), dtype=torch.int32, pin_memory=True)
        host = pinned.numpy().view(np.uint32)
        self._rows = [(d, dev.data_ptr() + 4 * n * i, host[i], pinned.data_ptr() + 4 * n * i)
                      for i, d in enumerate(dev.unbind(0))][::-1]
        self._slab = (shape, n, self.done.cuda_event)

    def __del__(self):
        if self.done is not None:
            try:
                self.done.synchronize()   # the slabs outlive the kernels that store into them
            except Exception:   # at exit the runtime may be gone, and the kernels with it
                pass


def ctr_mod(key: bytes, counter: int, offset: int, lo: int, span: int, shape,
            device) -> torch.Tensor:
    """The ``prod(shape)`` words of the module docstring as an int32 tensor
    of ``shape`` on ``device``: the kernel's on a CUDA device, the plain
    version's on the CPU (``KeyStream.draw``)."""
    return KeyStream(key, device).draw(counter, offset, lo, span, shape)[0]


def ctr_mod_plain(key: bytes, counter: int, offset: int, lo: int, span: int,
                  n: int) -> np.ndarray:
    """``n`` words as int32 on the host: ``cryptography``'s AES-CTR entered
    at ``counter``, then numpy's modulo, as ``CsRng.integers`` computes."""
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

    enc = Cipher(algorithms.AES(key), modes.CTR(counter.to_bytes(16, "big"))).encryptor()
    words = np.frombuffer(enc.update(b"\0" * (offset + 8 * n))[offset:], dtype="<u8")
    return ((words % np.uint64(span)).astype(np.int64) + lo).astype(np.int32)
