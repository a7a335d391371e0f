"""Typed wire protocol + ciphertext bit-packing (port of
``apsu_tpu/net/wire.py``; the format is the reference's bit for bit, so a port
party and a reference party talk over one socket).

Two layers:

* ``TypedDuplex`` — tags every message with (version, op) and checks types
  on receive; an ``OP_ERROR`` frame carries a remote exception text so a
  desynced peer fails loudly instead of dying on a decode error.
* residue packing — RNS ciphertext residues occupy ≤30 bits of their 32-bit
  lanes; ``pack_residues``/``unpack_residues`` transmit exactly
  ceil(log2 p_j) bits per coefficient.  ``pack_residues`` takes the port's
  int32 residue arrays (or the reference's uint32 ones) as numpy.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from apsu_tpu_torch.mpc.duplex import Duplex, _decode, _encode

WIRE_VERSION = 2

# operation codes (the C++ reference's rop_* types, plus the OPRF, endgame
# and serve-loop control phases)
OP_PARAMS_REQ = 1
OP_PARAMS = 2
OP_OPRF = 3       # interactive OPRF rounds (KKRT extension / ECDH blind-eval)
OP_QUERY = 4      # query meta: power list, seeds, flags
OP_QUERY_DATA = 5  # ciphertext payloads
OP_RESPONSE = 6   # query response meta
OP_RESULT = 7     # packed result ciphertexts
OP_ENDGAME = 8    # PEQT + OT subprotocol messages
OP_BYE = 9        # client done (serve loop exits)
OP_ERROR = 10     # remote failure, payload = utf-8 message
OP_REBIND = 11    # client opens a FRESH KKRT correlation for its next query
#                   (the DB party rebinds its retained placement —
#                   ReceiverDB.rebind)

_OP_NAMES = {
    v: k
    for k, v in globals().items()
    if k.startswith("OP_") and isinstance(v, int)
}


class ProtocolError(Exception):
    """Wire desync: unexpected op type or version."""


class RemoteError(Exception):
    """The peer reported a failure (OP_ERROR frame)."""


class TypedDuplex:
    """Op-typed messaging over any Duplex.

    ``send_op``/``expect`` carry one header byte pair (version, op) inside
    the underlying length-prefixed frame.  Subprotocols that exchange many
    messages (OT extension, PEQT) run through ``scoped(op)``, which returns
    a Duplex view tagging every message with that op.
    """

    def __init__(self, inner: Duplex):
        self.inner = inner

    # -- byte accounting passthrough ----------------------------------
    @property
    def bytes_sent(self) -> int:
        return self.inner.bytes_sent

    @property
    def bytes_received(self) -> int:
        return self.inner.bytes_received

    # -- typed messaging ----------------------------------------------
    def send_op(self, op: int, obj) -> None:
        self.inner.send(bytes([WIRE_VERSION, op]) + _encode(obj))

    def recv_any(self) -> Tuple[int, object]:
        buf = self.inner.recv()
        if not isinstance(buf, (bytes, bytearray)) or len(buf) < 2:
            raise ProtocolError("untyped frame on typed channel")
        ver, op = buf[0], buf[1]
        if ver != WIRE_VERSION:
            raise ProtocolError(f"wire version {ver} != {WIRE_VERSION}")
        if op == OP_ERROR:
            raise RemoteError(bytes(buf[2:]).decode("utf-8", "replace"))
        return op, _decode(bytes(buf[2:]))

    def expect(self, op: int):
        got, obj = self.recv_any()
        if got != op:
            raise ProtocolError(
                f"expected {_OP_NAMES.get(op, op)}, got {_OP_NAMES.get(got, got)}"
            )
        return obj

    def send_error(self, msg: str) -> None:
        self.inner.send(bytes([WIRE_VERSION, OP_ERROR]) + msg.encode())

    def scoped(self, op: int) -> "_ScopedDuplex":
        return _ScopedDuplex(self, op)


class _ScopedDuplex(Duplex):
    """Duplex view whose raw send/recv tag messages with a fixed op."""

    def __init__(self, typed: TypedDuplex, op: int):
        super().__init__()
        self._typed = typed
        self._op = op

    def send(self, obj) -> None:
        self._typed.send_op(self._op, obj)

    def recv(self):
        return self._typed.expect(self._op)

    @property
    def bytes_sent(self) -> int:  # type: ignore[override]
        return self._typed.bytes_sent

    @bytes_sent.setter
    def bytes_sent(self, v) -> None:  # Duplex.__init__ assigns; ignore
        pass

    @property
    def bytes_received(self) -> int:  # type: ignore[override]
        return self._typed.bytes_received

    @bytes_received.setter
    def bytes_received(self, v) -> None:
        pass


# ---------------------------------------------------------------------
# residue bit-packing
# ---------------------------------------------------------------------
def _bitwidths(primes: Sequence[int]) -> list:
    return [int(p - 1).bit_length() for p in primes]


def pack_residues(data: np.ndarray, primes: Sequence[int]) -> np.ndarray:
    """[..., L, N] residues (limb j < primes[j]; uint32, or the port's int32)
    -> packed uint8.

    Each limb plane is packed at its own bit width, planes concatenated.
    """
    d = np.ascontiguousarray(data, dtype=np.uint32)
    L = d.shape[-2]
    assert L == len(primes), (d.shape, len(primes))
    chunks = []
    for j, bits in enumerate(_bitwidths(primes)):
        v = np.moveaxis(d, -2, 0)[j].ravel()
        bitmat = (v[:, None] >> np.arange(bits, dtype=np.uint32)) & np.uint32(1)
        chunks.append(np.packbits(bitmat.astype(np.uint8), bitorder="little"))
    return np.concatenate(chunks)


def unpack_residues(
    buf: np.ndarray, primes: Sequence[int], shape: Tuple[int, ...]
) -> np.ndarray:
    """Inverse of pack_residues; shape is the full [..., L, N] shape."""
    L = shape[-2]
    assert L == len(primes)
    per_plane = int(np.prod(shape)) // L
    out_planes = []
    off = 0
    for bits in _bitwidths(primes):
        nbytes = (per_plane * bits + 7) // 8
        plane_bits = np.unpackbits(
            np.ascontiguousarray(buf[off : off + nbytes], dtype=np.uint8),
            bitorder="little",
            count=per_plane * bits,
        ).reshape(per_plane, bits)
        weights = (np.uint32(1) << np.arange(bits, dtype=np.uint32))
        out_planes.append((plane_bits.astype(np.uint32) * weights).sum(
            axis=1, dtype=np.uint32
        ))
        off += nbytes
    plane_shape = shape[:-2] + (shape[-1],)
    stacked = np.stack([p.reshape(plane_shape) for p in out_planes], axis=-2)
    return stacked


def packed_nbytes(primes: Sequence[int], shape: Tuple[int, ...]) -> int:
    """Size of pack_residues output for a [..., L, N] tensor."""
    per_plane = int(np.prod(shape)) // len(primes)
    return sum((per_plane * b + 7) // 8 for b in _bitwidths(primes))
