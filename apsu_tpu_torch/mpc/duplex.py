"""Two-party transport with byte accounting (port of ``apsu_tpu/mpc/duplex.py``).

A duplex message pipe carrying length-prefixed numpy arrays and byte strings,
with per-direction byte counters.  The frame format is the reference's byte
for byte, so a port party and a reference party talk over one socket: a
two-byte dtype code (``u1``/``u4``/``u8``/``i4``/``i8``, or ``by`` for raw
bytes), one byte of rank, the shape as little-endian int64s, then the array's
C-order bytes.  On a socket each frame is preceded by its int64 length.

Implementations: an in-process pair (thread-safe queues) for tests and
single-process runs, and a TCP socket duplex for two-process runs.
"""

from __future__ import annotations

import queue
import socket
import struct
from typing import Tuple

import numpy as np

_DTYPES = {
    b"u1": np.uint8, b"u4": np.uint32, b"u8": np.uint64,
    b"i4": np.int32, b"i8": np.int64, b"by": None,
}
_CODES = {v: k for k, v in _DTYPES.items()}


def _encode(obj) -> bytes:
    if isinstance(obj, (bytes, bytearray)):
        return b"by" + struct.pack("<B", 0) + bytes(obj)
    a = np.ascontiguousarray(obj)
    code = _CODES.get(a.dtype.type)
    if code is None:
        raise TypeError(f"unsupported dtype {a.dtype}")
    shape = a.shape
    hdr = code + struct.pack("<B", len(shape)) + struct.pack(f"<{len(shape)}q", *shape)
    return hdr + a.tobytes()


def _decode(buf: bytes):
    code, ndim = buf[:2], buf[2]
    if code == b"by":
        return buf[3:]
    off = 3 + 8 * ndim
    shape = struct.unpack(f"<{ndim}q", buf[3:off])
    return np.frombuffer(buf[off:], dtype=_DTYPES[code]).reshape(shape)


class Duplex:
    """Base interface: ordered message send/recv with byte counters."""

    def __init__(self):
        self.bytes_sent = 0
        self.bytes_received = 0

    def send(self, obj) -> None:
        raise NotImplementedError

    def recv(self):
        raise NotImplementedError


class QueueDuplex(Duplex):
    def __init__(self, out_q: queue.Queue, in_q: queue.Queue):
        super().__init__()
        self._out = out_q
        self._in = in_q

    def send(self, obj) -> None:
        buf = _encode(obj)
        self.bytes_sent += len(buf)
        self._out.put(buf)

    def recv(self):
        buf = self._in.get()
        if buf is None:
            raise EOFError("peer closed the pipe")
        self.bytes_received += len(buf)
        return _decode(buf)

    def close(self) -> None:
        """End this side: the peer's next ``recv`` raises EOFError instead of
        waiting forever (a queue has no disconnect of its own)."""
        self._out.put(None)


def pipe_pair() -> Tuple[QueueDuplex, QueueDuplex]:
    """In-process duplex pair (use from two threads)."""
    a, b = queue.Queue(), queue.Queue()
    return QueueDuplex(a, b), QueueDuplex(b, a)


class SocketDuplex(Duplex):
    """Length-prefixed framing over a TCP socket."""

    def __init__(self, sock: socket.socket):
        super().__init__()
        self.sock = sock
        sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)

    def send(self, obj) -> None:
        buf = _encode(obj)
        self.bytes_sent += len(buf) + 8
        self.sock.sendall(struct.pack("<q", len(buf)) + buf)

    def recv(self):
        hdr = self._recv_exact(8)
        (n,) = struct.unpack("<q", hdr)
        buf = self._recv_exact(n)
        self.bytes_received += n + 8
        return _decode(buf)

    def _recv_exact(self, n: int) -> bytes:
        chunks = []
        while n:
            c = self.sock.recv(min(n, 1 << 20))
            if not c:
                raise ConnectionError("socket closed")
            chunks.append(c)
            n -= len(c)
        return b"".join(chunks)

    def close(self) -> None:
        self.sock.close()

    @staticmethod
    def connect(host: str, port: int, timeout: float = 30.0) -> "SocketDuplex":
        s = socket.create_connection((host, port), timeout=timeout)
        s.settimeout(None)
        return SocketDuplex(s)


class SocketListener:
    """Persistent accept loop for multi-client dispatch: the DB party binds
    once and serves successive client connections against its resident
    cache."""

    def __init__(self, port: int, host: str = "0.0.0.0"):
        srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        srv.bind((host, port))
        srv.listen(16)
        self.sock = srv
        self.port = srv.getsockname()[1]  # resolved when port=0

    def accept(self) -> "SocketDuplex":
        conn, _ = self.sock.accept()
        return SocketDuplex(conn)

    def close(self) -> None:
        self.sock.close()

    def __enter__(self) -> "SocketListener":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
