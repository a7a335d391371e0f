"""What a response decrypts to: mask + ∏(x − r) in every slot.

For bundle b, cache c and lane n, the receiver's bin holds the roots
r[b, c, k, n] for k < count[b, c, n]; the sender's query value in that lane
is x[b, n].  The response's slot (b, c, n) decrypts to
(mask[b, c, n] + ∏_k (x − r_k)) mod t, so it equals the mask exactly where x
is one of the bin's roots.
"""

from __future__ import annotations

import numpy as np
import torch


def matching_values(x: torch.Tensor, roots: torch.Tensor, counts, t: int) -> torch.Tensor:
    """∏_{k < count} (x − r_k) mod t.  ``x`` [Q, N] holds the query values
    of Q queries against one bundle, ``roots`` [C, K, N] that bundle's bins
    and ``counts`` [C, N] (None: every bin full).  Returns [Q, C, N] int64."""
    x = x.to(torch.int64)[:, None, :]
    r = roots.to(torch.int64)
    K = r.shape[1]
    acc = torch.ones((x.shape[0], r.shape[0], r.shape[2]), dtype=torch.int64, device=r.device)
    for k in range(K):
        f = (x - r[None, :, k, :]) % t
        if counts is not None:
            f = torch.where(counts[None] > k, f, torch.ones_like(f))
        acc = acc * f % t
    return acc


def mask_draws(key: bytes, ordinal: int, shape, t: int) -> np.ndarray:
    """The mask of the receiver's ``ordinal``-th query (0 first): its RNG is
    AES-256-CTR under ``key`` from a zero counter, a query draws prod(shape)
    64-bit words in order and reduces each mod t.  Each query's words start
    on a block boundary, so the stream is entered at its counter."""
    from cryptography.hazmat.primitives.ciphers import Cipher, algorithms, modes

    n = int(np.prod(shape))
    offset = ordinal * 8 * n
    if offset % 16:
        raise ValueError("a query's draws must start on an AES block")
    ctr = (offset // 16).to_bytes(16, "big")
    enc = Cipher(algorithms.AES(key.ljust(32, b"\0")[:32]), modes.CTR(ctr)).encryptor()
    words = np.frombuffer(enc.update(b"\0" * (8 * n)), dtype="<u8")
    return (words % np.uint64(t)).astype(np.uint32).reshape(shape)
