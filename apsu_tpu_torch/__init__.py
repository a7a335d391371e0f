"""apsu_tpu_torch — the PyTorch/CUDA port of apsu_tpu for NVIDIA Hopper.

The JAX package ``apsu_tpu`` is the reference; this package does everything
it does, unbalanced Private Set Union (eprint 2022/653) end to end: the BFV
core and the receiver's query (Paterson–Stockmeyer and dot-product paths,
labeled mode) as plain PyTorch tensor code around hand-written CUDA kernels
for ``sm_90a`` (``csrc/``: the negacyclic NTT, the PS inner sums, the
matching-polynomial dot product and the two ceiling probes), the receiver
DB and its lifecycle, the host MPC engine (OPRF, OT, PEQT), the wire
session, the parallel runtime and the CLIs.  It imports nothing of
``apsu_tpu`` and never imports ``jax``.

Representation (fixed for the whole package):

* residue tensors are ``torch.int32`` holding canonical residues < 2^30 in
  the reference's ``[..., L, N]`` layouts — the same bits as its ``uint32``;
* NTT domain ⇒ Montgomery form (R = 2^32), coefficient domain ⇒ plain;
* plain tensor code widens to ``int64`` for products;
* entry points take ``device="cuda"`` by default and raise when CUDA is
  asked for but absent — nothing falls back to the CPU.

The top-level names ``run_psu``, ``run_psu_mpc``, ``PsuResult``, ``Sender``,
``Receiver``, ``ReceiverDB`` and ``BfvContext`` load their modules on first
use, as the reference's do, so ``import apsu_tpu_torch`` stays light.
"""

__version__ = "0.1.0"

from apsu_tpu_torch.core.params import PSUParams  # noqa: F401


def __getattr__(name):
    """Lazy top-level API (keeps ``import apsu_tpu_torch`` light)."""
    if name in ("run_psu", "run_psu_mpc", "PsuResult"):
        from apsu_tpu_torch.api import protocol

        return getattr(protocol, name)
    if name in ("Sender", "Receiver"):
        from apsu_tpu_torch.api import parties

        return getattr(parties, name)
    if name == "ReceiverDB":
        from apsu_tpu_torch.db.receiver_db import ReceiverDB

        return ReceiverDB
    if name == "BfvContext":
        from apsu_tpu_torch.core.bfv import BfvContext

        return BfvContext
    raise AttributeError(name)
