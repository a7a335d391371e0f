"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve(device) -> torch.device:
    """``torch.device`` for ``device``; raises when CUDA is asked for and
    absent (the port never carries on silently on the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is False"
        )
    return dev


def synchronize(x: torch.Tensor) -> None:
    """Wait for the device work that produces ``x`` (no-op on the CPU)."""
    if x.is_cuda:
        torch.cuda.synchronize(x.device)


def canonical(device) -> torch.device:
    """``device`` with its index spelled out (``cuda`` -> ``cuda:<current>``),
    so that two names of one device compare equal."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev
