"""Device selection for the port's entry points."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """Return `torch.device(device)`; raise if CUDA is asked for but absent.

    Entry points never fall back to the CPU on their own: a caller that wants
    the CPU (the tests) passes device="cpu" explicitly."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return dev


def synchronize(dev: torch.device) -> None:
    """Wait for the work queued on `dev`: torch.cuda.synchronize on a CUDA
    device, nothing on the CPU (whose ops finish before they return)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
