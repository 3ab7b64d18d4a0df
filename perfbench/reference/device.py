"""Device selection."""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device(device); raise if CUDA is asked for but absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device!r} requested but CUDA is absent")
    return dev
