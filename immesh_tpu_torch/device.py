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


class HostCopy:
    """A device tensor's value, copied to the host without waiting: the
    reference's `copy_to_host_async()` and a later `int()`.

    On a CUDA device the copy into pinned host memory and an event are
    queued on the current stream now, so the value is the one the tensor
    holds at this point of the stream, whatever later work does to it;
    `value()` waits for that event only.  On the CPU the value is copied
    at once."""

    def __init__(self, x: torch.Tensor):
        self._event = None
        if x.device.type == "cuda":
            self._host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
            self._host.copy_(x, non_blocking=True)
            self._event = torch.cuda.Event()
            self._event.record(torch.cuda.current_stream(x.device))
        else:
            self._host = x.clone()

    def value(self):
        """The copied value as a Python number (list for a non-scalar)."""
        if self._event is not None:
            self._event.synchronize()
        return self._host.tolist()
