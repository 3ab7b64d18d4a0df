"""Segmented sum over rows sorted by segment — the CUDA kernel's binding,
its plain PyTorch version, and the checks both share.

    out[s] = Σ values[order[j]]   for j in [offsets[s], offsets[s + 1])

each of the row's columns added one row at a time in j order, from +0.0:
the order of a sequential scatter-add.  `order` (N,) lists the rows of
values (N, ...) by segment and `offsets` (S + 1,) where each segment
starts in it, both int64, as core/ops.py::segment_sum makes them (a stable
argsort of the ids, so a segment's rows keep their input order, and a
search of the sorted ids).  Rows before offsets[0] or from offsets[S] on,
those whose id lies outside [0, S), are never read: they are dropped, as
`jax.ops.segment_sum` drops them.  The result is (S, ...) with values'
trailing dims, f32.

The counterpart of the reference's `jax.ops.segment_sum` in the scan
downsample, the map update's levels, window BA and the dp LIO
(immesh_tpu/lio/downsample.py:31, immesh_tpu/map/voxel_map.py:164,
immesh_tpu/dist/window_ba.py:127-133, immesh_tpu/dist/lio.py:143).

The plain version gathers the kept rows in order and adds them with
`index_add_`, which on the CPU adds them one at a time in index order; it
is the CPU path and the kernel's oracle (on the card `index_add_` adds
with atomics, in no fixed order, so the kernel is held to the plain version
computed on the CPU).  It reads the kept range back on the host.  On the
card, core/ops.py::segment_sum launches the kernel in csrc/segment_sum.cu
(one launch a call, no host read, nothing allocated but the result) or
raises — there is no fallback.

Counts: `launches` the kernel launches the wrapper made, `captured` those it
recorded into a CUDA graph under stream capture (they run at each replay,
not then), and `runs()` the kernel's runs on the device, eager and replayed,
from a counter the kernel itself adds to.
"""

from __future__ import annotations

import ctypes
import math

import torch

from immesh_tpu_torch.kernels import build as _build

NAME = "segment_sum"

launches = 0  # kernel launches since the last reset_launches()
captured = 0  # launches recorded into a CUDA graph since then
_build.register_captured(lambda: {"segment_sum": captured})
_devices = set()  # the CUDA devices the kernel was launched on


def reset_launches() -> None:
    """launches, captured and the device's run counter to 0."""
    global launches, captured
    launches = captured = 0
    if _lib is not None:
        _build.reset_runs(_lib, NAME, _devices)


def runs() -> int:
    """The kernel's runs on the device since reset_launches(), eager and
    replayed in CUDA graphs (synchronises the devices it ran on)."""
    return 0 if _lib is None else _build.read_runs(_lib, NAME, 1,
                                                   _devices)[0]


def check(values: torch.Tensor, order: torch.Tensor,
          offsets: torch.Tensor) -> None:
    """The argument contract of both versions: values with a row axis,
    order (N,) and offsets (S + 1,) int64."""
    if values.dim() == 0:
        raise ValueError("values must have a row axis")
    if order.dtype != torch.int64 or offsets.dtype != torch.int64:
        raise TypeError(f"order and offsets must be int64, got {order.dtype} "
                        f"and {offsets.dtype}")
    if tuple(order.shape) != (values.shape[0],):
        raise ValueError(f"order has shape {tuple(order.shape)}, expected "
                         f"({values.shape[0]},): one entry a row")
    if offsets.dim() != 1 or offsets.shape[0] < 1:
        raise ValueError(f"offsets has shape {tuple(offsets.shape)}, "
                         f"expected (segments + 1,)")


def sum_plain(values: torch.Tensor, order: torch.Tensor,
              offsets: torch.Tensor) -> torch.Tensor:
    """The rows of positions offsets[0] .. offsets[S] − 1 of `order`, each
    added into its segment's row in position order (index_add_; on the CPU
    a sequential scatter-add), from zeros."""
    check(values, order, offsets)
    S = offsets.shape[0] - 1
    pos = torch.arange(int(offsets[0]), int(offsets[-1]),
                       device=values.device)
    seg = torch.searchsorted(offsets, pos, right=True) - 1
    out = torch.zeros((S,) + tuple(values.shape[1:]), dtype=values.dtype,
                      device=values.device)
    return out.index_add_(0, seg, values[order[pos]])


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------
def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry point's arguments on a loaded library of
    csrc/segment_sum.cu."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.segment_sum_launch.argtypes = [p, ll, ll, i, p, p, ll, p, p]
    lib.segment_sum_launch.restype = i
    _build.bind_runs(lib, NAME)
    return lib


_lib = None


def _library() -> ctypes.CDLL:
    """The kernel's library, built, loaded and bound at first use."""
    global _lib
    if _lib is None:
        _lib = _bind(_build.load(NAME))
    return _lib


def rows2d(values: torch.Tensor) -> torch.Tensor:
    """values as (N, C) rows, C the product of its trailing dims: a view
    where one exists, else a copy."""
    return values.reshape(values.shape[0], math.prod(values.shape[1:]))


def launch(lib, values2d, order, offsets, out) -> None:
    """One counted launch on the current stream into the preallocated out
    (S, C) (in `captured` under stream capture, else in `launches`),
    without checks: sum_cuda's last step, and what timing code calls with
    `_library()`.  Launches nothing for no segment or no column."""
    global launches, captured
    S, C = out.shape[0], values2d.shape[1]
    if S == 0 or C == 0:
        return
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.segment_sum_launch(
            values2d.data_ptr(), values2d.stride(0), values2d.stride(1), C,
            order.data_ptr(), offsets.data_ptr(), S, out.data_ptr(), stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
    _devices.add(out.device.index)
    if capturing:
        captured += 1
    else:
        launches += 1


def sum_cuda(values: torch.Tensor, order: torch.Tensor,
             offsets: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: sum_plain's result, on one CUDA device (f32
    values, contiguous order and offsets)."""
    check(values, order, offsets)
    dev = values.device
    if dev.type != "cuda":
        raise ValueError("values must lie on a CUDA device")
    for name, x in (("order", order), ("offsets", offsets)):
        if x.device != dev:
            raise ValueError(f"{name} must lie on values' CUDA device")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if values.dtype != torch.float32:
        raise TypeError(f"the kernel sums f32 values, got {values.dtype}")
    out = torch.empty((offsets.shape[0] - 1,) + tuple(values.shape[1:]),
                      dtype=values.dtype, device=dev)
    v = rows2d(values)
    launch(_library(), v, order, offsets, out.view(out.shape[0], v.shape[1]))
    return out
