"""Scatter and segment helpers shared by the map and mesh modules.

JAX's `mode="drop"` scatters skip out-of-bounds targets silently; torch
raises on them, so every such scatter here takes an explicit lane mask.
The scatters are kernels/scatter_drop.py's: its plain version for CPU
tensors, one launch of its CUDA kernel for CUDA tensors, with no host read;
the _group forms write several fields that share one (idx, ok) in one
launch.
Segment sums are taken without atomics (a stable sort by segment, then
kernels/segment_sum.py's segmented sum), so the f32 result is the same on
every run instead of depending on the order in which CUDA atomics land.
"""

from __future__ import annotations

import torch

from immesh_tpu_torch.kernels import scatter_drop
from immesh_tpu_torch.kernels import segment_sum as segment_sum_k


def div(x: torch.Tensor, s: float) -> torch.Tensor:
    """x / s rounded as one IEEE f32 division.

    PyTorch's CUDA kernel turns division by a Python scalar into a multiply
    by its reciprocal, which can differ by one ulp; grid quantization
    (floor(p / size)) must not, so the divisor goes in as a device tensor."""
    return x / torch.full((), s, dtype=x.dtype, device=x.device)


def set_drop(dst: torch.Tensor, idx: torch.Tensor, src, ok: torch.Tensor
             ) -> None:
    """In place: dst[idx[l]] = src[l] for every lane l with ok[l].

    `idx` and `ok` share one shape (the lanes); `src` is a scalar or a
    tensor of the lanes' shape plus dst's trailing dims.  Targets of the
    selected lanes must be distinct (as they are at every call site)."""
    if dst.device.type == "cpu":
        scatter_drop.set_plain(dst, idx, src, ok)
    else:
        scatter_drop.set_cuda(dst, idx, src, ok)


def add_drop(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
             ok: torch.Tensor) -> None:
    """In place: dst[idx[l]] += src[l] for every lane l with ok[l] (f32; the
    selected targets are distinct at every call site, so the sum order does
    not depend on the device)."""
    if dst.device.type == "cpu":
        scatter_drop.add_plain(dst, idx, src, ok)
    else:
        scatter_drop.add_cuda(dst, idx, src, ok)


def set_drop_group(dsts, idx: torch.Tensor, srcs, ok: torch.Tensor) -> None:
    """set_drop(dsts[f], idx, srcs[f], ok) for every field f, in one kernel
    launch on the card: up to 8 dsts of one row count, no src sharing
    memory with a dst (kernels/scatter_drop.py::check_group)."""
    if ok.device.type == "cpu":
        scatter_drop.set_group_plain(dsts, idx, srcs, ok)
    else:
        scatter_drop.set_group_cuda(dsts, idx, srcs, ok)


def add_drop_group(dsts, idx: torch.Tensor, srcs, ok: torch.Tensor) -> None:
    """add_drop(dsts[f], idx, srcs[f], ok) for every field f, in one kernel
    launch on the card (f32; as set_drop_group)."""
    if ok.device.type == "cpu":
        scatter_drop.add_group_plain(dsts, idx, srcs, ok)
    else:
        scatter_drop.add_group_cuda(dsts, idx, srcs, ok)


def nan_where_failed(x: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """NaN out the factorisations whose LAPACK/cuSOLVER info is nonzero —
    what XLA returns for a singular inverse or a non-PD Cholesky.  With the
    `_ex` forms nothing is read back on the host."""
    bad = (info != 0).reshape(info.shape + (1, 1))
    return torch.where(bad, torch.full_like(x, float("nan")), x)


def segment_sum(values: torch.Tensor, seg: torch.Tensor,
                num_segments: int) -> torch.Tensor:
    """Σ of values (N, ...) rows per segment id in [0, num_segments); rows
    with an id outside that range are dropped, as jax.ops.segment_sum drops
    them.

    The rows of a segment are summed in input order from zero, the order of
    a sequential scatter-add, on the CPU and on the card alike
    (kernels/segment_sum.py: its plain version on the CPU, one launch of its
    kernel on the card).  The rows are put in segment order by a stable
    sort and the segment offsets come from a search of the sorted ids, so
    nothing waits on the device."""
    seg = seg.long()
    order = torch.argsort(seg, stable=True)
    bounds = torch.arange(num_segments + 1, device=seg.device)
    offsets = torch.searchsorted(seg[order], bounds)
    if values.device.type == "cpu":
        return segment_sum_k.sum_plain(values, order, offsets)
    return segment_sum_k.sum_cuda(values, order, offsets)


def compact_indices(keep: torch.Tensor, k: int) -> torch.Tensor:
    """Indices of True entries in order, compacted to (k,); padded with N."""
    n = keep.shape[0]
    pos = torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32) - 1
    out = torch.full((k,), n, dtype=torch.int32, device=keep.device)
    ids = torch.arange(n, dtype=torch.int32, device=keep.device)
    set_drop(out, pos, ids, keep & (pos < k))
    return out
