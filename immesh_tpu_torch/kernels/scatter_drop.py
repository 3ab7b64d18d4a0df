"""Drop-mode masked scatters — the CUDA kernel's binding, its plain PyTorch
versions, and the checks both share.

    set:  dst[idx[l]]  = src[l]   for every lane l with ok[l]
    add:  dst[idx[l]] += src[l]   (f32)

The counterpart of the XLA scatters that the reference compiles into its
step, `dst.at[jnp.where(ok, idx, cap)].set/add(src, mode="drop")`
(immesh_tpu/map/voxel_map.py:180-183, :212 and on).  `idx` and `ok` share
one shape (the lanes); `src` is a Python scalar or a tensor of the lanes'
shape plus dst's trailing dims, in dst's dtype.  A selected lane's target
is read as the reference reads it: a negative one from the end, and one
still outside [0, rows) dropped.  The selected targets are distinct at
every call site, so neither form depends on an order of writes.

A group — up to MAX_FIELDS dsts of one row count that share one (idx, ok),
each with its own src — is one call (set_group_*/add_group_*): the same
result as the fields' single calls one after the other, since the targets
resolve from idx, ok and the rows alone and no src shares memory with a dst.

The plain versions select the lanes with `nonzero`, which reads their count
back on the host; they are the CPU path and the kernel's oracle.  On the
card, core/ops.py's set_drop/add_drop and their _group forms launch the
kernel in csrc/scatter_drop.cu (one launch a call, a group's fields
together; no host read, nothing allocated) or raise — there is no fallback.

Counts: `launches` the kernel launches the wrapper made (a group is one),
`captured` those it recorded into a CUDA graph under stream capture (they
run at each replay, not then), and `runs()` the kernel's runs on the device,
eager and replayed, from a counter the kernel itself adds to.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from immesh_tpu_torch.kernels import build as _build

NAME = "scatter_drop"
_BLOCK = 256
MAX_FIELDS = 8  # fields of one group: csrc/scatter_drop.cu's kMaxFields

launches = 0  # kernel launches since the last reset_launches()
captured = 0  # launches recorded into a CUDA graph since then
_build.register_captured(lambda: {"scatter_drop": captured})
_devices = set()  # the CUDA devices the kernel was launched on


def reset_launches() -> None:
    """launches, captured and the device's run counters to 0."""
    global launches, captured
    launches = captured = 0
    if _lib is not None:
        _build.reset_runs(_lib, NAME, _devices)


def runs() -> int:
    """The kernel's runs on the device since reset_launches(), eager and
    replayed in CUDA graphs (synchronises the devices it ran on)."""
    return 0 if _lib is None else _build.read_runs(_lib, NAME, 1,
                                                   _devices)[0]


def check(dst: torch.Tensor, idx: torch.Tensor, src, ok: torch.Tensor
          ) -> None:
    """The argument contract of both versions: the kernel takes exactly what
    the plain versions are given at every call site."""
    if tuple(idx.shape) != tuple(ok.shape):
        raise ValueError(f"idx {tuple(idx.shape)} and ok {tuple(ok.shape)} "
                         f"must share the lanes' shape")
    if ok.dtype != torch.bool:
        raise TypeError(f"ok must be bool, got {ok.dtype}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be int32 or int64, got {idx.dtype}")
    if torch.is_tensor(src):
        want = tuple(ok.shape) + tuple(dst.shape[1:])
        if tuple(src.shape) != want:
            raise ValueError(f"src has shape {tuple(src.shape)}, expected "
                             f"{want} (the lanes, then dst's row)")
        if src.dtype != dst.dtype:
            raise TypeError(f"src is {src.dtype}, dst {dst.dtype}")
    elif not isinstance(src, (bool, int, float)):
        raise TypeError(f"src must be a tensor or a Python scalar, got "
                        f"{type(src).__name__}")


def check_group(dsts, idx: torch.Tensor, srcs, ok: torch.Tensor,
                add: bool) -> None:
    """The argument contract of a group, both versions: 1..MAX_FIELDS
    fields, each as `check` takes it, all dsts with one row count, f32
    tensors for an add, and no src (and neither idx nor ok) sharing memory
    with a dst, so the fields may be written in any order."""
    if not 1 <= len(dsts) <= MAX_FIELDS or len(srcs) != len(dsts):
        raise ValueError(f"a group takes 1 to {MAX_FIELDS} dsts and one src "
                         f"each, got {len(dsts)} and {len(srcs)}")
    rows = {d.shape[0] if d.dim() else None for d in dsts}
    if len(rows) != 1 or None in rows:
        raise ValueError(f"a group's dsts share one row count, got "
                         f"{[tuple(d.shape) for d in dsts]}")
    for d, s in zip(dsts, srcs):
        check(d, idx, s, ok)
        if add and (not torch.is_tensor(s) or d.dtype != torch.float32):
            raise TypeError("add_drop takes an f32 dst and an f32 src tensor")
    held = [_memory(d) for d in dsts if _memory(d)]
    if len(set(held)) != len(held):
        raise ValueError("two dsts of a group share memory")
    for name, x in (("idx", idx), ("ok", ok),
                    *(("a src", s) for s in srcs)):
        if torch.is_tensor(x) and _memory(x) in held:
            raise ValueError(f"{name} shares memory with a dst of the group")


def _memory(x: torch.Tensor) -> int:
    """The address of x's storage (0 for an empty or meta tensor)."""
    return 0 if x.numel() == 0 or x.is_meta else \
        x.untyped_storage().data_ptr()


# ---------------------------------------------------------------------------
# plain versions: the CPU path and the kernel's oracle
# ---------------------------------------------------------------------------
def _targets(dst: torch.Tensor, idx: torch.Tensor, ok: torch.Tensor):
    """(selected lanes, their targets): the lanes with ok whose target,
    a negative one counted from the end, lies in [0, rows)."""
    rows = dst.shape[0]
    tgt = idx.reshape(-1).long()
    tgt = torch.where(tgt < 0, tgt + rows, tgt)
    sel = (ok.reshape(-1) & (tgt >= 0) & (tgt < rows)).nonzero().squeeze(1)
    return sel, tgt[sel]


def set_plain(dst: torch.Tensor, idx: torch.Tensor, src, ok: torch.Tensor
              ) -> None:
    check(dst, idx, src, ok)
    sel, tgt = _targets(dst, idx, ok)
    if torch.is_tensor(src):
        src = src.reshape((-1,) + src.shape[ok.dim():])[sel]
    dst[tgt] = src


def add_plain(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
              ok: torch.Tensor) -> None:
    check(dst, idx, src, ok)
    if not torch.is_tensor(src) or dst.dtype != torch.float32:
        raise TypeError("add_drop takes an f32 dst and an f32 src tensor")
    sel, tgt = _targets(dst, idx, ok)
    src = src.reshape((-1,) + src.shape[ok.dim():])
    dst.index_add_(0, tgt, src[sel])


def set_group_plain(dsts, idx: torch.Tensor, srcs, ok: torch.Tensor
                    ) -> None:
    """set_plain on every field of the group, the targets found once."""
    check_group(dsts, idx, srcs, ok, add=False)
    sel, tgt = _targets(dsts[0], idx, ok)
    for dst, src in zip(dsts, srcs):
        if torch.is_tensor(src):
            src = src.reshape((-1,) + src.shape[ok.dim():])[sel]
        dst[tgt] = src


def add_group_plain(dsts, idx: torch.Tensor, srcs, ok: torch.Tensor
                    ) -> None:
    """add_plain on every field of the group, the targets found once."""
    check_group(dsts, idx, srcs, ok, add=True)
    sel, tgt = _targets(dsts[0], idx, ok)
    for dst, src in zip(dsts, srcs):
        dst.index_add_(0, tgt, src.reshape((-1,) + src.shape[ok.dim():])[sel])


# ---------------------------------------------------------------------------
# the CUDA kernel
# ---------------------------------------------------------------------------
def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry point's arguments on a loaded library of
    csrc/scatter_drop.cu."""
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.scatter_drop_group_launch.argtypes = [i, p, p, p, p, p, p, p, ll, p,
                                              i, p, ll, i, i, p]
    lib.scatter_drop_group_launch.restype = i
    _build.bind_runs(lib, NAME)
    return lib


_lib = None


def _library() -> ctypes.CDLL:
    """The kernel's library, built, loaded and bound at first use."""
    global _lib
    if _lib is None:
        _lib = _bind(_build.load(NAME))
    return _lib


@functools.lru_cache(maxsize=None)
def max_blocks(index: int) -> int:
    """Blocks of _BLOCK threads that the card holds at once: the grid of
    the largest launch, whose threads then stride over the rest."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count * (
        props.max_threads_per_multi_processor // _BLOCK)


def _scalar_bits(x, dtype: torch.dtype) -> int:
    """The bits of Python scalar x in dtype, as an unsigned integer (host
    only: nothing is copied to the card)."""
    raw = torch.tensor([x], dtype=dtype).view(torch.uint8).tolist()
    return int.from_bytes(bytes(raw), "little")


def launch(lib, dst, idx, src, ok, add: bool) -> None:
    """One counted launch of one field (launch_group with one field),
    without checks: what timing code calls with `_library()`."""
    launch_group(lib, (dst,), idx, (src,), ok, add)


def launch_group(lib, dsts, idx, srcs, ok, add: bool) -> None:
    """One counted launch of a group on the current stream (in `captured`
    under stream capture, else in `launches`), without checks: the last
    step of the *_cuda wrappers, and what timing code calls with
    `_library()`.  Launches nothing for zero lanes or empty rows."""
    global launches, captured
    lanes = ok.numel()
    rows = [math.prod(d.shape[1:]) for d in dsts]
    if lanes == 0 or max(rows) == 0:
        return
    n = len(dsts)
    i = idx.reshape(-1).contiguous()
    k = ok.reshape(-1).contiguous()
    ptr, i64, u64 = ctypes.c_void_p * n, ctypes.c_longlong * n, \
        ctypes.c_ulonglong * n
    sp, s_lane, s_elem, bits = ptr(), i64(), i64(), u64()
    for f, (d, src, row) in enumerate(zip(dsts, srcs, rows)):
        if torch.is_tensor(src):
            s = src.reshape(lanes, row)
            sp[f], s_lane[f], s_elem[f] = s.data_ptr(), s.stride(0), \
                s.stride(1)
        else:
            bits[f] = _scalar_bits(src, d.dtype)
    with torch.cuda.device(dsts[0].device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.scatter_drop_group_launch(
            n, ptr(*(d.data_ptr() for d in dsts)), i64(*rows),
            (ctypes.c_int * n)(*(d.element_size() for d in dsts)), sp,
            s_lane, s_elem, bits, dsts[0].shape[0], i.data_ptr(),
            i.element_size(), k.data_ptr(), lanes, int(add),
            max_blocks(dsts[0].device.index), stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if err != 0:
        raise RuntimeError(f"{NAME} kernel launch failed: CUDA error {err}")
    _devices.add(dsts[0].device.index)
    if capturing:
        captured += 1
    else:
        launches += 1


def _check_cuda(dsts, idx, srcs, ok) -> None:
    """The kernel's own demands beyond the contract: every tensor on one
    CUDA device, each dst contiguous with a row axis."""
    dev = dsts[0].device
    if dev.type != "cuda":
        raise ValueError("dst must lie on a CUDA device")
    for name, x in (("idx", idx), ("ok", ok), *(("dst", d) for d in dsts),
                    *(("src", s) for s in srcs)):
        if torch.is_tensor(x) and x.device != dev:
            raise ValueError(f"{name} must lie on dst's CUDA device")
    for d in dsts:
        if not d.is_contiguous():
            raise ValueError("dst must be contiguous")
        if d.dim() == 0:
            raise ValueError("dst must have a row axis")


def set_cuda(dst: torch.Tensor, idx: torch.Tensor, src, ok: torch.Tensor
             ) -> None:
    """Launch the kernel: set_plain's result, on one CUDA device."""
    check(dst, idx, src, ok)
    _check_cuda((dst,), idx, (src,), ok)
    launch_group(_library(), (dst,), idx, (src,), ok, add=False)


def add_cuda(dst: torch.Tensor, idx: torch.Tensor, src: torch.Tensor,
             ok: torch.Tensor) -> None:
    """Launch the kernel's add: add_plain's result, on one CUDA device."""
    check(dst, idx, src, ok)
    _check_cuda((dst,), idx, (src,), ok)
    if not torch.is_tensor(src) or dst.dtype != torch.float32:
        raise TypeError("add_drop takes an f32 dst and an f32 src tensor")
    launch_group(_library(), (dst,), idx, (src,), ok, add=True)


def set_group_cuda(dsts, idx: torch.Tensor, srcs, ok: torch.Tensor) -> None:
    """One launch for the group: set_group_plain's result, on one CUDA
    device."""
    check_group(dsts, idx, srcs, ok, add=False)
    _check_cuda(dsts, idx, srcs, ok)
    launch_group(_library(), dsts, idx, srcs, ok, add=False)


def add_group_cuda(dsts, idx: torch.Tensor, srcs, ok: torch.Tensor) -> None:
    """One launch for the group: add_group_plain's result, on one CUDA
    device."""
    check_group(dsts, idx, srcs, ok, add=True)
    _check_cuda(dsts, idx, srcs, ok)
    launch_group(_library(), dsts, idx, srcs, ok, add=True)
