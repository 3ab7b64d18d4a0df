"""Drop-mode masked scatters, plain PyTorch versions only:

    set:  dst[idx[l]]  = src[l]   for every lane l with ok[l]
    add:  dst[idx[l]] += src[l]   (f32)

A selected lane's target is read from the end where negative, and dropped
where still outside [0, rows).  The selected targets are distinct at every
call site, so no result depends on an order of writes."""

from __future__ import annotations


import torch


NAME = "scatter_drop"
MAX_FIELDS = 8  # fields of one group: csrc/scatter_drop.cu's kMaxFields

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


