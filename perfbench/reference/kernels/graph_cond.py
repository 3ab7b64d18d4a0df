"""The predicates of the IF sites (the ESIKF body's `not converged`, a
refinement level's or a mesh chunk's `any`) and their plain version, read
on the host by utils/graphs.py::device_if."""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch


NAME = "graph_cond"
FORMS = {"read": 0, "not": 1, "any": 2}
COUNT_OPS = {None: 0, "set": 1, "add": 2}
MAX_USES = 4  # csrc/graph_cond.cu's kMaxHandles


@dataclasses.dataclass(eq=False)
class Pred:
    """One IF site's predicate: `form` over `x` (module docstring), the
    taken bit set into or added to the int32 scalar `count` (form "any"
    only), and the `uses` IF nodes that depend on it (each device_if call
    on it takes one; one set launch sets them all)."""
    form: str
    x: torch.Tensor
    count: Optional[torch.Tensor] = None
    count_op: Optional[str] = None
    uses: int = 1
    # device_if's state: the nodes (slot, handle) or the host-read values
    # the remaining uses take
    pending: list = dataclasses.field(default_factory=list, init=False,
                                      repr=False)

    def __post_init__(self):
        if self.form not in FORMS or self.count_op not in COUNT_OPS \
                or (self.count is None) != (self.count_op is None) \
                or not 1 <= self.uses <= MAX_USES:
            raise ValueError(f"{NAME}: a predicate {self.form!r} with count "
                             f"{self.count_op!r} and {self.uses} uses")
        if self.x.dtype != torch.bool or (self.form != "any"
                                          and self.x.numel() != 1):
            raise ValueError(f"{NAME}: a {self.form!r} predicate reads "
                             f"{'a bool tensor' if self.form == 'any' else 'one bool'},"
                             f" got {self.x.dtype} {tuple(self.x.shape)}")
        if self.count is not None and (
                self.form != "any" or self.count.dtype != torch.int32
                or self.count.numel() != 1
                or self.count.device != self.x.device):
            raise ValueError(f"{NAME}: a predicate's count is one int32 "
                             f"beside an 'any' predicate's mask")

    def value(self) -> torch.Tensor:
        """The plain version: the predicate as a device bool, made by the
        torch expression the site used before the set kernel made it (and
        the count updated)."""
        if self.form == "read":
            return self.x.reshape(())
        if self.form == "not":
            return ~self.x.reshape(())
        taken = self.x.any()
        if self.count_op == "set":
            self.count.copy_(taken.to(torch.int32))
        elif self.count_op == "add":
            self.count.add_(taken.to(torch.int32))
        return taken


def negation(x: torch.Tensor, uses: int = 1) -> Pred:
    """`~x` of a one-element bool tensor."""
    return Pred("not", x, uses=uses)


def any_of(x: torch.Tensor, count: Optional[torch.Tensor] = None,
           count_op: Optional[str] = None) -> Pred:
    """`x.any()` of a bool tensor (read in place: x must be contiguous on
    the card), its bit set into or added to `count`."""
    return Pred("any", x, count, count_op)


def as_pred(pred) -> Pred:
    """A Pred, or a one-element bool tensor as the "read" Pred of it."""
    return pred if isinstance(pred, Pred) else Pred("read", pred)


def taken_plain(pred) -> bool:
    """The set kernel's plain version: the predicate made by torch
    (Pred.value) and read on the host."""
    return bool(as_pred(pred).value())
