"""CUDA-graph IF nodes — the binding of csrc/graph_cond.cu and its plain
version.

A captured step (utils/graphs.py) turns the reference's on-device exits
(the ESIKF while_loop, the refinement levels' and the mesh chunks'
lax.cond) into IF nodes.  Each site describes its predicate as a `Pred`:
the form the set kernel computes and the tensors it reads, one definition
with two versions:

  * `Pred.value()`, the plain version: the site's torch expression, a
    device bool (the level count updated beside it), which the eager step
    reads on the host (`taken_plain`);
  * the set kernel: `set_launch` launches it on the capturing stream, where
    it makes the same bool from the same tensors at every replay and sets
    the conditional handle of every IF node on the predicate (`uses` of
    them, one launch); `if_begin` adds one node on a handle and begins
    capturing the body stream into its body graph, `if_end` ends that.

Forms: "read" (a one-element bool tensor: its value; what a bare bool
tensor given to device_if means), "not" (its negation: the ESIKF body's
`~converged`), "any" (any element of a contiguous bool tensor, a level's
mask or a chunk's rows of the pull mask, with an optional int32 `count`
the taken bit is set into or added to: the levels' count).

The set kernel runs only inside graphs: the wrapper launches it only under
stream capture, so its `launches` stay 0 and `captured` counts the launches
it recorded (one a predicate, however many nodes it sets).  `runs()` is the
set kernel's runs on the device, `taken(slots)` the runs of each node (its
slot) whose predicate held, both from counters the kernel itself adds to.

The conditional-node API needs a CUDA 12.3 runtime and driver: the first
use checks both (`check_versions`) and raises below it.  There is no
fallback: a failed step raises.
"""

from __future__ import annotations

import ctypes
import dataclasses
import itertools
from typing import List, Optional, Sequence, Tuple

import torch

from immesh_tpu_torch.kernels import build as _build

NAME = "graph_cond"
MIN_VERSION = 12030  # cudaGraphConditionalHandleCreate, BeginCaptureToGraph
FORMS = {"read": 0, "not": 1, "any": 2}
COUNT_OPS = {None: 0, "set": 1, "add": 2}
MAX_USES = 4  # csrc/graph_cond.cu's kMaxHandles

launches = 0  # eager launches: always 0 (the kernel runs only in graphs)
captured = 0  # set-kernel launches recorded into a CUDA graph
_build.register_captured(lambda: {"graph_cond": captured})
_devices = set()  # the CUDA devices the kernel was recorded on
_slots = itertools.count()  # each node's taken counter


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


def reset_launches() -> None:
    """launches, captured and the device's counters (runs and every slot's
    taken count) to 0."""
    global launches, captured
    launches = captured = 0
    if _lib is not None:
        _build.reset_runs(_lib, NAME, _devices)


def runs() -> int:
    """The set kernel's runs on the device since reset_launches() (each
    replay of a graph runs it once a launch it recorded; synchronises)."""
    return 0 if _lib is None else _build.read_runs(_lib, NAME, 1,
                                                   _devices)[0]


def taken(slots: Sequence[int]) -> List[int]:
    """For each slot, the set kernel's runs since reset_launches() whose
    predicate held: the runs of that node's body (synchronises)."""
    if _lib is None or not slots:
        return [0] * len(slots)
    first, n = min(slots), max(slots) - min(slots) + 1
    total = [0] * n
    for d in sorted(_devices):
        with torch.cuda.device(d):
            torch.cuda.synchronize()
            out = (ctypes.c_ulonglong * n)()
            _check(_lib.graph_cond_taken(out, first, n), "reading the taken "
                   "counters")
            total = [t + v for t, v in zip(total, out)]
    return [total[s - first] for s in slots]


def next_slots(n: int = 1) -> int:
    """The first of n fresh consecutive slots for nodes' taken counters."""
    slot = next(_slots)
    for _ in range(n - 1):
        next(_slots)
    if slot + n > _library().graph_cond_max_slots():
        raise RuntimeError(f"{NAME}: more than "
                           f"{_library().graph_cond_max_slots()} IF nodes in "
                           f"one process")
    return slot


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{NAME}: {what} failed: CUDA error {err}")


def check_versions(lib: ctypes.CDLL) -> Tuple[int, int]:
    """(driver, runtime) CUDA versions; raises below MIN_VERSION."""
    driver, runtime = ctypes.c_int(0), ctypes.c_int(0)
    _check(lib.graph_cond_versions(ctypes.byref(driver),
                                   ctypes.byref(runtime)),
           "reading the CUDA versions")
    if min(driver.value, runtime.value) < MIN_VERSION:
        raise RuntimeError(
            f"{NAME}: CUDA-graph conditional nodes need a CUDA "
            f"{MIN_VERSION // 1000}.{MIN_VERSION % 1000 // 10} driver and "
            f"runtime; this one has driver {driver.value}, runtime "
            f"{runtime.value}")
    return driver.value, runtime.value


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' arguments on a loaded library of
    csrc/graph_cond.cu and check the CUDA versions."""
    p, i, u64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_ulonglong
    lib.graph_cond_versions.argtypes = [ctypes.POINTER(i)] * 2
    lib.graph_cond_versions.restype = i
    lib.graph_cond_max_slots.argtypes = []
    lib.graph_cond_max_slots.restype = i
    lib.graph_cond_max_handles.argtypes = []
    lib.graph_cond_max_handles.restype = i
    lib.graph_cond_set.argtypes = [p, i, p, ctypes.c_longlong, p, i, i, i,
                                   ctypes.POINTER(u64)]
    lib.graph_cond_set.restype = i
    lib.graph_cond_if_begin.argtypes = [p, u64, p, ctypes.POINTER(p)]
    lib.graph_cond_if_begin.restype = i
    lib.graph_cond_if_end.argtypes = [p, p]
    lib.graph_cond_if_end.restype = i
    lib.graph_cond_taken.argtypes = [ctypes.POINTER(u64), i, i]
    lib.graph_cond_taken.restype = i
    _build.bind_runs(lib, NAME)
    check_versions(lib)
    if lib.graph_cond_max_handles() != MAX_USES:
        raise RuntimeError(f"{NAME}: the library sets "
                           f"{lib.graph_cond_max_handles()} nodes a launch, "
                           f"the binding {MAX_USES}")
    return lib


_lib = None


def _library() -> ctypes.CDLL:
    """The library, built, loaded and bound at first use."""
    global _lib
    if _lib is None:
        _lib = _bind(_build.load(NAME))
    return _lib


def set_launch(pred: Pred, slot: int) -> List[int]:
    """Under stream capture on the current stream: make `pred.uses`
    conditional handles and launch the set kernel that sets them from
    `pred` at every replay (node i's taken runs counted in slot + i).
    Returns the handles."""
    global captured
    x = pred.x
    if x.device.type != "cuda" or not x.is_contiguous() or (
            pred.count is not None and not pred.count.is_contiguous()):
        raise ValueError(f"{NAME}: the set kernel reads a contiguous "
                         f"tensor on a CUDA device, got {tuple(x.shape)} "
                         f"strides {x.stride()} on {x.device}")
    if x.numel() == 0:
        raise ValueError(f"{NAME}: an 'any' predicate over no element")
    lib = _library()
    with torch.cuda.device(x.device):
        if not torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{NAME}: the set kernel is launched only "
                               f"under stream capture")
        handles = (ctypes.c_ulonglong * pred.uses)()
        count = 0 if pred.count is None else pred.count.data_ptr()
        _check(lib.graph_cond_set(
            torch.cuda.current_stream().cuda_stream, FORMS[pred.form],
            x.data_ptr(), x.numel(), count, COUNT_OPS[pred.count_op], slot,
            pred.uses, handles), "launching the set kernel")
    _devices.add(x.device.index)
    captured += 1
    return list(handles)


def if_begin(handle: int, device: torch.device,
             body_stream: torch.cuda.Stream) -> int:
    """Under stream capture on `device`'s current stream: add an IF node on
    `handle` (set_launch's) and begin capturing `body_stream` into the
    node's body graph.  Returns the body graph (a cudaGraph_t, as an
    int)."""
    with torch.cuda.device(device):
        graph = ctypes.c_void_p(0)
        _check(_library().graph_cond_if_begin(
            torch.cuda.current_stream().cuda_stream, handle,
            body_stream.cuda_stream, ctypes.byref(graph)), "adding an IF node")
    return graph.value


def if_end(body_stream: torch.cuda.Stream, body_graph: int) -> None:
    """End the body capture if_begin began."""
    _check(_library().graph_cond_if_end(body_stream.cuda_stream, body_graph),
           "ending an IF node's body capture")
