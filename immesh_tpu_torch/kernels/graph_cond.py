"""CUDA-graph IF nodes — the binding of csrc/graph_cond.cu and its plain
version.

A captured step (utils/graphs.py) turns the reference's on-device exits
(the ESIKF while_loop, the refinement levels' and the mesh chunks'
lax.cond) into IF nodes: `if_begin` launches the set kernel on the
capturing stream (it reads the predicate, one device bool, and sets the
node's conditional handle at every replay), adds the node and begins
capturing the body stream into the node's body graph; `if_end` ends that
capture.  The plain version is `taken_plain`, the host read bool(pred): what
the eager step does instead (utils/graphs.py::device_if).

The set kernel runs only inside graphs: the wrapper launches it only under
stream capture, so its `launches` stay 0 and `captured` counts the nodes it
made.  `runs()` is the set kernel's runs on the device, `taken(slots)` the
runs of each node (its slot) whose predicate held, both from counters the
kernel itself adds to.

The conditional-node API needs a CUDA 12.3 runtime and driver: the first
use checks both (`check_versions`) and raises below it.  There is no
fallback: a failed step raises.
"""

from __future__ import annotations

import ctypes
import itertools
from typing import List, Sequence, Tuple

import torch

from immesh_tpu_torch.kernels import build as _build

NAME = "graph_cond"
MIN_VERSION = 12030  # cudaGraphConditionalHandleCreate, BeginCaptureToGraph

launches = 0  # eager launches: always 0 (the kernel runs only in graphs)
captured = 0  # set-kernel launches recorded into a CUDA graph (one a node)
_build.register_captured(lambda: {"graph_cond": captured})
_devices = set()  # the CUDA devices the kernel was recorded on
_slots = itertools.count()  # each node's taken counter


def taken_plain(pred: torch.Tensor) -> bool:
    """The set kernel's plain version: the predicate read on the host."""
    return bool(pred)


def reset_launches() -> None:
    """launches, captured and the device's counters (runs and every slot's
    taken count) to 0."""
    global launches, captured
    launches = captured = 0
    if _lib is not None:
        _build.reset_runs(_lib, NAME, _devices)


def runs() -> int:
    """The set kernel's runs on the device since reset_launches() (each
    replay of a graph runs it once a node; synchronises)."""
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


def next_slot() -> int:
    """A fresh slot for a node's taken counter."""
    slot = next(_slots)
    if slot >= _library().graph_cond_max_slots():
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
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.graph_cond_versions.argtypes = [ctypes.POINTER(i)] * 2
    lib.graph_cond_versions.restype = i
    lib.graph_cond_max_slots.argtypes = []
    lib.graph_cond_max_slots.restype = i
    lib.graph_cond_if_begin.argtypes = [p, p, i, p, ctypes.POINTER(p),
                                        ctypes.POINTER(ctypes.c_ulonglong)]
    lib.graph_cond_if_begin.restype = i
    lib.graph_cond_if_end.argtypes = [p, p]
    lib.graph_cond_if_end.restype = i
    lib.graph_cond_taken.argtypes = [ctypes.POINTER(ctypes.c_ulonglong), i,
                                     i]
    lib.graph_cond_taken.restype = i
    _build.bind_runs(lib, NAME)
    check_versions(lib)
    return lib


_lib = None


def _library() -> ctypes.CDLL:
    """The library, built, loaded and bound at first use."""
    global _lib
    if _lib is None:
        _lib = _bind(_build.load(NAME))
    return _lib


def if_begin(pred: torch.Tensor, slot: int, body_stream: torch.cuda.Stream
             ) -> int:
    """Under stream capture on the current stream: launch the set kernel on
    `pred` (a one-element bool tensor on the stream's device), add an IF
    node after it and begin capturing `body_stream` into the node's body
    graph.  Returns the body graph (a cudaGraph_t, as an int)."""
    global captured
    if pred.device.type != "cuda" or pred.dtype != torch.bool \
            or pred.numel() != 1:
        raise ValueError(f"an IF node's predicate is one bool on a CUDA "
                         f"device, got {pred.dtype} {tuple(pred.shape)} on "
                         f"{pred.device}")
    lib = _library()
    pred = pred.reshape(())
    with torch.cuda.device(pred.device):
        stream = torch.cuda.current_stream()
        if not torch.cuda.is_current_stream_capturing():
            raise RuntimeError(f"{NAME}: an IF node is added only under "
                               f"stream capture")
        graph, handle = ctypes.c_void_p(0), ctypes.c_ulonglong(0)
        _check(lib.graph_cond_if_begin(
            stream.cuda_stream, pred.data_ptr(), slot,
            body_stream.cuda_stream, ctypes.byref(graph),
            ctypes.byref(handle)), "adding an IF node")
    _devices.add(pred.device.index)
    captured += 1
    return graph.value


def if_end(body_stream: torch.cuda.Stream, body_graph: int) -> None:
    """End the body capture if_begin began."""
    _check(_library().graph_cond_if_end(body_stream.cuda_stream, body_graph),
           "ending an IF node's body capture")
