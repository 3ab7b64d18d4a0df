"""A step captured once as a CUDA graph and replayed every frame.

The reference's frame is one jitted program with no host round-trips
(immesh_tpu/runtime/joint.py:32-42).  Its counterpart here is a step
function captured with torch.cuda.graph once per pipeline and input shape,
and replayed (lio/captured.py, mesh/captured.py):

  * the first call of an input shape runs the step eagerly on the capture
    stream: the warm-up, and a real frame (the step never runs twice on the
    live state).  It builds and loads the kernels' libraries and the
    library handles before anything is captured;
  * the second call captures the step from static input buffers into the
    graph's private memory pool, then replays it;
  * every call copies the inputs into the static buffers, checks that no
    persistent tensor (a map, a store) moved since the capture, replays,
    and clones out what the step returned, which the next replay would
    overwrite.

A step must read no device value on the host, and must update its
persistent tensors in place.  A capture or replay that fails raises;
nothing falls back to the eager step.

Counts: a replay calls no kernel wrapper.  The wrappers count the launches
they record during a capture apart (their `captured`, read through
kernels/build.py::captured_launches), and each graph keeps them beside its
replays; the kernels' own device counters (`runs()` of the
kernels/ modules) measure what the replays ran.  Each graph also keeps its
cudaGraph_t, so its nodes can be counted by type (Graph.nodes).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, Dict, List, Tuple

import torch

from immesh_tpu_torch.kernels.build import captured_launches

# the CUDA driver API's CUgraphNodeType values
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
               5: "empty", 6: "wait_event", 7: "event_record",
               8: "ext_semas_signal", 9: "ext_semas_wait", 10: "mem_alloc",
               11: "mem_free", 12: "batch_mem_op", 13: "conditional"}


def graph_nodes(graph: torch.cuda.CUDAGraph) -> Dict[str, int]:
    """The nodes of a graph captured with keep_graph=True, by type
    ("kernel", "memcpy", "memset" and any other type the graph holds, by
    its CUgraphNodeType name), read from its cudaGraph_t through the CUDA
    driver API."""
    cuda = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    err = cuda.cuGraphGetNodes(raw, None, ctypes.byref(n))
    nodes = (ctypes.c_void_p * n.value)()
    if err == 0:
        err = cuda.cuGraphGetNodes(raw, nodes, ctypes.byref(n))
    counts = {"kernel": 0, "memcpy": 0, "memset": 0}
    for node in nodes[:n.value] if err == 0 else ():
        kind = ctypes.c_int(-1)
        err = cuda.cuGraphNodeGetType(ctypes.c_void_p(node),
                                      ctypes.byref(kind))
        if err != 0:
            break
        name = _NODE_TYPES.get(kind.value, f"type {kind.value}")
        counts[name] = counts.get(name, 0) + 1
    if err != 0:
        raise RuntimeError(f"reading the graph's nodes failed: CUresult {err}")
    return counts


def named_tensors(x, name: str = "") -> List[Tuple[str, torch.Tensor]]:
    """(path, tensor) of every tensor of x (a tensor, or tuples, lists,
    dicts and dataclasses of them), in a fixed order; a path joins the
    field names, keys and indices from x down with "."."""
    if torch.is_tensor(x):
        return [(name, x)]
    if dataclasses.is_dataclass(x):
        items = [(f.name, getattr(x, f.name)) for f in dataclasses.fields(x)]
    elif isinstance(x, dict):
        items = list(x.items())
    elif isinstance(x, (tuple, list)):
        items = list(enumerate(x))
    else:
        return []
    return [p for k, v in items
            for p in named_tensors(v, f"{name}.{k}" if name else str(k))]


def tensors(x) -> List[torch.Tensor]:
    """The tensors of x, in named_tensors' order."""
    return [t for _, t in named_tensors(x)]


def clone_tree(x):
    """x with every tensor cloned (tuples, lists, dicts, dataclasses)."""
    if torch.is_tensor(x):
        return x.clone()
    if dataclasses.is_dataclass(x):
        return dataclasses.replace(x, **{f.name: clone_tree(getattr(x, f.name))
                                         for f in dataclasses.fields(x)})
    if isinstance(x, dict):
        return {k: clone_tree(v) for k, v in x.items()}
    if isinstance(x, (tuple, list)):
        return type(x)(clone_tree(v) for v in x)
    return x


@dataclasses.dataclass
class Graph:
    graph: torch.cuda.CUDAGraph  # kept (keep_graph=True), instantiated
    inputs: tuple               # the static inputs the graph reads
    out: Any                    # what the step returned: graph-owned
    ptrs: Tuple[int, ...]       # the persistent tensors' addresses
    captured: Dict[str, int]    # kernel launches recorded into the graph
    replays: int = 0

    def nodes(self) -> Dict[str, int]:
        """The graph's nodes by type (graph_nodes)."""
        return graph_nodes(self.graph)


class CapturedStep:
    """A step, `_step(*persistent, *inputs)`, captured once per input shape
    and replayed.  A subclass gives
    `_step` and `_pointers(*persistent)`, the addresses of every tensor the
    step updates in place; `what` names them in the error a moved tensor
    raises."""

    what = "the persistent state"

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self._graphs = {}   # key → Graph, or None once warmed up

    @property
    def graphs(self) -> List[Graph]:
        """The captured graphs, one per input shape."""
        return [g for g in self._graphs.values() if g is not None]

    @property
    def replays(self) -> int:
        """Replays of all the graphs."""
        return sum(g.replays for g in self.graphs)

    def _step(self, *args):
        raise NotImplementedError

    def _pointers(self, *persistent) -> Tuple[int, ...]:
        raise NotImplementedError

    def _run(self, persistent: tuple, inputs: tuple):
        key = tuple((tuple(t.shape), t.dtype, t.device)
                    for t in tensors(inputs))
        if key not in self._graphs:
            self._graphs[key] = None
            return self._warm_up(persistent, inputs)
        g = self._graphs[key]
        if g is None:
            g = self._graphs[key] = self._capture(persistent, inputs)
        return self._replay(g, persistent, inputs)

    def _warm_up(self, persistent, inputs):
        """The shape's first frame, eager, on the capture stream (which
        runs nothing else but the capture)."""
        cur = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = self._step(*persistent, *inputs)
        cur.wait_stream(self.stream)
        return out

    def _capture(self, persistent, inputs) -> Graph:
        static_in = clone_tree(inputs)
        before = captured_launches()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, stream=self.stream):
            out = self._step(*persistent, *static_in)
        graph.instantiate()
        after = captured_launches()
        return Graph(graph, static_in, out, self._pointers(*persistent),
                     {k: n - before.get(k, 0) for k, n in after.items()})

    def _replay(self, g: Graph, persistent, inputs):
        if self._pointers(*persistent) != g.ptrs:
            raise RuntimeError(
                f"a tensor of {self.what} moved since the step was "
                f"captured; it must be updated in place")
        for s, x in zip(tensors(g.inputs), tensors(inputs)):
            s.copy_(x)
        g.graph.replay()
        g.replays += 1
        return clone_tree(g.out)
