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
    overwrite.  With the frame trace on (utils/timers.py) these are its
    `copy_in` (the shape key, the check and the copies), `launch`, `graph`
    (the replay's device span) and `clone_out` spans, and the device
    spans recorded inside the step are event-record nodes of its graph.

A step must read no device value on the host, and must update its
persistent tensors in place.  A capture or replay that fails raises;
nothing falls back to the eager step.

Counts: a replay calls no kernel wrapper.  The wrappers count the launches
they record during a capture apart (their `captured`, read through
kernels/build.py::captured_launches), and each graph keeps them beside its
replays; the kernels' own device counters (`runs()` of the
kernels/ modules) measure what the replays ran.  Each graph also keeps its
cudaGraph_t, so its nodes can be counted by type (Graph.nodes).

Device-side exits (`device_if`).  Where the reference skips work on the
device (the ESIKF while_loop, an empty refinement level's or mesh chunk's
lax.cond), the step calls device_if(pred, body), `pred` a
kernels/graph_cond.py Pred (the site's predicate: its form and the tensors
it reads) or a one-element bool tensor:

  * under capture on the card the body is captured into the body graph of
    an IF node: the set kernel, launched on the capture stream before the
    predicate's first node, makes the predicate from its tensors and sets
    every node on it (`pred.uses` of them: the ESIKF body's two) at every
    replay, and a skipped body runs nothing;
  * outside capture (graph=False, the warm-up frame, the CPU) it is the
    reference's semantics read on the host, once a predicate:
    `if pred.value(): body()`.

A site whose predicate is fixed (the ESIKF's first body: the while_loop's
first test always holds) calls its body directly, with no node.

A body writes its results only in place, into tensors allocated before the
node (the carry): a tensor the body creates holds the previous replay's
bits whenever the body is skipped, so nothing after the node may read one.
A body is captured on the step's own body stream, a stream of its own (a
conditional body may hold no event node, so it takes no wait_stream), with
torch's allocations of the capturing thread routed into the graph's private
pool; the warm-up frame runs every body it takes on that stream too, so the
library handles and workspaces of the body stream exist before the capture.
A graph keeps its bodies (`Graph.bodies`): each one's slot, its body graph
and the kernel launches recorded into it, which the kernels' device runs
follow as kernels/graph_cond.py's per-slot taken counts say.  A node that
cannot be made, or a graph that cannot be instantiated, raises: there is
no masked fallback.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch

from immesh_tpu_torch.kernels import graph_cond
from immesh_tpu_torch.kernels.build import captured_launches
from immesh_tpu_torch.utils.timers import trace

# the CUDA driver API's CUgraphNodeType values
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
               5: "empty", 6: "wait_event", 7: "event_record",
               8: "ext_semas_signal", 9: "ext_semas_wait", 10: "mem_alloc",
               11: "mem_free", 12: "batch_mem_op", 13: "conditional"}


def graph_nodes(graph: torch.cuda.CUDAGraph) -> Dict[str, int]:
    """The nodes of a graph captured with keep_graph=True, by type
    ("kernel", "memcpy", "memset" and any other type the graph holds, by
    its CUgraphNodeType name), read from its cudaGraph_t through the CUDA
    driver API.  A conditional node counts as one "conditional"; its body
    is not entered (Graph.nodes adds the bodies)."""
    return raw_graph_nodes(graph.raw_cuda_graph())


def raw_graph_nodes(raw: int) -> Dict[str, int]:
    """graph_nodes of a cudaGraph_t given as an int."""
    cuda = ctypes.CDLL("libcuda.so.1")
    raw = ctypes.c_void_p(raw)
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


class _EdgeData(ctypes.Structure):
    """The CUDA driver API's CUgraphEdgeData (CUDA 12.3)."""
    _fields_ = [("from_port", ctypes.c_ubyte), ("to_port", ctypes.c_ubyte),
                ("type", ctypes.c_ubyte), ("reserved", ctypes.c_ubyte * 5)]


# (CUgraphDependencyType, the edge's CUgraphKernelNodePort from port) names
_EDGE_KINDS = {(0, 0): "default", (1, 1): "programmatic",
               (1, 2): "launch_order"}


def graph_edges(graph: torch.cuda.CUDAGraph) -> Dict[str, int]:
    """The dependency edges of a graph captured with keep_graph=True, by
    kind: "default" (the next node starts when the last one completed),
    "programmatic" (a programmatic dependent launch kept by the capture:
    the next kernel may start once every block of the last one released
    it), "launch_order" or "type t port p"; read with each edge's data
    through the CUDA driver API."""
    cuda = ctypes.CDLL("libcuda.so.1")
    get = getattr(cuda, "cuGraphGetEdges_v2", None)
    if get is None:  # CUDA 13's driver: the edge data in the plain name
        version = ctypes.c_int(0)
        cuda.cuDriverGetVersion(ctypes.byref(version))
        if version.value < 13000:
            raise RuntimeError("the CUDA driver reads no graph edge data")
        get = cuda.cuGraphGetEdges
    raw = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    err = get(raw, None, None, None, ctypes.byref(n))
    src = (ctypes.c_void_p * n.value)()
    dst = (ctypes.c_void_p * n.value)()
    data = (_EdgeData * n.value)()
    if err == 0 and n.value:
        err = get(raw, src, dst, data, ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"reading the graph's edges failed: CUresult {err}")
    counts: Dict[str, int] = {}
    for e in data[:n.value]:
        key = (e.type, e.from_port)
        name = _EDGE_KINDS.get(key, f"type {e.type} port {e.from_port}")
        counts[name] = counts.get(name, 0) + 1
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
class Body:
    """The body of one IF node of a captured graph (device_if)."""
    what: str                   # the site, as device_if was told
    slot: int                   # its taken counter (kernels/graph_cond.py)
    launch: int                 # the slot of its set launch's first node
    graph: int                  # the body's cudaGraph_t
    captured: Dict[str, int]    # kernel launches recorded into the body

    def nodes(self) -> Dict[str, int]:
        """The body's nodes by type (raw_graph_nodes)."""
        return raw_graph_nodes(self.graph)


@dataclasses.dataclass
class Graph:
    graph: torch.cuda.CUDAGraph  # kept (keep_graph=True), instantiated
    inputs: tuple               # the static inputs the graph reads
    out: Any                    # what the step returned: graph-owned
    ptrs: tuple                 # each persistent part's tensors' addresses
    captured: Dict[str, int]    # kernel launches recorded outside the bodies
    bodies: List[Body] = dataclasses.field(default_factory=list)
    pool: Any = None            # the bodies' memory pool, kept with the graph
    replays: int = 0
    # the frame trace's device spans captured into the graph (timers.trace:
    # name, parent, start and end event), read at each replay
    spans: list = dataclasses.field(default_factory=list)

    def nodes(self) -> Dict[str, int]:
        """The graph's nodes by type, its IF nodes' bodies included (each
        IF node counts once as "conditional")."""
        total = graph_nodes(self.graph)
        for b in self.bodies:
            for k, n in b.nodes().items():
                total[k] = total.get(k, 0) + n
        return total


# the step running now on the card: its body stream, and while it is being
# captured the graph's bodies (device_if)
@dataclasses.dataclass
class _Step:
    body_stream: torch.cuda.Stream
    capturing: bool = False
    bodies: List[Body] = dataclasses.field(default_factory=list)
    in_body: bool = False


_running: List[_Step] = []


def device_if(pred, body: Callable[[], Any], what: str = "body") -> None:
    """Run body() where `pred` (a graph_cond.Pred, or a one-element bool
    tensor) holds, as the reference's lax.cond / while_loop test does on
    the device (the module's docstring).  Under a CapturedStep's capture:
    an IF node whose body graph holds body()'s launches, set by the
    predicate's one set launch.  Otherwise the predicate read on the host
    once (graph_cond.taken_plain) and kept for its other uses, and
    `if taken: body()`, on the step's body stream during its warm-up
    frame.  body() returns nothing that is used: it writes its results in
    place."""
    pred = graph_cond.as_pred(pred)
    dev = pred.x.device
    step = _running[-1] if _running else None
    if dev.type != "cuda" or step is None or not step.capturing:
        if not pred.pending:
            pred.pending = [graph_cond.taken_plain(pred)] * pred.uses
        if not pred.pending.pop():
            return
        if dev.type != "cuda" or step is None:
            body()
            return
        cur = torch.cuda.current_stream(dev)
        step.body_stream.wait_stream(cur)
        with torch.cuda.stream(step.body_stream):
            body()
        cur.wait_stream(step.body_stream)
        return
    if step.in_body:
        raise RuntimeError("device_if inside a conditional body")
    if not pred.pending:
        first = graph_cond.next_slots(pred.uses)
        pred.pending = [(first + i, h, first) for i, h in enumerate(
            graph_cond.set_launch(pred, first))][::-1]
    slot, handle, launch = pred.pending.pop()
    body_graph = graph_cond.if_begin(handle, dev, step.body_stream)
    before = captured_launches()
    step.in_body = True
    try:
        with torch.cuda.stream(step.body_stream):
            body()
    except BaseException:
        step.in_body = False
        try:
            graph_cond.if_end(step.body_stream, body_graph)
        except RuntimeError:
            pass  # the body's own error is the one to report
        raise
    step.in_body = False
    graph_cond.if_end(step.body_stream, body_graph)
    after = captured_launches()
    step.bodies.append(Body(what, slot, launch, body_graph,
                            {k: n - before.get(k, 0)
                             for k, n in after.items()}))


class CapturedStep:
    """A step, `_step(*persistent, *inputs)`, captured once per input shape
    and replayed.  A subclass gives `_step` and `_pointers(*persistent)`:
    for each part of the persistent state, the addresses of every tensor
    of it the step updates in place; `parts` names them, in that order, in
    the error a moved tensor raises."""

    parts: Tuple[str, ...] = ("the persistent state",)

    def __init__(self, device: torch.device):
        self.stream = torch.cuda.Stream(device)
        self.body_stream = torch.cuda.Stream(device)  # device_if's bodies
        self._graphs = {}   # key → Graph, or None once warmed up
        # where a caller sets a list: a (start, end) CUDA event pair
        # recorded around each replay, appended (the graph's device span;
        # the same pair is the frame trace's `graph` span)
        self.replay_events = None

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
        with trace.span("copy_in"):  # the inputs' shapes pick the graph
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
        runs nothing else but the capture), its bodies on the body
        stream."""
        cur = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(cur)
        _running.append(_Step(self.body_stream))
        try:
            with torch.cuda.stream(self.stream):
                out = self._step(*persistent, *inputs)
        finally:
            _running.pop()
        cur.wait_stream(self.stream)
        return out

    def _capture(self, persistent, inputs) -> Graph:
        static_in = clone_tree(inputs)
        before = captured_launches()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        step = _Step(self.body_stream, capturing=True)
        pool = torch.cuda.MemPool()
        dev = self.stream.device.index
        spans = []
        with trace.capture(spans), torch.cuda.graph(graph,
                                                     stream=self.stream):
            # the body stream's allocations, captured into the bodies, into
            # the pool kept with the graph (torch routes only the capture
            # stream's into the graph's own)
            with torch.cuda.stream(self.body_stream):
                torch._C._cuda_beginAllocateCurrentStreamToPool(dev, pool.id)
            _running.append(step)
            try:
                out = self._step(*persistent, *static_in)
            finally:
                _running.pop()
                torch._C._cuda_endAllocateToPool(dev, pool.id)
                torch._C._cuda_releasePool(dev, pool.id)
        try:
            graph.instantiate()
        except RuntimeError as e:
            raise RuntimeError(
                f"instantiating the captured step failed ({e}); its IF "
                f"nodes' bodies hold " + "; ".join(
                    f"{b.what}: {b.nodes()}" for b in step.bodies)) from e
        after = captured_launches()
        outer = {k: n - before.get(k, 0) - sum(b.captured.get(k, 0)
                                                for b in step.bodies)
                 for k, n in after.items()}
        return Graph(graph, static_in, out, self._pointers(*persistent),
                     outer, step.bodies, pool, spans=spans)

    def _replay(self, g: Graph, persistent, inputs):
        with trace.span("copy_in"):
            ptrs = self._pointers(*persistent)
            if ptrs != g.ptrs:
                moved = [n for n, a, b in zip(self.parts, ptrs, g.ptrs)
                         if a != b]
                raise RuntimeError(
                    f"a tensor of {' and '.join(moved)} moved since the step "
                    f"was captured; it must be updated in place")
            for s, x in zip(tensors(g.inputs), tensors(inputs)):
                s.copy_(x)
        trace.replaying(g.spans)
        timed = self.replay_events is not None or trace.on
        if timed:
            span = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            span[0].record()
        with trace.span("launch"):
            g.graph.replay()
        if timed:
            span[1].record()
            if self.replay_events is not None:
                self.replay_events.append(tuple(span))
            trace.replayed(span, g.spans)
        g.replays += 1
        with trace.span("clone_out"):
            return clone_tree(g.out)
