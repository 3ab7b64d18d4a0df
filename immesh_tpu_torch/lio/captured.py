"""The LIO step as one captured CUDA graph, replayed every frame.

The reference's step is one jitted program with no host round-trips
(immesh_tpu/lio/pipeline.py:1-7, `jax.jit(..., static_argnames=("cfg",))`
at :32).  Its counterpart here is `lio_step` captured with torch.cuda.graph
once per pipeline (its config) and bundle shape, and replayed:

  * the first call of a bundle shape runs lio_step eagerly on the capture
    stream: the warm-up, and a real frame (the step never runs twice on the
    live map).  It builds and loads the kernels' libraries and the library
    handles before anything is captured;
  * the second call captures lio_step from static input buffers into the
    graph's private memory pool, then replays it;
  * every call copies the bundle and the filter state into the static
    buffers (BA pose feedback, static_init and reset_filter replace the
    state between frames), checks that no map tensor moved since the
    capture, replays, and copies out what outlives the next replay: the
    state, the world scan and diag.

lio_step reads no device value on the host: the ESIKF iterations after
convergence and the empty refinement levels run masked (lio/esikf.py,
map/voxel_map.py), so the graph has no conditional node and a replay runs
every launch it holds.  A capture that fails raises; nothing falls back to
the eager step.

Counts: a replay calls no kernel wrapper.  The wrappers count the launches
they record during the capture apart (`captured`), and each graph keeps
them beside its replays; the kernels' own device counters (`runs()` of
kernels/hash_probe.py and kernels/scatter_drop.py) measure what the replays
ran.  Each graph also keeps its cudaGraph_t, so its nodes can be counted
by type (_Graph.nodes).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Dict, Tuple

import torch

from immesh_tpu_torch.config import ImMeshConfig
from immesh_tpu_torch.core.state import EsikfState
from immesh_tpu_torch.frontend.types import ScanBundle
from immesh_tpu_torch.kernels import hash_probe, scatter_drop
from immesh_tpu_torch.map.voxel_map import VoxelMap

_STATE = tuple(f.name for f in dataclasses.fields(EsikfState))
_BUNDLE = tuple(f.name for f in dataclasses.fields(ScanBundle))
# the CUDA driver API's CUgraphNodeType values
_NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "graph",
               5: "empty", 6: "wait_event", 7: "event_record",
               8: "ext_semas_signal", 9: "ext_semas_wait", 10: "mem_alloc",
               11: "mem_free", 12: "batch_mem_op", 13: "conditional"}


def _captured() -> Dict[str, int]:
    """The kernel wrappers' launches recorded into graphs, by kernel."""
    return {**hash_probe.captured, "scatter_drop": scatter_drop.captured}


def map_pointers(vm: VoxelMap) -> Tuple[int, ...]:
    """The addresses of every tensor of the map: a replay reads and writes
    the map at the addresses it was captured with."""
    return (vm.table.keys.data_ptr(), vm.table.fp.data_ptr(),
            *(getattr(vm, n).data_ptr() for n in VoxelMap._FIELDS))


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


@dataclasses.dataclass
class _Graph:
    graph: torch.cuda.CUDAGraph  # kept (keep_graph=True), instantiated
    bundle: ScanBundle          # static inputs the graph reads
    state: EsikfState
    out: tuple                  # (state, world_scan, diag), graph-owned
    map_ptrs: Tuple[int, ...]
    captured: Dict[str, int]    # kernel launches recorded into the graph
    replays: int = 0

    def nodes(self) -> Dict[str, int]:
        """The graph's nodes by type (graph_nodes)."""
        return graph_nodes(self.graph)


def _bundle_key(b: ScanBundle) -> tuple:
    return tuple((tuple(t.shape), t.dtype, t.device)
                 for t in (getattr(b, n) for n in _BUNDLE))


class CapturedLioStep:
    """lio_step(state, vm, bundle, cfg, ext) of one pipeline, captured once
    per bundle shape and replayed.  Calls return (state, world_scan, diag)
    as fresh tensors; `vm` is updated in place."""

    def __init__(self, cfg: ImMeshConfig, ext, device: torch.device):
        self.cfg, self.ext = cfg, ext
        self.stream = torch.cuda.Stream(device)
        self._graphs = {}   # bundle key → _Graph, or None once warmed up

    @property
    def graphs(self):
        """The captured graphs (_Graph), one per bundle shape."""
        return [g for g in self._graphs.values() if g is not None]

    @property
    def replays(self) -> int:
        """Replays of all the graphs."""
        return sum(g.replays for g in self.graphs)

    def __call__(self, state: EsikfState, vm: VoxelMap, bundle: ScanBundle):
        key = _bundle_key(bundle)
        if key not in self._graphs:
            self._graphs[key] = None
            return self._warm_up(state, vm, bundle)
        g = self._graphs[key]
        if g is None:
            g = self._graphs[key] = self._capture(state, vm, bundle)
        return self._replay(g, state, vm, bundle)

    def _step(self, state, vm, bundle):
        from immesh_tpu_torch.lio.pipeline import lio_step
        state, _, world_scan, diag = lio_step(state, vm, bundle, self.cfg,
                                              self.ext)
        return state, world_scan, diag

    def _warm_up(self, state, vm, bundle):
        """The shape's first frame, eager, on the capture stream (which
        runs nothing else but the capture)."""
        cur = torch.cuda.current_stream(self.stream.device)
        self.stream.wait_stream(cur)
        with torch.cuda.stream(self.stream):
            out = self._step(state, vm, bundle)
        cur.wait_stream(self.stream)
        return out

    def _capture(self, state, vm, bundle) -> _Graph:
        static_b = ScanBundle(**{n: getattr(bundle, n).clone()
                                 for n in _BUNDLE})
        static_s = EsikfState(**{n: getattr(state, n).clone()
                                 for n in _STATE})
        before = _captured()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with torch.cuda.graph(graph, stream=self.stream):
            out = self._step(static_s, vm, static_b)
        graph.instantiate()
        after = _captured()
        return _Graph(graph, static_b, static_s, out, map_pointers(vm),
                      {k: after[k] - before[k] for k in after})

    def _replay(self, g: _Graph, state, vm, bundle):
        if map_pointers(vm) != g.map_ptrs:
            raise RuntimeError("a tensor of the plane map moved since the "
                               "LIO step was captured; the map must be "
                               "updated in place")
        for n in _BUNDLE:
            getattr(g.bundle, n).copy_(getattr(bundle, n))
        for n in _STATE:
            getattr(g.state, n).copy_(getattr(state, n))
        g.graph.replay()
        g.replays += 1
        st, world_scan, diag = g.out
        return (EsikfState(**{n: getattr(st, n).clone() for n in _STATE}),
                world_scan.clone(), {k: v.clone() for k, v in diag.items()})
