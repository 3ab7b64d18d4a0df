"""The LIO step as one captured CUDA graph, replayed every frame.

The reference's step is one jitted program with no host round-trips
(immesh_tpu/lio/pipeline.py:1-7, `jax.jit(..., static_argnames=("cfg",))`
at :32).  Its counterpart here is `lio_step` captured with torch.cuda.graph
once per pipeline (its config) and bundle shape, and replayed as
utils/graphs.py describes: frame 0 eager on the capture stream, frame 1
captured, every later frame replayed.  Each replay copies the bundle and
the filter state into the static buffers (BA pose feedback, static_init and
reset_filter replace the state between frames), checks that no plane-map
tensor moved since the capture, and clones out the state, the world scan
and diag.

lio_step reads no device value on the host under capture: each ESIKF
body and each refinement level is the body of an IF node (lio/esikf.py,
map/voxel_map.py, utils/graphs.py::device_if), so a replay skips the
bodies after convergence and the empty levels on the device, as the
reference's while_loop and lax.cond do; the eager step (graph=False, the
CPU) reads the same tests on the host, once a body and once a level.
"""

from __future__ import annotations

from typing import Tuple

import torch

from immesh_tpu_torch.config import ImMeshConfig
from immesh_tpu_torch.core.state import EsikfState
from immesh_tpu_torch.frontend.types import ScanBundle
from immesh_tpu_torch.map.voxel_map import VoxelMap
from immesh_tpu_torch.utils.graphs import CapturedStep


def map_pointers(vm: VoxelMap) -> Tuple[int, ...]:
    """The addresses of every tensor of the map: a replay reads and writes
    the map at the addresses it was captured with."""
    return (vm.table.keys.data_ptr(), vm.table.fp.data_ptr(),
            *(getattr(vm, n).data_ptr() for n in VoxelMap._FIELDS))


class CapturedLioStep(CapturedStep):
    """lio_step(state, vm, bundle, cfg, ext) of one pipeline, captured once
    per bundle shape and replayed.  Calls return (state, world_scan, diag)
    as fresh tensors; `vm` is updated in place."""

    parts = ("the plane map",)

    def __init__(self, cfg: ImMeshConfig, ext, device: torch.device):
        super().__init__(device)
        self.cfg, self.ext = cfg, ext

    def __call__(self, state: EsikfState, vm: VoxelMap, bundle: ScanBundle):
        return self._run((vm,), (state, bundle))

    def _pointers(self, vm):
        return (map_pointers(vm),)

    def _step(self, vm, state, bundle):
        from immesh_tpu_torch.lio.pipeline import lio_step
        state, _, world_scan, diag = lio_step(state, vm, bundle, self.cfg,
                                              self.ext)
        return state, world_scan, diag
