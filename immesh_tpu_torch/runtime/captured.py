"""The fused frame as one captured CUDA graph, replayed every frame.

The reference's frame is one donated, jitted program: joint_step runs
lio_step, then mesh_step on the world scan and pose it made
(immesh_tpu/runtime/joint.py:32-42).  Its counterpart here is that
composition captured with torch.cuda.graph once per pipeline and bundle
shape, and replayed as utils/graphs.py describes: frame 0 eager on the
capture stream, frame 1 captured, every later frame replayed.  The step is
exactly lio/captured.py's step followed by mesh/captured.py's, in one
graph: the world scan, its mask and the pose pass from the LIO half to the
mesh half inside the graph, with no copy, and the IF nodes of both halves
(ESIKF bodies, refinement levels, mesh chunks) share the step's one body
stream and one memory pool.

Each replay copies the filter state and the bundle into the static
buffers, checks that no tensor of the plane map, the point map or the
triangle store moved since the capture (the error names which), and clones
out once what the caller reads: the state, the world scan, the LIO diag,
the active count, the work list and the mesh diag.  One graph serves both
mesh budgets, since neither step reads one (reference behaviour 7).
"""

from __future__ import annotations

import torch

from immesh_tpu_torch.config import ImMeshConfig
from immesh_tpu_torch.core.state import EsikfState
from immesh_tpu_torch.frontend.types import ScanBundle
from immesh_tpu_torch.lio.captured import map_pointers
from immesh_tpu_torch.map.voxel_map import VoxelMap
from immesh_tpu_torch.mesh.captured import mesh_pointers
from immesh_tpu_torch.mesh.global_map import GlobalPointMap
from immesh_tpu_torch.mesh.triangles import TriangleStore
from immesh_tpu_torch.utils.graphs import CapturedStep


class CapturedJointStep(CapturedStep):
    """lio_step(state, vm, bundle, cfg, ext) then mesh_step(gm, store,
    world_scan, bundle.mask, state.pos, gm.cfg.mesh_chunk) of one
    pipeline, captured once per bundle shape and replayed.  Calls return
    (state, world_scan, diag, n_active, slots, smask, mesh diag) as fresh
    tensors; `vm`, `gm` and `store` are updated in place."""

    parts = ("the plane map", "the point map", "the triangle store")

    def __init__(self, cfg: ImMeshConfig, ext, device: torch.device):
        super().__init__(device)
        self.cfg, self.ext = cfg, ext

    def __call__(self, state: EsikfState, vm: VoxelMap, gm: GlobalPointMap,
                 store: TriangleStore, bundle: ScanBundle):
        return self._run((vm, gm, store), (state, bundle))

    def _pointers(self, vm, gm, store):
        return (map_pointers(vm), *mesh_pointers(gm, store))

    def _step(self, vm, gm, store, state, bundle):
        from immesh_tpu_torch.lio.pipeline import lio_step
        from immesh_tpu_torch.mesh.pipeline import mesh_step
        state, _, world_scan, diag = lio_step(state, vm, bundle, self.cfg,
                                              self.ext)
        _, _, n_active, slots, smask, mdiag = mesh_step(
            gm, store, world_scan, bundle.mask, state.pos, gm.cfg.mesh_chunk)
        return state, world_scan, diag, n_active, slots, smask, mdiag
