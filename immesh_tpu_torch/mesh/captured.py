"""The mesh step as one captured CUDA graph, replayed every frame.

The reference's mesh step runs inside its jitted frame program
(immesh_tpu/runtime/joint.py:32-42) and skips empty chunks on the device
with `lax.cond` inside `lax.map` (immesh_tpu/mesh/triangles.py:196, :353).
Its counterpart here is `mesh_step` captured with torch.cuda.graph once per
pipeline and scan shape, and replayed as utils/graphs.py describes:
frame 0 eager on the capture stream, frame 1 captured, every later frame
replayed.  Each replay copies the world scan, its mask and the sensor
position into the static buffers, checks that no tensor of the point map
or the triangle store moved since the capture (compaction copies back in
place), and clones out the work list (slots, smask), the active count and
every diag counter: the frame's diag hands the counters on, and the
texture and render paths read the work list.

Each chunk is the body of an IF node on "the chunk has an active point"
(triangles.triangulate_voxels, utils/graphs.py::device_if), so a replay
skips an empty chunk on the device, as the reference's lax.cond does; the
eager step (graph=False, the CPU) reads the same test on the host.  The
chunk outputs hold the empty result before the loop and a body writes its
rows in place, so a replay equals the eager step bit for bit.
"""

from __future__ import annotations

from typing import Tuple

import torch

from immesh_tpu_torch.mesh.global_map import GlobalPointMap
from immesh_tpu_torch.mesh.triangles import TriangleStore
from immesh_tpu_torch.utils.graphs import CapturedStep, tensors


def mesh_pointers(gm: GlobalPointMap, store: TriangleStore
                  ) -> Tuple[Tuple[int, ...], Tuple[int, ...]]:
    """The addresses of every tensor of the point map, and of the store: a
    replay reads and writes them at the addresses it was captured with."""
    return (tuple(t.data_ptr() for t in tensors(gm)),
            tuple(t.data_ptr() for t in tensors(store)))


class CapturedMeshStep(CapturedStep):
    """mesh_step(gm, store, pts_world, mask, sensor_pos) of one pipeline,
    at the map's own chunk (gm.cfg.mesh_chunk), captured once per scan
    shape and replayed.  Calls return (n_active, slots, smask, diag) as
    fresh tensors; `gm` and `store` are updated in place."""

    parts = ("the point map", "the triangle store")

    def __call__(self, gm: GlobalPointMap, store: TriangleStore,
                 pts_world: torch.Tensor, mask: torch.Tensor,
                 sensor_pos: torch.Tensor):
        return self._run((gm, store), (pts_world, mask, sensor_pos))

    def _pointers(self, gm, store):
        return mesh_pointers(gm, store)

    def _step(self, gm, store, pts_world, mask, sensor_pos):
        from immesh_tpu_torch.mesh.pipeline import mesh_step
        _, _, n_active, slots, smask, diag = mesh_step(
            gm, store, pts_world, mask, sensor_pos, gm.cfg.mesh_chunk)
        return n_active, slots, smask, diag
