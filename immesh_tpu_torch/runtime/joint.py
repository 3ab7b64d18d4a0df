"""Fused odometry + meshing frame step.

Port of immesh_tpu/runtime/joint.py: lio_step then mesh_step on the same
frame, with both pipelines' occupancy-triggered compaction after it.  The
JAX reference donates the four persistent states (filter state, plane voxel
map, global point map, triangle store) into one jitted program, joint_step;
here the maps and store are updated in place and the small filter state is
replaced.  On a CUDA device `JointPipeline.step` replays the LIO step's
captured graph on the caller's stream, then the mesh half
(mesh/pipeline.py::MeshPipeline.step: the mesh step's graph and the mesh
compaction poll) on the MeshPipeline's own stream, after the LIO half that
made its world scan and pose.  The pose is read as soon as the LIO half is
done, and the mesh half's state is joined by whoever reads it
(MeshPipeline.join).  `graph=False`, and the CPU, compose the
LioPipeline's and the MeshPipeline's steps eagerly, serial.
"""

from __future__ import annotations

from typing import Optional

import torch

from immesh_tpu_torch.config import ImMeshConfig
from immesh_tpu_torch.device import resolve_device
from immesh_tpu_torch.frontend.types import ScanBundle
from immesh_tpu_torch.lio.pipeline import LioPipeline
from immesh_tpu_torch.mesh.pipeline import MeshPipeline
from immesh_tpu_torch.runtime.captured import FrameSteps
from immesh_tpu_torch.utils.timers import trace


class JointPipeline:
    """Host wrapper for the fused step (bench, headless runs).

    `adaptive_mesh_budget` and `adaptive_threshold` are the reference's
    signature and have no effect in either package: its hi-budget config
    never reaches the mesh step, which sizes its work from the point map's
    own config (reference behaviour 7).

    A step is the reference joint_step's composition: the LioPipeline's
    step without its compaction trigger (LioPipeline.advance), the mesh
    half (MeshPipeline.step), then the plane map's poll
    (LioPipeline.maybe_compact).  On a CUDA device it replays the
    LioPipeline's graph, then, on the MeshPipeline's stream, the
    MeshPipeline's graph (`captured` shows the two as one,
    runtime/captured.py).  The step returns once both halves are launched,
    and `mesh.count_pending` counts `pose_before_mesh` as it returns: its
    caller reads the pose then.  `graph=False`, and the CPU, run both
    eagerly on the caller's stream, or, where a caller replaced `lio` or
    `mesh` with a pipeline of its own before the first step, as that
    pipeline runs it."""

    def __init__(self, cfg: ImMeshConfig, adaptive_mesh_budget: int = 0,
                 adaptive_threshold: int = 0, device="cuda",
                 graph: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        # state + voxel map, and point map + store
        self.lio = LioPipeline(cfg, device=self.device, graph=graph)
        self.mesh = MeshPipeline(cfg, device=self.device, graph=graph)
        self.frame_idx = 0

    @property
    def captured(self) -> Optional[FrameSteps]:
        """The frame's captured steps, the LIO's and the mesh's, as one;
        None unless both halves are captured."""
        lio, mesh = self.lio.captured, self.mesh.captured
        return None if lio is None or mesh is None else FrameSteps(lio, mesh)

    def static_init(self, acc, gyr) -> None:
        """IMU static initialization of the filter (reference IMU_init)."""
        self.lio.static_init(acc, gyr)

    def step(self, bundle: ScanBundle):
        """One frame (the frame trace's `frame` span); returns (world_scan,
        diag).  The pose stays on the device: read_pose copies it.  diag's
        mesh entries (n_active_voxels, drop_*) are device scalars the mesh
        half writes: read them after `self.mesh.join()`."""
        with trace.frame(self.frame_idx, self.device):
            lio, mesh = self.lio, self.mesh
            mesh.count_pending("lio_over_mesh")
            world_scan, diag = lio.advance(bundle)
            n_active, drops = mesh.step(world_scan, bundle.mask,
                                        lio.state.pos)
            self.frame_idx += 1
            lio.frame_idx = mesh.frame_idx = self.frame_idx
            lio.maybe_compact()
            mesh.count_pending("pose_before_mesh")
            return world_scan, dict(diag, n_active_voxels=n_active, **drops)

    def read_pose(self) -> torch.Tensor:
        """The filter's position on the host, state.pos.cpu(): what an
        odometry node publishes after each step.  The copy waits for the
        frame's work on the stream; it is the frame trace's `pose_read`
        span."""
        with trace.pose_read():
            return self.lio.state.pos.cpu()

    @property
    def state(self):
        return self.lio.state

    @property
    def store(self):
        return self.mesh.store
