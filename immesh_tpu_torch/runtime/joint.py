"""Fused odometry + meshing frame step.

Port of immesh_tpu/runtime/joint.py: lio_step then mesh_step on the same
frame, with both pipelines' occupancy-triggered compaction after it.  The
JAX reference donates the four persistent states (filter state, plane voxel
map, global point map, triangle store) into one jitted program, joint_step;
here the maps and store are updated in place and the small filter state is
replaced.  On a CUDA device `JointPipeline.step` replays the LIO step's
captured graph on the caller's stream, then the mesh half on the
MeshPipeline's own stream (mesh/pipeline.py::MeshPipeline.half): the mesh
step's graph, the backlog's copy and the mesh compaction poll, after the
LIO half that made its world scan and pose.  The pose is read as soon as
the LIO half is done, and the mesh half's state is joined by whoever reads
it (MeshPipeline.join).  `graph=False`, and the CPU, compose the
LioPipeline's and the MeshPipeline's steps eagerly, serial.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from immesh_tpu_torch.config import ImMeshConfig
from immesh_tpu_torch.device import HostCopy, resolve_device
from immesh_tpu_torch.frontend.types import ScanBundle
from immesh_tpu_torch.lio.pipeline import LioPipeline
from immesh_tpu_torch.mesh.pipeline import MeshPipeline
from immesh_tpu_torch.runtime.captured import FrameSteps
from immesh_tpu_torch.utils.timers import trace


def _mesh_half(mesh: MeshPipeline, world_scan, bundle, state, diag, cfg):
    """JointPipeline.step after the LIO step: the MeshPipeline's step
    without its compaction trigger (MeshPipeline.advance).  Returns the
    frame's diag with the mesh step's.  `cfg` is the frame's config (the
    hi-budget one on hi frames); the step does not read it, since it sizes
    its work from the point map's own config (reference behaviour 7), and
    the tests' budget recorders log it here."""
    n_active = mesh.advance(world_scan, bundle.mask, state.pos)
    return dict(diag, n_active_voxels=n_active, **mesh.last_drops)


def _frame(pipe: "JointPipeline", bundle, cfg):
    """JointPipeline.step's frame, before the plane map's poll: the LIO
    step, then the mesh half (_mesh_half, the backlog's copy and the mesh
    compaction poll, on the mesh stream where the mesh step is captured).
    Returns (world_scan, diag).  `cfg` is the frame's config, as
    _mesh_half's."""
    lio, mesh = pipe.lio, pipe.mesh
    mesh.count_pending("lio_over_mesh")
    world_scan, diag = lio.advance(bundle)
    with mesh.half():
        diag = _mesh_half(mesh, world_scan, bundle, lio.state, diag, cfg)
        if pipe._cfg_hi is not None:
            pipe._backlog_q = (pipe._backlog_q
                               + [HostCopy(diag["drop_deferred"])])[-2:]
        mesh.maybe_compact(lio.state.pos)
    return world_scan, diag


class JointPipeline:
    """Host wrapper for the fused step (bench, headless runs).

    adaptive_mesh_budget > cfg.mesh.active_voxels_per_frame enables the
    hi-budget variant: on frames where the re-mesh backlog of TWO frames
    before exceeded `adaptive_threshold` (default 2× the base budget),
    the frame's step gets the config with the larger budget.  As the
    reference, the backlog is copied to the host asynchronously after each
    frame (device.HostCopy) and read two frames later, so the read never
    waits on a frame in flight and the hi/lo decision falls on the same
    frames in both.  As in the reference, mesh_step sizes its work list
    from the point map's own config (gm.cfg), not from the config the frame
    is given.

    A step is the reference joint_step's composition.  On a CUDA device it
    replays the LioPipeline's graph, then, on the MeshPipeline's stream,
    the mesh half with the MeshPipeline's graph (`captured` shows the two
    as one, runtime/captured.py); neither step reads a mesh budget from the
    frame's config, so one mesh graph serves both budgets.  The step
    returns once both halves are launched, and `mesh.count_pending` counts
    `pose_before_mesh` as it returns: its caller reads the pose then.
    `graph=False`, and the CPU, run the LioPipeline's step without its
    compaction trigger (LioPipeline.advance), then the MeshPipeline's
    (_mesh_half), eagerly on the caller's stream, or, where a caller
    replaced `lio` or `mesh` with a pipeline of its own before the first
    step, as that pipeline runs it.  `_frame` is the hook the budget
    recorders wrap."""

    def __init__(self, cfg: ImMeshConfig, adaptive_mesh_budget: int = 0,
                 adaptive_threshold: int = 0, device="cuda",
                 graph: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        # state + voxel map, and point map + store
        self.lio = LioPipeline(cfg, device=self.device, graph=graph)
        self.mesh = MeshPipeline(cfg, device=self.device, graph=graph)
        self.frame_idx = 0
        self._cfg_hi = None
        if adaptive_mesh_budget > cfg.mesh.active_voxels_per_frame:
            self._cfg_hi = cfg.replace(mesh=dataclasses.replace(
                cfg.mesh, active_voxels_per_frame=adaptive_mesh_budget))
        self.adaptive_threshold = (adaptive_threshold or
                                   2 * cfg.mesh.active_voxels_per_frame)
        self._backlog_q = []  # drop_deferred of the last two frames (HostCopy)

    @property
    def captured(self) -> Optional[FrameSteps]:
        """The frame's captured steps, the LIO's and the mesh's, as one;
        None unless both halves are captured."""
        lio, mesh = self.lio.captured, self.mesh.captured
        return None if lio is None or mesh is None else FrameSteps(lio, mesh)

    def static_init(self, acc, gyr) -> None:
        """IMU static initialization of the filter (reference IMU_init)."""
        self.lio.static_init(acc, gyr)

    def prime_adaptive(self) -> None:
        """Force the next steps onto the hi-budget variant (benches call this
        during warm-up)."""
        if self._cfg_hi is not None:
            self._backlog_q = [HostCopy(torch.tensor(1 << 30))] * 2

    def step(self, bundle: ScanBundle):
        """One frame (the frame trace's `frame` span); returns (world_scan,
        diag).  The pose stays on the device: read_pose copies it.  diag's
        mesh entries (n_active_voxels, drop_*) are device scalars the mesh
        half writes: read them after `self.mesh.join()`."""
        with trace.frame(self.frame_idx, self.device):
            cfg = self.cfg
            if self._cfg_hi is not None and len(self._backlog_q) >= 2 \
                    and self._backlog_q[0].value() > self.adaptive_threshold:
                cfg = self._cfg_hi
            world_scan, diag = _frame(self, bundle, cfg)
            self.frame_idx += 1
            self.lio.frame_idx = self.mesh.frame_idx = self.frame_idx
            self.lio.maybe_compact()
            self.mesh.count_pending("pose_before_mesh")
            return world_scan, diag

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
