"""Fused odometry + meshing frame step.

Port of immesh_tpu/runtime/joint.py: lio_step then mesh_step on the same
frame, with both pipelines' occupancy-triggered compaction after it.  The
JAX reference donates the four persistent states (filter state, plane voxel
map, global point map, triangle store) into one jitted program, joint_step;
here the maps and store are updated in place and the small filter state is
replaced.  On a CUDA device `JointPipeline.step` replays that program's
counterpart, the frame as one captured CUDA graph (runtime/captured.py),
with the compactions between frames; `graph=False`, and the CPU, compose
the LioPipeline's and the MeshPipeline's steps eagerly.
"""

from __future__ import annotations

import dataclasses

import torch

from immesh_tpu_torch.config import ImMeshConfig
from immesh_tpu_torch.device import HostCopy, resolve_device
from immesh_tpu_torch.frontend.types import ScanBundle
from immesh_tpu_torch.lio.pipeline import LioPipeline
from immesh_tpu_torch.mesh.pipeline import MeshPipeline
from immesh_tpu_torch.runtime.captured import CapturedJointStep
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
    """JointPipeline.step's frame, before the polls: one replay of the
    frame graph on the card, else the LIO step then _mesh_half.  Returns
    (world_scan, diag).  `cfg` is the frame's config, as _mesh_half's."""
    lio, mesh = pipe.lio, pipe.mesh
    if pipe.captured is None:
        world_scan, diag = lio.advance(bundle)
        return world_scan, _mesh_half(mesh, world_scan, bundle, lio.state,
                                      diag, cfg)
    (lio.state, world_scan, diag, n_active, slots, smask,
     mesh.last_drops) = pipe.captured(lio.state, lio.vm, mesh.gm, mesh.store,
                                      bundle)
    mesh.last_active = (slots, smask)
    return world_scan, dict(diag, n_active_voxels=n_active, **mesh.last_drops)


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
    is one replay of the frame graph (runtime/captured.py), which neither
    the inner LioPipeline nor the MeshPipeline captures a graph of their
    own for; neither step reads a mesh budget from the frame's config, so
    one graph serves both budgets.  `graph=False`, and the CPU, run the
    LioPipeline's step without its compaction trigger
    (LioPipeline.advance), then the MeshPipeline's (_mesh_half): eagerly,
    or, where a caller replaced `lio` or `mesh` with a pipeline of its own
    before the first step, as that pipeline runs it (a captured LioPipeline
    and MeshPipeline chain the two graphs of one).  `_frame` is the hook
    the budget recorders wrap."""

    def __init__(self, cfg: ImMeshConfig, adaptive_mesh_budget: int = 0,
                 adaptive_threshold: int = 0, device="cuda",
                 graph: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        # state + voxel map, and point map + store
        self.lio = LioPipeline(cfg, device=self.device, graph=False)
        self.mesh = MeshPipeline(cfg, device=self.device, graph=False)
        self.captured = (CapturedJointStep(cfg, self.lio.ext, self.device)
                         if graph and self.device.type == "cuda" else None)
        self.frame_idx = 0
        self._cfg_hi = None
        if adaptive_mesh_budget > cfg.mesh.active_voxels_per_frame:
            self._cfg_hi = cfg.replace(mesh=dataclasses.replace(
                cfg.mesh, active_voxels_per_frame=adaptive_mesh_budget))
        self.adaptive_threshold = (adaptive_threshold or
                                   2 * cfg.mesh.active_voxels_per_frame)
        self._backlog_q = []  # drop_deferred of the last two frames (HostCopy)

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
        diag).  The pose stays on the device: read_pose copies it."""
        with trace.frame(self.frame_idx, self.device):
            cfg = self.cfg
            if self._cfg_hi is not None and len(self._backlog_q) >= 2 \
                    and self._backlog_q[0].value() > self.adaptive_threshold:
                cfg = self._cfg_hi
            world_scan, diag = _frame(self, bundle, cfg)
            if self._cfg_hi is not None:
                self._backlog_q = (self._backlog_q
                                   + [HostCopy(diag["drop_deferred"])])[-2:]
            self.frame_idx += 1
            self.lio.frame_idx = self.mesh.frame_idx = self.frame_idx
            self.lio.maybe_compact()
            self.mesh.maybe_compact(self.lio.state.pos)
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
