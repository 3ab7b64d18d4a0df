"""Fused odometry + meshing frame step.

Port of immesh_tpu/runtime/joint.py: lio_step then mesh_step on the same
frame, with both pipelines' occupancy-triggered compaction after it.  The
JAX reference donates the four persistent states (filter state, plane voxel
map, global point map, triangle store) into one jitted program; here the
map and store are updated in place and the small filter state is replaced.
"""

from __future__ import annotations

import dataclasses

from immesh_tpu_torch.config import ImMeshConfig
from immesh_tpu_torch.core.state import EsikfState
from immesh_tpu_torch.device import resolve_device
from immesh_tpu_torch.frontend.types import ScanBundle
from immesh_tpu_torch.lio.pipeline import LioPipeline, lio_step
from immesh_tpu_torch.map.voxel_map import VoxelMap
from immesh_tpu_torch.mesh.global_map import GlobalPointMap
from immesh_tpu_torch.mesh.pipeline import MeshPipeline, mesh_step
from immesh_tpu_torch.mesh.triangles import TriangleStore


def joint_step(state: EsikfState, vm: VoxelMap, gm: GlobalPointMap,
               store: TriangleStore, bundle: ScanBundle, cfg: ImMeshConfig,
               ext):
    """propagate → deskew → ESIKF → map grow → append → re-mesh: lio_step
    (`ext` its extrinsics), then _mesh_half.  Returns (state, vm, gm,
    store, world_scan, slots, smask, diag)."""
    state, vm, world_scan, diag = lio_step(state, vm, bundle, cfg, ext)
    return (state, vm) + _mesh_half(gm, store, world_scan, bundle, state,
                                    diag, cfg)


def _mesh_half(gm, store, world_scan, bundle, state, diag, cfg):
    """joint_step after the LIO step: (gm, store, world_scan, slots, smask,
    diag)."""
    gm, store, n_active, slots, smask, mdiag = mesh_step(
        gm, store, world_scan, bundle.mask, state.pos, cfg.mesh.mesh_chunk)
    diag = dict(diag, n_active_voxels=n_active, **mdiag)
    return gm, store, world_scan, slots, smask, diag


class JointPipeline:
    """Host wrapper for the fused step (bench, headless runs).

    adaptive_mesh_budget > cfg.mesh.active_voxels_per_frame enables the
    hi-budget variant: on frames where the re-mesh backlog of TWO frames
    before exceeded `adaptive_threshold` (default 2× the base budget),
    joint_step gets the config with the larger budget.  The reference polls
    the backlog two frames deep so its read never waits on an in-flight
    program; the port keeps the same two-deep queue (and reads it
    synchronously), so the hi/lo decision falls on the same frames in both.
    As in the reference, mesh_step sizes its work list from the point map's
    own config (gm.cfg), not from the config joint_step is given.

    A step is joint_step's composition: the LioPipeline's step without its
    compaction trigger (LioPipeline.advance: on a CUDA device its captured
    graph, which reads no mesh setting and so serves both budgets; eager
    with `graph=False` and on the CPU), then _mesh_half with the frame's
    config, eagerly."""

    def __init__(self, cfg: ImMeshConfig, adaptive_mesh_budget: int = 0,
                 adaptive_threshold: int = 0, device="cuda",
                 graph: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lio = LioPipeline(cfg, device=self.device,  # state + voxel map
                               graph=graph)
        self.mesh = MeshPipeline(cfg, device=self.device)  # point map + store
        self.frame_idx = 0
        self._cfg_hi = None
        if adaptive_mesh_budget > cfg.mesh.active_voxels_per_frame:
            self._cfg_hi = cfg.replace(mesh=dataclasses.replace(
                cfg.mesh, active_voxels_per_frame=adaptive_mesh_budget))
        self.adaptive_threshold = (adaptive_threshold or
                                   2 * cfg.mesh.active_voxels_per_frame)
        self._backlog_q = []  # drop_deferred of the last two frames

    def static_init(self, acc, gyr) -> None:
        """IMU static initialization of the filter (reference IMU_init)."""
        self.lio.static_init(acc, gyr)

    def prime_adaptive(self) -> None:
        """Force the next steps onto the hi-budget variant (benches call this
        during warm-up)."""
        if self._cfg_hi is not None:
            self._backlog_q = [1 << 30, 1 << 30]

    def step(self, bundle: ScanBundle):
        cfg = self.cfg
        if self._cfg_hi is not None and len(self._backlog_q) >= 2 \
                and int(self._backlog_q[0]) > self.adaptive_threshold:
            cfg = self._cfg_hi
        world_scan, diag = self.lio.advance(bundle)
        (self.mesh.gm, self.mesh.store, world_scan, slots, smask,
         diag) = _mesh_half(self.mesh.gm, self.mesh.store, world_scan,
                            bundle, self.lio.state, diag, cfg)
        if self._cfg_hi is not None:
            self._backlog_q = (self._backlog_q + [diag["drop_deferred"]])[-2:]
        self.mesh.last_active = (slots, smask)
        self.frame_idx += 1
        self.lio.frame_idx = self.mesh.frame_idx = self.frame_idx
        self.lio.maybe_compact()
        self.mesh.maybe_compact(self.lio.state.pos)
        return world_scan, diag

    @property
    def state(self):
        return self.lio.state

    @property
    def store(self):
        return self.mesh.store
