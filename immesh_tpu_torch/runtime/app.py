"""Joint odometry + meshing runtime — the system's `main()`.

Port of immesh_tpu/runtime/app.py: one host loop runs the LIO step and then
the mesh step on each frame (the reference's LIO thread, frame queue and
mesh thread pool, src/voxel_mapping.cpp:1660-2050 and
ImMesh_mesh_reconstruction.cpp:272-326, collapsed into one loop).  Kernels
on the card run asynchronously, so host prep of the next frame overlaps
them.

  * static IMU init, per-frame step with the IMU-gap filter reset,
    pose/trajectory logging (kitti_log);
  * the full deskewed world scan handed to meshing;
  * per-frame cost-time rows in the reference's log schema, written one
    frame late so no read of a device scalar waits on the running frame;
  * mesh export and whole-state checkpoints.

Not ported yet (each raises NotImplementedError, ROADMAP.md queue 1): the
live viewer and `reinforce` (render/, item 12) and window bundle adjustment
(`cfg.ba.enabled`, lio/window.py, item 11).
"""

from __future__ import annotations

import os
from collections import deque
from typing import Iterable, Optional

import numpy as np
import torch

from immesh_tpu_torch.config import ImMeshConfig
from immesh_tpu_torch.core import so3
from immesh_tpu_torch.device import resolve_device
from immesh_tpu_torch.frontend.types import ScanBundle
from immesh_tpu_torch.lio.pipeline import LioPipeline
from immesh_tpu_torch.mesh.pipeline import MeshPipeline
from immesh_tpu_torch.runtime.export import (
    save_checkpoint, save_ply, smooth_vertices)
from immesh_tpu_torch.utils.timers import (
    CostTimeLogger, Timer, TrajectoryLogger)


class ImMeshRuntime:
    """End-to-end LiDAR(-inertial) odometry + incremental meshing."""

    def __init__(self, cfg: ImMeshConfig, log_dir: Optional[str] = None,
                 mesh_enabled: bool = True, device="cuda"):
        if cfg.ba.enabled:
            raise NotImplementedError(
                "window bundle adjustment (cfg.ba.enabled) is not ported yet "
                "(ROADMAP.md queue 1 item 11, lio/window.py)")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.lio = LioPipeline(cfg, device=self.device)
        self.mesh = (MeshPipeline(cfg, device=self.device)
                     if mesh_enabled else None)
        self.timer = Timer()
        self.frame_idx = 0
        if log_dir:
            os.makedirs(log_dir, exist_ok=True)
            self.traj_log = TrajectoryLogger(
                os.path.join(log_dir, "kitti_log.txt"))
            self.cost_log = CostTimeLogger(
                os.path.join(log_dir, "mesh_cost_time.log"))
        else:
            self.traj_log = TrajectoryLogger(None)
            self.cost_log = CostTimeLogger(None)
        self._pending_cost = deque()

    def start_live_viewer(self, *args, **kwargs) -> str:
        raise NotImplementedError(
            "the live mesh viewer is not ported yet (ROADMAP.md queue 1 "
            "item 12, render/live.py)")

    def reinforce(self, cam=None):
        raise NotImplementedError(
            "point-cloud reinforcement is not ported yet (ROADMAP.md queue 1 "
            "item 12, render/raster.py)")

    # ------------------------------------------------------------------
    def static_init(self, acc: np.ndarray, gyr: np.ndarray) -> None:
        self.lio.static_init(acc, gyr)

    def process_frame(self, bundle: ScanBundle, t: float = 0.0,
                      imu_gap: bool = False) -> dict:
        """One LiDAR(-inertial) frame through odometry and meshing.

        `imu_gap` (a stream anomaly) re-initialises the filter before the
        step (reference m_flg_reset, src/voxel_mapping.cpp:1791-1797).  The
        active-voxel count is a device scalar; it reaches the cost log one
        frame late."""
        if imu_gap:
            self.lio.reset_filter(keep_pose=True)

        self.timer.tic("lio")
        world_scan, diag = self.lio.step(bundle)
        lio_ms = self.timer.toc("lio")

        n_active_dev = None
        mesh_ms = 0.0
        if self.mesh is not None:
            self.timer.tic("mesh")
            n_active_dev = self.mesh.step(
                world_scan, bundle.mask, self.lio.state.pos)
            mesh_ms = self.timer.toc("mesh")

        pos = self.lio.state.pos.cpu().numpy()
        quat = so3.rot_to_quat(self.lio.state.rot).cpu().numpy()  # wxyz
        self.traj_log.record(t, pos, (*quat[1:4], quat[0]))
        self._pending_cost.append(
            (self.frame_idx, mesh_ms, n_active_dev, lio_ms))
        # flush rows at least one frame old: their work has retired
        while len(self._pending_cost) > 1:
            self._flush_cost()
        self.frame_idx += 1
        return {
            "pos": pos, "lio_ms": lio_ms, "mesh_ms": mesh_ms,
            # device scalars — callers that want numbers int() them
            "n_active_voxels": n_active_dev,
            "n_effective": diag["n_effective"],
            "ba_cost": None,
        }

    def _flush_cost(self) -> None:
        fi, mms, nact, lms = self._pending_cost.popleft()
        self.cost_log.record(fi, mms, 0 if nact is None else int(nact), lms)

    def run(self, bundles: Iterable[ScanBundle]) -> list:
        return [self.process_frame(b, t=k * 0.1)
                for k, b in enumerate(bundles)]

    # ------------------------------------------------------------------
    def save_mesh(self, path: str, smooth_iters: int = 0) -> tuple:
        """Export the current mesh to PLY (reference Save-Mesh button,
        ImMesh_node.cpp:395-402 → save_to_ply_file)."""
        assert self.mesh is not None
        verts, faces = self.mesh.extract()
        if smooth_iters:
            verts = smooth_vertices(verts, faces, smooth_iters)
        save_ply(path, verts, faces)
        return verts, faces

    def save_state(self, path_prefix: str) -> None:
        """Checkpoint filter + maps in the reference's layout
        (interop.load_reference_checkpoint reads them back)."""
        save_checkpoint(path_prefix + ".lio.npz", self.lio.state)
        save_checkpoint(path_prefix + ".vmap.npz", self.lio.vm)
        if self.mesh is not None:
            save_checkpoint(path_prefix + ".gmap.npz", self.mesh.gm)
            save_checkpoint(path_prefix + ".tris.npz", self.mesh.store)

    def close(self) -> None:
        while self._pending_cost:
            self._flush_cost()
        self.traj_log.close()
        self.cost_log.close()


def run_offline_pointcloud(pts: np.ndarray, cfg: ImMeshConfig,
                           frame_size: int = 100_000,
                           device="cuda") -> MeshPipeline:
    """Offline meshing of a raw point cloud, no odometry (reference
    `reconstruct_mesh_from_pointcloud`, ImMesh_mesh_reconstruction.cpp:
    328-345): identity pose, the cloud chunked into frames."""
    mesh = MeshPipeline(cfg, device=device)
    sensor = pts.mean(axis=0).astype(np.float32) + np.array(
        [0, 0, 100.0], np.float32)
    sensor = torch.from_numpy(sensor).to(mesh.device)
    for k in range(0, len(pts), frame_size):
        chunk = torch.from_numpy(
            np.ascontiguousarray(pts[k:k + frame_size], np.float32))
        mesh.step(chunk.to(mesh.device),
                  torch.ones(len(chunk), dtype=torch.bool, device=mesh.device),
                  sensor)
    return mesh
