"""Joint odometry + meshing runtime — the system's `main()`.

Port of immesh_tpu/runtime/app.py: one host loop runs the LIO step and then
the mesh step on each frame (the reference's LIO thread, frame queue and
mesh thread pool, src/voxel_mapping.cpp:1660-2050 and
ImMesh_mesh_reconstruction.cpp:272-326, collapsed into one loop).  Kernels
on the card run asynchronously, so host prep of the next frame overlaps
them, and the mesh step runs on a stream of its own, as the reference's
mesh threads run beside its odometry: the pose is read once the LIO step
is done.

  * static IMU init, per-frame step with the IMU-gap filter reset,
    pose/trajectory logging (kitti_log);
  * the full deskewed world scan handed to meshing;
  * per-frame cost-time rows in the reference's log schema, the frame
    trace's `mesh` and `lio` device spans of the frame, written one frame
    late so no read of a device scalar waits on the running frame;
  * sliding-window plane BA (`cfg.ba.enabled`): each frame's posterior
    pose and world scan go to `WindowBA.observe`, and a refined window's
    correction is left-applied to the live filter;
  * the live viewer (`start_live_viewer`): the dirty mesh regions and the
    plane-map overlay are synced to the host every `sync_every` frames, and
    its pause control holds `run`;
  * point-cloud reinforcement (`reinforce`) at the viewer's settings;
  * mesh export and whole-state checkpoints.
"""

from __future__ import annotations

import math
import os
import time
from collections import deque
from typing import Iterable, Optional

import numpy as np
import torch

from immesh_tpu_torch.config import ImMeshConfig
from immesh_tpu_torch.core import so3
from immesh_tpu_torch.device import resolve_device
from immesh_tpu_torch.frontend.types import ScanBundle
from immesh_tpu_torch.lio.pipeline import LioPipeline
from immesh_tpu_torch.lio.window import WindowBA
from immesh_tpu_torch.mesh.pipeline import MeshPipeline
from immesh_tpu_torch.render.live import (
    LiveMeshServer, RegionCache, extract_planes)
from immesh_tpu_torch.render.raster import PinholeCam, reinforce_scan
from immesh_tpu_torch.runtime.export import (
    save_checkpoint, save_ply, smooth_vertices)
from immesh_tpu_torch.utils.timers import (
    CostTimeLogger, TrajectoryLogger, trace)


class ImMeshRuntime:
    """End-to-end LiDAR(-inertial) odometry + incremental meshing.

    A `log_dir` turns the frame trace on (utils/timers.py::trace) until
    close(), where the runtime turned it on: the cost log's mesh and LIO
    columns are its device spans."""

    def __init__(self, cfg: ImMeshConfig, log_dir: Optional[str] = None,
                 mesh_enabled: bool = True, device="cuda", graph: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._traced = bool(log_dir) and not trace.on
        if self._traced:  # before the graphs are captured
            trace.enable()
        # graph: the LIO step and the mesh step each as one captured CUDA
        # graph on the card
        self.lio = LioPipeline(cfg, device=self.device, graph=graph)
        self.mesh = (MeshPipeline(cfg, device=self.device, graph=graph)
                     if mesh_enabled else None)
        self.ba = WindowBA(cfg) if cfg.ba.enabled else None
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
        self._live = None
        self._live_cache = None
        self._live_sync_every = 5

    # ------------------------------------------------------------------
    def start_live_viewer(self, host: str = "127.0.0.1", port: int = 0,
                          sync_every: int = 5) -> str:
        """Serve the live WebGL mesh viewer (reference GUI window analogue,
        ImMesh_node.cpp:298-525); returns its URL.  Dirty regions are synced
        to the host cache every `sync_every` frames (the reference uses a
        100 ms sync thread, mesh_rec_display.cpp:262-271)."""
        if self.mesh is None:
            raise RuntimeError("the live viewer needs meshing enabled")
        self._live_cache = RegionCache(self.cfg.mesh.region_size,
                                       self.cfg.mesh.voxel_resolution,
                                       self.cfg.mesh.display_smooth_lam)
        self._live = LiveMeshServer(self._live_cache, host, port).start()
        self._live_sync_every = max(1, sync_every)
        return self._live.url

    def stop_live_viewer(self) -> None:
        if self._live is not None:
            self._live.stop()
            self._live = None

    # ------------------------------------------------------------------
    def static_init(self, acc: np.ndarray, gyr: np.ndarray) -> None:
        self.lio.static_init(acc, gyr)

    def process_frame(self, bundle: ScanBundle, t: float = 0.0,
                      imu_gap: bool = False) -> dict:
        """One LiDAR(-inertial) frame through odometry and meshing.

        `imu_gap` (a stream anomaly) re-initialises the filter before the
        step (reference m_flg_reset, src/voxel_mapping.cpp:1791-1797).  The
        LIO step is launched, then the mesh half (on the MeshPipeline's
        own stream on the card, mesh/pipeline.py::MeshPipeline.step), then
        the pose is read, which waits for the LIO step alone.  The
        active-voxel count is a device scalar; it reaches the cost log one
        frame late, after a join of its own frame's mesh half.  The frame
        is the frame trace's `frame` span, and its pose reads (`pos`, and
        the quaternion) its `pose_read` spans."""
        with trace.frame(self.frame_idx, self.device):
            if imu_gap:
                self.lio.reset_filter(keep_pose=True)

            mesh = self.mesh
            if mesh is not None:
                mesh.count_pending("lio_over_mesh")
            world_scan, diag = self.lio.step(bundle)
            n_active_dev = done = None
            if mesh is not None:
                # on the mesh's own stream where it is a captured graph:
                # the pose below waits for the LIO step alone
                n_active_dev, _ = mesh.step(world_scan, bundle.mask,
                                            self.lio.state.pos)
                done = mesh.done
                mesh.count_pending("pose_before_mesh")

            with trace.pose_read():
                pos = self.lio.state.pos.cpu().numpy()
            ba_cost = None
            if self.ba is not None:
                corr = self.ba.observe(self.lio.state.rot, pos, world_scan,
                                       bundle.mask, self.lio.vm)
                if corr is not None:
                    ba_cost = corr["cost"]
                    if self.cfg.ba.apply_correction:
                        # left-apply the window's world-frame correction to
                        # the live filter (velocity rotates with the frame;
                        # gravity and biases are frame-invariant here)
                        st = self.lio.state
                        dR, dp = (torch.from_numpy(np.asarray(
                            corr[key], np.float32)).to(self.device)
                            for key in ("d_rot", "d_pos"))
                        self.lio.state = st.replace(
                            rot=dR @ st.rot, pos=dR @ st.pos + dp,
                            vel=dR @ st.vel)
                        with trace.pose_read():
                            pos = self.lio.state.pos.cpu().numpy()
            with trace.pose_read():  # the quaternion wxyz
                quat = so3.rot_to_quat(self.lio.state.rot).cpu().numpy()
            self.traj_log.record(t, pos, (*quat[1:4], quat[0]))
            if self._live is not None:
                self._live.record_pose(t, pos, (*quat[1:4], quat[0]))
                if self.frame_idx % self._live_sync_every == 0:
                    self.mesh.store = self._live_cache.sync(
                        self.mesh.gm, self.mesh.store)
                    # plane-map overlay (reference pubPlaneMap,
                    # voxel_mapping.cpp:947-1159): the LIO map's fitted
                    # planes beside the mesh regions
                    self._live.record_planes(extract_planes(self.lio.vm))
            self._pending_cost.append((self.frame_idx, n_active_dev, done))
            # flush rows at least one frame old: their work has retired
            while len(self._pending_cost) > 1:
                self._flush_cost()
            self.frame_idx += 1
        return {
            "pos": pos,
            # device scalars — callers that want numbers int() them; the
            # mesh half writes this one: int() it after self.mesh.join()
            "n_active_voxels": n_active_dev,
            "n_effective": diag["n_effective"],
            "iterations": diag["iterations"], "levels": diag["levels"],
            "ba_cost": ba_cost,
        }

    def _flush_cost(self) -> None:
        fi, nact, done = self._pending_cost.popleft()
        if done is not None:  # the count's own mesh half, not a later one
            self.mesh.join(done)
        # the trace's spans of frame fi; none while it is off (its ring may
        # hold another run's frames)
        mesh_ms, lio_ms = (trace.span_ms(fi, name) if trace.on else None
                           for name in ("mesh", "lio"))
        self.cost_log.record(
            fi, math.nan if mesh_ms is None else mesh_ms,
            0 if nact is None else int(nact),
            math.nan if lio_ms is None else lio_ms)

    def reinforce(self, cam=None):
        """LiDAR point-cloud reinforcement at the viewer's runtime-mutable
        density/depth settings (the reference exposes these live in its GUI,
        ImMesh_node.cpp:305-329): rasterize the current mesh from `cam` (or
        a forward-looking camera at the current sensor pose) and synthesize
        densified points from the depth buffer.  Returns (points (N, 3),
        depth image) as numpy arrays."""
        step, max_depth = 2, 80.0
        if self._live is not None:
            c = self._live.controls
            step = max(1, int(c.get("reinf_step", step)))
            max_depth = float(c.get("reinf_max_depth", max_depth))
        if cam is None:
            pos = self.lio.state.pos.cpu().numpy()
            fwd = self.lio.state.rot[:, 0].cpu().numpy()  # body +x in world
            cam = PinholeCam.looking(pos, pos + fwd, device=self.device)
        return reinforce_scan(self.mesh.store, self.mesh.gm, cam,
                              stride=step, max_depth=max_depth)

    @property
    def paused(self) -> bool:
        """Runtime-mutable pause from the live viewer (the reference's GUI
        pause flag halts `service_LiDAR_update`, ImMesh_node.cpp:360-432)."""
        return self._live is not None and self._live.paused

    def run(self, bundles: Iterable[ScanBundle]) -> list:
        out = []
        for k, b in enumerate(bundles):
            while self.paused:
                time.sleep(0.05)
            out.append(self.process_frame(b, t=k * 0.1))
        return out

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
        if self._traced:
            trace.disable()
            self._traced = False


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
