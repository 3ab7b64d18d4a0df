"""Per-frame LIO step: propagate → deskew → downsample → update → grow map.

Port of immesh_tpu/lio/pipeline.py (reference service_LiDAR_update,
src/voxel_mapping.cpp:1660-2050): the IMU branch (imu_propagate + deskew)
and the IMU-less constant-twist branch, with LiDAR→IMU extrinsics.

The full deskewed world-frame scan is returned for the meshing stage.

The reference's step is one jitted program with no host round-trips
(immesh_tpu/lio/pipeline.py:32).  On the card `LioPipeline` runs
`lio_step` as one captured CUDA graph, replayed every frame, which reads
nothing on the host and skips the ESIKF bodies after convergence and the
empty refinement levels on the device (lio/captured.py); `graph=False`
keeps the eager step, which reads those two tests on the host.
"""

from __future__ import annotations

import torch

from immesh_tpu_torch.config import ImMeshConfig
from immesh_tpu_torch.core.geometry import lidar_point_cov_body
from immesh_tpu_torch.core.state import EsikfState
from immesh_tpu_torch.device import HostCopy, resolve_device
from immesh_tpu_torch.frontend.types import ScanBundle
from immesh_tpu_torch.lio import imu as imu_mod
from immesh_tpu_torch.lio.captured import CapturedLioStep
from immesh_tpu_torch.lio.downsample import voxel_downsample
from immesh_tpu_torch.lio.esikf import lio_update
from immesh_tpu_torch.map.hash import EMPTY
from immesh_tpu_torch.map.voxel_map import VoxelMap, _key_centers
from immesh_tpu_torch.utils.timers import trace

_IDENTITY_R = (1.0, 0.0, 0.0, 0.0, 1.0, 0.0, 0.0, 0.0, 1.0)


def propagate_and_deskew(state: EsikfState, bundle: ScanBundle,
                         pts_body: torch.Tensor, imu_cfg):
    """(propagated state, scan points at scan end): IMU propagation and
    deskew, or without an IMU the constant-twist model, whose filter bg
    slot carries the body angular rate, so the deskew twist is {ω̂·T, v·T}."""
    if imu_cfg.imu_en:
        state_prop, seg = imu_mod.imu_propagate(state, bundle, imu_cfg)
        return state_prop, imu_mod.deskew(seg, state_prop, pts_body,
                                          bundle.t_rel)
    state_prop = imu_mod.const_velocity_propagate(
        state, bundle.scan_duration, imu_cfg)
    return state_prop, imu_mod.deskew_const_twist(
        pts_body, bundle.t_rel, bundle.scan_duration,
        state.bg * bundle.scan_duration, state.vel * bundle.scan_duration)


def extrinsics(imu_cfg, like: torch.Tensor):
    """The LiDAR→IMU extrinsics (r_ext (3, 3), t_ext (3,)) in `like`'s dtype
    and device, or None where they are the identity and points arrive in
    the body frame.  A copy from the host: LioPipeline makes them once."""
    if (tuple(imu_cfg.extrinsic_t) == (0.0, 0.0, 0.0)
            and tuple(imu_cfg.extrinsic_r) == _IDENTITY_R):
        return None
    r_ext = torch.tensor(imu_cfg.extrinsic_r, dtype=like.dtype,
                         device=like.device).reshape(3, 3)
    t_ext = torch.tensor(imu_cfg.extrinsic_t, dtype=like.dtype,
                         device=like.device)
    return r_ext, t_ext


def point_cov(down_pts: torch.Tensor, ext, map_cfg) -> torch.Tensor:
    """Body-frame covariance (N, 3, 3) of each downsampled point.  The beam
    noise is defined by the LiDAR-frame geometry, so with extrinsics it is
    computed on the LiDAR-frame point and rotated by r_ext
    (voxel_mapping.cpp:1305-1311)."""
    if ext is None:
        return lidar_point_cov_body(down_pts, map_cfg.dept_err,
                                    map_cfg.beam_err)
    r_ext, t_ext = ext
    pcov_l = lidar_point_cov_body(
        (down_pts - t_ext) @ r_ext, map_cfg.dept_err, map_cfg.beam_err)
    return torch.einsum("ij,njk,lk->nil", r_ext, pcov_l, r_ext)


def grow_map(vm: VoxelMap, state: EsikfState, down_pts: torch.Tensor,
             pcov: torch.Tensor, down_mask: torch.Tensor) -> torch.Tensor:
    """Insert the downsampled scan at `state`'s pose into the plane map, in
    place (reference map_incremental_grow).  Returns the number of
    refinement levels that had points (VoxelMap.update_levels)."""
    sigma2 = (pcov[:, 0, 0] + pcov[:, 1, 1] + pcov[:, 2, 2]) / 3.0
    return vm.update_levels(state.transform_points(down_pts), sigma2,
                            down_mask)


def lio_step(state: EsikfState, vm: VoxelMap, bundle: ScanBundle,
             cfg: ImMeshConfig, ext):
    """One LiDAR frame. Returns (state, vm, world_scan, diag); `vm` is
    updated in place.  world_scan is the full deskewed scan in world frame,
    shaped like bundle.pts with bundle.mask validity.  `ext` is
    extrinsics(cfg.imu, ...), made once by the caller (a copy from the
    host).  diag: "converged", "n_effective", "iterations" (live ESIKF
    bodies) and "levels" (refinement levels with points), device
    scalars."""
    lio_cfg, map_cfg, imu_cfg = cfg.lio, cfg.voxel_map, cfg.imu

    # the frame trace's `lio` span: the step up to the map's growth
    with trace.device_span("lio", bundle.pts.device):
        # 0. LiDAR→IMU extrinsics: points arrive in the LiDAR frame;
        # express them once in the IMU/body frame the filter state lives in
        pts_body = (bundle.pts if ext is None
                    else bundle.pts @ ext[0].T + ext[1])

        # 1. propagate + deskew (reference Process2 → Forward/UndistortPcl)
        state_prop, pts_end = propagate_and_deskew(state, bundle, pts_body,
                                                   imu_cfg)

        # 2. scan downsample for registration/map (reference
        # downSizeFilterSurf)
        down_pts, down_mask = voxel_downsample(
            pts_end, bundle.mask, lio_cfg.downsample_voxel,
            lio_cfg.map_update_points)

        # 3. iterated ESIKF update (reference lio_state_estimation)
        pcov = point_cov(down_pts, ext, map_cfg)
        state_new, diag = lio_update(
            state_prop, vm, down_pts, pcov, down_mask, lio_cfg, map_cfg)

        # 4. map growth with the posterior pose
        if lio_cfg.update_map:
            with trace.device_span("lio.map_update", down_pts.device):
                levels = grow_map(vm, state_new, down_pts, pcov, down_mask)
        else:
            levels = torch.zeros((), dtype=torch.int32,
                                 device=down_pts.device)

    world_scan = state_new.transform_points(pts_end)
    return state_new, vm, world_scan, dict(diag, levels=levels)


class LioPipeline:
    """Host-side wrapper holding filter + map state across frames.

    On a CUDA device the step runs as one captured CUDA graph
    (lio/captured.py: the first frame eager, the second captured, every
    frame after it replayed); `graph=False` runs it eagerly, as every CPU
    device does."""

    def __init__(self, cfg: ImMeshConfig, device="cuda", graph: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.state = EsikfState.identity(
            gravity=cfg.imu.gravity,
            init_rot_cov=cfg.lio.init_rot_cov, init_pos_cov=cfg.lio.init_pos_cov,
            init_vel_cov=cfg.lio.init_vel_cov,
            init_bias_cov=cfg.lio.init_bias_cov,
            init_grav_cov=cfg.lio.init_grav_cov, device=self.device,
        )
        self.vm = VoxelMap.create(cfg.voxel_map, device=self.device)
        self.ext = extrinsics(cfg.imu, self.state.pos)  # made once
        self.captured = (CapturedLioStep(cfg, self.ext, self.device)
                         if graph and self.device.type == "cuda" else None)
        self.frame_idx = 0
        self.n_compactions = 0
        self._occ_pending = None  # previous frame's occupancy (HostCopy)

    def static_init(self, acc, gyr) -> None:
        """IMU static initialization (reference IMU_init)."""
        self.state = imu_mod.static_init(
            torch.as_tensor(acc, dtype=torch.float32, device=self.device),
            torch.as_tensor(gyr, dtype=torch.float32, device=self.device),
            self.cfg.imu, self.state)

    def reset_filter(self, keep_pose: bool = True) -> None:
        """Re-initialize the filter after a stream anomaly (IMU gap, bag
        restart) — the reference's m_flg_reset → ImuProcess::Reset path
        (src/voxel_mapping.cpp:1791-1797).  Pose mean and gravity survive;
        velocity and biases are zeroed and the covariance re-inflated, with
        extra velocity uncertainty, so the next updates re-converge."""
        lio = self.cfg.lio
        fresh = EsikfState.identity(
            gravity=self.cfg.imu.gravity,
            init_rot_cov=max(lio.init_rot_cov, 1e-3),
            init_pos_cov=max(lio.init_pos_cov, 1e-2),
            init_vel_cov=max(lio.init_vel_cov, 1.0),
            init_bias_cov=lio.init_bias_cov,
            init_grav_cov=lio.init_grav_cov, device=self.device,
        )
        if keep_pose:
            fresh = fresh.replace(rot=self.state.rot, pos=self.state.pos,
                                  grav=self.state.grav)
        self.state = fresh

    def step(self, bundle: ScanBundle):
        world_scan, diag = self.advance(bundle)
        self.maybe_compact()
        return world_scan, diag

    def advance(self, bundle: ScanBundle):
        """The LIO step on this pipeline's state and map, without the
        compaction trigger: the captured graph, or lio_step eagerly.
        Returns (world_scan, diag)."""
        if self.captured is None:
            self.state, self.vm, world_scan, diag = lio_step(
                self.state, self.vm, bundle, self.cfg, self.ext)
        else:
            self.state, world_scan, diag = self.captured(self.state, self.vm,
                                                         bundle)
        self.frame_idx += 1
        return world_scan, diag

    def maybe_compact(self) -> bool:
        """Occupancy-triggered map lifetime management (reference
        laser_map_fov_segment, voxel_mapping_common.cpp:214-288).

        The decision reads the PREVIOUS frame's occupancy, as the reference's
        one-frame-delayed async poll does: copied to the host asynchronously
        after each frame and read on the next (device.HostCopy), so no frame
        waits on its own work and compactions fall on the same frames in
        both."""
        mc = self.cfg.voxel_map
        if mc.compact_check_every <= 0:
            return False
        high = mc.compact_high_water * mc.capacity
        pending = self._occ_pending
        self._occ_pending = HostCopy(self.vm.n_voxels())
        if pending is None or pending.value() <= high:
            return False
        self._occ_pending = None
        self.n_compactions += 1
        with trace.span("compact"):
            # hysteresis: compact down to the LOW water mark, radius solved
            # in one pass as a distance quantile
            low = int(mc.compact_low_water * mc.capacity)
            radius = _keep_radius_vm(self.vm, self.state.pos, low,
                                     mc.local_map_radius)
            self.vm.compact(self.state.pos, radius)
            r = float(radius) * 0.7
            for _ in range(2):  # quantile-granularity guard, rarely taken
                if int(self.vm.n_voxels()) <= high:
                    break
                self.vm.compact(self.state.pos, torch.tensor(
                    r, dtype=torch.float32, device=self.device))
                r *= 0.7
        return True

    def pending_occupancy(self):
        """The plane map's live voxels after the last frame, as the pending
        compaction poll holds them (the host copy maybe_compact reads on
        the next frame), or None where no poll is pending."""
        pending = self._occ_pending
        return None if pending is None else pending.value()


def _keep_radius_vm(vm: VoxelMap, center: torch.Tensor, low: int,
                    r_max: float) -> torch.Tensor:
    """Largest keep radius whose Chebyshev cube holds ≤ `low` live voxels
    (per-level centers, the rule VoxelMap.compact evicts by)."""
    keys = vm.table.keys
    live = keys[:, 0] != EMPTY
    vcen = _key_centers(keys, vm.cfg.voxel_size, torch.float32)
    d = torch.amax(torch.abs(vcen - center[None, :]), dim=-1)
    d = torch.sort(torch.where(live, d, torch.full_like(d, float("inf"))))[0]
    r = torch.clamp(d[min(low, d.shape[0]) - 1], max=r_max)
    return torch.where(torch.isfinite(r), r * (1.0 - 1e-6),
                       torch.full_like(r, r_max))
