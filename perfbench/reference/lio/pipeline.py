"""Per-frame LIO step: propagate → deskew → downsample → update → grow map.

Port of immesh_tpu/lio/pipeline.py (reference service_LiDAR_update,
src/voxel_mapping.cpp:1660-2050): the IMU branch (imu_propagate + deskew)
and the IMU-less constant-twist branch, with LiDAR→IMU extrinsics.

The full deskewed world-frame scan is returned for the meshing stage.
"""

from __future__ import annotations

import torch

from perfbench.reference.config import ImMeshConfig
from perfbench.reference.core.geometry import lidar_point_cov_body
from perfbench.reference.core.state import EsikfState
from perfbench.reference.frontend.types import ScanBundle
from perfbench.reference.lio import imu as imu_mod
from perfbench.reference.lio.downsample import voxel_downsample
from perfbench.reference.lio.esikf import lio_update
from perfbench.reference.map.hash import EMPTY
from perfbench.reference.map.voxel_map import VoxelMap, _key_centers

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

    # 0. LiDAR→IMU extrinsics: points arrive in the LiDAR frame; express them
    # once in the IMU/body frame the filter state lives in
    pts_body = bundle.pts if ext is None else bundle.pts @ ext[0].T + ext[1]

    # 1. propagate + deskew (reference Process2 → Forward/UndistortPcl)
    state_prop, pts_end = propagate_and_deskew(state, bundle, pts_body,
                                               imu_cfg)

    # 2. scan downsample for registration/map (reference downSizeFilterSurf)
    down_pts, down_mask = voxel_downsample(
        pts_end, bundle.mask, lio_cfg.downsample_voxel,
        lio_cfg.map_update_points)

    # 3. iterated ESIKF update (reference lio_state_estimation)
    pcov = point_cov(down_pts, ext, map_cfg)
    state_new, diag = lio_update(
        state_prop, vm, down_pts, pcov, down_mask, lio_cfg, map_cfg)

    # 4. map growth with the posterior pose
    if lio_cfg.update_map:
        levels = grow_map(vm, state_new, down_pts, pcov, down_mask)
    else:
        levels = torch.zeros((), dtype=torch.int32, device=down_pts.device)

    world_scan = state_new.transform_points(pts_end)
    return state_new, vm, world_scan, dict(diag, levels=levels)


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
