"""Data-parallel LIO over torch.distributed — port of immesh_tpu/dist/lio.py.

The scan's point dimension is split over the ranks of a process group (the
reference's OpenMP parallel-for over association, voxel_mapping.cpp:167,
turned into processes):

  * IMU propagation: replicated (identical tiny compute on every rank);
  * deskew + association + Jacobian rows: local to each rank's point shard;
  * ESIKF normal equations: lio/esikf.iterated_update with the 6×6/6
    information contributions summed over the ranks each iteration
    (dist/comm.psum — rank order, the same bits on every rank, so every
    rank takes the same convergence decision);
  * map growth: each rank aggregates its shard's voxel moments, the
    aggregate lists are all-gathered and merged again, so every replica
    applies the IDENTICAL insert and the replicas stay bit-identical.

State and the plane map are replicated: every rank holds its own copy and
updates it in place with the same deterministic ops on the same inputs.
The step mirrors `_dp_lio_body` as written, extrinsics included: the JAX
dp step does not apply LiDAR→IMU extrinsics (lio/pipeline.py does).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from immesh_tpu_torch.config import ImMeshConfig
from immesh_tpu_torch.core.geometry import lidar_point_cov_body
from immesh_tpu_torch.core.ops import compact_indices, segment_sum
from immesh_tpu_torch.core.state import EsikfState
from immesh_tpu_torch.dist import comm
from immesh_tpu_torch.frontend.types import ScanBundle
from immesh_tpu_torch.lio.association import associate
from immesh_tpu_torch.lio.downsample import voxel_downsample
from immesh_tpu_torch.lio.esikf import iterated_update
from immesh_tpu_torch.lio.pipeline import propagate_and_deskew
from immesh_tpu_torch.map.voxel_map import VoxelMap


def _dp_lio_body(state: EsikfState, vm: VoxelMap, bundle: ScanBundle,
                 cfg: ImMeshConfig, group, n_dev: int):
    """One frame on this rank's point shard (`bundle` point arrays are the
    LOCAL rows); `vm` is updated in place, identically on every rank."""
    lio_cfg, map_cfg = cfg.lio, cfg.voxel_map

    # 1. propagate — replicated
    state_prop, pts_end = propagate_and_deskew(state, bundle, bundle.pts,
                                               cfg.imu)

    # 2. per-shard downsample (shards own disjoint point subsets; cross-shard
    #    voxel duplicates just contribute a few extra residual rows)
    down_pts, down_mask = voxel_downsample(
        pts_end, bundle.mask, lio_cfg.downsample_voxel,
        lio_cfg.map_update_points // n_dev)
    pcov = lidar_point_cov_body(down_pts, map_cfg.dept_err, map_cfg.beam_err)

    # 3. iterated ESIKF with summed information reductions
    st, diag = iterated_update(
        state_prop,
        lambda s: associate(s, vm, down_pts, pcov, down_mask, map_cfg),
        lio_cfg, reduce=lambda sums: comm.psum(sums, group))

    # 4. replicated map growth from all-gathered per-shard aggregates
    pts_world_down = st.transform_points(down_pts)
    sigma2 = (pcov[:, 0, 0] + pcov[:, 1, 1] + pcov[:, 2, 2]) / 3.0
    max_vox = 4096 // n_dev
    lmask = down_mask
    for level in range(map_cfg.max_layers):
        if level > 0:
            lmask = vm.parent_mask(pts_world_down, lmask, level)
        uc, agg, ok = vm.scan_aggregates(
            pts_world_down, sigma2, lmask, level, max_vox)
        # gather every shard's aggregates → identical combined list everywhere
        uc_m, agg_m, ok_m = _merge_aggregates(
            comm.all_gather_cat(uc, group), comm.all_gather_cat(agg, group),
            comm.all_gather_cat(ok, group))
        vm.apply_aggregates(uc_m, agg_m, ok_m, level)

    world_scan = st.transform_points(pts_end)
    return st, vm, world_scan, diag


def _lexsort_rows(keys) -> torch.Tensor:
    """Stable lexicographic order of rows; keys[0] is the PRIMARY key (the
    reverse of jnp.lexsort's argument order)."""
    order = torch.arange(keys[0].shape[0], device=keys[0].device)
    for k in reversed(keys):
        order = order[torch.argsort(k[order], stable=True)]
    return order


def _merge_aggregates(uc: torch.Tensor, agg: torch.Tensor, ok: torch.Tensor):
    """Sum aggregate rows with identical voxel keys (cross-shard dedup).

    Keys are compared EXACTLY on all four int32 columns (one lexicographic
    sort, invalid rows last); the reference's equivalent is exact
    VOXEL_LOC key equality (voxel_loc.hpp:106-127).  Rows of one key are
    summed from zero in sorted (= rank, then row) order."""
    u = uc.shape[0]
    dev = uc.device
    order = _lexsort_rows([(~ok).to(torch.uint8), uc[:, 0], uc[:, 1],
                           uc[:, 2], uc[:, 3]])
    uc_s, agg_s, ok_s = uc[order], agg[order], ok[order]
    same = torch.all(uc_s[1:] == uc_s[:-1], dim=-1) & ok_s[1:] & ok_s[:-1]
    head = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), ~same])
    seg = torch.cumsum(head.to(torch.int32), 0) - 1
    agg_m = segment_sum(agg_s, seg, u)
    # representative row per segment = its first (head) row
    idx = compact_indices(head, u).clamp(max=u - 1).long()
    uc_m = uc_s[idx]
    ok_m = ok_s[idx] & (torch.arange(u, device=dev) < torch.sum(head))
    return uc_m, agg_m, ok_m


def make_dp_lio_step(cfg: ImMeshConfig,
                     group: Optional[dist.ProcessGroup] = None):
    """The multi-rank LIO step: returns (step, shard_bundle).

    `shard_bundle(b)` keeps this rank's rows [r·N/n, (r+1)·N/n) of the
    point arrays (the JAX P(axis) layout, so both see identical shards);
    IMU arrays and scan_duration stay whole.  `step(state, vm, local)`
    returns (state, vm, world_scan_local, diag); every rank must call it
    once per frame, and `vm` is updated in place."""
    rank, n = comm.rank_size(group)
    group = group if group is not None else dist.group.WORLD

    def shard_bundle(b: ScanBundle) -> ScanBundle:
        N = b.pts.shape[0]
        if N % n:
            raise ValueError(f"{N} scan rows do not split over {n} ranks")
        sl = slice(rank * N // n, (rank + 1) * N // n)
        return ScanBundle(
            pts=b.pts[sl], t_rel=b.t_rel[sl], mask=b.mask[sl],
            imu_stamps=b.imu_stamps, imu_acc=b.imu_acc, imu_gyr=b.imu_gyr,
            imu_mask=b.imu_mask, scan_duration=b.scan_duration)

    def step(state: EsikfState, vm: VoxelMap, local: ScanBundle):
        return _dp_lio_body(state, vm, local, cfg, group, n)

    return step, shard_bundle
