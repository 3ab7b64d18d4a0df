"""Spatially sharded voxel map over torch.distributed — port of
immesh_tpu/dist/sharded_map.py.

dist/lio.py replicates the plane map on every rank; this module shards it:
world space is striped into x-slabs of `slab_voxels` coarse voxels, slab s
OWNED by rank s mod n, so each rank stores ~1/n of the voxels (the
reference's spatial mutex sharding, SURVEY.md P6, triangle.cpp:35-53, with
ownership in place of locking).  The only cross-rank coupling — a point
whose face-neighbor probe (lio/association.py `_lookup_with_neighbors`)
crosses a slab edge — is served by a HALO: each frame every rank sends the
plane records of its boundary voxel columns to its two ring neighbours,
which insert them flagged `is_halo`.  Mod-striping makes slab adjacency
ring adjacency, so the halo is two point-to-point exchanges (right, then
left, dist/comm.ppermute), never a gather of the map.

Per frame:
  1. association runs on the full (replicated) scan, but each rank keeps
     only the residual rows of points whose voxel it owns at the current
     iterate (one owner per point, so the summed normal equations count
     each point once);
  2. every rank grows its map from the scan's aggregates masked to OWNED
     voxels (owner-computes: no conflicts, no replication);
  3. boundary planes are exchanged and written in as refreshed halo entries.

The filter state stays replicated (18 numbers); the MAP is what scales.
Each rank holds only its own shard (JAX's stacked shards are per-rank
state here).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch
import torch.distributed as dist

from immesh_tpu_torch.config import ImMeshConfig, VoxelMapConfig
from immesh_tpu_torch.core.geometry import lidar_point_cov_body
from immesh_tpu_torch.core.ops import compact_indices, set_drop
from immesh_tpu_torch.core.state import EsikfState
from immesh_tpu_torch.dist import comm
from immesh_tpu_torch.frontend.types import ScanBundle
from immesh_tpu_torch.lio.association import associate
from immesh_tpu_torch.lio.downsample import voxel_downsample
from immesh_tpu_torch.lio.esikf import iterated_update
from immesh_tpu_torch.lio.pipeline import propagate_and_deskew
from immesh_tpu_torch.map.hash import EMPTY, voxel_coords
from immesh_tpu_torch.map.voxel_map import VoxelMap

# the plane fields a halo record carries: floats, then flags
_REC_FLOAT = ("normal", "d", "center", "cov_nn", "var_c", "lam")
_REC_FLAG = ("plane_valid", "subdivided")


def owner_of_coords(coords: torch.Tensor, slab_voxels: int, n_shards: int
                    ) -> torch.Tensor:
    """(…, 4) int32 voxel keys → owning shard id in [0, n_shards).

    Ownership is defined on the LEVEL-0 (coarse) x column so a voxel and
    its octant children always share an owner: parent_x = key_x >> level
    (arithmetic shift == floor division, valid for negatives)."""
    px = torch.bitwise_right_shift(coords[..., 0], coords[..., 3])
    return torch.remainder(torch.div(px, slab_voxels, rounding_mode="floor"),
                           n_shards)


@dataclass
class ShardedVoxelMap:
    """One rank's shard: a plain VoxelMap whose entries are either OWNED
    (inserted/refit locally) or HALO (read-only copies of the neighbours'
    boundary planes, refreshed every frame).  Halo entries live in the same
    table and arrays, so `lio/association.associate` works on it unchanged.
    Updated in place."""

    vm: VoxelMap
    is_halo: torch.Tensor         # (capacity,) bool
    shard_id: int
    n_shards: int
    slab_voxels: int
    halo_capacity: int

    @classmethod
    def create(cls, cfg: VoxelMapConfig, shard_id: int, n_shards: int,
               slab_voxels: int = 32, halo_capacity: int = 1024,
               device="cuda") -> "ShardedVoxelMap":
        vm = VoxelMap.create(cfg, device=device)
        return cls(vm=vm, is_halo=torch.zeros(cfg.capacity, dtype=torch.bool,
                                              device=vm.count.device),
                   shard_id=shard_id, n_shards=n_shards,
                   slab_voxels=slab_voxels, halo_capacity=halo_capacity)

    # ------------------------------------------------------------------
    def owns(self, coords: torch.Tensor) -> torch.Tensor:
        return owner_of_coords(
            coords, self.slab_voxels, self.n_shards) == self.shard_id

    def update_owned(self, pts_world, point_sigma2, mask,
                     max_voxels: int = 4096) -> "ShardedVoxelMap":
        """Owner-computes map growth: VoxelMap.update with each level's
        aggregate mask restricted to voxels this shard owns."""
        vm = self.vm
        cfg = vm.cfg
        m = mask & self.owns(voxel_coords(pts_world, cfg.voxel_size, 0))
        for lvl in range(cfg.max_layers):
            if lvl > 0:
                m = vm.parent_mask(pts_world, m, lvl)
            uc, agg, ok = vm.scan_aggregates(
                pts_world, point_sigma2, m, lvl, max_voxels)
            vm.apply_aggregates(uc, agg, ok, lvl)
        return self

    # ------------------------------------------------------------------
    def _extract_boundary(self, side: int):
        """(int32 (H, 7) [key | valid | plane_valid | subdivided], f32
        (H, 17) [normal | d | center | cov_nn | var_c | lam]): the plane
        records of owned occupied voxels in the boundary column toward
        `side` (+1: rightmost column of each owned slab, −1: leftmost),
        compacted to halo_capacity rows."""
        vm = self.vm
        keys = vm.table.keys                                   # (cap, 4)
        occupied = keys[:, 0] != EMPTY
        px = torch.bitwise_right_shift(keys[:, 0], keys[:, 3])
        col = torch.remainder(px, self.slab_voxels)
        at_edge = col == (self.slab_voxels - 1 if side > 0 else 0)
        pred = occupied & ~self.is_halo & at_edge & (
            vm.plane_valid | vm.subdivided)
        cap = keys.shape[0]
        idx = compact_indices(pred, self.halo_capacity).clamp(
            max=cap - 1).long()
        valid = pred[idx]
        coords = torch.where(valid[:, None], keys[idx],
                             torch.full_like(keys[idx], EMPTY))
        ints = torch.cat(
            [coords, valid[:, None].to(torch.int32)]
            + [(getattr(vm, f)[idx] & valid)[:, None].to(torch.int32)
               for f in _REC_FLAG], dim=1)
        floats = torch.cat([getattr(vm, f)[idx].reshape(idx.shape[0], -1)
                            for f in _REC_FLOAT], dim=1)
        return ints, floats

    def _insert_halo(self, ints: torch.Tensor, floats: torch.Tensor
                     ) -> "ShardedVoxelMap":
        """Insert/refresh received boundary records as halo entries."""
        vm = self.vm
        valid = ints[:, 4] != 0
        slots, _ = vm.table.insert(ints[:, :4].contiguous(), valid)
        ok = valid & (slots >= 0)
        off = 0
        for f in _REC_FLOAT:
            dst = getattr(vm, f)
            w = dst[0].numel()
            set_drop(dst, slots, floats[:, off:off + w].reshape(
                (-1,) + dst.shape[1:]), ok)
            off += w
        for j, f in enumerate(_REC_FLAG):
            set_drop(getattr(vm, f), slots, ints[:, 5 + j] != 0, ok)
        set_drop(self.is_halo, slots, True, ok)
        return self

    def halo_exchange(self, group: Optional[dist.ProcessGroup] = None
                      ) -> "ShardedVoxelMap":
        """Refresh halos: my right boundary → right neighbour, then my left
        → left neighbour (the JAX ring ppermutes, in their order).  Every
        rank of the group must call it."""
        for side in (+1, -1):
            recs = self._extract_boundary(side)
            self._insert_halo(*comm.ppermute(recs, side, group))
        return self

    # ------------------------------------------------------------------
    def n_owned_voxels(self) -> torch.Tensor:
        occupied = self.vm.table.keys[:, 0] != EMPTY
        return torch.sum(occupied & ~self.is_halo)


# ======================================================================
# the sharded-map LIO step
# ======================================================================

def _sharded_lio_body(state: EsikfState, svm: ShardedVoxelMap,
                      bundle: ScanBundle, cfg: ImMeshConfig, group):
    """One frame: bundle replicated, map sharded by slab ownership."""
    lio_cfg, map_cfg = cfg.lio, cfg.voxel_map
    state_prop, pts_end = propagate_and_deskew(state, bundle, bundle.pts,
                                               cfg.imu)
    down_pts, down_mask = voxel_downsample(
        pts_end, bundle.mask, lio_cfg.downsample_voxel,
        lio_cfg.map_update_points)
    pcov = lidar_point_cov_body(down_pts, map_cfg.dept_err, map_cfg.beam_err)

    def assoc_owned(st: EsikfState):
        # ownership of a point = ownership of its CURRENT-iterate voxel; the
        # state is replicated, so every rank assigns each point to the same
        # single owner and the summed rows count every point once
        own = svm.owns(voxel_coords(st.transform_points(down_pts),
                                    map_cfg.voxel_size, 0))
        return associate(st, svm.vm, down_pts, pcov, down_mask & own, map_cfg)

    st, diag = iterated_update(state_prop, assoc_owned, lio_cfg,
                               reduce=lambda sums: comm.psum(sums, group))

    # owner-computes growth + halo refresh
    pts_world_down = st.transform_points(down_pts)
    sigma2 = (pcov[:, 0, 0] + pcov[:, 1, 1] + pcov[:, 2, 2]) / 3.0
    svm.update_owned(pts_world_down, sigma2, down_mask)
    svm.halo_exchange(group)
    return st, svm, st.transform_points(pts_end), diag


def create_sharded_map(cfg: ImMeshConfig,
                       group: Optional[dist.ProcessGroup] = None, *,
                       slab_voxels: int = 32, halo_capacity: int = 1024,
                       device="cuda") -> ShardedVoxelMap:
    """This rank's map shard (shard id = the rank in `group`)."""
    rank, n = comm.rank_size(group)
    return ShardedVoxelMap.create(cfg.voxel_map, rank, n, slab_voxels,
                                  halo_capacity, device=device)


def make_sharded_lio_step(cfg: ImMeshConfig,
                          group: Optional[dist.ProcessGroup] = None):
    """The multi-rank LIO step over a spatially sharded map:
    step(state, svm, bundle) → (state, svm, world_scan, diag), with the
    bundle and state replicated and `svm` this rank's shard (updated in
    place).  Every rank must call it once per frame."""
    group = group if group is not None else dist.group.WORLD

    def step(state: EsikfState, svm: ShardedVoxelMap, bundle: ScanBundle):
        return _sharded_lio_body(state, svm, bundle, cfg, group)

    return step
