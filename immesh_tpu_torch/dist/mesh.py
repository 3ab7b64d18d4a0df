"""Multi-rank meshing over torch.distributed — port of immesh_tpu/dist/mesh.py.

The reference parallelizes per-voxel triangulation with a 12-thread pool +
TBB (SURVEY.md P2/P3, ImMesh_mesh_reconstruction.cpp:129); here the
active-voxel work is split over the ranks of a process group.  Two
strategies, as in the JAX package:

  * `make_mp_mesh_step` — compute-parallel only: the global point map and
    triangle store are REPLICATED on every rank; the point-sharded world
    scan is all-gathered, every replica applies the identical append, each
    rank triangulates its slice of the active voxels, and the triangle
    lists are all-gathered back and applied identically.
  * `ShardedMeshMap` + `make_sharded_mesh_step` — capacity-parallel: world
    space is striped into x-slabs of `slab_voxels` meshing voxels, slab s
    owned by rank s mod n (the reference's 10 m region shards,
    src/meshing/r3live/triangle.cpp:35-53).  Each rank appends the points
    of its owned columns plus a 2-column halo on each slab edge — the
    append is PRE-PARTITIONED: the gathered scan is compacted to those rows
    (an order-preserving cumsum-scatter) and the per-frame budgets scale by
    the keep fraction — and triangulates only the active voxels it owns.
    Boundary voxels are populated bitwise-identically on both sides, so
    the centroid-ownership triangle dedup (mesh/triangles.py) stays exact
    across rank boundaries.  `gather_mesh` assembles the shards.

Each rank holds only its own shard (the JAX stacked (n_dev, …) state is
per-rank state here); every collective is in dist/comm.py, and none sits
in a data-dependent branch, so the ranks cannot part ways.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from immesh_tpu_torch.config import ImMeshConfig, MeshConfig
from immesh_tpu_torch.core.ops import div, set_drop
from immesh_tpu_torch.dist import comm
from immesh_tpu_torch.mesh.global_map import GlobalPointMap
from immesh_tpu_torch.mesh.triangles import (
    TriangleStore, apply_triangles, triangulate_voxels)

# halo width in voxel columns on EACH side of an owned slab (see
# ShardedMeshMap for the width-2 invariant)
_HALO_COLS = 2


def _round_up(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def shard_keep_fraction(slab_voxels: int, n_shards: int) -> float:
    """Expected fraction of a (spatially uniform) scan a rank appends: its
    owned slabs plus the 2-column halo on each slab edge."""
    if n_shards <= 1:
        return 1.0
    return min(1.0, (slab_voxels + 2 * _HALO_COLS) / (slab_voxels * n_shards))


def shard_mesh_config(mesh_cfg: MeshConfig, n_shards: int,
                      slab_voxels: int, margin: float = 1.5) -> MeshConfig:
    """Scale the PER-FRAME budgets of a mesh config by the shard keep
    fraction (×margin headroom for spatial non-uniformity); capacities are
    untouched — each shard keeps a full-size store.  Floors keep tiny
    workloads behaving like the single-device path."""
    f = shard_keep_fraction(slab_voxels, n_shards) * margin
    if f >= 1.0:
        return mesh_cfg

    def scale(v: int, floor: int) -> int:
        # never raise a budget above its configured value, never scale
        # below the floor
        return max(min(v, floor), int(v * f))

    act = scale(mesh_cfg.active_voxels_per_frame, 128)
    return dataclasses.replace(
        mesh_cfg,
        max_pts_per_frame=scale(mesh_cfg.max_pts_per_frame, 2048),
        file_voxels_per_frame=scale(mesh_cfg.file_voxels_per_frame, 512),
        active_voxels_per_frame=act,
        # the kernel chunk tracks the scaled active set, so a rank does not
        # pad a small active set into one mostly-empty chunk
        mesh_chunk=max(8, min(mesh_cfg.mesh_chunk, _round_up(act // 4, 8))),
    )


def make_mp_mesh_step(cfg: ImMeshConfig,
                      group: Optional[dist.ProcessGroup] = None):
    """Compute-parallel mesh step: step(gm, store, scan_local, mask_local,
    sensor_pos) → (gm, store, n_active), with `gm` and `store` replicated
    and updated in place identically on every rank.  The scan arrays are
    this rank's rows (the dp LIO step's world-scan layout)."""
    rank, n = comm.rank_size(group)
    group = group if group is not None else dist.group.WORLD

    def step(gm: GlobalPointMap, store: TriangleStore, scan_local, mask_local,
             sensor_pos):
        pts_all = comm.all_gather_cat(scan_local, group)
        mask_all = comm.all_gather_cat(mask_local, group)
        gm, slots, smask, _ = gm.append_frame(pts_all, mask_all)
        if cfg.mesh.pull_smooth_lam > 0:
            # replicated smoothing over the FULL active set before voxels
            # are split — every rank must read identical smoothed geometry
            gm.smooth_active(slots, smask)
        # this rank's slice of the active voxels (the tail A % n is left
        # out, as in the JAX step)
        per = slots.shape[0] // n
        sl = slots[rank * per:(rank + 1) * per]
        sm = smask[rank * per:(rank + 1) * per]
        ids, counts, _ = triangulate_voxels(
            gm, sl, sm, sensor_pos, cfg.mesh, cfg.mesh.mesh_chunk)
        apply_triangles(store, comm.all_gather_cat(sl, group),
                        comm.all_gather_cat(sm, group),
                        comm.all_gather_cat(ids, group),
                        comm.all_gather_cat(counts, group))
        gm.mark_meshed(slots, smask)
        return gm, store, torch.sum(smask.to(torch.int32))

    return step


# ======================================================================
# capacity-sharded meshing: each rank owns x-slabs of meshing voxels
# ======================================================================

def mesh_column_owner(col: torch.Tensor, slab_voxels: int, n_shards: int
                      ) -> torch.Tensor:
    """x voxel column (at voxel_resolution) → owning shard id."""
    return torch.remainder(torch.div(col, slab_voxels, rounding_mode="floor"),
                           n_shards)


@dataclass
class ShardedMeshMap:
    """One rank's mesh shard: a GlobalPointMap + TriangleStore holding the
    rank's OWNED voxel columns plus a 2-column halo on each slab edge.

    The halo width-2 invariant: owned voxels pull 27-neighborhoods (±1
    column); a pulled point near the slab edge may belong to a dedup cell
    straddling a voxel boundary, and the in-frame dedup representative is
    only rank-consistent when every point of that cell is inside the rank's
    append mask — 2 columns of halo guarantee it for all points any owned
    voxel can pull."""

    gm: GlobalPointMap
    store: TriangleStore
    shard_id: int
    n_shards: int
    slab_voxels: int
    # headroom factor sizing the pre-partition append buffer (and the scaled
    # per-frame budgets) above the uniform-scan keep fraction — frames
    # overflowing it past this margin DROP the excess (counted in the
    # step's n_part_drops)
    append_margin: float = 1.5
    # (slots, owned mask) of the most recent step's re-mesh
    last_active: Optional[tuple] = None

    @classmethod
    def create(cls, cfg: ImMeshConfig, shard_id: int, n_shards: int,
               slab_voxels: int = 8, append_margin: float = 1.5,
               device="cuda") -> "ShardedMeshMap":
        mc = shard_mesh_config(cfg.mesh, n_shards, slab_voxels, append_margin)
        return cls(gm=GlobalPointMap.create(mc, device=device),
                   store=TriangleStore.create(mc, device=device),
                   shard_id=shard_id, n_shards=n_shards,
                   slab_voxels=slab_voxels, append_margin=append_margin)

    def _owner(self, col: torch.Tensor) -> torch.Tensor:
        return mesh_column_owner(col, self.slab_voxels, self.n_shards)

    def append_keep(self, pts_world: torch.Tensor) -> torch.Tensor:
        """(N,) bool — point is in an owned column or the 2-column halo."""
        col = torch.floor(div(pts_world[:, 0], self.gm.cfg.voxel_resolution)
                          ).to(torch.int32)
        keep = self._owner(col) == self.shard_id
        for d in range(-_HALO_COLS, _HALO_COLS + 1):
            if d:
                keep = keep | (self._owner(col + d) == self.shard_id)
        return keep

    def owns_voxel(self, slots: torch.Tensor) -> torch.Tensor:
        """(A,) bool — voxel slot's column is owned (not halo)."""
        col = self.gm.vox.keys[slots.clamp(min=0).long(), 0]
        return self._owner(col) == self.shard_id

    def n_owned_triangles(self) -> torch.Tensor:
        return self.store.n_triangles()


def _sharded_mesh_body(smm: ShardedMeshMap, scan_local, mask_local,
                       sensor_pos, group):
    pts_all = comm.all_gather_cat(scan_local, group)
    mask_all = comm.all_gather_cat(mask_local, group)
    keep = mask_all & smm.append_keep(pts_all)

    # ---- dedup pre-partition: compact the gathered scan to THIS rank's
    # owned+halo rows before append_frame, so the in-frame dedup sort runs
    # on ~N/n + halo rows.  The buffer M is static (expected keep fraction
    # × append_margin) and the cumsum-scatter keeps row order, so the
    # first-occurrence dedup representatives are those of the uncompacted
    # masked append.  Rows beyond M are dropped and counted.
    N = pts_all.shape[0]
    dev = pts_all.device
    f = shard_keep_fraction(smm.slab_voxels, smm.n_shards)
    M = (N if f * smm.append_margin >= 1.0
         else min(N, _round_up(int(N * f * smm.append_margin), 256)))
    if M < N:
        pos = torch.cumsum(keep.to(torch.int32), 0, dtype=torch.int32) - 1
        pts_c = torch.zeros((M, 3), dtype=pts_all.dtype, device=dev)
        set_drop(pts_c, pos, pts_all, keep & (pos < M))
        n_kept = torch.sum(keep.to(torch.int32))
        mask_c = torch.arange(M, dtype=torch.int32, device=dev) < n_kept
        n_part_drop = torch.clamp(n_kept - M, min=0)
    else:
        pts_c, mask_c = pts_all, keep
        n_part_drop = torch.zeros((), dtype=torch.int32, device=dev)

    gm, slots, smask, _ = smm.gm.append_frame(pts_c, mask_c)
    mc = gm.cfg         # the budget-SCALED mesh config (shard_mesh_config)
    if mc.pull_smooth_lam > 0:
        # smooth ALL active voxels this rank appended (own + halo): halo
        # copies of a point smooth from the same raw geometry
        gm.smooth_active(slots, smask)

    # triangulate only the active voxels this rank OWNS (ownership reads
    # the post-append table) — halo voxels are re-meshed by their owner
    smask_own = smask & smm.owns_voxel(slots)
    ids, counts, _ = triangulate_voxels(
        gm, slots, smask_own, sensor_pos, mc, mc.mesh_chunk)
    apply_triangles(smm.store, slots, smask_own, ids, counts)
    # mark the FULL pre-ownership active set meshed: a halo voxel left
    # pending would re-enter the backlog every frame and crowd owned voxels
    # out of the active budget; its owner keeps its own backlog
    gm.mark_meshed(slots, smask)
    smm.last_active = (slots, smask_own)
    red = comm.psum({"n_active": torch.sum(smask_own.to(torch.int32)),
                     "n_tris": smm.store.n_triangles().to(torch.int32),
                     "n_part_drop": n_part_drop.to(torch.int32)}, group)
    return smm, red["n_active"], red["n_tris"], red["n_part_drop"]


def create_sharded_mesh(cfg: ImMeshConfig,
                        group: Optional[dist.ProcessGroup] = None, *,
                        slab_voxels: int = 8, append_margin: float = 1.5,
                        device="cuda") -> ShardedMeshMap:
    """This rank's mesh shard (shard id = the rank in `group`)."""
    rank, n = comm.rank_size(group)
    return ShardedMeshMap.create(cfg, rank, n, slab_voxels, append_margin,
                                 device=device)


def make_sharded_mesh_step(cfg: ImMeshConfig,
                           group: Optional[dist.ProcessGroup] = None):
    """Capacity-sharded mesh step: step(smm, scan_local, mask_local,
    sensor_pos) → (smm, n_active, n_triangles, n_part_drops), the three
    counters summed over the ranks.  The scan arrays are this rank's rows
    (the dp LIO world-scan layout); `smm` is this rank's shard, updated in
    place.  n_part_drops counts rows lost to pre-partition buffer overflow
    (≈0 unless a frame is concentrated in one rank's slabs)."""
    group = group if group is not None else dist.group.WORLD

    def step(smm: ShardedMeshMap, scan_local, mask_local, sensor_pos):
        return _sharded_mesh_body(smm, scan_local, mask_local, sensor_pos,
                                  group)

    return step


def gather_mesh(smm: ShardedMeshMap,
                group: Optional[dist.ProcessGroup] = None) -> dict:
    """Assemble the shard stores into one host-side mesh on every rank (a
    collective): the shards' vertex arrays concatenated (n·P rows, each
    shard's first pt_count rows filled) and triangle ids offset per shard
    (id = shard·P + local), as the JAX gather_mesh lays them out."""
    Pcap = smm.gm.pts.shape[0]
    tri = smm.store.tri_ids.reshape(-1, 3)
    tri = tri[torch.all(tri >= 0, dim=1)]
    counts = torch.stack(comm.all_gather(torch.tensor(
        [int(smm.gm.pt_count), tri.shape[0]], dtype=torch.int64,
        device=tri.device), group)).cpu()
    p_max, t_max = (int(x) for x in counts.max(0).values)
    pts = torch.zeros((p_max, 3), dtype=smm.gm.pts.dtype,
                      device=smm.gm.pts.device)
    pts[:int(counts[smm.shard_id, 0])] = smm.gm.pts[:int(
        counts[smm.shard_id, 0])]
    tpad = torch.full((t_max, 3), -1, dtype=tri.dtype, device=tri.device)
    tpad[:tri.shape[0]] = tri
    all_pts = [p.cpu().numpy() for p in comm.all_gather(pts, group)]
    all_tri = [t.cpu().numpy() for t in comm.all_gather(tpad, group)]
    n = len(all_pts)
    out_pts = np.zeros((n * Pcap, 3), all_pts[0].dtype)
    tris = []
    for s in range(n):
        out_pts[s * Pcap:s * Pcap + p_max] = all_pts[s]
        tris.append(all_tri[s][:int(counts[s, 1])] + s * Pcap)
    return {"pts": out_pts, "tris": np.concatenate(tris, axis=0),
            "n_pts_per_shard": counts[:, 0].numpy().astype(np.int32)}
