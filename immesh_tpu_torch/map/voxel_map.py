"""Probabilistic hash-voxel plane map — the keystone structure.

Port of immesh_tpu/map/voxel_map.py (reference src/voxel_loc.{hpp,cpp} and
buildVoxelMap/updateVoxelMap, src/voxel_mapping.cpp:110-151,320-354):
one open-addressing table keyed by (ix, iy, iz, level) holding running
moments {Σp, Σppᵀ, N, Σσ²} per voxel, closed-form plane refits over every
touched voxel at once, and a multi-level descent through non-planar voxels.

The JAX reference updates the map functionally inside a donated program;
here `update` and `compact` modify the tensors of this object in place and
never rebind them, so a captured CUDA graph of the LIO step (lio/captured.py)
keeps pointing at the live map.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace

import torch

from immesh_tpu_torch.config import VoxelMapConfig
from immesh_tpu_torch.core.geometry import plane_from_moments
from immesh_tpu_torch.core.ops import (add_drop_group, segment_sum,
                                      set_drop_group)
from immesh_tpu_torch.device import resolve_device
from immesh_tpu_torch.kernels import graph_cond, hash_probe
from immesh_tpu_torch.map.hash import (
    EMPTY, HashTable, frame_unique_coords, voxel_coords)
from immesh_tpu_torch.utils.graphs import device_if

# upper-triangle index pairs for symmetric 3×3 ↔ length-6 storage
_TRI = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))


def _sym_pack(M: torch.Tensor) -> torch.Tensor:
    return torch.stack([M[..., i, j] for i, j in _TRI], dim=-1)


def _sym_unpack(v: torch.Tensor) -> torch.Tensor:
    xx, xy, xz, yy, yz, zz = (v[..., k] for k in range(6))
    return torch.stack(
        [
            torch.stack([xx, xy, xz], dim=-1),
            torch.stack([xy, yy, yz], dim=-1),
            torch.stack([xz, yz, zz], dim=-1),
        ],
        dim=-2,
    )


def _key_centers(keys: torch.Tensor, voxel_size: float,
                 dtype: torch.dtype) -> torch.Tensor:
    """Voxel center of each (k, 4) key at its own level (children are
    half-size): (c + 0.5) · voxel_size / 2^level."""
    size = voxel_size / torch.exp2(keys[:, 3].to(dtype))  # exact: 2^-level
    return (keys[:, :3].to(dtype) + 0.5) * size[:, None]


@dataclass
class VoxelMap:
    table: HashTable
    # running moments
    sum_p: torch.Tensor       # (cap, 3)
    sum_ppT: torch.Tensor     # (cap, 6) packed symmetric
    count: torch.Tensor       # (cap,) f32
    sigma2_sum: torch.Tensor  # (cap,) Σ per-point isotropic noise
    # fitted plane
    normal: torch.Tensor      # (cap, 3)
    d: torch.Tensor           # (cap,)
    center: torch.Tensor      # (cap, 3)
    cov_nn: torch.Tensor      # (cap, 6) packed symmetric normal covariance
    var_c: torch.Tensor       # (cap,)
    lam: torch.Tensor         # (cap, 3) eigenvalues ascending
    plane_valid: torch.Tensor  # (cap,) bool — fitted & planar
    subdivided: torch.Tensor   # (cap,) bool — voxel spilled to children
    cfg: VoxelMapConfig

    _MOMENTS = ("sum_p", "sum_ppT", "count", "sigma2_sum")
    _FIELDS = _MOMENTS + ("normal", "d", "center", "cov_nn", "var_c", "lam",
                          "plane_valid", "subdivided")

    @classmethod
    def create(cls, cfg: VoxelMapConfig, dtype=torch.float32,
               device="cuda") -> "VoxelMap":
        dev = resolve_device(device)
        cap = cfg.capacity

        def z(*s):
            return torch.zeros(s, dtype=dtype, device=dev)

        return cls(
            table=HashTable.create(cap, cfg.max_probe, device=dev),
            sum_p=z(cap, 3), sum_ppT=z(cap, 6), count=z(cap), sigma2_sum=z(cap),
            normal=z(cap, 3), d=z(cap), center=z(cap, 3), cov_nn=z(cap, 6),
            var_c=z(cap), lam=z(cap, 3),
            plane_valid=torch.zeros(cap, dtype=torch.bool, device=dev),
            subdivided=torch.zeros(cap, dtype=torch.bool, device=dev),
            cfg=cfg,
        )

    def clone(self) -> "VoxelMap":
        """A copy of the map that shares no tensor with this one."""
        return replace(self, table=self.table.clone(),
                       **{n: getattr(self, n).clone() for n in self._FIELDS})

    # ==================================================================
    # growth (reference buildVoxelMap / updateVoxelMap)
    # ==================================================================
    def update(self, pts_world: torch.Tensor, point_sigma2: torch.Tensor,
               mask: torch.Tensor, max_voxels: int = 0) -> "VoxelMap":
        """Insert a scan into the map and refit touched planes, in place.

        pts_world (N, 3), point_sigma2 (N,) isotropic noise tr(Σ)/3, mask
        (N,); max_voxels caps unique voxels per level (0 =
        cfg.touched_voxels_per_scan).  Returns self."""
        self.update_levels(pts_world, point_sigma2, mask, max_voxels)
        return self

    def update_levels(self, pts_world: torch.Tensor,
                      point_sigma2: torch.Tensor, mask: torch.Tensor,
                      max_voxels: int = 0) -> torch.Tensor:
        """`update`'s work.  Returns how many refinement levels (1 ..
        max_layers − 1) had points to insert, an int32 device scalar."""
        max_voxels = max_voxels or self.cfg.touched_voxels_per_scan
        self._update_level(pts_world, point_sigma2, mask, 0, max_voxels)
        m = mask
        if self.cfg.max_layers < 2:
            return torch.zeros((), dtype=torch.int32, device=mask.device)
        levels = torch.empty((), dtype=torch.int32, device=mask.device)
        for lvl in range(1, self.cfg.max_layers):
            # points whose full parent chain is subdivided feed level lvl
            # (reference cut_octo_tree recursion, voxel_loc.cpp:161-217);
            # the level update runs where the mask has a point, as the
            # reference's lax.cond: an IF node of the captured LIO step
            # (utils/graphs.py::device_if), which writes the map in place;
            # its set launch counts the level into `levels` (set by the
            # first, added by the others)
            m = self.parent_mask(pts_world, m, lvl)
            device_if(graph_cond.any_of(m, levels,
                                        "set" if lvl == 1 else "add"),
                      functools.partial(self._update_level, pts_world,
                                        point_sigma2, m, lvl, max_voxels),
                      "level")
        return levels

    def parent_mask(self, pts_world: torch.Tensor, m: torch.Tensor,
                    level: int) -> torch.Tensor:
        """m & (each point's voxel at level − 1 is present and
        subdivided): the mask of refinement level `level`
        (kernels/hash_probe.py's parent form)."""
        return hash_probe.lookup_parent(
            pts_world.contiguous(), self.cfg.voxel_size, level - 1,
            self.table.fp, self.subdivided, m.contiguous(),
            self.table.max_probe)

    def scan_aggregates(self, pts, sigma2, mask, level: int, max_voxels: int):
        """Per-scan segment aggregation: (uniq_coords (U,4), agg (U,11), ok).

        agg columns: Σp (3) | Σppᵀ packed (6) | N (1) | Σσ² (1), with moments
        relative to each point's voxel center (exact in f32 at world scale)."""
        cfg = self.cfg
        n = pts.shape[0]
        coords = voxel_coords(pts, cfg.voxel_size, level)
        seg, first, _ = frame_unique_coords(coords[:, :3], mask, max_voxels)
        seg_ok = seg < max_voxels

        size = cfg.voxel_size / (2 ** level)
        pl = pts - (coords[:, :3].to(pts.dtype) + 0.5) * size
        w = seg_ok.to(pts.dtype)
        feats = torch.cat(
            [
                pl * w[:, None],                                       # (3)
                _sym_pack(pl[:, :, None] * pl[:, None, :]) * w[:, None],  # (6)
                w[:, None],                                            # (1)
                (sigma2 * w)[:, None],                                 # (1)
            ],
            dim=-1,
        )
        agg = segment_sum(feats, seg, max_voxels)  # id max_voxels dropped

        uniq_valid = first < n
        uniq_coords = coords[first.clamp(max=n - 1).long()]
        return uniq_coords, agg, uniq_valid

    def apply_aggregates(self, uniq_coords, agg, uniq_valid, level: int
                         ) -> "VoxelMap":
        """Insert the aggregated voxels and add their moments, in place."""
        cfg = self.cfg
        slots, _ = self.table.insert(uniq_coords, uniq_valid)
        ok = uniq_valid & (slots >= 0)
        sl = slots.clamp(min=0).long()
        # freeze full voxels (reference voxel_loc.cpp:243-248)
        frozen = torch.where(ok, self.count[sl] >= cfg.max_points_per_voxel,
                             True)
        add = ok & ~frozen
        add_drop_group([self.sum_p, self.sum_ppT, self.count,
                        self.sigma2_sum], slots,
                       [agg[:, 0:3], agg[:, 3:9], agg[:, 9], agg[:, 10]], add)
        return self._refit(slots, ok, level)

    def _update_level(self, pts, sigma2, mask, level: int, max_voxels: int
                      ) -> "VoxelMap":
        uniq_coords, agg, ok = self.scan_aggregates(
            pts, sigma2, mask, level, max_voxels)
        return self.apply_aggregates(uniq_coords, agg, ok, level)

    def _refit(self, slots: torch.Tensor, ok: torch.Tensor,
               level: int) -> "VoxelMap":
        """Batched plane refit of the touched slots (gather → eigh → scatter)."""
        cfg = self.cfg
        s = torch.where(ok, slots, 0).long()
        n = self.count[s]
        sigma2_mean = self.sigma2_sum[s] / torch.clamp(n, min=1.0)
        size = cfg.voxel_size / (2 ** level)
        anchor = (self.table.keys[s, :3].to(self.sum_p.dtype) + 0.5) * size
        fit = plane_from_moments(
            self.sum_p[s], _sym_unpack(self.sum_ppT[s]), n, sigma2_mean,
            min_count=cfg.min_plane_points, anchor=anchor,
        )
        planar = fit["valid"] & (fit["lam"][..., 0] < cfg.planer_threshold)
        dsts = [self.normal, self.d, self.center, self.cov_nn, self.var_c,
                self.lam, self.plane_valid]
        srcs = [fit["normal"], fit["d"], fit["center"],
                _sym_pack(fit["cov_nn"]), fit["var_c"], fit["lam"], planar]
        if level < cfg.max_layers - 1:
            # non-finest levels spill to children when the fit is not planar
            dsts.append(self.subdivided)
            srcs.append(fit["valid"] & ~planar)
        set_drop_group(dsts, slots, srcs, ok)
        return self

    # ==================================================================
    # queries
    # ==================================================================
    def lookup_planes(self, q: torch.Tensor, near: bool):
        """(found (N,), slot (N,)) of the multi-level plane lookup of the
        (N, 3) points q, with the near-voxel probe of lio/association.py
        where `near` (kernels/hash_probe.py's planes form)."""
        return hash_probe.lookup_planes(
            q.contiguous(), self.cfg.voxel_size, self.cfg.max_layers,
            self.table.fp, self.plane_valid, self.subdivided,
            self.table.max_probe, near)

    def query_planes(self, pts_world: torch.Tensor):
        """Multi-level plane lookup for (N, 3) points: the coarsest planar
        level, descending through subdivided parents (reference
        voxel_mapping.cpp:247-318)."""
        found, slot = self.lookup_planes(pts_world, near=False)
        sl = slot.long()
        return {
            "found": found,
            "slot": slot,
            "normal": self.normal[sl],
            "d": self.d[sl],
            "center": self.center[sl],
            "cov_nn": _sym_unpack(self.cov_nn[sl]),
            "var_c": self.var_c[sl],
        }

    def lookup_planes_stack(self, pts_stack: torch.Tensor):
        """Multi-level plane lookup for a (P, N, 3) stack of query positions,
        all P·max_layers hash lookups in one launch.  Returns (found (P, N),
        slot (P, N)) with query_planes' descent semantics."""
        P, N, _ = pts_stack.shape
        found, slot = self.lookup_planes(pts_stack.reshape(P * N, 3),
                                         near=False)
        return found.reshape(P, N), slot.reshape(P, N)

    def n_voxels(self) -> torch.Tensor:
        return self.table.occupancy()

    def n_planes(self) -> torch.Tensor:
        return torch.sum(self.plane_valid)

    # ==================================================================
    # lifetime management (reference laser_map_fov_segment,
    # voxel_mapping_common.cpp:214-288)
    # ==================================================================
    def compact(self, center: torch.Tensor, keep_radius) -> "VoxelMap":
        """Evict voxels outside a Chebyshev `keep_radius` cube around
        `center` and rehash the survivors into a fresh table.  In place: the
        compacted table and fields are copied back into the same tensors."""
        cfg = self.cfg
        keys = self.table.keys
        live = keys[:, 0] != EMPTY
        vcen = _key_centers(keys, cfg.voxel_size, self.sum_p.dtype)
        cheb = torch.amax(torch.abs(vcen - center[None, :]), dim=-1)
        keep = live & (cheb <= keep_radius)

        fresh = HashTable.create(cfg.capacity, cfg.max_probe,
                                 device=keys.device)
        slots, _ = fresh.insert(keys, keep)
        ok = keep & (slots >= 0)
        # one scatter a group of at most 8 fields into zeroed copies, then
        # the copies back into the same tensors
        for names in (self._MOMENTS, self._FIELDS[len(self._MOMENTS):]):
            srcs = [getattr(self, n) for n in names]
            outs = [torch.zeros_like(x) for x in srcs]
            set_drop_group(outs, slots, srcs, ok)
            for x, out in zip(srcs, outs):
                x.copy_(out)
        self.table.keys.copy_(fresh.keys)
        self.table.fp.copy_(fresh.fp)
        return self
