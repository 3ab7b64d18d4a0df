"""Global meshing point map — fixed-capacity SoA point store + voxel grid.

Port of immesh_tpu/mesh/global_map.py (reference `Global_map`,
src/meshing/r3live/pointcloud_rgbd.{hpp,cpp}): a presence-only dedup grid
at pts_minimum_scale, a meshing-voxel grid at voxel_resolution with per-voxel
point-slot rows, and 3×3×3 voxel-slot pulls in place of the reference's
ikd-tree radius queries.  Appends are one deterministic pipeline: in-frame
grid dedup → map dedup via hash find-or-insert → bump allocation →
rank-ordered filing into per-voxel slots.

The JAX reference updates the map functionally inside a donated program;
here `append_frame`, `smooth_active`, `mark_meshed` and `compact` modify the
tensors of this object in place, and never rebind them: the captured mesh
step (mesh/captured.py) replays at the addresses it was captured with.
The mesh step reads no device value on the host.

MeshConfig.ablate's append cuts ("app_cell0", "app_insert0", "app_alloc0",
"app_file0", "app_active0") stop `append_frame` after the named stage and
return what the reference's cut returns: the map as it was before the
frame with frame_no advanced, an empty work list and zero drop counters.
Since the stages before a cut have already written this map in place, a cut
frame first copies the map and puts the copy back at the cut.
"""

from __future__ import annotations

from dataclasses import dataclass, fields, replace
from typing import Tuple

import numpy as np
import torch

from perfbench.reference.config import MeshConfig
from perfbench.reference.core.ops import (compact_indices, div, set_drop,
                                      set_drop_group)
from perfbench.reference.device import resolve_device
from perfbench.reference.kernels import hash_probe
from perfbench.reference.kernels.hash_probe import _OFFS
from perfbench.reference.map.hash import EMPTY, HashTable, frame_unique_coords

_SENTINEL = 1 << 30

_OWN_OFFSET_IDX = int(np.where((_OFFS == 0).all(axis=1))[0][0])


def _grid_coords(pts: torch.Tensor, size: float, tag: int) -> torch.Tensor:
    """(N,3) world pts → (N,4) int32 hash keys; `tag` separates key spaces."""
    c = torch.floor(div(pts, size)).to(torch.int32)
    t = torch.full((pts.shape[0], 1), tag, dtype=torch.int32,
                   device=pts.device)
    return torch.cat([c, t], dim=-1)


def _round_up_int(n: int, k: int) -> int:
    return ((n + k - 1) // k) * k


def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _rank_in_segment(seg: torch.Tensor, mask: torch.Tensor,
                     k: int) -> torch.Tensor:
    """Rank (0-based) of each masked element within its segment, by row order."""
    n = seg.shape[0]
    dev = seg.device
    s = torch.where(mask, seg, k)
    order = torch.argsort(s, stable=True)
    sorted_seg = s[order]
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    start = torch.full((k + 1,), n, dtype=torch.int32, device=dev)
    start.scatter_reduce_(0, sorted_seg.long(), idx, reduce="amin")
    rank_sorted = idx - start[sorted_seg.clamp(0, k).long()]
    rank = torch.empty(n, dtype=torch.int32, device=dev)
    rank[order] = rank_sorted
    return torch.where(mask, rank, 0)


@dataclass
class GlobalPointMap:
    # point store
    pts: torch.Tensor         # (P, 3) f32 world positions (raw, append-time)
    pts_smooth: torch.Tensor  # (P, 3) f32 Laplacian-smoothed positions — the
    # triangulation geometry, stored globally so every pulling voxel reads
    # identical smoothed coordinates
    pt_count: torch.Tensor    # () int32 bump pointer
    dedup: HashTable          # presence grid at pts_minimum_scale
    vox: HashTable            # meshing voxel grid at voxel_resolution
    vox_pt_idx: torch.Tensor  # (V, S) int32 indices into pts; -1 empty
    vox_pts: torch.Tensor     # (V, S, 3) the same positions as pts[vox_pt_idx]
    vox_pts_sm: torch.Tensor  # (V, S, 3) smoothed twin (smooth_active)
    vox_n: torch.Tensor       # (V,) int32 occupied slots
    vox_new: torch.Tensor     # (V,) int32 points added since last re-mesh
    vox_meshed: torch.Tensor  # (V,) bool ever meshed
    frame_no: torch.Tensor    # () int32 append counter — rotates the backlog
    # drain start so no pending voxel is starved
    cfg: MeshConfig

    @classmethod
    def create(cls, cfg: MeshConfig, dtype=torch.float32,
               device="cuda") -> "GlobalPointMap":
        dev = resolve_device(device)
        P, V, S = cfg.points_capacity, cfg.voxel_capacity, cfg.pts_per_voxel
        i32 = dict(dtype=torch.int32, device=dev)
        return cls(
            pts=torch.zeros((P, 3), dtype=dtype, device=dev),
            pts_smooth=torch.zeros((P, 3), dtype=dtype, device=dev),
            pt_count=torch.zeros((), **i32),
            dedup=HashTable.create(_next_pow2(4 * P), max_probe=32, device=dev),
            vox=HashTable.create(V, max_probe=32, device=dev),
            vox_pt_idx=torch.full((V, S), -1, **i32),
            vox_pts=torch.zeros((V, S, 3), dtype=dtype, device=dev),
            vox_pts_sm=torch.zeros((V, S, 3), dtype=dtype, device=dev),
            vox_n=torch.zeros(V, **i32),
            vox_new=torch.zeros(V, **i32),
            vox_meshed=torch.zeros(V, dtype=torch.bool, device=dev),
            frame_no=torch.zeros((), **i32),
            cfg=cfg,
        )

    def clone(self) -> "GlobalPointMap":
        """A copy of the map that shares no tensor with this one."""
        def copy(x):
            if isinstance(x, (HashTable, torch.Tensor)):
                return x.clone()
            return x
        return replace(self, **{f.name: copy(getattr(self, f.name))
                                for f in fields(self)})

    def copy_(self, src: "GlobalPointMap") -> "GlobalPointMap":
        """Copy src's tensors into this map's, in place (same shapes)."""
        for f in fields(self):
            dst = getattr(self, f.name)
            if isinstance(dst, HashTable):
                dst.keys.copy_(getattr(src, f.name).keys)
                dst.fp.copy_(getattr(src, f.name).fp)
            elif torch.is_tensor(dst):
                dst.copy_(getattr(src, f.name))
        return self

    def _trunc(self, before: "GlobalPointMap"):
        """MeshConfig.ablate app_*: end the append here, as the reference's
        `_trunc` does.  The map goes back to `before`, its copy from the
        start of the frame, with frame_no + 1 (copied back in place); the
        work list is empty and every drop counter 0."""
        self.copy_(before)
        self.frame_no.add_(1)
        A = self.cfg.active_voxels_per_frame
        dev = self.pts.device
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return (self, torch.zeros(A, dtype=torch.int32, device=dev),
                torch.zeros(A, dtype=torch.bool, device=dev),
                {k: zero for k in
                 ("cells", "points", "voxels", "slots", "deferred")})

    # ==================================================================
    def append_frame(self, pts_world: torch.Tensor, mask: torch.Tensor
                     ) -> Tuple["GlobalPointMap", torch.Tensor, torch.Tensor,
                                dict]:
        """Append one frame of world points (dedup'd), in place; returns
        (self, active_slots (A,), active_mask (A,), drops) with the drop
        counters of immesh_tpu.mesh.global_map.GlobalPointMap.append_frame
        ("cells", "points", "voxels", "slots", "deferred" — deferred counts
        backlog beyond this frame's re-mesh budget, not lost work)."""
        cfg = self.cfg
        cut = cfg.ablate
        before = self.clone() if cut.startswith("app_") else None
        N = pts_world.shape[0]
        dev = pts_world.device
        k_cells = min(N, cfg.max_pts_per_frame)
        i32 = torch.int32
        arange_n = torch.arange(N, dtype=i32, device=dev)

        # ---- 0. uniform decimation to ≈max_pts_per_frame (every step-th
        # valid point, spatially unbiased — ImMesh_mesh_reconstruction
        # .cpp:111)
        if N > cfg.max_pts_per_frame:
            n_valid = torch.sum(mask.to(i32))
            step = n_valid // cfg.max_pts_per_frame + 1
            vrank = torch.cumsum(mask.to(i32), 0, dtype=i32) - 1
            mask = mask & (vrank % step == 0)

        # ---- 1. in-frame dedup at the min-spacing grid -------------------
        if N > cfg.max_pts_per_frame:
            # order-preserving compaction of the surviving rows' ids into an
            # M0-row buffer; only that is sorted (first-occurrence
            # representatives are unchanged: min compact index ⇔ min row id)
            M0 = min(N, _round_up_int(cfg.max_pts_per_frame, 256))
            cpos = torch.cumsum(mask.to(i32), 0, dtype=i32) - 1
            ids0 = torch.full((M0,), N, dtype=i32, device=dev)
            set_drop(ids0, cpos, arange_n, mask & (cpos < M0))
            cvalid = ids0 < N
            ccell = _grid_coords(pts_world[ids0.clamp(max=N - 1).long()],
                                 cfg.pts_minimum_scale, tag=0)[:, :3]
            _, firstc, n_cells = frame_unique_coords(ccell, cvalid, k_cells)
            first = torch.where(
                firstc < M0, ids0[firstc.clamp(max=M0 - 1).long()], N)
        else:
            cell = _grid_coords(pts_world, cfg.pts_minimum_scale, tag=0)
            _, first, n_cells = frame_unique_coords(cell[:, :3], mask, k_cells)
        if cut == "app_cell0":
            return self._trunc(before)

        # ---- 2. map-level dedup: find-or-insert into the presence grid ---
        cand_ok = first < N
        ci = first.clamp(max=N - 1).long()
        p_ci = pts_world[ci]
        cand_cell = _grid_coords(p_ci, cfg.pts_minimum_scale, tag=0)
        slots, inserted = self.dedup.insert(cand_cell, cand_ok)
        # fresh ⇔ the key claimed a previously empty slot
        fresh = cand_ok & (slots >= 0) & inserted
        if cut == "app_insert0":
            return self._trunc(before)

        # ---- 3. bump-allocate point ids ----------------------------------
        order = torch.cumsum(fresh.to(i32), 0, dtype=i32) - 1
        new_ids = torch.where(fresh, self.pt_count + order, _SENTINEL)
        n_new = torch.sum(fresh.to(i32))
        cap_ok = new_ids < cfg.points_capacity
        drop_points = torch.sum((fresh & ~cap_ok).to(i32))
        fresh = fresh & cap_ok
        # fresh points start unsmoothed; their voxel is active this frame
        set_drop_group([self.pts, self.pts_smooth], new_ids, [p_ci, p_ci],
                       fresh)
        self.pt_count.copy_(torch.clamp(self.pt_count + n_new,
                                        max=cfg.points_capacity))
        if cut == "app_alloc0":
            return self._trunc(before)

        # ---- 4. voxel membership: rank-ordered scatter append ------------
        vcell = _grid_coords(p_ci, cfg.voxel_resolution, tag=0)
        F = cfg.file_voxels_per_frame
        vseg, vfirst, n_vox = frame_unique_coords(vcell[:, :3], fresh, F)
        vok = vfirst < k_cells
        vfi = vfirst.clamp(max=k_cells - 1).long()
        vslots, _ = self.vox.insert(vcell[vfi], vok)
        vslot_of_cand = torch.where(
            vseg < F, vslots[vseg.clamp(0, F - 1).long()], -1)
        rank = _rank_in_segment(vseg, fresh, F)
        write_ok = fresh & (vslot_of_cand >= 0)
        S = cfg.pts_per_voxel
        vsc = vslot_of_cand.clamp(min=0)
        base = torch.where(write_ok, self.vox_n[vsc.long()], 0)
        pos = base + rank
        drop_slots = torch.sum((write_ok & (pos >= S)).to(i32))
        write_ok = write_ok & (pos < S)
        flat = vsc * S + pos
        # member ids, and their positions duplicated into the slot rows
        # (contiguous pulls)
        set_drop_group([self.vox_pt_idx.view(-1), self.vox_pts.view(-1, 3),
                        self.vox_pts_sm.view(-1, 3)], flat,
                       [new_ids, p_ci, p_ci], write_ok)

        # per-voxel added counts (a scatter-add of ones: torch.bincount
        # would read its input's range back on the host)
        addc = torch.zeros(F + 1, dtype=i32, device=dev).scatter_add_(
            0, torch.where(write_ok, vseg, F).long(),
            torch.ones_like(vseg))[:F]
        vadd = vok & (vslots >= 0)
        vsl = vslots.clamp(min=0).long()
        set_drop_group([self.vox_n, self.vox_new], vslots,
                       [self.vox_n[vsl] + addc, self.vox_new[vsl] + addc],
                       vadd)
        if cut == "app_file0":
            return self._trunc(before)

        # ---- 5. active set = pending backlog ∪ occupied neighbors --------
        V = self.vox_n.shape[0]
        A = cfg.active_voxels_per_frame
        pending = (self.vox_new > 0) & (self.vox_n >= 3)
        n_pending = torch.sum(pending.to(i32))
        # rotate the drain start per frame so a sustained backlog is served
        # round-robin (the reference's mesh queue is FIFO)
        off = (self.frame_no * 40503) % V
        ar_v = torch.arange(V, dtype=i32, device=dev)
        psl_rot = compact_indices(pending[((ar_v + off) % V).long()], A)
        pmask = psl_rot < V
        psl = torch.where(pmask, (psl_rot + off) % V, V)
        self.frame_no.add_(1)
        active_slots, active_mask, drop_dilate = self._dilate_active(
            psl.clamp(max=V - 1), pmask)
        if cut == "app_active0":
            return self._trunc(before)
        zero = torch.zeros((), dtype=i32, device=dev)
        drops = {
            "cells": torch.maximum(n_cells - k_cells, zero),
            "points": drop_points,
            "voxels": (torch.maximum(n_vox - F, zero)
                       + torch.sum((vok & (vslots < 0)).to(i32))),
            "slots": drop_slots,
            "deferred": torch.maximum(n_pending - A, zero) + drop_dilate,
        }
        return self, active_slots, active_mask, drops

    # ------------------------------------------------------------------
    def _neighbor_slots(self, s: torch.Tensor) -> torch.Tensor:
        """(A·27,) slots of the 3×3×3 neighbourhoods of the voxel table's
        (A,) slots, −1 where absent (kernels/hash_probe.py's neighbours
        form)."""
        return hash_probe.lookup_neighbors(
            s.to(torch.int32).contiguous(), self.vox.keys, self.vox.fp,
            self.vox.max_probe)

    def _dilate_active(self, touched: torch.Tensor, tmask: torch.Tensor):
        """Expand the touched-voxel set to its occupied 26-neighborhood,
        bounded to cfg.active_voxels_per_frame entries with every seed
        first; returns (slots, mask, n_dropped)."""
        cfg = self.cfg
        dev = touched.device
        A = cfg.active_voxels_per_frame
        V = self.vox_n.shape[0]
        nb_slots = self._neighbor_slots(touched.clamp(min=0))  # (A*27,)
        nb_ok = tmask.repeat_interleave(27) & (nb_slots >= 0)
        nb_ok = nb_ok & (self.vox_n[nb_slots.clamp(min=0).long()] >= 3)
        # unique slots, each with priority = min over its candidate rows
        # (0 = itself a seed); the A best (priority, unique rank) win
        nrows = nb_slots.shape[0]                            # = 27·A
        prio = (torch.arange(27, dtype=torch.int32, device=dev)
                != _OWN_OFFSET_IDX).to(torch.int32).repeat(A)
        seg, first, n_uniq = frame_unique_coords(
            torch.where(nb_ok, nb_slots, 0)[:, None], nb_ok, nrows)
        prio_u = torch.full((nrows + 1,), 2, dtype=torch.int32, device=dev)
        prio_u.scatter_reduce_(0, torch.where(nb_ok, seg, nrows).long(), prio,
                               reduce="amin")
        prio_u = prio_u[:nrows]
        uvalid = first < nrows
        slot_u = nb_slots[first.clamp(max=nrows - 1).long()]
        big = 0x3FFFFFFF
        sel_key = torch.where(
            uvalid,
            prio_u * nrows + torch.arange(nrows, dtype=torch.int32, device=dev),
            big)
        # lax.top_k(-key, A): ascending key, lowest index first on ties
        pick = torch.argsort(sel_key, stable=True)[:A]
        ok = sel_key[pick] < big
        slots = slot_u[pick]
        zero = torch.zeros((), dtype=torch.int32, device=dev)
        return (torch.where(ok, slots, V - 1), ok,
                torch.maximum(n_uniq - A, zero))

    # ------------------------------------------------------------------
    def _neighborhood(self, s: torch.Tensor):
        """Slots (A,) → (keys (A, 4), nb_slots (A, 27), cand_idx (A, 27, S),
        cand_ok (A, 27, S), cand_pts (A, 27, S, 3)) of the 3×3×3 voxels."""
        A = s.shape[0]
        keys = self.vox.keys[s.long()]
        nb_slots = self._neighbor_slots(s).reshape(A, 27)
        nbs = nb_slots.clamp(min=0).long()
        cand_idx = self.vox_pt_idx[nbs]                         # (A, 27, S)
        cand_ok = (nb_slots >= 0)[:, :, None] & (cand_idx >= 0)
        return keys, nb_slots, cand_idx, cand_ok, self.vox_pts[nbs]

    def pull_neighborhood(self, slots: torch.Tensor, smask: torch.Tensor
                          ) -> dict:
        """Gather per-voxel point neighborhoods for meshing: idx (A, K) global
        point ids (-1 pad), pts (A, K, 3), pts_sm, mask (A, K), center —
        the voxel's own points first, then the nearest halo points within
        knn_radius_scale × voxel_resolution of the voxel center
        (retrieve_neighbor_pts_kdtree, mesh_rec_geometry.cpp:336-377)."""
        cfg = self.cfg
        A, S, K = slots.shape[0], cfg.pts_per_voxel, cfg.pull_capacity
        s = slots.clamp(min=0)
        keys, _, cand_idx, cand_ok, cand_pts = self._neighborhood(s)
        center = (keys[:, :3].to(self.pts.dtype) + 0.5) * cfg.voxel_resolution
        cand_idx = cand_idx.clamp(min=0)

        r = cfg.knn_radius_scale * cfg.voxel_resolution
        d = torch.linalg.norm(cand_pts - center[:, None, None, :], dim=-1)
        is_own = (torch.arange(27, device=slots.device)
                  == _OWN_OFFSET_IDX)[None, :, None]
        usable = cand_ok & (is_own | (d <= r))
        # own-first then by distance; lax.top_k of −key keeps ties in index
        # order, as a stable ascending sort does
        key = torch.where(usable, torch.where(is_own, d - 1e3, d),
                          torch.full_like(d, float("inf")))
        order = torch.argsort(key.reshape(A, 27 * S), dim=-1,
                              stable=True)[:, :K]              # (A, K)
        g_idx = torch.gather(cand_idx.reshape(A, -1), 1, order)
        g_ok = torch.gather(usable.reshape(A, -1), 1, order) & smask[:, None]
        g_pts = torch.gather(cand_pts.reshape(A, -1, 3), 1,
                             order[..., None].expand(A, K, 3))
        if cfg.pull_smooth_lam > 0:
            g_sm = self.pts_smooth[g_idx.clamp(min=0).long()]
        else:
            g_sm = g_pts
        return {
            "idx": torch.where(g_ok, g_idx, -1),
            "pts": g_pts,
            "pts_sm": g_sm,
            "mask": g_ok,
            "center": center,
        }

    def smooth_active(self, slots: torch.Tensor, smask: torch.Tensor
                      ) -> "GlobalPointMap":
        """Recompute the Gaussian-weighted Laplacian-smoothed positions of the
        active voxels' OWN points (σ = 2×min spacing), in place — the stored
        smoothed position is what triangulation reads (reference
        mesh_rec_geometry.cpp:333-369 + RGB_pts::set_smooth_pos)."""
        cfg = self.cfg
        lam = cfg.pull_smooth_lam
        A, S = slots.shape[0], cfg.pts_per_voxel
        s = slots.clamp(min=0)
        sl = s.long()
        keys, _, _, cand_ok, cand_pts = self._neighborhood(s)
        cand_pts = cand_pts.reshape(A, 27 * S, 3)
        cand_ok = cand_ok.reshape(A, 27 * S)

        own_idx = self.vox_pt_idx[sl]                           # (A, S)
        own_ok = (own_idx >= 0) & smask[:, None]
        p_own = self.vox_pts[sl]                                # (A, S, 3)

        # d² via the Gram expansion on VOXEL-CENTERED coordinates (exact
        # enough in f32 at world scale; raw coordinates cancel)
        vcen = (keys[:, :3].to(p_own.dtype) + 0.5) * cfg.voxel_resolution
        po_c = p_own - vcen[:, None, :]
        cp_c = cand_pts - vcen[:, None, :]
        d2 = (torch.sum(po_c * po_c, -1)[:, :, None]
              + torch.sum(cp_c * cp_c, -1)[:, None, :]
              - 2.0 * torch.einsum("asc,akc->ask", po_c, cp_c))
        sig = 2.0 * cfg.pts_minimum_scale
        w = torch.where(cand_ok[:, None, :] & (d2 < (3.0 * sig) ** 2),
                        torch.exp(-d2 / (2.0 * sig * sig)),
                        torch.zeros_like(d2))                   # (A, S, 27S)
        wsum = torch.sum(w, dim=-1, keepdim=True)
        mean = (torch.einsum("ask,akc->asc", w, cand_pts)
                / torch.clamp(wsum, min=1e-12))
        sm = (1.0 - lam) * p_own + lam * mean

        set_drop(self.pts_smooth, own_idx, sm, own_ok)
        # keep the slot-resident smoothed twin in sync (whole-row write;
        # non-own lanes keep their current values)
        sm_row = torch.where(own_ok[..., None], sm, self.vox_pts_sm[sl])
        set_drop(self.vox_pts_sm, s, sm_row, smask)
        return self

    def mark_meshed(self, slots: torch.Tensor, smask: torch.Tensor
                    ) -> "GlobalPointMap":
        set_drop_group([self.vox_new, self.vox_meshed], slots, [0, True],
                       smask)
        return self

    def n_points(self) -> torch.Tensor:
        return self.pt_count

    # ==================================================================
    # lifetime management (reference pointcloud_rgbd.cpp:278-294,425-455)
    # ==================================================================
    def compact(self, center: torch.Tensor, keep_radius
                ) -> Tuple["GlobalPointMap", dict]:
        """Drop every meshing voxel (and its member points) outside a
        Chebyshev `keep_radius` cube around `center`; rebuild both hash
        tables and compact the point store, then copy the result back into
        this map's tensors, in place.  Returns (self, maps)
        with maps = {"idmap": (P,) old→new point id or -1, "slot_map": (V,)
        old→new voxel slot or -1} for remap_store."""
        cfg = self.cfg
        P = cfg.points_capacity
        V = self.vox_n.shape[0]
        dtype = self.pts.dtype
        dev = self.pts.device
        res = cfg.voxel_resolution

        def vox_keep_of_coords(c3):
            vcen = (c3.to(dtype) + 0.5) * res
            return (torch.amax(torch.abs(vcen - center[None, :]), dim=-1)
                    <= keep_radius)

        # ---- voxel table rebuild ----------------------------------------
        vkeys = self.vox.keys
        vlive = vkeys[:, 0] != EMPTY
        vkeep = vlive & vox_keep_of_coords(vkeys[:, :3])
        vox = HashTable.create(V, self.vox.max_probe, device=dev)
        vslots, _ = vox.insert(vkeys, vkeep)
        vok = vkeep & (vslots >= 0)
        slot_map = torch.where(vok, vslots, -1)

        # ---- point keep + old→new id map --------------------------------
        alloc = torch.arange(P, dtype=torch.int32, device=dev) < self.pt_count
        pc3 = torch.floor(div(self.pts, res)).to(torch.int32)
        pkeep = alloc & vox_keep_of_coords(pc3)
        new_id = torch.cumsum(pkeep.to(torch.int32), 0, dtype=torch.int32) - 1
        idmap = torch.where(pkeep, new_id, -1)
        pts = torch.zeros_like(self.pts)
        pts_smooth = torch.zeros_like(self.pts_smooth)
        set_drop_group([pts, pts_smooth], new_id,
                       [self.pts, self.pts_smooth], pkeep)

        # ---- dedup grid rebuild (cells of surviving points) --------------
        dcell = _grid_coords(self.pts, cfg.pts_minimum_scale, tag=0)
        dedup = HashTable.create(self.dedup.capacity, self.dedup.max_probe,
                                 device=dev)
        dedup.insert(dcell, pkeep)

        # ---- per-voxel rows: move to new slots, remap member ids ---------
        row_ids = self.vox_pt_idx
        row_new = torch.where(row_ids >= 0,
                              idmap[row_ids.clamp(min=0).long()], -1)

        rows = {"vox_pt_idx": (row_new, -1), "vox_pts": (self.vox_pts, 0),
                "vox_pts_sm": (self.vox_pts_sm, 0), "vox_n": (self.vox_n, 0),
                "vox_new": (self.vox_new, 0),
                "vox_meshed": (self.vox_meshed, False)}
        moved = {n: torch.full_like(src, fill)
                 for n, (src, fill) in rows.items()}
        set_drop_group(list(moved.values()), vslots,
                       [src for src, _ in rows.values()], vok)

        self.copy_(replace(
            self, pts=pts, pts_smooth=pts_smooth,
            pt_count=torch.sum(pkeep.to(torch.int32)), dedup=dedup, vox=vox,
            **moved))
        return self, {"idmap": idmap, "slot_map": slot_map}
