"""Owner-computes triangle store + the per-frame incremental mesh step.

Port of immesh_tpu/mesh/triangles.py (reference triangle management,
src/meshing/r3live/triangle.{hpp,cpp}, and `triangle_compare`,
mesh_rec_geometry.cpp:137-172): every triangle is owned by the meshing voxel
its centroid falls in; a re-meshed voxel's triangle list is replaced
wholesale, so no global hash, lock or diff is needed.  Winding mirrors
`correct_triangle_index` (mesh_rec_geometry.cpp:399-433).

The reference's exact-f32 one-hot contractions and top-k payload keys were
TPU gather workarounds; here they are integer gathers with the same
outputs.  The store is updated in place and never rebound (the captured
mesh step replays at the addresses it was captured with).

MeshConfig.ablate's triangulation cuts ("skip_tri", "pull0", "argmin0",
"pairs0", "compact0", "fake_tri3", "tri30", "gather0", "sort30") stop a
chunk after the named stage and return the reference's empty result at that
point, so the active voxels' rows end up empty; "fake_tri3" instead runs the
chunk with a wrong third vertex.  The reference folds the cut prefix into
its outputs only so XLA cannot delete it; eager PyTorch runs every op it is
given, so the port does not.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch

from perfbench.reference.config import MeshConfig
from perfbench.reference.core.ops import div, set_drop_group
from perfbench.reference.core.so3 import cross
from perfbench.reference.device import resolve_device
from perfbench.reference.kernels import graph_cond
from perfbench.reference.kernels.pairs_argmin import pairs_argmin
from perfbench.reference.mesh.delaunay import (
    angle_filter, compact_triangles, delaunay_pairs_w, pca_project)
from perfbench.reference.mesh.global_map import GlobalPointMap
from perfbench.reference.utils.graphs import device_if


def _pos_hash(pts: torch.Tensor) -> torch.Tensor:
    """(…, 3) f32 → (…,) int32 hash of the position BITS — the cocircular
    tie key and canonical vertex order, a function of the point itself."""
    b = pts.contiguous().view(torch.int32)
    return (b[..., 0] * -1640531527
            ^ b[..., 1] * 668265263
            ^ b[..., 2] * 374761393)


@dataclass
class TriangleStore:
    tri_ids: torch.Tensor  # (V, C, 3) int32 global point ids, winding order; -1 pad
    tri_n: torch.Tensor    # (V,) int32 triangles per voxel
    dirty: torch.Tensor    # (V,) bool — re-meshed since last viz sync
    cfg: MeshConfig

    @classmethod
    def create(cls, cfg: MeshConfig, device="cuda") -> "TriangleStore":
        dev = resolve_device(device)
        V, C = cfg.voxel_capacity, cfg.tris_per_voxel
        return cls(
            tri_ids=torch.full((V, C, 3), -1, dtype=torch.int32, device=dev),
            tri_n=torch.zeros(V, dtype=torch.int32, device=dev),
            dirty=torch.zeros(V, dtype=torch.bool, device=dev),
            cfg=cfg,
        )

    def n_triangles(self) -> torch.Tensor:
        return torch.sum(self.tri_n)

    def clear_dirty(self) -> "TriangleStore":
        self.dirty.zero_()
        return self


def remap_store(store: TriangleStore, slot_map: torch.Tensor,
                idmap: torch.Tensor) -> TriangleStore:
    """Carry the store through a GlobalPointMap.compact, in place: move each
    surviving voxel's row to its new slot, rewrite vertex ids through the
    old→new point map, drop triangles that lost a vertex, and re-compact
    rows so tri_n stays the prefix length."""
    V, C, _ = store.tri_ids.shape
    ids = store.tri_ids
    remapped = torch.where(ids >= 0, idmap[ids.clamp(min=0).long()], -1)
    valid = torch.all(remapped >= 0, dim=-1)                   # (V, C)
    # stable per-row compaction: valid triangles first, order preserved
    order = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)
    packed = torch.gather(remapped, 1, order[..., None].expand(V, C, 3))
    vmask = torch.gather(valid, 1, order)
    packed = torch.where(vmask[..., None], packed, -1)
    counts = torch.sum(vmask, dim=-1).to(torch.int32)

    keep = slot_map >= 0
    store.tri_ids.fill_(-1)
    store.tri_n.zero_()
    store.dirty.zero_()
    # everything moved: let the viewer resync every surviving region
    set_drop_group([store.tri_ids, store.tri_n, store.dirty], slot_map,
                   [packed, counts, True], keep)
    return store


def mesh_voxels(gm: GlobalPointMap, store: TriangleStore,
                slots: torch.Tensor, smask: torch.Tensor,
                sensor_pos: torch.Tensor, chunk: int = 16):
    """Re-triangulate the active voxels and replace their triangle lists.
    Returns (store, n_emitted, n_dropped)."""
    ids, counts, dropped = triangulate_voxels(
        gm, slots, smask, sensor_pos, store.cfg, chunk)
    n_emitted = torch.sum(torch.where(smask, counts, 0))
    return apply_triangles(store, slots, smask, ids, counts), n_emitted, dropped


def apply_triangles(store: TriangleStore, slots: torch.Tensor,
                    smask: torch.Tensor, ids: torch.Tensor,
                    counts: torch.Tensor) -> TriangleStore:
    """Replace the owning voxels' triangle lists wholesale, in place."""
    set_drop_group([store.tri_ids, store.tri_n, store.dirty], slots,
                   [ids, counts, True], smask)
    return store


def _gather_rows(x: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """x (a, R, ...) at rows (a, r) → (a, r, ...)."""
    idx = rows.long().reshape(rows.shape + (1,) * (x.dim() - 2))
    return torch.gather(x, 1, idx.expand(rows.shape + x.shape[2:]))


def _sort3(k0, k1, k2, a0, a1, a2, p0, p1, p2):
    """Order three vertices by ascending key (a 3-element sorting network)."""
    def sw(c, x, y):
        c = c.reshape(c.shape + (1,) * (x.dim() - c.dim()))
        return torch.where(c, y, x), torch.where(c, x, y)

    c = k0 > k1
    k0, k1 = sw(c, k0, k1)
    a0, a1 = sw(c, a0, a1)
    p0, p1 = sw(c, p0, p1)
    c = k1 > k2
    k1, k2 = sw(c, k1, k2)
    a1, a2 = sw(c, a1, a2)
    p1, p2 = sw(c, p1, p2)
    c = k0 > k1
    a0, a1 = sw(c, a0, a1)
    p0, p1 = sw(c, p0, p1)
    return a0, a1, a2, p0, p1, p2


def _empty(a: int, C: int, device):
    """The result of a chunk with nothing triangulated: (ids, counts, drops)."""
    return (torch.full((a, C, 3), -1, dtype=torch.int32, device=device),
            torch.zeros(a, dtype=torch.int32, device=device),
            torch.zeros((), dtype=torch.int32, device=device))


def _chunk_impl(pts_c, sm_c, pmask_c, gidx_c, key_c, sensor_pos,
                cfg: MeshConfig):
    """Triangulate one chunk of voxels: (ids (a, C, 3), counts (a,), drops)."""
    a, K = pts_c.shape[0], pts_c.shape[1]
    C = cfg.tris_per_voxel
    C2 = min(4 * C, 2 * cfg.pull_capacity)
    cut, dev = cfg.ablate, pts_c.device
    if cut == "pull0":
        return _empty(a, C, dev)
    uv, _, _ = pca_project(sm_c, pmask_c)
    phash = _pos_hash(pts_c)                                   # (a, K)
    if cut == "argmin0":
        # the reference's unperturbed lift and fixed d_eps
        u, v = uv[..., 0].contiguous(), uv[..., 1].contiguous()
        pairs_argmin(u, v, u * u + v * v, pmask_c.to(torch.float32),
                     torch.full((a,), 1e-6, dtype=torch.float32, device=dev))
        return _empty(a, C, dev)
    W, emit = delaunay_pairs_w(uv, pmask_c, tiebreak=phash,
                               tie_scale=cfg.tie_scale)        # (a, K, K) ×2
    keep = emit.reshape(a, K * K)
    if cut == "pairs0":
        return _empty(a, C, dev)

    rows, rmask = compact_triangles(keep, C2)                  # (a, C2)
    rowc = rows.clamp(min=0)
    t2 = torch.where(rmask, _gather_rows(W.reshape(a, K * K), rowc), 0)
    if cut == "compact0":
        return _empty(a, C, dev)
    drop1 = torch.sum(torch.clamp(
        torch.sum(keep.to(torch.int32), dim=-1) - C2, min=0))
    t0 = rowc // K
    t1 = rowc - t0 * K
    if cut == "fake_tri3":
        t2 = (t0 + t1) % K
    if cut == "tri30":
        return _empty(a, C, dev)

    v0, v1, v2 = (_gather_rows(pts_c, t) for t in (t0, t1, t2))
    i0, i1, i2 = (_gather_rows(gidx_c, t) for t in (t0, t1, t2))

    keep2 = rmask & angle_filter(v0, v1, v2, cfg.max_tri_angle_deg)
    if cut == "gather0":
        return _empty(a, C, dev)
    if cfg.max_edge_scale > 0:
        emax = cfg.max_edge_scale * cfg.pts_minimum_scale
        keep2 = keep2 & (
            (torch.linalg.norm(v1 - v0, dim=-1) < emax)
            & (torch.linalg.norm(v2 - v1, dim=-1) < emax)
            & (torch.linalg.norm(v0 - v2, dim=-1) < emax)
        )

    # canonical vertex order (ascending position hash) so the centroid is
    # bitwise identical in every voxel that generates this triangle
    s0, s1, s2, q0, q1, q2 = _sort3(_pos_hash(v0), _pos_hash(v1),
                                    _pos_hash(v2), i0, i1, i2, v0, v1, v2)
    cen = ((q0 + q1) + q2) * (1.0 / 3.0)
    cen_key = torch.floor(div(cen, cfg.voxel_resolution)).to(torch.int32)
    keep2 = keep2 & torch.all(cen_key == key_c[:, None, :], dim=-1)
    if cut == "sort30":
        return _empty(a, C, dev)

    rows2, rmask2 = compact_triangles(keep2, C)                # (a, C)
    drop2 = torch.sum(torch.clamp(
        torch.sum(keep2.to(torch.int32), dim=-1) - C, min=0))
    r2 = rows2.clamp(min=0)
    ids = torch.stack([_gather_rows(s, r2) for s in (s0, s1, s2)], dim=-1)
    w0, w1, w2 = (_gather_rows(q, r2) for q in (q0, q1, q2))

    # winding: flip so the normal faces the sensor (correct_triangle_index)
    nrm = cross(w1 - w0, w2 - w0)
    cen3 = ((w0 + w1) + w2) * (1.0 / 3.0)
    flip = torch.sum(nrm * (sensor_pos - cen3), dim=-1) < 0
    ids = torch.where(flip[..., None], torch.stack(
        [ids[..., 0], ids[..., 2], ids[..., 1]], dim=-1), ids)
    ids = torch.where(rmask2[..., None], ids, -1)
    return (ids, rmask2.sum(dim=-1).to(torch.int32),
            (drop1 + drop2).to(torch.int32))


def triangulate_voxels(gm: GlobalPointMap, slots: torch.Tensor,
                       smask: torch.Tensor, sensor_pos: torch.Tensor,
                       cfg: MeshConfig, chunk: int = 16):
    """Pure compute: active voxels → (ids (A, C, 3) global point ids,
    counts (A,), dropped ()) — pull → PCA project → Delaunay → filters →
    ownership → winding (reference ImMesh_mesh_reconstruction.cpp:92-267).

    Chunks of `chunk` voxels are triangulated one launch each, a chunk with
    no active point skipped, as the reference's lax.cond skips it: an IF
    node of the captured mesh step (utils/graphs.py::device_if), a host
    read of the chunk's mask in the eager step.  ids, counts and dropped
    hold the empty result before the loop (the reference's false branch),
    and a chunk's body writes its rows and adds its drops in place."""
    A = slots.shape[0]
    C = cfg.tris_per_voxel
    dev = slots.device
    if cfg.ablate == "skip_tri":
        return _empty(A, C, dev)
    pull = gm.pull_neighborhood(slots, smask)
    pts, pmask, gidx = pull["pts"], pull["mask"], pull["idx"]
    pts_sm = pull["pts_sm"]  # smoothed geometry feeds the PCA/Delaunay
    vox_key = gm.vox.keys[slots.clamp(min=0).long(), :3]         # (A, 3)

    ids, counts, dropped = _empty(A, C, dev)

    def body(sl):
        i_c, n_c, d_c = _chunk_impl(pts[sl], pts_sm[sl], pmask[sl], gidx[sl],
                                    vox_key[sl], sensor_pos, cfg)
        ids[sl] = i_c
        counts[sl] = n_c
        dropped.add_(d_c)

    for c0 in range(0, A, chunk):
        sl = slice(c0, c0 + chunk)
        # the set launch reads the chunk's rows of the mask in place
        device_if(graph_cond.any_of(pmask[sl]), functools.partial(body, sl),
                  "chunk")
    return ids, counts, dropped
