"""Quantitative mesh-quality metrics against an analytic ground truth — port
of immesh_tpu/eval/mesh_quality.py.

The reference has NO mesh-accuracy harness — its verification is visual
(GUI screenshots, reference README.md:136-141).  Our simulator's scene is a
set of bounded planes (frontend/sim.py Rect), so vertex-to-surface distance
has a closed form and mesh quality becomes a regression number:

  * `vertex_surface_rms` — RMS / p95 of each mesh vertex's distance to the
    nearest scene rectangle (reconstruction accuracy);
  * `hole_stats` — edge-manifold accounting: an interior edge is shared by
    exactly two triangles, so the boundary-edge fraction measures hole/crack
    density (the reference's visual "watertightness");
  * `mesh_quality_report` — one dict with both + triangle/vertex counts;
  * `oracle_mesh_from_map` / `oracle_boundary_stats` — the reference's
    per-voxel meshing geometry (scipy Delaunay) over a recorded map's own
    pulled neighbourhoods, to tell kernel-made cracks from sampling ones.
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np
import torch


def point_rect_distance(pts: np.ndarray, rect) -> np.ndarray:
    """(N, 3) points → (N,) Euclidean distance to a bounded plane patch."""
    d = pts - rect.center[None, :]
    h = d @ rect.normal                       # out-of-plane
    u = d @ rect.t1
    v = d @ rect.t2
    du = np.maximum(np.abs(u) - rect.e1, 0.0)
    dv = np.maximum(np.abs(v) - rect.e2, 0.0)
    return np.sqrt(h * h + du * du + dv * dv)


def vertex_surface_distance(verts: np.ndarray,
                            scene: Sequence) -> np.ndarray:
    """(N, 3) vertices → (N,) distance to the nearest scene rect."""
    if len(verts) == 0:
        return np.zeros(0)
    d = np.full(len(verts), np.inf)
    for rect in scene:
        d = np.minimum(d, point_rect_distance(verts, rect))
    return d


def hole_stats(faces: np.ndarray) -> Dict[str, float]:
    """Edge-manifold accounting over (T, 3) triangle vertex ids."""
    if len(faces) == 0:
        return {"n_edges": 0, "boundary_edges": 0, "boundary_fraction": 1.0,
                "nonmanifold_edges": 0}
    e = np.concatenate([faces[:, [0, 1]], faces[:, [1, 2]], faces[:, [2, 0]]])
    e = np.sort(e, axis=1)
    _, counts = np.unique(e, axis=0, return_counts=True)
    n = len(counts)
    boundary = int(np.sum(counts == 1))
    nonmanifold = int(np.sum(counts > 2))
    return {"n_edges": n, "boundary_edges": boundary,
            "boundary_fraction": boundary / n,
            "nonmanifold_edges": nonmanifold}


def mesh_quality_report(verts: np.ndarray, faces: np.ndarray,
                        scene: Sequence) -> Dict[str, float]:
    """Full report for (verts (P,3), faces (T,3) ids, scene rect list).
    Only vertices referenced by a face are scored (the point store holds
    unmeshed points too)."""
    used = np.unique(faces.reshape(-1)) if len(faces) else np.zeros(0, int)
    dist = vertex_surface_distance(verts[used], scene)
    rep = {
        "n_triangles": int(len(faces)),
        "n_vertices": int(len(used)),
        "rms_m": float(np.sqrt(np.mean(dist ** 2))) if len(dist) else 0.0,
        "p95_m": float(np.percentile(dist, 95)) if len(dist) else 0.0,
        "max_m": float(dist.max()) if len(dist) else 0.0,
    }
    rep.update(hole_stats(faces))
    return rep


def store_faces(store) -> np.ndarray:
    """TriangleStore → (T, 3) valid triangle id rows (host)."""
    t = store.tri_ids.reshape(-1, 3).cpu().numpy()
    return t[np.all(t >= 0, axis=1)]


def _max_corner_angle_deg(v: np.ndarray) -> np.ndarray:
    """(T, 3, 3) triangle vertices → (T,) largest interior angle, degrees."""
    def ang(a, b, c):
        u, w = b - a, c - a
        cosv = np.einsum("ij,ij->i", u, w) / np.maximum(
            np.linalg.norm(u, axis=1) * np.linalg.norm(w, axis=1), 1e-12)
        return np.degrees(np.arccos(np.clip(cosv, -1.0, 1.0)))
    a0 = ang(v[:, 0], v[:, 1], v[:, 2])
    a1 = ang(v[:, 1], v[:, 2], v[:, 0])
    return np.maximum(a0, np.maximum(a1, 180.0 - a0 - a1))


def oracle_mesh_from_map(gm, max_voxels: int = 4096, batch: int = 512,
                         max_angle_deg: float = 150.0,
                         seed: int = 0) -> np.ndarray:
    """Reference-algorithm oracle mesh over a RECORDED map state.

    Runs the reference's per-voxel meshing geometry (reference
    mesh_rec_geometry.cpp:174-295: PCA plane projection → exact 2-D Delaunay
    → max-angle sliver filter, with CGAL stood in by scipy/qhull — the
    oracle already accepted by tests/test_mesh.py) over the SAME pulled
    point neighborhoods the meshing pipeline consumes (pulled on the map's
    device, batch by batch), and unions the per-voxel
    triangulations with sorted-id dedup (the reference's triangle hash,
    triangle.hpp:330-356).  The result is what the reference pipeline would
    produce on identical point sets — comparing its boundary-edge fraction
    against the store's isolates kernel-induced cracks from
    sampling-induced ones.

    Returns (T, 3) global point-id faces.
    """
    from scipy.spatial import Delaunay as SciDelaunay
    from scipy.spatial import QhullError

    dev = gm.pts.device
    vox_n = gm.vox_n.cpu().numpy()
    slots = np.where(vox_n >= 3)[0]
    if len(slots) > max_voxels:
        rng = np.random.default_rng(seed)
        slots = np.sort(rng.choice(slots, max_voxels, replace=False))

    tris = set()
    for i in range(0, len(slots), batch):
        sl = slots[i:i + batch]
        pad = batch - len(sl)
        s = np.concatenate([sl, np.zeros(pad, np.int64)]).astype(np.int32)
        m = np.concatenate([np.ones(len(sl), bool), np.zeros(pad, bool)])
        pull = gm.pull_neighborhood(torch.from_numpy(s).to(dev),
                                    torch.from_numpy(m).to(dev))
        idx = pull["idx"].cpu().numpy()
        pts = pull["pts_sm"].cpu().numpy()
        pm = pull["mask"].cpu().numpy()
        for a in range(len(sl)):
            ok = pm[a]
            if int(ok.sum()) < 3:
                continue
            p3 = pts[a][ok].astype(np.float64)
            gi = idx[a][ok]
            c = p3.mean(axis=0)
            x = p3 - c
            # PCA long/mid axes = the reference's projection plane
            _, _, vt = np.linalg.svd(x, full_matrices=False)
            uv = x @ vt[:2].T
            try:
                dt = SciDelaunay(uv, qhull_options="QJ")
            except (QhullError, ValueError):
                continue
            if len(dt.simplices) == 0:
                continue
            v = p3[dt.simplices]                      # (T, 3, 3)
            keep = _max_corner_angle_deg(v) <= max_angle_deg
            for t in dt.simplices[keep]:
                tris.add(tuple(sorted(int(g) for g in gi[t])))
    if not tris:
        return np.zeros((0, 3), np.int64)
    return np.array(sorted(tris), np.int64)


def oracle_boundary_stats(gm, **kw) -> Dict[str, float]:
    """hole_stats of the oracle mesh (see oracle_mesh_from_map)."""
    return hole_stats(oracle_mesh_from_map(gm, **kw))
