"""Quantitative mesh-quality metrics against an analytic ground truth — the
NumPy part of immesh_tpu/eval/mesh_quality.py (the scipy oracle mesh over a
recorded map is not ported).

The reference has NO mesh-accuracy harness — its verification is visual
(GUI screenshots, reference README.md:136-141).  Our simulator's scene is a
set of bounded planes (frontend/sim.py Rect), so vertex-to-surface distance
has a closed form and mesh quality becomes a regression number:

  * `vertex_surface_rms` — RMS / p95 of each mesh vertex's distance to the
    nearest scene rectangle (reconstruction accuracy);
  * `hole_stats` — edge-manifold accounting: an interior edge is shared by
    exactly two triangles, so the boundary-edge fraction measures hole/crack
    density (the reference's visual "watertightness").
"""

from __future__ import annotations

from typing import Dict, Sequence

import numpy as np


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

