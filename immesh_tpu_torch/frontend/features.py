"""Optional LOAM-style feature extraction (plane / edge classification).

Port of immesh_tpu/frontend/features.py (host NumPy, unchanged).

Re-design of the reference's `give_feature` path (reference
src/preprocess.cpp:900-1210 with `plane_judge` :1223 and `edge_jump_judge`
:1338, types preprocess.h:53-93): the reference walks each scan ring with
pointer-state machines classifying points into {Real_Plane, Poss_Plane,
Edge_Jump, Edge_Plane, Wire, ZeroPoint}.  Disabled by default in every
shipped config (`feature_extract_en: 0` — the voxel map consumes raw points),
but part of the public surface, so provided here as a vectorized per-ring
pass over the same signals:

  * smoothness: LOAM curvature ‖Σ_w (p_j − p_i)‖ / (w·r_i) over a ±w window;
  * plane points: lowest-curvature points per azimuth sector (Real_Plane);
  * edge points: highest-curvature points, rejecting occlusion edges (depth
    gap toward the sensor on one side, edge_jump_judge's Nr_zero/Nr_blind)
    and near-parallel beams (grazing incidence, preprocess.cpp:1190-1205).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class FeatureConfig:
    window: int = 5              # half-window for curvature (LOAM classic)
    n_sectors: int = 6           # azimuth sectors per ring (LOAM splits scans)
    max_planes_per_sector: int = 40
    max_edges_per_sector: int = 4
    # thresholds are relative to the ring's median curvature — the absolute
    # LOAM curvature scale depends on the sensor's angular resolution
    plane_rel: float = 3.0       # plane: curv < plane_rel·median
    plane_curv_max: float = 0.01  # …and below this absolute cap
    edge_rel: float = 8.0        # edge: curv > edge_rel·median
    edge_curv_min: float = 2e-3  # …and above this absolute floor
    occlusion_gap: float = 0.5   # m depth jump ⇒ occlusion edge, reject
    parallel_dot: float = 0.9998  # |cos| beam·surface ⇒ grazing, reject


def extract_features(xyz: np.ndarray, ring: np.ndarray, t_rel: np.ndarray,
                     cfg: FeatureConfig = FeatureConfig()
                     ) -> Tuple[np.ndarray, np.ndarray]:
    """Classify points into (surf_mask, edge_mask), both (N,) bool.

    Points are processed per ring in acquisition order (t_rel).
    """
    n = len(xyz)
    surf = np.zeros(n, bool)
    edge = np.zeros(n, bool)
    if n == 0:
        return surf, edge
    r = np.linalg.norm(xyz, axis=1)

    for rg in np.unique(ring):
        idx = np.where(ring == rg)[0]
        if len(idx) < 2 * cfg.window + 2:
            continue
        idx = idx[np.argsort(t_rel[idx], kind="stable")]
        p = xyz[idx]
        ri = r[idx]
        m = len(idx)
        w = cfg.window

        # LOAM curvature via sliding window sum
        csum = np.cumsum(np.vstack([np.zeros((1, 3)), p]), axis=0)
        win = csum[2 * w + 1:] - csum[:-2 * w - 1]      # Σ over [i-w, i+w]
        diff = win - (2 * w + 1) * p[w:m - w]
        curv = np.linalg.norm(diff, axis=1) / ((2 * w) * np.maximum(
            ri[w:m - w], 1e-6))
        curv_full = np.full(m, np.inf)
        curv_full[w:m - w] = curv

        # occlusion-edge rejection: depth discontinuity to either neighbor,
        # dilated by the curvature window (every point whose window straddles
        # the jump carries contaminated curvature)
        gap_next = np.abs(np.diff(ri, append=ri[-1]))
        gap_prev = np.abs(np.diff(ri, prepend=ri[0]))
        occ0 = (gap_next > cfg.occlusion_gap) | (gap_prev > cfg.occlusion_gap)
        occluded = np.convolve(
            occ0.astype(np.int32), np.ones(2 * w + 1, np.int32), "same") > 0

        # grazing-incidence rejection: beam nearly parallel to local surface
        d_prev = p - np.roll(p, 1, axis=0)
        nrm = np.linalg.norm(d_prev, axis=1) * np.maximum(ri, 1e-6)
        cosb = np.abs(np.einsum("ij,ij->i", d_prev, p)) / np.maximum(nrm, 1e-9)
        grazing = cosb > cfg.parallel_dot

        med = np.median(curv) + 1e-9
        plane_thr = min(cfg.plane_rel * med, cfg.plane_curv_max)
        edge_thr = max(cfg.edge_rel * med, cfg.edge_curv_min)

        # sector-wise selection (LOAM splits each ring into sectors and takes
        # the best candidates of each — keeps features spatially spread)
        sector = np.minimum(
            (np.arange(m) * cfg.n_sectors) // m, cfg.n_sectors - 1)
        for s in range(cfg.n_sectors):
            sm = np.where(sector == s)[0]
            if len(sm) == 0:
                continue
            order = np.argsort(curv_full[sm], kind="stable")
            # planes: lowest curvature below threshold
            cand = sm[order]
            good = cand[
                (curv_full[cand] < plane_thr)
                & ~grazing[cand]][: cfg.max_planes_per_sector]
            surf[idx[good]] = True
            # edges: highest curvature above threshold, not occlusion artifacts
            cand_e = sm[order[::-1]]
            good_e = cand_e[
                np.isfinite(curv_full[cand_e])
                & (curv_full[cand_e] > edge_thr)
                & ~occluded[cand_e]][: cfg.max_edges_per_sector]
            edge[idx[good_e]] = True

    return surf, edge
