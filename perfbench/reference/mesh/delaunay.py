"""Batched bounded 2-D Delaunay triangulation — the main-path part of
immesh_tpu/mesh/delaunay.py (reference per-voxel CGAL call,
src/meshing/mesh_rec_geometry.cpp:174-295).

PCA plane projection, then the O(K³) dual edge-neighbor characterization:
for every directed edge i→j the Delaunay triangle on its left has the third
vertex k* minimizing the lifted-plane slope among points strictly left of
the edge, and a triangle (i, j, k) is Delaunay iff all three of its directed
edges agree.  The k-sweep argmin is kernels/pairs_argmin.py's plain version.  Cocircular ties are
broken by perturbing the lift with a hash of each point's identity, so every
voxel resolves a tie the same way.

"""

from __future__ import annotations

import functools
import math
from typing import Optional, Tuple

import numpy as np
import torch

from perfbench.reference.core.geometry import eigh3x3
from perfbench.reference.kernels.pairs_argmin import pairs_argmin


def pca_project(pts: torch.Tensor, mask: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Masked PCA plane projection, batched over voxels.

    pts: (A, K, 3), mask: (A, K) → (uv (A, K, 2), origin (A, 3), axes
    (A, 3, 3)) with axes columns [short(=normal), mid, long] ascending."""
    w = mask.to(pts.dtype)
    n = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1.0)
    mean = torch.sum(pts * w[..., None], dim=-2) / n
    q = (pts - mean[:, None, :]) * w[..., None]
    cov = torch.einsum("aki,akj->aij", q, q) / n[..., None]
    _, vecs = eigh3x3(cov)  # ascending; columns eigenvectors
    e_long = vecs[..., :, 2]
    e_mid = vecs[..., :, 1]
    rel = pts - mean[:, None, :]
    uv = torch.stack([
        torch.einsum("aki,ai->ak", rel, e_long),
        torch.einsum("aki,ai->ak", rel, e_mid),
    ], dim=-1)
    return uv, mean, vecs


def _lifted(uv: torch.Tensor, mask: torch.Tensor, eps_scale: float,
            tiebreak: Optional[torch.Tensor], tie_scale: float):
    """(u, v, lift, scale): the paraboloid lift u² + v² plus the
    identity-hash tie perturbation, and the per-voxel characteristic scale
    the epsilons are sized by."""
    A, K, _ = uv.shape
    u, v = uv[..., 0], uv[..., 1]
    lift = u * u + v * v
    zero = torch.zeros_like(u)
    scale = torch.clamp(
        torch.amax(torch.where(mask, torch.abs(u), zero), dim=-1)
        + torch.amax(torch.where(mask, torch.abs(v), zero), dim=-1),
        min=1e-3,
    )  # (A,)

    if tiebreak is None:
        tiebreak = torch.arange(K, dtype=torch.int32,
                                device=uv.device)[None].expand(A, K)
    tb = ((tiebreak * -1640531527) & 0xFFFF).to(uv.dtype) * (1.0 / 65536.0)
    eta = max(tie_scale, 256.0 * eps_scale) * scale * scale
    return u, v, lift + eta[:, None] * tb, scale


def pairs_channels(uv: torch.Tensor, mask: torch.Tensor,
                   eps_scale: float = 1e-6,
                   tiebreak: Optional[torch.Tensor] = None,
                   tie_scale: float = 256.0 * 1e-6):
    """The pairs-argmin inputs of delaunay_pairs_w: (u, v, lift, valid,
    d_eps), contiguous f32 — lift = u² + v² plus the identity-hash
    perturbation, valid 1.0/0.0, d_eps = eps_scale·scale² per voxel."""
    u, v, lift, scale = _lifted(uv, mask, eps_scale, tiebreak, tie_scale)
    d_eps = eps_scale * scale * scale                           # (A,)
    return (u.contiguous(), v.contiguous(), lift.contiguous(),
            mask.to(torch.float32).contiguous(), d_eps.contiguous())


@functools.lru_cache(maxsize=8)
def _tri_candidates_np(k: int) -> np.ndarray:
    idx = np.arange(k)
    i, j, l = np.meshgrid(idx, idx, idx, indexing="ij")
    m = (i < j) & (j < l)
    return np.stack([i[m], j[m], l[m]], axis=-1).astype(np.int32)


def delaunay_pairs_w(uv: torch.Tensor, mask: torch.Tensor,
                     eps_scale: float = 1e-6,
                     tiebreak: Optional[torch.Tensor] = None,
                     tie_scale: float = 256.0 * 1e-6
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Edge-neighbor Delaunay core: (W (A,K,K) int32 third-vertex table with
    −1 clamped to 0, emit (A,K,K) bool one-emission-per-triangle mask).  The
    triple for flat pair f = i·K + j is (i, j, W[f])."""
    A, K, _ = uv.shape
    W = pairs_argmin(*pairs_channels(uv, mask, eps_scale, tiebreak,
                                     tie_scale))
    has = W >= 0
    W = torch.clamp(W, min=0)

    # mutual agreement: W[i,j]=k ∧ W[j,k]=i ∧ W[k,i]=j, by integer gathers
    # of W/has at [a, j, k] and [a, k, i]
    ar = torch.arange(K, dtype=torch.int32, device=uv.device)
    ii, jj = ar[:, None], ar[None, :]
    Wf = W.reshape(A, K * K)
    hf = has.reshape(A, K * K)
    f_jk = (jj * K + W).reshape(A, K * K).long()
    f_ki = (W * K + ii).reshape(A, K * K).long()
    W_jk = torch.gather(Wf, 1, f_jk).reshape(A, K, K)
    h_jk = torch.gather(hf, 1, f_jk).reshape(A, K, K)
    W_ki = torch.gather(Wf, 1, f_ki).reshape(A, K, K)
    h_ki = torch.gather(hf, 1, f_ki).reshape(A, K, K)
    agree = has & h_jk & h_ki & (W_jk == ii) & (W_ki == jj)
    # emit each triangle once, from the directed edge leaving its min vertex
    emit = agree & (ii < jj) & (ii < W)
    return W, emit


def delaunay_pairs(uv: torch.Tensor, mask: torch.Tensor,
                   eps_scale: float = 1e-6,
                   tiebreak: Optional[torch.Tensor] = None,
                   tie_scale: float = 256.0 * 1e-6
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(trip (A, K², 3) int32 vertex index triples, keep (A, K²) bool) —
    delaunay_pairs_w with the triples materialized, for tests and small
    callers."""
    W, emit = delaunay_pairs_w(uv, mask, eps_scale=eps_scale,
                               tiebreak=tiebreak, tie_scale=tie_scale)
    A, K, _ = uv.shape
    ar = torch.arange(K, dtype=torch.int32, device=uv.device)
    trip = torch.stack([
        ar[:, None].expand(K, K)[None].expand(A, K, K),
        ar[None, :].expand(K, K)[None].expand(A, K, K),
        W,
    ], dim=-1).reshape(A, K * K, 3)
    return trip, emit.reshape(A, K * K)


def angle_filter(p0: torch.Tensor, p1: torch.Tensor, p2: torch.Tensor,
                 max_angle_deg: float) -> torch.Tensor:
    """Sliver filter on 3-D vertex triples (..., 3): max interior angle gate
    (reference is_face_is_ok, mesh_rec_geometry.cpp:40-57)."""
    def ang(a, b, c):
        u = b - a
        v = c - a
        cosv = torch.sum(u * v, dim=-1) / torch.clamp(
            torch.linalg.norm(u, dim=-1) * torch.linalg.norm(v, dim=-1),
            min=1e-12)
        return torch.arccos(torch.clamp(cosv, -1.0, 1.0))

    a0 = ang(p0, p1, p2)
    a1 = ang(p1, p2, p0)
    a2 = ang(p2, p0, p1)
    max_a = torch.maximum(a0, torch.maximum(a1, a2))
    return max_a < math.radians(max_angle_deg)


def compact_triangles(keep: torch.Tensor, cap: int):
    """Per-voxel compaction (A, T) bool → (rows (A, cap) candidate-row ids
    in ascending order, −1 pad; rmask (A, cap)).  Kept rows beyond `cap` are
    dropped — the first-cap-in-order semantics of the reference's top-k."""
    A, T = keep.shape
    dev = keep.device
    rank = torch.where(keep,
                       T - torch.arange(T, dtype=torch.int32, device=dev)[None],
                       -1)
    k = min(cap, T)
    top, rows = torch.sort(rank, dim=-1, descending=True, stable=True)
    top, rows = top[:, :k], rows[:, :k].to(torch.int32)
    if k < cap:
        top = torch.nn.functional.pad(top, (0, cap - k), value=-1)
        rows = torch.nn.functional.pad(rows, (0, cap - k))
    rmask = top > 0
    return torch.where(rmask, rows, -1), rmask
