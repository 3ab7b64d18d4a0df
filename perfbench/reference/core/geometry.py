"""Batched geometric primitives: analytic symmetric-3×3 eigendecomposition and
probabilistic plane fitting from running moments.

Port of immesh_tpu/core/geometry.py (reference src/voxel_loc.cpp:47-139
`init_plane` and :310-368 `updatePlane`), with the same branch-free
closed-form eigensolve and the isotropic-noise plane covariance
(docs/plane_cov.md):

    Σ_normal = σ̄² · Σ_{m≠min} (λ_m + λ_min) / (N·(λ_m − λ_min)²) · u_m u_mᵀ
    Σ_center = σ̄²/N · I
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.core.so3 import cross

_EPS = 1e-12


def _axis(i: int, like: torch.Tensor) -> torch.Tensor:
    """Unit axis i broadcast to like's shape, made on like's device (an
    element written from the host would be a copy and a sync)."""
    return torch.eye(3, dtype=like.dtype, device=like.device)[i].expand(
        like.shape)


def eigh3x3(A: torch.Tensor):
    """Analytic eigendecomposition of symmetric (..., 3, 3) matrices.

    Returns (eigvals, eigvecs) with eigvals ascending, eigvecs[..., :, k] the
    unit eigenvector for eigvals[..., k].  Trigonometric (Smith) eigenvalues +
    row-cross eigenvectors, with the reference's scalar and collapsed-vector
    fallbacks.
    """
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]

    q = (a00 + a11 + a22) / 3.0
    p1 = a01 * a01 + a02 * a02 + a12 * a12
    p2 = (a00 - q) ** 2 + (a11 - q) ** 2 + (a22 - q) ** 2 + 2.0 * p1
    p = torch.sqrt(torch.clamp(p2 / 6.0, min=_EPS))

    # r = det(B)/2 with B = (A - qI)/p
    b00, b11, b22 = (a00 - q) / p, (a11 - q) / p, (a22 - q) / p
    b01, b02, b12 = a01 / p, a02 / p, a12 / p
    detB = (
        b00 * (b11 * b22 - b12 * b12)
        - b01 * (b01 * b22 - b12 * b02)
        + b02 * (b01 * b12 - b11 * b02)
    )
    r = torch.clamp(detB / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0

    lam_max = q + 2.0 * p * torch.cos(phi)
    lam_min = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    lam_mid = 3.0 * q - lam_max - lam_min

    # near-scalar matrices (p2≈0): all eigenvalues = q
    scalar = p2 < 1e-10 * torch.clamp(q * q, min=1.0)
    lam_min = torch.where(scalar, q, lam_min)
    lam_mid = torch.where(scalar, q, lam_mid)
    lam_max = torch.where(scalar, q, lam_max)

    def eigvec_for(lam):
        # rows of (A - λI)
        r0 = torch.stack([a00 - lam, a01, a02], dim=-1)
        r1 = torch.stack([a01, a11 - lam, a12], dim=-1)
        r2 = torch.stack([a02, a12, a22 - lam], dim=-1)
        c01 = cross(r0, r1)
        c02 = cross(r0, r2)
        c12 = cross(r1, r2)
        n01 = torch.sum(c01 * c01, dim=-1)
        n02 = torch.sum(c02 * c02, dim=-1)
        n12 = torch.sum(c12 * c12, dim=-1)
        # pick the largest-magnitude cross product (branch-free)
        best12 = (n12 >= n01) & (n12 >= n02)
        best02 = (n02 >= n01) & ~best12
        v = torch.where(best12[..., None], c12,
                        torch.where(best02[..., None], c02, c01))
        # exact normalization; only the exactly-zero case takes a fixed axis
        nrm2 = torch.sum(v * v, dim=-1, keepdim=True)
        unit = v / torch.sqrt(torch.where(nrm2 > 0, nrm2,
                                          torch.ones_like(nrm2)))
        return torch.where(nrm2 > 0, unit, _axis(0, v))

    v_min = eigvec_for(lam_min)
    v_max = eigvec_for(lam_max)
    # orthonormalize: protect against degenerate (repeated-eigenvalue) cases
    v_max = v_max - torch.sum(v_max * v_min, dim=-1, keepdim=True) * v_min
    vmn = torch.sqrt(torch.clamp(torch.sum(v_max * v_max, dim=-1, keepdim=True),
                                 min=_EPS))
    # fallback basis when v_max collapsed onto v_min
    alt = cross(v_min, _axis(0, v_min))
    alt2 = cross(v_min, _axis(1, v_min))
    alt = torch.where(torch.sum(alt * alt, dim=-1, keepdim=True) > 1e-6,
                      alt, alt2)
    alt = alt / torch.sqrt(torch.clamp(
        torch.sum(alt * alt, dim=-1, keepdim=True), min=_EPS))
    collapsed = vmn[..., 0] < 1e-5
    v_max = torch.where(collapsed[..., None], alt, v_max / vmn)
    v_mid = cross(v_min, v_max)

    # fully-scalar case: identity basis
    eye = torch.eye(3, dtype=A.dtype, device=A.device).expand(A.shape)
    vecs = torch.stack([v_min, v_mid, v_max], dim=-1)  # columns = ascending
    vecs = torch.where(scalar[..., None, None], eye, vecs)

    vals = torch.stack([lam_min, lam_mid, lam_max], dim=-1)
    return vals, vecs


def plane_from_moments(sum_p: torch.Tensor, sum_ppT: torch.Tensor,
                       count: torch.Tensor, sigma2_mean: torch.Tensor,
                       min_count: int = 5, anchor: torch.Tensor = None):
    """Fit planes from per-voxel running moments, batched over voxels.

    sum_p (..., 3) Σ(p − anchor), sum_ppT (..., 3, 3), count (...,),
    sigma2_mean (...,), anchor (..., 3) or None.  Returns a dict of
    normal, d, center, lam (ascending), cov_nn, var_c and valid (N ≥
    min_count), as immesh_tpu.core.geometry.plane_from_moments does.
    """
    n = torch.clamp(count.to(sum_p.dtype), min=1.0)
    mean = sum_p / n[..., None]
    cov = sum_ppT / n[..., None, None] - mean[..., :, None] * mean[..., None, :]
    # symmetrize against accumulation drift
    cov = 0.5 * (cov + cov.transpose(-1, -2))
    lam, vecs = eigh3x3(cov)
    normal = vecs[..., :, 0]  # min-eigenvalue column
    if anchor is not None:
        mean = mean + anchor
    d = -torch.sum(normal * mean, dim=-1)

    lam_min = lam[..., 0]
    contrib = []
    for m in (1, 2):
        dlam = torch.clamp(lam[..., m] - lam_min, min=1e-8)
        w = sigma2_mean * (lam[..., m] + lam_min) / (n * dlam * dlam)
        u = vecs[..., :, m]
        contrib.append(w[..., None, None] * u[..., :, None] * u[..., None, :])
    cov_nn = contrib[0] + contrib[1]
    var_c = sigma2_mean / n

    valid = count >= min_count
    return {
        "normal": normal, "d": d, "center": mean, "lam": lam,
        "cov_nn": cov_nn, "var_c": var_c, "valid": valid,
    }


def point_to_plane_sigma2(q_world, point_cov_world, normal, center, cov_nn,
                          var_c) -> torch.Tensor:
    """Variance of the point-to-plane distance for the probabilistic gate:
    (q−c)ᵀ Σ_nn (q−c) + σ_c² + nᵀ Σ_p n (reference voxel_mapping.cpp:246-269)."""
    qc = q_world - center
    s_plane = torch.einsum("...i,...ij,...j->...", qc, cov_nn, qc) + var_c
    s_point = torch.einsum("...i,...ij,...j->...", normal, point_cov_world,
                           normal)
    return s_plane + s_point


def lidar_point_cov_body(pts_body: torch.Tensor, range_err: float,
                         bearing_err: float) -> torch.Tensor:
    """Per-point measurement covariance in the body frame, (..., 3, 3):
    range noise along the beam + bearing noise growing with range
    (reference `calcBodyVar`, voxel_mapping.cpp:1221-1241)."""
    r = torch.linalg.norm(pts_body, dim=-1, keepdim=True)
    r = torch.clamp(r, min=1e-4)
    dirv = pts_body / r
    use2 = torch.abs(dirv[..., 2:3]) > 0.99
    refv = torch.where(use2, _axis(0, dirv), _axis(2, dirv))
    t1 = cross(dirv, refv)
    t1 = t1 / torch.clamp(torch.linalg.norm(t1, dim=-1, keepdim=True), min=1e-8)
    t2 = cross(dirv, t1)
    sr2 = range_err ** 2
    st2 = (bearing_err * r[..., 0]) ** 2  # tangential std grows with range
    return (
        sr2 * dirv[..., :, None] * dirv[..., None, :]
        + st2[..., None, None] * (t1[..., :, None] * t1[..., None, :]
                                  + t2[..., :, None] * t2[..., None, :])
    )
