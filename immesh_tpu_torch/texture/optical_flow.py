"""Pyramidal Lucas-Kanade optical flow — batched over features.

Port of immesh_tpu/texture/optical_flow.py (reference
src/meshing/optical_flow/lkpyramid.{hpp,cpp}, an OpenCV-derived scalar
pyramidal LK used by the texture-reconstruction application).  Each pyramid
level is one batched Gauss-Newton pass over ALL features: the JAX `vmap`
over features becomes an (N, P) patch gather, its `fori_loop` a fixed
Python loop of `iters` updates (no data-dependent early exit).

  * pyramid: 5-tap binomial blur + stride-2 decimation (same kernel family
    as cv::buildOpticalFlowPyramid), the blur taken as shifted sums in the
    reference's order of additions;
  * per level: gather the fixed-size patch around each feature from the
    previous image once, form the 2×2 structure tensor G, then a fixed
    number of masked iterations updating flow by solving G·δ = b (closed
    form 2×2);
  * coarse→fine: flow is upscaled ×2 between levels.

Status per feature mirrors the reference's checks: a feature fails if its
patch leaves the image or G is near-singular (min eigenvalue below
`min_eig_threshold`, cf. lkpyramid.cpp minEigThreshold handling).
"""

from __future__ import annotations

from typing import List, Tuple

import torch

from immesh_tpu_torch.core.ops import div

_BINOMIAL = (1.0 / 16.0, 4.0 / 16.0, 6.0 / 16.0, 4.0 / 16.0, 1.0 / 16.0)


def _blur5(img: torch.Tensor) -> torch.Tensor:
    """Separable 5-tap binomial blur, edge-clamped, (H, W) → (H, W)."""
    H, W = img.shape
    rows = torch.arange(-2, H + 2, device=img.device).clamp(0, H - 1)
    pad = img[rows]
    out = 0
    for i, k in enumerate(_BINOMIAL):
        out = out + k * pad[i:i + H]
    cols = torch.arange(-2, W + 2, device=img.device).clamp(0, W - 1)
    pad = out[:, cols]
    out = 0
    for i, k in enumerate(_BINOMIAL):
        out = out + k * pad[:, i:i + W]
    return out


def build_pyramid(img: torch.Tensor, levels: int) -> List[torch.Tensor]:
    """Grayscale (H, W) → list of `levels` images, level 0 = full resolution."""
    pyr = [img]
    for _ in range(levels - 1):
        pyr.append(_blur5(pyr[-1])[::2, ::2])
    return pyr


def _patch_coords(half: int, dtype, device) -> torch.Tensor:
    r = torch.arange(-half, half + 1, dtype=dtype, device=device)
    gy, gx = torch.meshgrid(r, r, indexing="ij")
    return torch.stack([gx.reshape(-1), gy.reshape(-1)], dim=-1)  # (P, 2) u,v


def _sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Bilinear sample of a (H, W) image at (..., 2) u(col), v(row) coords."""
    H, W = img.shape
    u = uv[..., 0].clamp(0.0, W - 1.001)
    v = uv[..., 1].clamp(0.0, H - 1.001)
    u0 = torch.floor(u).long()
    v0 = torch.floor(v).long()
    fu, fv = u - u0, v - v0
    i00 = img[v0, u0]
    i01 = img[v0, u0 + 1]
    i10 = img[v0 + 1, u0]
    i11 = img[v0 + 1, u0 + 1]
    return (i00 * (1 - fu) * (1 - fv) + i01 * fu * (1 - fv)
            + i10 * (1 - fu) * fv + i11 * fu * fv)


def _lk_level(prev: torch.Tensor, nxt: torch.Tensor, pts: torch.Tensor,
              flow: torch.Tensor, ok: torch.Tensor, half: int, iters: int,
              min_eig: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """One pyramid level of LK for all features: (N,2) flow refinement."""
    H, W = prev.shape
    offs = _patch_coords(half, pts.dtype, pts.device)    # (P, 2)
    base = pts[:, None, :] + offs                         # (N, P, 2)
    in_img = ((pts[:, 0] >= half + 1) & (pts[:, 0] <= W - half - 2)
              & (pts[:, 1] >= half + 1) & (pts[:, 1] <= H - half - 2))
    du = torch.tensor([0.5, 0.0], dtype=pts.dtype, device=pts.device)
    dv = torch.tensor([0.0, 0.5], dtype=pts.dtype, device=pts.device)
    tmpl = _sample(prev, base)
    gx = _sample(prev, base + du) - _sample(prev, base - du)
    gy = _sample(prev, base + dv) - _sample(prev, base - dv)
    gxx = (gx * gx).sum(-1)
    gxy = (gx * gy).sum(-1)
    gyy = (gy * gy).sum(-1)
    det = gxx * gyy - gxy * gxy
    tr = gxx + gyy
    eig_min = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0.0)))
    good = ok & in_img & (div(eig_min, offs.shape[0]) > min_eig)
    d = torch.where(det.abs() < 1e-9, torch.full_like(det, 1e-9), det)
    inv = torch.stack([torch.stack([gyy, -gxy], -1),
                       torch.stack([-gxy, gxx], -1)], -2) / d[:, None, None]

    f = flow
    for _ in range(iters):
        err = _sample(nxt, base + f[:, None, :]) - tmpl
        b = torch.stack([(err * gx).sum(-1), (err * gy).sum(-1)], -1)
        f = f - (inv @ b[:, :, None])[:, :, 0]
    return torch.where(good[:, None], f, flow), good


def lk_track(prev_pyr: List[torch.Tensor], next_pyr: List[torch.Tensor],
             pts: torch.Tensor, win: int = 21, iters: int = 10,
             min_eig: float = 1e-4) -> Tuple[torch.Tensor, torch.Tensor]:
    """Track (N, 2) feature points (u, v) from prev to next.

    Returns (pts_next (N,2), status (N,) bool).  Mirrors the reference
    tracker's interface (lkpyramid.hpp calc signature): window `win`,
    `iters` fixed iterations per level, coarse→fine over the shared pyramid.
    """
    if len(prev_pyr) != len(next_pyr):
        raise ValueError(f"pyramids of {len(prev_pyr)} and {len(next_pyr)} "
                         "levels")
    L = len(prev_pyr)
    half = win // 2
    flow = torch.zeros_like(pts)
    ok = torch.ones(pts.shape[0], dtype=torch.bool, device=pts.device)
    good = ok
    for lev in range(L - 1, -1, -1):
        p = pts / (2.0 ** lev)
        # coarse levels refine flow where the patch fits; only the finest
        # level decides trackability (a border point at a coarse level just
        # keeps the coarser flow estimate, as in the reference tracker)
        flow, good = _lk_level(prev_pyr[lev], next_pyr[lev], p, flow, ok,
                               half, iters, min_eig)
        if lev > 0:
            flow = flow * 2.0
    return pts + flow, ok & good
