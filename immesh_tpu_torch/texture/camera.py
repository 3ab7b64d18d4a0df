"""Batched pinhole camera model + image sampling.

Port of immesh_tpu/texture/camera.py (reference
src/meshing/r3live/image_frame.{hpp,cpp}: `set_intrinsic` :94-107,
`project_3d_point_in_this_img` :323-339, sub-pixel sampling `getSubPixel`
:184-204, gamma/exposure response :206-260): projection and colour
sampling are single batched ops over all candidate points, on the device
of the tensors passed in.

Images are float32 (H, W, C) tensors in [0, 255]; poses are world→camera
(R_w2c, t_w2c) so `p_cam = R_w2c @ p_world + t_w2c`, matching the reference's
`m_pose_c2w_*` refresh (image_frame.cpp:76-83, inverted convention).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch


@dataclass(frozen=True)
class PinholeCamera:
    """Intrinsics + response parameters (image_frame.cpp:94-107, gamma :52-53).

    Plain Python numbers; each enters the f32 ops as an f32 scalar."""

    fx: float
    fy: float
    cx: float
    cy: float
    width: int = 640
    height: int = 480
    # linear photometric response y = gamma0 * x + gamma1 (m_gama_para)
    gamma0: float = 1.0
    gamma1: float = 0.0

    @classmethod
    def create(cls, fx, fy, cx, cy, width, height) -> "PinholeCamera":
        return cls(fx=float(fx), fy=float(fy), cx=float(cx), cy=float(cy),
                   width=int(width), height=int(height))

    @classmethod
    def from_K(cls, K, width, height) -> "PinholeCamera":
        K = torch.as_tensor(K, dtype=torch.float32)
        return cls.create(K[0, 0], K[1, 1], K[0, 2], K[1, 2], width, height)


def project_points(pts_w: torch.Tensor, R_w2c: torch.Tensor,
                   t_w2c: torch.Tensor, cam: PinholeCamera,
                   margin: float = 1.0
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """World points → pixel coords.

    Returns (uv (N,2) float32, depth (N,), ok (N,) bool).  `ok` requires
    positive depth and the pixel inside the image with `margin` px border —
    the reference's in-image test (image_frame.cpp:323-339 returns false for
    out-of-frame / behind-camera points).
    """
    p_cam = pts_w @ R_w2c.T + t_w2c
    z = p_cam[:, 2]
    zs = torch.where(z.abs() < 1e-6, torch.full_like(z, 1e-6), z)
    u = cam.fx * p_cam[:, 0] / zs + cam.cx
    v = cam.fy * p_cam[:, 1] / zs + cam.cy
    ok = ((z > 1e-3)
          & (u >= margin) & (u <= cam.width - 1 - margin)
          & (v >= margin) & (v <= cam.height - 1 - margin))
    return torch.stack([u, v], dim=-1), z, ok


def bilinear_sample(img: torch.Tensor, uv: torch.Tensor) -> torch.Tensor:
    """Sample (H, W, C) image at continuous (u=col, v=row) coords, (N, 2)→(N, C).

    Bilinear, clamped at borders — replaces the reference's per-pixel
    `getSubPixel` template (image_frame.cpp:184-204) with one batched gather.
    """
    H, W = img.shape[0], img.shape[1]
    u = uv[:, 0].clamp(0.0, W - 1.0)
    v = uv[:, 1].clamp(0.0, H - 1.0)
    u0 = torch.floor(u).long()
    v0 = torch.floor(v).long()
    u1 = torch.clamp(u0 + 1, max=W - 1)
    v1 = torch.clamp(v0 + 1, max=H - 1)
    fu = (u - u0.to(u.dtype))[:, None]
    fv = (v - v0.to(v.dtype))[:, None]
    i00 = img[v0, u0]
    i01 = img[v0, u1]
    i10 = img[v1, u0]
    i11 = img[v1, u1]
    top = i00 * (1 - fu) + i01 * fu
    bot = i10 * (1 - fu) + i11 * fu
    return top * (1 - fv) + bot * fv


def sample_with_gradient(img: torch.Tensor, uv: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Bilinear value + central-difference image gradients at uv.

    Returns (val (N,C), d/du (N,C), d/dv (N,C)); mirrors the optional
    rgb_dx/rgb_dy outputs of the reference's `get_rgb`
    (image_frame.cpp:206-245).
    """
    du = torch.tensor([[0.5, 0.0]], dtype=img.dtype, device=img.device)
    dv = torch.tensor([[0.0, 0.5]], dtype=img.dtype, device=img.device)
    val = bilinear_sample(img, uv)
    gx = bilinear_sample(img, uv + du) - bilinear_sample(img, uv - du)
    gy = bilinear_sample(img, uv + dv) - bilinear_sample(img, uv - dv)
    return val, gx, gy


def to_gray(img: torch.Tensor) -> torch.Tensor:
    """RGB (H,W,3) → luma (H,W), BT.601 weights (cv::cvtColor RGB2GRAY)."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype, device=img.device)
    return img @ w
