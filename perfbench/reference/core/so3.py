"""SO(3) utilities — batched, Taylor-guarded at small angles.

Port of immesh_tpu/core/so3.py (reference include/so3_math.h:12-76): Exp /
Log / skew and the right Jacobians, broadcasting over leading batch axes.
"""

from __future__ import annotations

import torch

_EPS = 1e-8


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product over the last axis, broadcasting like jnp.cross and with
    its operation order (a1·b2 − a2·b1, a2·b0 − a0·b2, a0·b1 − a1·b0)."""
    a0, a1, a2 = a[..., 0], a[..., 1], a[..., 2]
    b0, b1, b2 = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([a1 * b2 - a2 * b1, a2 * b0 - a0 * b2,
                        a0 * b1 - a1 * b0], dim=-1)


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def hat(w: torch.Tensor) -> torch.Tensor:
    """Skew-symmetric matrix; w: (..., 3) → (..., 3, 3)."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    z = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([z, -wz, wy], dim=-1),
            torch.stack([wz, z, -wx], dim=-1),
            torch.stack([-wy, wx, z], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """Inverse of hat; (..., 3, 3) → (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues exponential map; w: (..., 3) → (..., 3, 3)."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < _EPS
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta))
                    / torch.clamp(theta2, min=_EPS * _EPS))
    W = hat(w)
    W2 = W @ W
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * W2


def log(R: torch.Tensor) -> torch.Tensor:
    """Logarithm map; (..., 3, 3) → (..., 3), guarded near θ=0 and θ=π."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_theta = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_theta)
    w_hat = vee(R - R.transpose(-1, -2)) * 0.5  # = sinθ · axis
    sin_theta = torch.sqrt(torch.clamp(torch.sum(w_hat * w_hat, dim=-1),
                                       min=0.0))
    scale = torch.where(sin_theta < _EPS, torch.ones_like(theta),
                        theta / torch.clamp(sin_theta, min=_EPS))
    w = w_hat * scale[..., None]
    near_pi = cos_theta < -1.0 + 1e-6
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    axis_abs = torch.sqrt(torch.clamp((diag + 1.0) * 0.5, min=0.0))
    sx = torch.sign(R[..., 2, 1] - R[..., 1, 2])
    sy = torch.sign(R[..., 0, 2] - R[..., 2, 0])
    sz = torch.sign(R[..., 1, 0] - R[..., 0, 1])
    one = torch.ones_like(sx)
    sgn = torch.stack([torch.where(sx == 0, one, sx),
                       torch.where(sy == 0, one, sy),
                       torch.where(sz == 0, one, sz)], dim=-1)
    w_pi = axis_abs * sgn * theta[..., None]
    return torch.where(near_pi[..., None], w_pi, w)


def jr_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian: I + ½ŵ + (1/θ² − (1+cosθ)/(2θ sinθ)) ŵ²."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < _EPS
    coef = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        1.0 / torch.clamp(theta2, min=_EPS * _EPS)
        - (1.0 + torch.cos(theta))
        / torch.clamp(2.0 * theta * torch.sin(theta), min=_EPS),
    )
    W = hat(w)
    return _eye_like(W) + 0.5 * W + coef[..., None, None] * (W @ W)


def a_matrix(w: torch.Tensor) -> torch.Tensor:
    """Right Jacobian J_r(w) = I − (1−cosθ)/θ² ŵ + (θ−sinθ)/θ³ ŵ²."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS * _EPS))
    small = theta2 < _EPS
    b = torch.where(small, 0.5 - theta2 / 24.0,
                    (1.0 - torch.cos(theta))
                    / torch.clamp(theta2, min=_EPS * _EPS))
    c = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / torch.clamp(theta2 * theta, min=_EPS ** 3),
    )
    W = hat(w)
    return _eye_like(W) - b[..., None, None] * W + c[..., None, None] * (W @ W)


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z): (..., 4) → (..., 3, 3)."""
    qw, qx, qy, qz = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    r00 = 1 - 2 * (qy * qy + qz * qz)
    r01 = 2 * (qx * qy - qw * qz)
    r02 = 2 * (qx * qz + qw * qy)
    r10 = 2 * (qx * qy + qw * qz)
    r11 = 1 - 2 * (qx * qx + qz * qz)
    r12 = 2 * (qy * qz - qw * qx)
    r20 = 2 * (qx * qz - qw * qy)
    r21 = 2 * (qy * qz + qw * qx)
    r22 = 1 - 2 * (qx * qx + qy * qy)
    return torch.stack(
        [
            torch.stack([r00, r01, r02], dim=-1),
            torch.stack([r10, r11, r12], dim=-1),
            torch.stack([r20, r21, r22], dim=-1),
        ],
        dim=-2,
    )


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) → unit quaternion (w, x, y, z), trace form with a clamp."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    qw = 0.5 * torch.sqrt(torch.clamp(1.0 + trace, min=_EPS))
    s = 0.25 / torch.clamp(qw, min=_EPS)
    qx = (R[..., 2, 1] - R[..., 1, 2]) * s
    qy = (R[..., 0, 2] - R[..., 2, 0]) * s
    qz = (R[..., 1, 0] - R[..., 0, 1]) * s
    q = torch.stack([qw, qx, qy, qz], dim=-1)
    return q / torch.linalg.norm(q, dim=-1, keepdim=True)
