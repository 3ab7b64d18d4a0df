"""IMU-less propagation and deskew — the constant-twist part of
immesh_tpu/lio/imu.py (reference Forward_without_imu,
IMU_Processing.cpp:486-553).

The IMU path (imu_propagate, deskew, static_init) is not ported yet.
"""

from __future__ import annotations

import torch

from immesh_tpu_torch.config import ImuConfig
from immesh_tpu_torch.core import so3
from immesh_tpu_torch.core.state import STATE_DIM, EsikfState


def const_velocity_propagate(state: EsikfState, dt: torch.Tensor,
                             cfg: ImuConfig) -> EsikfState:
    """IMU-less propagation: `state.bg` carries the estimated body angular
    rate ω̂ and `state.vel` the linear velocity (the reference's
    Forward_without_imu semantics); gyr_cov/acc_cov act as the ω / velocity
    random walks."""
    dtype, dev = state.pos.dtype, state.pos.device
    dR = so3.exp(state.bg * dt)
    rot = state.rot @ dR
    pos = state.pos + state.vel * dt

    eye3 = torch.eye(3, dtype=dtype, device=dev)
    F = torch.eye(STATE_DIM, dtype=dtype, device=dev)
    F[0:3, 0:3] = dR.T
    F[0:3, 9:12] = eye3 * dt
    F[3:6, 6:9] = eye3 * dt
    Q = torch.zeros((STATE_DIM, STATE_DIM), dtype=dtype, device=dev)
    Q[9:12, 9:12] = eye3 * cfg.gyr_cov * dt * dt
    Q[6:9, 6:9] = eye3 * cfg.acc_cov * dt * dt
    cov = F @ state.cov @ F.T + Q
    return state.replace(rot=rot, pos=pos, cov=cov)


def deskew_const_twist(pts: torch.Tensor, t_rel: torch.Tensor,
                       scan_duration: torch.Tensor,
                       rel_rot_vec: torch.Tensor, rel_trans: torch.Tensor
                       ) -> torch.Tensor:
    """IMU-less deskew with a linear twist over the scan (KITTI mode): the
    point at time t is mapped to the scan-end frame by Rodrigues applied
    directly to the point vectors.  Divides by max(θ, 1e-12) as the
    reference does (immesh_tpu/lio/imu.py:217-218)."""
    T = torch.clamp(scan_duration, min=1e-6)
    alpha = torch.clamp(t_rel / T, 0.0, 1.0)[:, None] - 1.0  # ∈ [-1, 0]
    rv = alpha * rel_rot_vec[None, :]
    th = torch.linalg.norm(rv, dim=-1, keepdim=True)
    k = rv / torch.clamp(th, min=1e-12)
    c = torch.cos(th)
    s = torch.sin(th)
    rot = (pts * c + so3.cross(k, pts) * s
           + k * torch.sum(k * pts, dim=-1, keepdim=True) * (1.0 - c))
    return rot + alpha * rel_trans[None, :]
