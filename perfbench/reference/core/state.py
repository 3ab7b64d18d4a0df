"""18-dim ESIKF manifold state.

Port of immesh_tpu/core/state.py (reference include/common_lib.h:199-288):
{rotation, position, velocity, gyro bias, accel bias, gravity} with ⊞ / ⊟,
the rotation block composing through the SO(3) exponential.

Error-state ordering:
    [0:3] δθ  [3:6] δp  [6:9] δv  [9:12] δb_g  [12:15] δb_a  [15:18] δg
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass

import torch

from perfbench.reference.core import so3
from perfbench.reference.device import resolve_device

STATE_DIM = 18


@dataclass
class EsikfState:
    rot: torch.Tensor    # (3, 3) world←body
    pos: torch.Tensor    # (3,)
    vel: torch.Tensor    # (3,)
    bg: torch.Tensor     # (3,) gyro bias (IMU-less mode: body angular rate)
    ba: torch.Tensor     # (3,) accel bias
    grav: torch.Tensor   # (3,) gravity in world frame
    cov: torch.Tensor    # (18, 18)

    @classmethod
    def identity(cls, dtype=torch.float32, gravity: float = 9.81,
                 init_rot_cov: float = 1e-5, init_pos_cov: float = 1e-5,
                 init_vel_cov: float = 1e-2, init_bias_cov: float = 1e-4,
                 init_grav_cov: float = 1e-3, device="cuda") -> "EsikfState":
        dev = resolve_device(device)
        kw = dict(dtype=dtype, device=dev)
        diag = torch.cat([
            torch.full((3,), init_rot_cov, **kw),
            torch.full((3,), init_pos_cov, **kw),
            torch.full((3,), init_vel_cov, **kw),
            torch.full((6,), init_bias_cov, **kw),
            torch.full((3,), init_grav_cov, **kw),
        ])
        return cls(
            rot=torch.eye(3, **kw), pos=torch.zeros(3, **kw),
            vel=torch.zeros(3, **kw), bg=torch.zeros(3, **kw),
            ba=torch.zeros(3, **kw),
            grav=torch.tensor([0.0, 0.0, -gravity], **kw),
            cov=torch.diag(diag),
        )

    def replace(self, **kw) -> "EsikfState":
        return dataclasses.replace(self, **kw)

    # ---- manifold ops (reference common_lib.h:236-271 operator+/-) --------
    def boxplus(self, delta: torch.Tensor) -> "EsikfState":
        """state ⊞ δ, δ: (18,). Rotation right-composes through Exp."""
        return self.replace(
            rot=self.rot @ so3.exp(delta[0:3]),
            pos=self.pos + delta[3:6],
            vel=self.vel + delta[6:9],
            bg=self.bg + delta[9:12],
            ba=self.ba + delta[12:15],
            grav=self.grav + delta[15:18],
        )

    def boxminus(self, other: "EsikfState") -> torch.Tensor:
        """self ⊟ other → (18,) error vector, inverse of other.boxplus."""
        return torch.cat([
            so3.log(other.rot.T @ self.rot),
            self.pos - other.pos,
            self.vel - other.vel,
            self.bg - other.bg,
            self.ba - other.ba,
            self.grav - other.grav,
        ])

    def transform_points(self, pts_body: torch.Tensor) -> torch.Tensor:
        """Body→world for (..., 3) points."""
        return pts_body @ self.rot.T + self.pos

    def pose_matrix(self) -> torch.Tensor:
        """4×4 homogeneous world←body."""
        T = torch.eye(4, dtype=self.rot.dtype, device=self.rot.device)
        T[:3, :3] = self.rot
        T[:3, 3] = self.pos
        return T
