"""IMU forward propagation, per-point motion deskew and static init — port of
immesh_tpu/lio/imu.py (reference ImuProcess, src/IMU_Processing.cpp):

  * `imu_propagate` — midpoint gyro/accel integration with the 18×18
    covariance propagation of `Forward` (:366-484), emitting the per-sample
    pose knots deskew needs;
  * `deskew` — the batched form of `UndistortPcl`'s backward walk
    (:925-956): every point interpolates its segment pose in parallel;
  * `const_velocity_propagate` / `deskew_const_twist` — `Forward_without_imu`
    (:486-553) for IMU-less (KITTI) mode;
  * `static_init` — `IMU_init` (:188-232) from averaged static samples.

Error-state ordering matches core/state.py: [θ p v bg ba g].
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Tuple

import torch

from perfbench.reference.config import ImuConfig
from perfbench.reference.core import so3
from perfbench.reference.core.state import STATE_DIM, EsikfState
from perfbench.reference.frontend.types import ScanBundle


@dataclass
class PoseSegments:
    """Per-IMU-sample pose knots for deskew interpolation."""

    stamps: torch.Tensor  # (M,)
    rot: torch.Tensor     # (M, 3, 3) world←body at each knot
    pos: torch.Tensor     # (M, 3)
    vel: torch.Tensor     # (M, 3)
    gyr: torch.Tensor     # (M, 3) bias-corrected segment angular rate
    acc_w: torch.Tensor   # (M, 3) world-frame segment acceleration (gravity-included)


def _prefix_scan(combine: Callable, xs: tuple) -> tuple:
    """Inclusive prefix of an associative `combine(earlier, later)` over the
    leading axis of every tensor in `xs` — Hillis-Steele, ⌈log₂K⌉ batched
    levels (the reference's lax.associative_scan, in another tree order)."""
    n = xs[0].shape[0]
    d = 1
    while d < n:
        head = tuple(x[:d] for x in xs)
        tail = combine(tuple(x[:-d] for x in xs), tuple(x[d:] for x in xs))
        xs = tuple(torch.cat([h, t], 0) for h, t in zip(head, tail))
        d *= 2
    return xs


def _compose(a: tuple, b: tuple) -> tuple:
    """(F₁,Q₁) then (F₂,Q₂): P → F₂(F₁PF₁ᵀ+Q₁)F₂ᵀ+Q₂."""
    Fa, Qa = a
    Fb, Qb = b
    return (Fb @ Fa, Fb @ Qa @ Fb.transpose(-1, -2) + Qb)


def imu_propagate(state: EsikfState, bundle: ScanBundle, cfg: ImuConfig
                  ) -> Tuple[EsikfState, PoseSegments]:
    """Propagate mean + covariance through the scan's IMU window.  Returns
    the state at scan end and the pose knots for deskew.  The window has a
    static length M; padded samples carry dt = 0 and are exact no-ops
    (so3.exp(0) is exactly I).

    Same algebra as the reference: rotations as prefix products of dR,
    velocity/position as cumsums of the per-interval world accelerations,
    covariance as the prefix composition of (F, Q) with the F/Q blocks of
    IMU_Processing.cpp:429-445."""
    stamps = bundle.imu_stamps
    dtype, dev = state.pos.dtype, state.pos.device

    # midpoint pairs: interval k spans [stamps[k], stamps[k+1]]
    acc_mid = 0.5 * (bundle.imu_acc[:-1] + bundle.imu_acc[1:])
    gyr_mid = 0.5 * (bundle.imu_gyr[:-1] + bundle.imu_gyr[1:])
    dts = stamps[1:] - stamps[:-1]
    pair_ok = bundle.imu_mask[:-1] & bundle.imu_mask[1:]
    dts = torch.where(pair_ok, torch.clamp(dts, min=0.0),
                      torch.zeros_like(dts))
    dt1 = dts[:, None]

    # made on the card (torch.tensor would copy from the host and sync)
    g_std = torch.sqrt(torch.full((), cfg.gyr_cov, dtype=dtype, device=dev))
    a_std = torch.sqrt(torch.full((), cfg.acc_cov, dtype=dtype, device=dev))

    w = gyr_mid - state.bg[None, :]          # (K, 3) bias-corrected rates
    a_body = acc_mid - state.ba[None, :]
    dR = so3.exp(w * dt1)                    # (K, 3, 3); dt=0 → exact I

    # ---- rotation knots: prefix products of dR --------------------------
    (pfx,) = _prefix_scan(lambda a, b: (a[0] @ b[0],), (dR,))  # dR₀…dR_k
    rot_after = state.rot[None] @ pfx        # R at interval ends
    k_rot = torch.cat([state.rot[None], rot_after[:-1]], 0)  # starts
    rot_e = rot_after[-1]

    # ---- velocity / position knots (world accel known per interval) -----
    a_world = torch.einsum("kij,kj->ki", k_rot, a_body) + state.grav[None, :]
    dv = a_world * dt1
    zero = torch.zeros((1, 3), dtype=dtype, device=dev)
    k_vel = state.vel[None, :] + torch.cat(
        [zero, torch.cumsum(dv, 0)[:-1]], 0)
    dp = k_vel * dt1 + 0.5 * a_world * dt1 * dt1
    k_pos = state.pos[None, :] + torch.cat(
        [zero, torch.cumsum(dp, 0)[:-1]], 0)
    vel_e = k_vel[-1] + dv[-1]
    pos_e = k_pos[-1] + dp[-1]

    # ---- 18×18 covariance via associative composition -------------------
    # F = I + dt·A with the standard ESIKF blocks (reference F_x / cov_w)
    K = dts.shape[0]
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    dt3 = dt1[..., None]                     # (K, 1, 1)
    F = torch.eye(STATE_DIM, dtype=dtype, device=dev).repeat(K, 1, 1)
    F[:, 0:3, 0:3] = dR.transpose(1, 2)
    F[:, 0:3, 9:12] = -so3.a_matrix(w * dt1) * dt3
    F[:, 3:6, 6:9] = eye3[None] * dt3
    F[:, 6:9, 0:3] = -torch.einsum("kij,kjl->kil", k_rot,
                                   so3.hat(a_body)) * dt3
    F[:, 6:9, 12:15] = -k_rot * dt3
    F[:, 6:9, 15:18] = eye3[None] * dt3

    Q = torch.zeros((K, STATE_DIM, STATE_DIM), dtype=dtype, device=dev)
    Q[:, 0:3, 0:3] = eye3[None] * ((g_std * dt1) ** 2)[..., None]
    Q[:, 6:9, 6:9] = eye3[None] * ((a_std * dt1) ** 2)[..., None]
    Q[:, 9:12, 9:12] = eye3[None] * (cfg.b_gyr_cov * dt1)[..., None]
    Q[:, 12:15, 12:15] = eye3[None] * (cfg.b_acc_cov * dt1)[..., None]

    Phi, Theta = _prefix_scan(_compose, (F, Q))
    cov_e = Phi[-1] @ state.cov @ Phi[-1].T + Theta[-1]

    # final knot at the last stamp (pose after the last interval); like the
    # reference it reads the LAST SLOT of the window, which is a zero
    # padding row whenever the window is not full
    last_w = bundle.imu_gyr[-1] - state.bg
    last_aw = rot_e @ (bundle.imu_acc[-1] - state.ba) + state.grav
    seg = PoseSegments(
        stamps=stamps,
        rot=torch.cat([k_rot, rot_e[None]], 0),
        pos=torch.cat([k_pos, pos_e[None]], 0),
        vel=torch.cat([k_vel, vel_e[None]], 0),
        gyr=torch.cat([w, last_w[None]], 0),
        acc_w=torch.cat([a_world, last_aw[None]], 0),
    )
    out = state.replace(rot=rot_e, pos=pos_e, vel=vel_e, cov=cov_e)
    return out, seg


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


def deskew(seg: PoseSegments, end_state: EsikfState, pts: torch.Tensor,
           t_rel: torch.Tensor) -> torch.Tensor:
    """Motion-compensate every point to the scan-end body frame: each point
    finds its IMU segment (searchsorted, side="right" − 1, over stamps whose
    padding repeats the last valid stamp), evaluates the segment's
    constant-acceleration pose at its own time and is re-expressed in the
    scan-end frame, p_end = R_eᵀ (R(t)·p + p(t) − p_e)."""
    k = torch.clamp(
        torch.searchsorted(seg.stamps, t_rel, right=True) - 1,
        0, seg.stamps.shape[0] - 1)
    dt = (t_rel - seg.stamps[k])[:, None]
    R_k = seg.rot[k]
    w = seg.gyr[k]
    p_t = seg.pos[k] + seg.vel[k] * dt + 0.5 * seg.acc_w[k] * dt * dt
    R_t = R_k @ so3.exp(w * dt)
    p_world = torch.einsum("nij,nj->ni", R_t, pts) + p_t
    return (p_world - end_state.pos) @ end_state.rot


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


def static_init(acc: torch.Tensor, gyr: torch.Tensor, cfg: ImuConfig,
                state: EsikfState) -> EsikfState:
    """Static initialization from a stack of stationary IMU samples (reference
    IMU_init): gyro bias from the mean gyro, and the initial attitude chosen
    so that R·mean_acc points along +z (gravity along −z in the world)."""
    dtype, dev = acc.dtype, acc.device
    mean_acc = torch.mean(acc, dim=0)
    mean_gyr = torch.mean(gyr, dim=0)
    g_norm = torch.linalg.norm(mean_acc)
    a = mean_acc / torch.clamp(g_norm, min=1e-6)
    z = torch.tensor([0.0, 0.0, 1.0], dtype=dtype, device=dev)
    v = so3.cross(a, z)
    s = torch.linalg.norm(v)
    c = torch.dot(a, z)
    angle = torch.arctan2(s, c)
    axis = v / torch.clamp(s, min=1e-8)
    rot0 = so3.exp(axis * angle)  # R·a = z
    rot0 = torch.where(s < 1e-8, torch.eye(3, dtype=dtype, device=dev), rot0)
    return state.replace(
        rot=rot0,
        bg=mean_gyr,
        grav=torch.tensor([0.0, 0.0, -cfg.gravity], dtype=dtype, device=dev),
    )
