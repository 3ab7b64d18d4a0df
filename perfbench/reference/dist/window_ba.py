"""Sliding-window pose refinement against plane landmarks (Gauss-Newton with
a Schur complement), on one device: a frozen plain copy of the port's
dist/window_ba.py without its process-group path, which no cell runs.

Problem.  K keyframe poses {R_k, t_k} refined jointly with M plane landmarks
{n_m, d_m}, tied by

  * point-to-plane factors   r = n_mᵀ (R_k p + t_k) + d_m     (one per point)
  * odometry factors between consecutive keyframes (small-angle Jacobians)
  * a gauge prior anchoring keyframe 0.

Hll is block-diagonal (3×3 per plane), so the plane block is eliminated by
the Schur complement S = Hpp − Hpl Hll⁻¹ Hplᵀ, the (6K×6K) pose system is
solved by Cholesky, and the planes are back-substituted.  Planes move in a
local tangent δ = (δu∈R², δd): n ← Exp([B(n)δu]ˣ) n, d ← d + δd.

A singular plane block or a non-PD reduced system yields NaN in the
solution instead of an exception.  Per-(k, m) and per-m sums are
core/ops.py's segment_sum, in input order from zero.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from perfbench.reference.core import so3
from perfbench.reference.core.ops import nan_where_failed, segment_sum


class WindowProblem(NamedTuple):
    """A keyframe window: K keyframes, M plane landmarks, Np points per
    keyframe (padded)."""

    rot: torch.Tensor        # (K, 3, 3) world←body initial poses
    pos: torch.Tensor        # (K, 3)
    normal: torch.Tensor     # (M, 3) unit plane normals (world)
    d: torch.Tensor          # (M,) plane offsets: n·x + d = 0
    pts: torch.Tensor        # (K, Np, 3) body-frame points
    plane_id: torch.Tensor   # (K, Np) int32 landmark index per point
    weight: torch.Tensor     # (K, Np) information weight (0 = padded/invalid)
    odo_rot: torch.Tensor    # (K-1, 3, 3) measured R_kᵀ R_{k+1}
    odo_t: torch.Tensor      # (K-1, 3)   measured R_kᵀ (t_{k+1} − t_k)
    odo_w_rot: torch.Tensor  # (K-1,) rotation information weights
    odo_w_t: torch.Tensor    # (K-1,) translation information weights


def plane_tangent_basis(n: torch.Tensor) -> torch.Tensor:
    """(…,3) unit normal → (…,3,2) orthonormal tangent basis, branch-free."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    a = torch.where(torch.abs(n[..., 0:1]) < 0.9, ex, ey)
    b1 = so3.cross(n, a)
    b1 = b1 / torch.clamp(torch.linalg.norm(b1, dim=-1, keepdim=True),
                          min=1e-12)
    b2 = so3.cross(n, b1)
    return torch.stack([b1, b2], dim=-1)


def _point_factor_blocks(rot, pos, normal, d, pts, plane_id, weight,
                         huber_delta: float) -> Dict[str, torch.Tensor]:
    """GN blocks of the point-to-plane factors: dense {Hpp (K,6,6),
    Hpl (K,M,6,3), Hll (M,3,3), bp (K,6), bl (M,3), cost}."""
    K, P, _ = pts.shape
    M = normal.shape[0]
    pid = plane_id.long()

    n = normal[pid]                                             # (K,P,3)
    dd = d[pid]                                                 # (K,P)
    q = torch.einsum("kij,kpj->kpi", rot, pts) + pos[:, None, :]  # world pts
    r = torch.sum(n * q, dim=-1) + dd                           # (K,P)

    # Huber: scale the weight (IRLS form)
    absr = torch.abs(r)
    w = weight * torch.where(absr <= huber_delta, 1.0,
                             huber_delta / torch.clamp(absr, min=1e-12))

    # pose Jacobian rows [∂r/∂δθ, ∂r/∂δp] = [-nᵀ R [p]ˣ, nᵀ] (right perturb)
    j_rot = -torch.einsum("kpi,kij,kpjl->kpl", n, rot, so3.hat(pts))
    Jp = torch.cat([j_rot, n], dim=-1)                          # (K,P,6)

    # plane Jacobian rows [∂r/∂δu, ∂r/∂δd]: δn = −[n]ˣ B δu ⇒ ∂r/∂δu = −qᵀ[n]ˣB
    B = plane_tangent_basis(n)                                  # (K,P,3,2)
    j_u = -torch.einsum("kpi,kpij,kpjl->kpl", q, so3.hat(n), B)
    Jl = torch.cat([j_u, torch.ones_like(r)[..., None]], dim=-1)  # (K,P,3)

    Hpp = torch.einsum("kpi,kpj,kp->kij", Jp, Jp, w)            # (K,6,6)
    bp = -torch.einsum("kpi,kp->ki", Jp, w * r)                 # (K,6)

    ks = torch.arange(K, device=pts.device)[:, None]
    flat_seg = (ks * M + pid).reshape(-1)                       # (K·P,)
    JpJl = torch.einsum("kpi,kpj,kp->kpij", Jp, Jl, w).reshape(K * P, 6, 3)
    Hpl = segment_sum(JpJl, flat_seg, K * M).reshape(K, M, 6, 3)

    seg_m = pid.reshape(-1)
    JlJl = torch.einsum("kpi,kpj,kp->kpij", Jl, Jl, w).reshape(K * P, 3, 3)
    Hll = segment_sum(JlJl, seg_m, M)                           # (M,3,3)
    bl = -segment_sum((Jl * (w * r)[..., None]).reshape(K * P, 3), seg_m, M)

    cost = torch.sum(w * r * r)
    return {"Hpp": Hpp, "Hpl": Hpl, "Hll": Hll, "bp": bp, "bl": bl,
            "cost": cost}


def _odometry_blocks(rot, pos, prob: WindowProblem, anchor_rot, anchor_pos,
                     gauge_weight: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Odometry chain + gauge prior on keyframe 0: the dense (6K,6K)
    addition to the pose system and its (6K,) rhs, the K−1 factors added
    into H in chain order."""
    K = rot.shape[0]
    dtype, dev = rot.dtype, rot.device
    Rk, Rk1 = rot[:-1], rot[1:]                                 # (K-1,3,3)
    RkT = Rk.transpose(-1, -2)
    odoT = prob.odo_rot.transpose(-1, -2)
    dt_w = pos[1:] - pos[:-1]
    r_rot = so3.log(odoT @ (RkT @ Rk1))
    RkT_dt = (RkT @ dt_w[..., None])[..., 0]
    r_t = RkT_dt - prob.odo_t

    # J blocks into the 12-dim [δθ_k, δp_k, δθ_{k+1}, δp_{k+1}] sub-state
    Z = torch.zeros_like(Rk)
    eye = torch.eye(3, dtype=dtype, device=dev).expand_as(Rk)
    J_rot = torch.cat([-odoT, Z, eye, Z], dim=2)
    J_t = torch.cat([so3.hat(RkT_dt), -RkT, Z, RkT], dim=2)
    J = torch.cat([J_rot, J_t], dim=1)                          # (K-1,6,12)
    W = torch.cat([prob.odo_w_rot[:, None].expand(-1, 3),
                   prob.odo_w_t[:, None].expand(-1, 3)], dim=1)  # (K-1,6)
    JW = J * W[..., None]
    JWT = JW.transpose(-1, -2)
    H12 = JWT @ J                                               # (K-1,12,12)
    b12 = -(JWT @ torch.cat([r_rot, r_t], dim=1)[..., None])[..., 0]

    H = torch.zeros((K * 6, K * 6), dtype=dtype, device=dev)
    b = torch.zeros((K * 6,), dtype=dtype, device=dev)
    for k in range(K - 1):
        H[k * 6:k * 6 + 12, k * 6:k * 6 + 12] += H12[k]
        b[k * 6:k * 6 + 12] += b12[k]

    # gauge prior: keyframe 0 stays at its anchor (the window's entry pose)
    r0 = torch.cat([so3.log(anchor_rot.T @ rot[0]), pos[0] - anchor_pos])
    H[0:6, 0:6] += gauge_weight * torch.eye(6, dtype=dtype, device=dev)
    b[0:6] += -gauge_weight * r0
    return H, b


def schur_solve(Hpp_full: torch.Tensor, Hpl: torch.Tensor, Hll: torch.Tensor,
                bp: torch.Tensor, bl: torch.Tensor,
                damping: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Eliminate the plane block; solve the reduced pose system.

    Hpp_full (6K,6K) dense, Hpl (K,M,6,3), Hll (M,3,3), bp (6K,), bl (M,3).
    Returns (δ_pose (K,6), δ_plane (M,3))."""
    K, M = Hpl.shape[0], Hpl.shape[1]
    dtype, dev = Hpp_full.dtype, Hpp_full.device
    eye3 = torch.eye(3, dtype=dtype, device=dev)
    Hll_inv, info = torch.linalg.inv_ex(Hll + damping * eye3)  # batched
    Hll_inv = nan_where_failed(Hll_inv, info)

    Hpl_f = Hpl.permute(0, 2, 1, 3).reshape(K * 6, M, 3)
    # S = Hpp − Hpl Hll⁻¹ Hplᵀ ; bs = bp − Hpl Hll⁻¹ bl
    T = torch.einsum("amx,mxy->amy", Hpl_f, Hll_inv)           # (6K,M,3)
    S = Hpp_full - torch.einsum("amx,bmx->ab", T, Hpl_f)
    bs = bp - torch.einsum("amx,mx->a", T, bl)

    S = S + damping * torch.eye(K * 6, dtype=dtype, device=dev)
    chol, info = torch.linalg.cholesky_ex(S)
    chol = nan_where_failed(chol, info)
    dp = torch.cholesky_solve(bs[:, None], chol)[:, 0]         # (6K,)

    # back-substitute: δl = Hll⁻¹ (bl − Hplᵀ δp)
    rhs_l = bl - torch.einsum("amx,a->mx", Hpl_f, dp)
    dl = torch.einsum("mxy,my->mx", Hll_inv, rhs_l)
    return dp.reshape(K, 6), dl


def _retract(rot, pos, normal, d, dp, dl):
    rot = rot @ so3.exp(dp[:, 0:3])
    pos = pos + dp[:, 3:6]
    B = plane_tangent_basis(normal)                             # (M,3,2)
    axis = torch.einsum("mij,mj->mi", B, dl[:, 0:2])
    normal = torch.einsum("mij,mj->mi", so3.exp(axis), normal)
    normal = normal / torch.clamp(
        torch.linalg.norm(normal, dim=-1, keepdim=True), min=1e-12)
    d = d + dl[:, 2]
    return rot, pos, normal, d


def _gn_iteration(rot, pos, normal, d, prob: WindowProblem, anchor_rot,
                  anchor_pos, huber_delta, gauge_weight, damping,
                  plane_prior, fix_planes: bool):
    blocks = _point_factor_blocks(rot, pos, normal, d, prob.pts,
                                  prob.plane_id, prob.weight, huber_delta)
    K = blocks["Hpl"].shape[0]
    H_odo, b_odo = _odometry_blocks(rot, pos, prob, anchor_rot, anchor_pos,
                                    gauge_weight)
    Hpp_full = H_odo + torch.block_diag(*blocks["Hpp"].unbind(0))
    bp_full = b_odo + blocks["bp"].reshape(K * 6)

    # a zero-mean prior on the planes' tangent increment; fix_planes is the
    # same prior taken to ∞
    prior = plane_prior + (1e12 if fix_planes else 0.0)
    Hll = blocks["Hll"] + prior * torch.eye(3, dtype=rot.dtype,
                                            device=rot.device)
    dp, dl = schur_solve(Hpp_full, blocks["Hpl"], Hll, bp_full, blocks["bl"],
                         damping)
    if fix_planes:
        dl = torch.zeros_like(dl)
    rot, pos, normal, d = _retract(rot, pos, normal, d, dp, dl)
    return rot, pos, normal, d, blocks["cost"], torch.linalg.norm(dp)


def solve_window(prob: WindowProblem, *, iterations: int = 6,
                 huber_delta: float = 0.5, gauge_weight: float = 1e8,
                 damping: float = 1e-6, plane_prior: float = 10.0,
                 fix_planes: bool = False) -> Dict[str, torch.Tensor]:
    """Run Gauss-Newton on the window, on the problem's device.  `cost` is
    the robust point cost at the start of the last iteration and
    `last_step_norm` that iteration's pose step (zeros for 0 iterations)."""
    anchor_rot, anchor_pos = prob.rot[0], prob.pos[0]
    rot, pos, normal, d = prob.rot, prob.pos, prob.normal, prob.d
    cost = step = torch.zeros((), dtype=rot.dtype, device=rot.device)
    for _ in range(iterations):
        rot, pos, normal, d, cost, step = _gn_iteration(
            rot, pos, normal, d, prob, anchor_rot, anchor_pos, huber_delta,
            gauge_weight, damping, plane_prior, fix_planes)
    return {"rot": rot, "pos": pos, "normal": normal, "d": d,
            "cost": cost, "last_step_norm": step}
