"""Iterated ESIKF measurement update — port of immesh_tpu/lio/esikf.py
(reference lio_state_estimation, voxel_mapping.cpp:1284-1652).

Information form:
    A = HᵀR⁻¹H + P⁻¹,   δ = A⁻¹ (HᵀR⁻¹(−z) + P⁻¹·(x_prop ⊟ x)),
    x ← x ⊞ δ,  and at convergence P⁺ = A⁻¹.
The JAX `while_loop` is a Python loop with the same convergence predicate.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from immesh_tpu_torch.config import LioConfig, VoxelMapConfig
from immesh_tpu_torch.core.state import STATE_DIM, EsikfState
from immesh_tpu_torch.lio.association import associate
from immesh_tpu_torch.map.voxel_map import VoxelMap


def lio_update(state_prop: EsikfState, vm: VoxelMap, pts_body: torch.Tensor,
               point_cov_body: torch.Tensor, mask: torch.Tensor,
               lio_cfg: LioConfig, map_cfg: VoxelMapConfig
               ) -> Tuple[EsikfState, dict]:
    """Iterated measurement update against the plane map.  Returns
    (posterior state, {"converged", "n_effective"})."""
    return iterated_update(
        state_prop,
        lambda st: associate(st, vm, pts_body, point_cov_body, mask, map_cfg),
        lio_cfg)


def iterated_update(state_prop: EsikfState,
                    assoc_fn: Callable[[EsikfState], dict],
                    lio_cfg: LioConfig,
                    reduce: Optional[Callable[[dict], dict]] = None
                    ) -> Tuple[EsikfState, dict]:
    """The iteration of lio_update with the association rows of
    assoc_fn(state).  `reduce`, where given, sums the information
    contributions {"HtRH6", "HtRz6", "n"} over the ranks of a multi-rank
    step (dist/); the loop ends on the reduced step, so every rank takes
    the same convergence decision when the reduction gives every rank the
    same bits."""
    dtype, dev = state_prop.rot.dtype, state_prop.rot.device
    eye = torch.eye(STATE_DIM, dtype=dtype, device=dev)
    p_inv = torch.linalg.inv(state_prop.cov + eye * 1e-9)
    rot_thresh = torch.tensor(lio_cfg.converge_rot_deg * math.pi / 180.0,
                              dtype=dtype, device=dev)
    trans_thresh = torch.tensor(lio_cfg.converge_trans_m, dtype=dtype,
                                device=dev)

    state = state_prop
    converged = torch.tensor(False, device=dev)
    n_eff = torch.tensor(0, dtype=torch.int32, device=dev)
    A_last = p_inv  # if zero matches, posterior = prior
    it = 0
    while it < lio_cfg.max_iterations and not bool(converged):
        assoc = assoc_fn(state)
        h6, z, r_inv = assoc["h6"], assoc["z"], assoc["r_inv"]

        hw = h6 * r_inv[:, None]
        sums = {"HtRH6": hw.T @ h6, "HtRz6": hw.T @ (-z),
                "n": torch.sum(assoc["valid"].to(torch.int32))}
        if reduce is not None:
            sums = reduce(sums)

        A = p_inv.clone()
        A[0:6, 0:6] += sums["HtRH6"]
        b = p_inv @ state_prop.boxminus(state)
        b[0:6] += sums["HtRz6"]
        L = torch.linalg.cholesky(A + eye * 1e-9)
        delta = torch.cholesky_solve(b[:, None], L)[:, 0]

        state = state.boxplus(delta)
        # convergence on the pose increment (reference :1619-1622)
        step_rot = torch.linalg.norm(delta[0:3])
        step_trans = torch.linalg.norm(delta[3:6])
        converged = (step_rot < rot_thresh) & (step_trans < trans_thresh)
        n_eff = sums["n"]
        A_last = A
        it += 1

    cov_post = torch.linalg.inv(A_last + eye * 1e-9)
    cov_post = 0.5 * (cov_post + cov_post.T)
    state = state.replace(cov=cov_post)
    return state, {"converged": converged, "n_effective": n_eff}
