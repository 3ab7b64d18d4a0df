"""Iterated ESIKF measurement update — port of immesh_tpu/lio/esikf.py
(reference lio_state_estimation, voxel_mapping.cpp:1284-1652).

Information form:
    A = HᵀR⁻¹H + P⁻¹,   δ = A⁻¹ (HᵀR⁻¹(−z) + P⁻¹·(x_prop ⊟ x)),
    x ← x ⊞ δ,  and at convergence P⁺ = A⁻¹.

The JAX `while_loop` (its cond and body, immesh_tpu/lio/esikf.py:51-81)
runs here as `max_iterations` static bodies with the iterations after
convergence masked to no-ops: the reference's own earlier design (its
docstring, :4-8).  A masked iteration computes and discards, so the result
is the while_loop's bit for bit; nothing is read back on the host, so the
LIO step can be captured as one CUDA graph (lio/captured.py).  PyTorch
2.11, the port's CUDA build, has no CUDA-graph conditional nodes
(CUDAGraph.begin_capture_to_if_node), which would let the captured step
skip the dead iterations as the while_loop does.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Tuple

import torch

from immesh_tpu_torch.config import LioConfig, VoxelMapConfig
from immesh_tpu_torch.core.ops import nan_where_failed
from immesh_tpu_torch.core.state import STATE_DIM, EsikfState
from immesh_tpu_torch.lio.association import associate
from immesh_tpu_torch.map.voxel_map import VoxelMap

# the state's mean fields, which ⊞ moves (the covariance is set at the end)
_MEAN = ("rot", "pos", "vel", "bg", "ba", "grav")


def lio_update(state_prop: EsikfState, vm: VoxelMap, pts_body: torch.Tensor,
               point_cov_body: torch.Tensor, mask: torch.Tensor,
               lio_cfg: LioConfig, map_cfg: VoxelMapConfig
               ) -> Tuple[EsikfState, dict]:
    """Iterated measurement update against the plane map.  Returns
    (posterior state, {"converged", "n_effective", "iterations"})."""
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
    step (dist/); every rank runs every static body, and the masks follow
    the reduced step, so replicas stay equal when the reduction gives every
    rank the same bits.  diag["iterations"] counts the live bodies: the
    while_loop's trip count."""
    dtype, dev = state_prop.rot.dtype, state_prop.rot.device
    eye = torch.eye(STATE_DIM, dtype=dtype, device=dev)
    p_inv = nan_where_failed(
        *torch.linalg.inv_ex(state_prop.cov + eye * 1e-9))
    rot_thresh = lio_cfg.converge_rot_deg * math.pi / 180.0
    trans_thresh = lio_cfg.converge_trans_m

    state = state_prop
    converged = torch.zeros((), dtype=torch.bool, device=dev)
    n_eff = torch.zeros((), dtype=torch.int32, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    A_last = p_inv  # if zero matches, posterior = prior
    for _ in range(lio_cfg.max_iterations):
        # the while_loop's test; it < max_iterations holds in every body
        live = ~converged
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
        L = nan_where_failed(*torch.linalg.cholesky_ex(A + eye * 1e-9))
        delta = torch.cholesky_solve(b[:, None], L)[:, 0]

        nxt = state.boxplus(delta)
        state = state.replace(**{f: torch.where(live, getattr(nxt, f),
                                                getattr(state, f))
                                 for f in _MEAN})
        # convergence on the pose increment (reference :1619-1622)
        step_rot = torch.linalg.norm(delta[0:3])
        step_trans = torch.linalg.norm(delta[3:6])
        now_conv = (step_rot < rot_thresh) & (step_trans < trans_thresh)
        converged = torch.where(live, now_conv, converged)
        n_eff = torch.where(live, sums["n"], n_eff)
        A_last = torch.where(live, A, A_last)
        it = it + live.to(torch.int32)

    cov_post = nan_where_failed(*torch.linalg.inv_ex(A_last + eye * 1e-9))
    cov_post = 0.5 * (cov_post + cov_post.T)
    state = state.replace(cov=cov_post)
    return state, {"converged": converged, "n_effective": n_eff,
                   "iterations": it}
