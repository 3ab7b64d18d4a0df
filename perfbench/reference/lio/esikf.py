"""Iterated ESIKF measurement update — port of immesh_tpu/lio/esikf.py
(reference lio_state_estimation, voxel_mapping.cpp:1284-1652).

Information form:
    A = HᵀR⁻¹H + P⁻¹,   δ = A⁻¹ (HᵀR⁻¹(−z) + P⁻¹·(x_prop ⊟ x)),
    x ← x ⊞ δ,  and at convergence P⁺ = A⁻¹.

The JAX `while_loop` (its cond and body, immesh_tpu/lio/esikf.py:51-81)
runs here as `max_iterations` static bodies.  The first runs
unconditionally: the loop's first test always holds (`converged` starts
false, max_iterations ≥ 1).  Each later one is under
utils/graphs.py::device_if on "not converged yet"
(kernels/graph_cond.py's "not" form, read from the carry's `converged`):
in the captured step a body is two CUDA-graph IF nodes that one set launch
sets — its normal equations and Cholesky factor, then its step — with the
Cholesky solve between them outside (torch.cholesky_solve makes graph
memory nodes on the card, which a conditional body may not hold; where the
body is skipped the solve runs on the last live factor and nothing reads
it), so the bodies after convergence run nothing else on the card, as the
while_loop ends; the eager step and the CPU read the test on the host,
once a body.  The
loop's carry (the six mean fields, converged, n_effective, the last
information matrix and the count, and the body's A, b, factor and row
count) is allocated before the loop and each body writes it in place, the
rule a conditional body keeps.  The multi-rank
step (dist/, `reduce` given) runs the reference dist/'s masked form
instead: every body runs on every rank, those after convergence masked to
no-ops by torch.where, so the ranks leave together; both forms give the
while_loop's result bit for bit.
"""

from __future__ import annotations

import functools
import math
from typing import Callable, Optional, Tuple

import torch

from perfbench.reference.config import LioConfig, VoxelMapConfig
from perfbench.reference.core.ops import nan_where_failed
from perfbench.reference.core.state import STATE_DIM, EsikfState
from perfbench.reference.kernels import graph_cond
from perfbench.reference.lio.association import associate
from perfbench.reference.map.voxel_map import VoxelMap
from perfbench.reference.utils.graphs import device_if

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
    step (dist/); every rank then runs every static body, and the masks
    follow the reduced step, so replicas stay equal when the reduction
    gives every rank the same bits.  Without it the bodies after
    convergence are skipped (device_if).  diag["iterations"] counts the
    bodies that ran live: the while_loop's trip count."""
    dtype, dev = state_prop.rot.dtype, state_prop.rot.device
    eye = torch.eye(STATE_DIM, dtype=dtype, device=dev)
    p_inv = nan_where_failed(
        *torch.linalg.inv_ex(state_prop.cov + eye * 1e-9))
    rot_thresh = lio_cfg.converge_rot_deg * math.pi / 180.0
    trans_thresh = lio_cfg.converge_trans_m

    def assemble(state):
        """A body's normal equations at `state`: (A, b, its Cholesky factor,
        the matched rows)."""
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
        return A, b, L, sums["n"]

    def solve(b, L):
        return torch.cholesky_solve(b[:, None], L)[:, 0]

    def converges(delta):
        """Convergence on the pose increment (reference :1619-1622)."""
        return ((torch.linalg.norm(delta[0:3]) < rot_thresh)
                & (torch.linalg.norm(delta[3:6]) < trans_thresh))

    # the carry (if zero matches, posterior = prior)
    converged = torch.zeros((), dtype=torch.bool, device=dev)
    n_eff = torch.zeros((), dtype=torch.int64, device=dev)
    it = torch.zeros((), dtype=torch.int32, device=dev)
    A_last = p_inv.clone()
    if reduce is None:
        # a body is two IF nodes on one predicate, the solve between them
        # outside: torch.cholesky_solve on the card makes stream-ordered
        # allocations (graph memory nodes), which a conditional body may
        # not hold, so it runs on every pass, on the last live body's
        # factor where the body is skipped, and nothing reads it then
        mean = {f: getattr(state_prop, f).clone() for f in _MEAN}
        A_cur, L_cur = p_inv.clone(), eye.clone()
        b_cur = torch.zeros(STATE_DIM, dtype=dtype, device=dev)
        n_cur = torch.zeros((), dtype=torch.int64, device=dev)

        def normal_equations():
            for dst, src in zip((A_cur, b_cur, L_cur, n_cur),
                                assemble(state_prop.replace(**mean))):
                dst.copy_(src)

        def step(delta):
            nxt = state_prop.replace(**mean).boxplus(delta)
            for f in _MEAN:
                mean[f].copy_(getattr(nxt, f))
            converged.copy_(converges(delta))
            n_eff.copy_(n_cur)
            A_last.copy_(A_cur)
            it.add_(1)

        for k in range(lio_cfg.max_iterations):
            if k == 0:  # the while_loop's first test holds: no node
                normal_equations()
                step(solve(b_cur, L_cur))
                continue
            # the while_loop's test; it < max_iterations holds in every body
            live = graph_cond.negation(converged, uses=2)
            device_if(live, normal_equations, "esikf")
            delta = solve(b_cur, L_cur)
            device_if(live, functools.partial(step, delta), "esikf_step")
        state = state_prop.replace(**mean)
    else:
        state = state_prop
        for _ in range(lio_cfg.max_iterations):
            live = ~converged
            A, b, L, n = assemble(state)
            delta = solve(b, L)
            nxt = state.boxplus(delta)
            state = state.replace(**{f: torch.where(live, getattr(nxt, f),
                                                    getattr(state, f))
                                     for f in _MEAN})
            converged = torch.where(live, converges(delta), converged)
            n_eff = torch.where(live, n, n_eff)
            A_last = torch.where(live, A, A_last)
            it = it + live.to(torch.int32)

    cov_post = nan_where_failed(*torch.linalg.inv_ex(A_last + eye * 1e-9))
    cov_post = 0.5 * (cov_post + cov_post.T)
    state = state.replace(cov=cov_post)
    return state, {"converged": converged, "n_effective": n_eff,
                   "iterations": it}
