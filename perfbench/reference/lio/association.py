"""Point-to-plane association — port of immesh_tpu/lio/association.py
(reference BuildResidualListOMP, voxel_mapping.cpp:153-245, and
build_single_residual :247-318): world transform → multi-level plane lookup
with the single near-voxel fallback probe → probabilistic χ gate → residual
and Jacobian rows, all (N,)-shaped with a validity mask."""

from __future__ import annotations

from typing import Dict

import torch

from perfbench.reference.config import VoxelMapConfig
from perfbench.reference.core.so3 import cross
from perfbench.reference.core.state import EsikfState
from perfbench.reference.map.voxel_map import VoxelMap, _sym_unpack


def _lookup_with_neighbors(vm: VoxelMap, q_world: torch.Tensor):
    """Plane lookup at the point's voxel plus ONE near-voxel probe, shifted
    one voxel on every axis where the point lies in the outer quarter.

    Mirrors the JAX code, not its docstring: the near voxel is probed for
    every point, and used wherever the own voxel found no plane — including
    when the own voxel is absent from the map.  Both probes, every level
    and the descent are kernels/hash_probe.py's planes form: its plain
    version on the CPU, one launch on the card."""
    return vm.lookup_planes(q_world, near=True)


def associate(state: EsikfState, vm: VoxelMap, pts_body: torch.Tensor,
              point_cov_body: torch.Tensor, mask: torch.Tensor,
              cfg: VoxelMapConfig) -> Dict[str, torch.Tensor]:
    """Residuals + H rows for the current state iterate: z (N,) signed
    point-to-plane distance, h6 (N, 6) rows for [δθ, δp], r_inv (N,)
    information 1/σ_l, valid (N,) gate, slot (N,)."""
    q_world = state.transform_points(pts_body)
    found, slot = _lookup_with_neighbors(vm, q_world)

    sl = slot.long()
    normal = vm.normal[sl]
    d = vm.d[sl]
    center = vm.center[sl]
    cov_nn = _sym_unpack(vm.cov_nn[sl])
    var_c = vm.var_c[sl]

    z = torch.sum(normal * q_world, dim=-1) + d

    # body-frame normal m = Rᵀn: nᵀ(RΣ_bRᵀ)n = mᵀΣ_b m and −nᵀR[p]× = −(m×p)ᵀ
    m = normal @ state.rot
    qc = q_world - center
    s_plane = torch.einsum("ni,nij,nj->n", qc, cov_nn, qc) + var_c
    s_point = torch.einsum("ni,nij,nj->n", m, point_cov_body, m)
    sigma2 = torch.clamp(s_plane + s_point, min=1e-9)

    gate = torch.abs(z) < cfg.sigma_num * torch.sqrt(sigma2)
    valid = mask & found & gate

    h_rot = -cross(m, pts_body)
    h6 = torch.cat([h_rot, normal], dim=-1)

    zero = torch.zeros_like(z)
    return {
        "z": torch.where(valid, z, zero),
        "h6": torch.where(valid[:, None], h6, torch.zeros_like(h6)),
        "r_inv": torch.where(valid, 1.0 / sigma2, zero),
        "valid": valid,
        "slot": slot,
    }
