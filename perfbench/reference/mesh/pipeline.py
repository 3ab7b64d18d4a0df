"""Per-frame incremental meshing step + host wrapper.

Port of immesh_tpu/mesh/pipeline.py (reference
`incremental_mesh_reconstruction`, ImMesh_mesh_reconstruction.cpp:92-267:
append → per-voxel pull/commit/push).  The map and store are updated in
place.
"""

from __future__ import annotations

import torch

from perfbench.reference.core.ops import div
from perfbench.reference.map.hash import EMPTY
from perfbench.reference.mesh.global_map import GlobalPointMap
from perfbench.reference.mesh.triangles import (
    TriangleStore, mesh_voxels, remap_store)


def mesh_step(gm: GlobalPointMap, store: TriangleStore,
              pts_world: torch.Tensor, mask: torch.Tensor,
              sensor_pos: torch.Tensor, chunk: int = 16):
    """Append one world-frame scan and re-mesh the active voxels.  Returns
    (gm, store, n_active, slots, smask, diag) like the reference.  A chunk
    of voxels with no active point is skipped (triangles.
    triangulate_voxels): on the device in the captured step, after a host
    read of its mask in the eager one."""
    gm, slots, smask, drops = gm.append_frame(pts_world, mask)
    if gm.cfg.pull_smooth_lam > 0:
        # refresh the stored smoothed positions of the active voxels' own
        # points BEFORE triangulation (mesh_rec_geometry.cpp:333-369)
        gm.smooth_active(slots, smask)
    store, n_emitted, tri_drop = mesh_voxels(
        gm, store, slots, smask, sensor_pos, chunk)
    gm.mark_meshed(slots, smask)
    diag = {f"drop_{k}": v for k, v in drops.items()}
    diag["drop_tris"] = tri_drop
    diag["tris_emitted"] = n_emitted
    return gm, store, torch.sum(smask.to(torch.int32)), slots, smask, diag


def _compact_mesh(gm: GlobalPointMap, store: TriangleStore,
                  center: torch.Tensor, radius) -> None:
    _, maps = gm.compact(center, radius)
    remap_store(store, maps["slot_map"], maps["idmap"])


def _keep_radius_mesh(gm: GlobalPointMap, center: torch.Tensor,
                      low_p: int, low_v: int, r_max: float) -> torch.Tensor:
    """Largest keep radius whose Chebyshev cube holds ≤ low-water voxels AND
    points: the (low_k)-th smallest live distance, one sort per table."""
    res = gm.cfg.voxel_resolution
    inf = float("inf")

    vkeys = gm.vox.keys
    vlive = vkeys[:, 0] != EMPTY
    vcen = (vkeys[:, :3].to(torch.float32) + 0.5) * res
    dv = torch.amax(torch.abs(vcen - center[None, :]), dim=-1)
    dv = torch.sort(torch.where(vlive, dv, torch.full_like(dv, inf)))[0]
    rv = dv[min(low_v, dv.shape[0]) - 1]

    alloc = (torch.arange(gm.pts.shape[0], device=gm.pts.device)
             < gm.pt_count)
    # a point survives iff its VOXEL center is inside the cube
    pc = (torch.floor(div(gm.pts, res)) + 0.5) * res
    dp = torch.amax(torch.abs(pc - center[None, :]), dim=-1)
    dp = torch.sort(torch.where(alloc, dp, torch.full_like(dp, inf)))[0]
    rp = dp[min(low_p, dp.shape[0]) - 1]

    r = torch.clamp(torch.minimum(rv, rp), max=r_max)
    # strictly below the quantile sample so the counted element is evicted
    return torch.where(torch.isfinite(r), r * (1.0 - 1e-6),
                       torch.full_like(r, r_max))
