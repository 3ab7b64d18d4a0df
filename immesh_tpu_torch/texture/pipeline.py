"""Host wrapper for the texture path: camera frames → colored map → colored mesh.

Port of immesh_tpu/texture/pipeline.py.  The reference runs texture
reconstruction as an application on top of ImMesh (README.md: ImMesh +
R3LIVE texturing; plumbing in src/meshing/r3live/pointcloud_rgbd.cpp
`render_pts_in_voxels_mp` :613-686 and image_frame.cpp).  After each mesh
step, feed the nearest camera frame to `TexturePipeline.render`, which
colorizes the points of the same active-voxel work list the mesher just
used; `extract_colored` then emits a vertex-colored mesh for
`runtime.export.save_ply`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from immesh_tpu_torch.config import ImMeshConfig
from immesh_tpu_torch.device import resolve_device
from immesh_tpu_torch.mesh.pipeline import MeshPipeline
from immesh_tpu_torch.texture.camera import PinholeCamera
from immesh_tpu_torch.texture.render import ColorStore, render_active_voxels


class TexturePipeline:
    """Owns the ColorStore parallel to a MeshPipeline's global point map."""

    def __init__(self, cfg: ImMeshConfig, cam: PinholeCamera, device="cuda"):
        self.cfg = cfg
        self.cam = cam
        self.device = resolve_device(device)
        self.colors = ColorStore.create(cfg.mesh.points_capacity,
                                        device=self.device)
        self.n_rendered_total = 0

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=torch.float32, device=self.device)

    def render(self, mesh: MeshPipeline, img, R_w2c, t_w2c, obs_time,
               inv_exposure: float = 1.0) -> int:
        """Fuse one camera frame; uses mesh.last_active (the voxels touched by
        the most recent mesh step) as the candidate set.  `img` is an
        (H, W, 3) array or tensor in [0, 255]."""
        if mesh.last_active is None:
            return 0
        slots, smask = mesh.last_active
        self.colors, n = render_active_voxels(
            self.colors, mesh.gm, slots, smask, self._tensor(img), self.cam,
            self._tensor(R_w2c), self._tensor(t_w2c), float(obs_time),
            float(inv_exposure))
        n = int(n)
        self.n_rendered_total += n
        return n

    def extract_colored(self, mesh: MeshPipeline
                        ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(verts, faces, colors_u8): vertex-colored mesh for save_ply."""
        tri = mesh.store.tri_ids.reshape(-1, 3).cpu().numpy()
        valid = np.all(tri >= 0, axis=-1)
        tri = tri[valid]
        pts = mesh.gm.pts.cpu().numpy()
        cols = self.colors.colors_u8().cpu().numpy()
        used = np.unique(tri)
        remap = np.full(pts.shape[0], -1, np.int64)
        remap[used] = np.arange(used.size)
        return pts[used], remap[tri], cols[used].astype(np.uint8)
