"""Headless mesh viewer: snapshot PNGs of the live mesh — port of
immesh_tpu/render/viewer.py.

Stands in for the reference's GLFW/ImGui window + per-region VBO shaders
(reference src/ImMesh_node.cpp:298-525 render loop, mesh_rec_display.cpp):
a server has no display, so observability is snapshot images rendered with
the same depth rasterizer that powers point-cloud reinforcement, plus
shaded normals from the depth gradient.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from immesh_tpu_torch.device import resolve_device
from immesh_tpu_torch.render.raster import (
    PinholeCam, depth_rasterize, padded_faces)


def render_mesh_views(verts: np.ndarray, faces: np.ndarray,
                      cam: PinholeCam, device="cuda"
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """(depth (H,W), shaded (H,W) in [0,1]) from explicit mesh arrays,
    rasterized on `device`."""
    dev = resolve_device(device)
    v = torch.from_numpy(np.ascontiguousarray(verts, np.float32)).to(dev)
    f = torch.from_numpy(np.ascontiguousarray(faces, np.int32)).to(dev)
    fpad, fmask = padded_faces(f)
    depth = depth_rasterize(v, fpad, fmask, cam.to(dev)).cpu().numpy()
    # cheap shading: depth-gradient lighting (screen-space normals)
    d = np.where(np.isfinite(depth), depth, np.nan)
    gx = np.gradient(d, axis=1)
    gy = np.gradient(d, axis=0)
    shade = 1.0 / (1.0 + 25.0 * np.hypot(np.nan_to_num(gx),
                                         np.nan_to_num(gy)))
    shade = np.where(np.isfinite(d), shade, 0.0)
    return depth, shade


def save_snapshot(verts: np.ndarray, faces: np.ndarray, path: str,
                  cam: Optional[PinholeCam] = None, device="cuda") -> None:
    """Write a PNG: left = inverse-depth, right = shaded mesh (needs
    matplotlib, imported here only)."""
    if len(verts) == 0:  # nothing meshed yet — auto-camera has no anchor
        verts = np.zeros((1, 3), np.float32)
        faces = np.zeros((0, 3), np.int32)
    if cam is None:
        c = verts.mean(axis=0)
        ext = np.ptp(verts, axis=0).max() + 1e-3
        cam = PinholeCam.looking(
            pos=c + np.array([0.6, -1.0, 0.8]) * ext,
            target=c, fx=260, fy=260, device=device)
    depth, shade = render_mesh_views(verts, faces, cam, device)
    inv = np.where(np.isfinite(depth), 1.0 / depth, 0.0)
    inv = inv / max(inv.max(), 1e-6)

    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(1, 2, figsize=(10, 4))
    axes[0].imshow(inv, cmap="turbo")
    axes[0].set_title("inverse depth")
    axes[1].imshow(shade, cmap="gray")
    axes[1].set_title("shaded")
    for a in axes:
        a.axis("off")
    fig.tight_layout()
    fig.savefig(path, dpi=110)
    plt.close(fig)
