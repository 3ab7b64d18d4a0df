"""Mesh depth rasterization + LiDAR point-cloud reinforcement.

Port of immesh_tpu/render/raster.py, a re-design of the reference's GL depth
pipeline (src/tools/openGL_libs/openGL_camera_view.cpp: the mesh is drawn,
the depth buffer read back, `read_depth` :418-476, and masked pixels
unprojected into synthetic 3-D points, `unproject_point` :409) — the paper's
"LiDAR point-cloud reinforcement" (README.md:145-149).  Rasterization is a
batched tile z-buffer in plain PyTorch:

  1. project triangles to screen space;
  2. bin triangles to image tiles by bounding box (stable sort by tile, rank
     within the tile, scatter into fixed-size per-tile lists);
  3. per tile, evaluate edge functions of its triangle list against its
     pixel block and min-reduce perspective-correct depth.

Shapes are fixed: tiles × per-tile triangle cap, overflowing triangles are
dropped (far clutter), and triangles wider than SPAN tiles go to a shared
list of LARGE that every tile tests.  Step 3 runs over chunks of tiles so
its (tiles, tile, tile, cap) temporaries stay bounded; every pixel's
minimum is taken over the same list either way, so the image is the same.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch

from immesh_tpu_torch.device import resolve_device

SPAN = 4     # bin span per axis; wider triangles go to the shared list
LARGE = 64   # capacity of the shared large-triangle list
_CHUNK_ELEMS = 1 << 24  # per-chunk (tiles × tile² × cap) budget of step 3


@dataclasses.dataclass
class PinholeCam:
    """Virtual pinhole camera (reference Cam_view, openGL_camera.hpp:185)."""

    rot: torch.Tensor   # (3, 3) cam←world rotation
    pos: torch.Tensor   # (3,) camera center in world
    fx: float = 200.0
    fy: float = 200.0
    cx: float = 160.0
    cy: float = 120.0
    width: int = 320
    height: int = 240
    znear: float = 0.1
    zfar: float = 100.0

    @classmethod
    def looking(cls, pos, target, up=(0, 0, 1.0), device="cuda",
                **kw) -> "PinholeCam":
        pos = np.asarray(pos, np.float32)
        fwd = np.asarray(target, np.float32) - pos
        fwd /= np.linalg.norm(fwd)
        right = np.cross(fwd, np.asarray(up, np.float32))
        right /= np.linalg.norm(right)
        dn = np.cross(fwd, right)
        rot = np.stack([right, dn, fwd])  # rows: cam axes in world
        dev = resolve_device(device)
        return cls(rot=torch.from_numpy(rot).to(dev),
                   pos=torch.from_numpy(pos).to(dev), **kw)

    def to(self, device) -> "PinholeCam":
        return dataclasses.replace(self, rot=self.rot.to(device),
                                   pos=self.pos.to(device))


def depth_rasterize(verts: torch.Tensor, faces: torch.Tensor,
                    face_mask: torch.Tensor, cam: PinholeCam,
                    tile: int = 16, max_tri_per_tile: int = 256
                    ) -> torch.Tensor:
    """Z-buffer depth image (H, W) of the mesh; +inf where nothing hit."""
    H, W = cam.height, cam.width
    if H % tile or W % tile:
        raise ValueError(f"image {W}x{H} is not a multiple of tile {tile}")
    tx, ty = W // tile, H // tile
    n_tiles = tx * ty
    F = faces.shape[0]
    M = max_tri_per_tile
    dev = verts.device
    i32 = torch.int32

    # ---- 1. project ---------------------------------------------------
    pc = (verts - cam.pos) @ cam.rot.T          # (P, 3) cam frame
    z = pc[:, 2]
    u = cam.fx * pc[:, 0] / torch.clamp(z, min=1e-6) + cam.cx
    v = cam.fy * pc[:, 1] / torch.clamp(z, min=1e-6) + cam.cy

    fl = faces.long()
    fu, fv, fz = u[fl], v[fl], z[fl]            # (F, 3)
    ok = (face_mask & torch.all(fz > cam.znear, dim=-1)
          & torch.all(fz < cam.zfar, dim=-1))
    # screen-space area (degenerate / backface-agnostic: keep both windings)
    area = ((fu[:, 1] - fu[:, 0]) * (fv[:, 2] - fv[:, 0])
            - (fv[:, 1] - fv[:, 0]) * (fu[:, 2] - fu[:, 0]))
    ok = ok & (torch.abs(area) > 1e-8)

    # ---- 2. tile binning ---------------------------------------------
    umin, umax = fu.amin(-1), fu.amax(-1)
    vmin, vmax = fv.amin(-1), fv.amax(-1)
    u0 = torch.floor(umin / tile).to(i32).clamp(0, tx - 1)
    v0 = torch.floor(vmin / tile).to(i32).clamp(0, ty - 1)
    u1 = torch.floor(umax / tile).to(i32).clamp(0, tx - 1)
    v1 = torch.floor(vmax / tile).to(i32).clamp(0, ty - 1)
    # visible at all?
    ok = ok & (umax >= 0) & (umin < W) & (vmax >= 0) & (vmin < H)

    is_large = ok & ((u1 - u0 >= SPAN) | (v1 - v0 >= SPAN))
    small = ok & ~is_large
    # shared list of large (close-up) triangles, the first LARGE by index;
    # dropped lanes land in a spill slot that is sliced off
    lpos = torch.cumsum(is_large.to(i32), 0, dtype=i32) - 1
    lrows = torch.full((LARGE + 1,), -1, dtype=i32, device=dev)
    lrows[torch.where(is_large & (lpos < LARGE), lpos, LARGE).long()] = \
        torch.arange(F, dtype=i32, device=dev)
    lrows = lrows[:LARGE]

    du = torch.arange(SPAN, dtype=i32, device=dev)
    pair_tx = u0[:, None, None] + du[None, :, None]          # (F, S, 1)
    pair_ty = v0[:, None, None] + du[None, None, :]          # (F, 1, S)
    pair_ok = (small[:, None, None] & (pair_tx <= u1[:, None, None])
               & (pair_ty <= v1[:, None, None]))             # (F, S, S)
    pair_tile = (pair_ty * tx + pair_tx).reshape(F * SPAN * SPAN)
    pair_ok = pair_ok.reshape(F * SPAN * SPAN)
    pair_tri = torch.arange(F, dtype=i32, device=dev).repeat_interleave(
        SPAN * SPAN)

    # rank-ordered scatter into per-tile triangle lists
    pair_tile = torch.where(pair_ok, pair_tile, n_tiles)
    sorted_tile, order = torch.sort(pair_tile, stable=True)
    sorted_tri = pair_tri[order]
    n_pairs = sorted_tile.shape[0]
    idxs = torch.arange(n_pairs, dtype=i32, device=dev)
    start = torch.full((n_tiles + 1,), n_pairs, dtype=i32, device=dev)
    start.scatter_reduce_(0, sorted_tile.long(), idxs, reduce="amin")
    rank = idxs - start[sorted_tile.long()]
    w_ok = (sorted_tile < n_tiles) & (rank < M)
    flat = torch.where(w_ok, sorted_tile * M + rank, n_tiles * M)
    tri_list = torch.full((n_tiles * M + 1,), -1, dtype=i32, device=dev)
    tri_list[flat.long()] = sorted_tri
    tri_list = tri_list[:n_tiles * M].reshape(n_tiles, M)

    # ---- 3. per-tile z-buffer ----------------------------------------
    # append the shared large-triangle list to every tile's bin
    tri_list = torch.cat(
        [tri_list, lrows[None].expand(n_tiles, LARGE)], dim=1)
    tl = tri_list.clamp(min=0).long()
    fu_l, fv_l, fz_l = fu[tl], fv[tl], fz[tl]   # (n_tiles, M+LARGE, 3)
    valid_l = tri_list >= 0

    px = torch.arange(tile, dtype=torch.float32, device=dev) + 0.5
    tids = torch.arange(n_tiles, dtype=i32, device=dev)
    tile_u0 = ((tids % tx) * tile).to(torch.float32)
    tile_v0 = ((tids // tx) * tile).to(torch.float32)

    tiles = torch.empty((n_tiles, tile, tile), dtype=torch.float32,
                        device=dev)
    step = max(1, _CHUNK_ELEMS // (tile * tile * (M + LARGE)))
    for c0 in range(0, n_tiles, step):
        sl = slice(c0, c0 + step)
        PU = (tile_u0[sl, None] + px)[:, None, :, None]  # (c, 1, tile, 1)
        PV = (tile_v0[sl, None] + px)[:, :, None, None]  # (c, tile, 1, 1)

        def corner(f, i):
            return f[sl, None, None, :, i]               # (c, 1, 1, M+L)

        x0, x1, x2 = (corner(fu_l, i) for i in range(3))
        y0, y1, y2 = (corner(fv_l, i) for i in range(3))
        z0, z1, z2 = (corner(fz_l, i) for i in range(3))
        # edge functions vs each triangle (c, tile, tile, M+L)
        w0 = (x2 - x1) * (PV - y1) - (y2 - y1) * (PU - x1)
        w1 = (x0 - x2) * (PV - y2) - (y0 - y2) * (PU - x2)
        w2 = (x1 - x0) * (PV - y0) - (y1 - y0) * (PU - x0)
        den = w0 + w1 + w2
        same = (((w0 >= 0) & (w1 >= 0) & (w2 >= 0))
                | ((w0 <= 0) & (w1 <= 0) & (w2 <= 0)))
        live = torch.abs(den) > 1e-8
        inside = same & live & valid_l[sl, None, None, :]
        # perspective-correct depth: interpolate 1/z with barycentrics
        izs = (w0 / z0 + w1 / z1 + w2 / z2) / torch.where(live, den, 1.0)
        depth = torch.where(inside, 1.0 / torch.clamp(izs, min=1e-6),
                            float("inf"))
        tiles[sl] = depth.amin(dim=-1)                    # (c, tile, tile)
    # assemble (ty, tx, tile, tile) → (H, W)
    img = tiles.reshape(ty, tx, tile, tile).permute(0, 2, 1, 3)
    return img.reshape(H, W)


def unproject_depth(depth: torch.Tensor, cam: PinholeCam, stride: int = 1
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Depth image → world points (reference unproject_point,
    openGL_camera_view.cpp:409).  Returns ((N,3) points, (N,) mask)."""
    d = depth[::stride, ::stride]
    H, W = d.shape
    dev = depth.device
    v, u = torch.meshgrid(
        torch.arange(H, device=dev) * stride + 0.5,
        torch.arange(W, device=dev) * stride + 0.5, indexing="ij")
    ok = torch.isfinite(d) & (d > cam.znear) & (d < cam.zfar)
    z = torch.where(ok, d, 1.0)
    x = (u - cam.cx) / cam.fx * z
    y = (v - cam.cy) / cam.fy * z
    pc = torch.stack([x, y, z], dim=-1).reshape(-1, 3)
    pw = pc @ cam.rot + cam.pos
    return pw, ok.reshape(-1)


def padded_faces(tri: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, 3) faces → (faces (f, 3), mask (f,)) zero-padded to a power of
    two ≥ 256, the JAX package's shape bucket (a padded face is masked out,
    so the image does not depend on the padding)."""
    n = tri.shape[0]
    f = 1 << max(8, int(np.ceil(np.log2(max(n, 1)))))
    pad = torch.zeros((f, 3), dtype=torch.int32, device=tri.device)
    pad[:n] = tri
    mask = torch.arange(f, device=tri.device) < n
    return pad, mask


def reinforce_scan(store, gm, cam: PinholeCam, stride: int = 2,
                   max_depth: float = 0.0
                   ) -> Tuple[np.ndarray, np.ndarray]:
    """LiDAR point-cloud reinforcement: rasterize the current mesh from the
    sensor pose and synthesize densified points from the depth buffer
    (reference GUI wiring ImMesh_node.cpp:305-329, 422-432), on the store's
    device.

    stride = synthesized-point density (1 = every pixel), max_depth = drop
    synthesized points beyond this range (0 = unlimited) — the two
    parameters the reference exposes live in its GUI; the runtime reads
    them from the viewer controls (runtime/app.py:reinforce).  Returns
    numpy (points (N, 3), depth (H, W))."""
    tri = store.tri_ids.reshape(-1, 3)
    tri = tri[torch.all(tri >= 0, dim=-1)]
    faces, fmask = padded_faces(tri)
    depth = depth_rasterize(gm.pts, faces, fmask, cam.to(gm.pts.device))
    pts, ok = unproject_depth(depth, cam.to(gm.pts.device), stride)
    if max_depth > 0:
        ok = ok & (depth[::stride, ::stride].reshape(-1) <= max_depth)
    return pts[ok].cpu().numpy(), depth.cpu().numpy()
