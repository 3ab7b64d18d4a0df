"""Mesh / point-cloud export and map checkpointing — port of
immesh_tpu/runtime/export.py (reference persistence layer, SURVEY.md
C20/C23):

  * binary-little-endian PLY mesh export with optional Laplacian vertex
    smoothing (`save_to_ply_file` + `smooth_all_pts`, reference
    src/meshing/mesh_rec_geometry.cpp:60-131);
  * the plane-map PLY: the LIO map's fitted planes as colored patches
    (`save_plane_map_ply`, the reference's `pubPlaneMap` MarkerArray);
  * PCD point export and import;
  * whole-state checkpoints: one npz of the state's tensors flattened in
    the JAX pytree order (`n_leaves`, `leaf_{i}`), so a checkpoint written
    by either package loads into the other.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from immesh_tpu_torch.map.voxel_map import _sym_unpack


# ----------------------------------------------------------------------
# PLY / PCD
# ----------------------------------------------------------------------

def save_ply(path: str, verts: np.ndarray, faces: np.ndarray,
             colors: Optional[np.ndarray] = None) -> None:
    """Binary PLY (same element layout the reference writes); `colors` is an
    optional (V, 3) uint8/float array of per-vertex RGB — written when the
    texture path has colorized the map, mirroring the
    reference's textured-mesh application (README.md texture section)."""
    verts = np.ascontiguousarray(verts, np.float32)
    faces = np.ascontiguousarray(faces, np.int32)
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(b"comment immesh_tpu mesh\n")
        f.write(f"element vertex {len(verts)}\n".encode())
        f.write(b"property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write(b"property uchar red\nproperty uchar green\n"
                    b"property uchar blue\n")
        f.write(f"element face {len(faces)}\n".encode())
        f.write(b"property list uchar int vertex_index\nend_header\n")
        if colors is None:
            f.write(verts.tobytes())
        else:
            c = np.clip(np.asarray(colors), 0, 255).astype(np.uint8)
            rec = np.zeros(len(verts), dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            rec["xyz"] = verts
            rec["rgb"] = c
            f.write(rec.tobytes())
        rec = np.zeros(len(faces), dtype=[("n", "u1"), ("v", "<i4", 3)])
        rec["n"] = 3
        rec["v"] = faces
        f.write(rec.tobytes())


def extract_plane_patches(vm, scale: float = 3.0,
                          max_planes: Optional[int] = None
                          ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """LIO plane-voxel map → displayable quads (verts, faces, colors).

    The analogue of the reference's plane MarkerArray publisher `pubPlaneMap`
    (reference src/voxel_mapping.cpp:947-1159): every fitted plane becomes a
    flat patch centered on the plane centroid, spanned by the two in-plane
    principal axes with half-extents `scale`·√λ (the reference draws
    eigen-scaled CUBE markers), and jet-colored by the plane's normal
    variance trace exactly like the reference colors by `plane_var`
    (voxel_mapping.cpp:1004-1016 mapJet ramp).

    Host-side (NumPy): visualization runs off the frame hot path.
    Returns (verts (4P, 3) f32, faces (2P, 3) i32, colors (4P, 3) u8).
    """
    valid = vm.plane_valid.cpu().numpy()
    slots = np.nonzero(valid)[0]
    if max_planes is not None and slots.size > max_planes:
        slots = slots[:max_planes]
    P = slots.size
    if P == 0:
        return (np.zeros((0, 3), np.float32), np.zeros((0, 3), np.int32),
                np.zeros((0, 3), np.uint8))

    sl = torch.from_numpy(slots).to(vm.plane_valid.device)
    center = vm.center[sl].cpu().numpy()
    lam = vm.lam[sl].cpu().numpy()             # ascending eigenvalues
    sum_p = vm.sum_p[sl].cpu().numpy()
    sum_ppT = _sym_unpack(vm.sum_ppT[sl]).cpu().numpy()
    count = np.maximum(vm.count[sl].cpu().numpy(), 1.0)

    # in-plane principal axes from the scatter covariance (the stored SoA
    # keeps only eigenvalues; re-derive eigenvectors host-side).  Moments
    # are ANCHORED at the voxel center (map/voxel_map.scan_aggregates), so
    # the local mean — not the world-frame centroid — completes the square;
    # covariance is translation-invariant so nothing else changes.
    mean_l = sum_p / count[:, None]
    cov = sum_ppT / count[:, None, None] - np.einsum(
        "ni,nj->nij", mean_l, mean_l)
    _, vecs = np.linalg.eigh(cov + 1e-12 * np.eye(3))
    e1, e2 = vecs[:, :, 2], vecs[:, :, 1]       # largest, middle
    a1 = scale * np.sqrt(np.maximum(lam[:, 2], 1e-12))[:, None]
    a2 = scale * np.sqrt(np.maximum(lam[:, 1], 1e-12))[:, None]

    corners = np.stack([
        center - e1 * a1 - e2 * a2,
        center + e1 * a1 - e2 * a2,
        center + e1 * a1 + e2 * a2,
        center - e1 * a1 + e2 * a2,
    ], axis=1).reshape(-1, 3).astype(np.float32)          # (4P, 3)
    base = 4 * np.arange(P, dtype=np.int32)[:, None]
    faces = np.concatenate([
        base + np.array([[0, 1, 2]], np.int32),
        base + np.array([[0, 2, 3]], np.int32),
    ], axis=0)

    # jet ramp over normal-covariance trace (reference plane_var coloring)
    tr = vm.cov_nn[sl].cpu().numpy()[:, [0, 3, 5]].sum(axis=1)
    t = np.sqrt(np.maximum(tr, 0.0))
    t = np.clip(t / (np.percentile(t, 95) + 1e-12), 0.0, 1.0)
    colors4 = np.repeat(_jet(t), 4, axis=0)
    return corners, faces, colors4


def _jet(t: np.ndarray) -> np.ndarray:
    """Jet-like color ramp t∈[0,1] → (N, 3) uint8 (reference mapJet,
    tinycolormap usage in pubPlaneMap)."""
    r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
    return (np.stack([r, g, b], axis=-1) * 255).astype(np.uint8)


def save_plane_map_ply(vm, path: str, scale: float = 3.0,
                       max_planes: Optional[int] = None) -> int:
    """Write the plane-map visualization as a colored PLY; returns the number
    of planes exported (reference publishes the same content as a ROS
    MarkerArray on `/voxels`, src/voxel_mapping.cpp:947-1159)."""
    verts, faces, colors = extract_plane_patches(vm, scale, max_planes)
    save_ply(path, verts, faces, colors)
    return len(verts) // 4


def load_ply(path: str):
    """Read back a binary PLY written by save_ply (for tests/round-trips).
    Returns (verts, faces) or (verts, faces, colors) when color properties
    are present."""
    with open(path, "rb") as f:
        n_v = n_f = 0
        has_color = False
        while True:
            line = f.readline().strip()
            if line.startswith(b"element vertex"):
                n_v = int(line.split()[-1])
            elif line.startswith(b"property uchar red"):
                has_color = True
            elif line.startswith(b"element face"):
                n_f = int(line.split()[-1])
            elif line == b"end_header":
                break
        if has_color:
            vrec = np.frombuffer(
                f.read(n_v * 15), dtype=[("xyz", "<f4", 3), ("rgb", "u1", 3)])
            verts, colors = vrec["xyz"].copy(), vrec["rgb"].copy()
        else:
            verts = np.frombuffer(f.read(n_v * 12), "<f4").reshape(n_v, 3).copy()
            colors = None
        rec = np.frombuffer(
            f.read(n_f * 13), dtype=[("n", "u1"), ("v", "<i4", 3)]
        )
        faces = rec["v"].copy()
        return (verts, faces, colors) if has_color else (verts, faces)


def save_pcd(path: str, pts: np.ndarray) -> None:
    """Binary PCD v0.7 (x y z), like the reference's PCL dumps."""
    pts = np.ascontiguousarray(pts, np.float32)
    hdr = (
        "# .PCD v0.7 - Point Cloud Data file format\nVERSION 0.7\n"
        "FIELDS x y z\nSIZE 4 4 4\nTYPE F F F\nCOUNT 1 1 1\n"
        f"WIDTH {len(pts)}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\n"
        f"POINTS {len(pts)}\nDATA binary\n"
    )
    with open(path, "wb") as f:
        f.write(hdr.encode())
        f.write(pts.tobytes())


def load_pcd(path: str) -> np.ndarray:
    """Read a PCD v0.7 point cloud (ascii or binary, x/y/z fields) — the
    input of the offline meshing mode (reference loadPCDFile,
    ImMesh_node.cpp:235-249)."""
    with open(path, "rb") as f:
        fields, sizes, types, counts = [], [], [], []
        n_pts, data_mode = 0, "ascii"
        while True:
            line = f.readline().decode("latin1").strip()
            if line.startswith("FIELDS"):
                fields = line.split()[1:]
            elif line.startswith("SIZE"):
                sizes = [int(x) for x in line.split()[1:]]
            elif line.startswith("TYPE"):
                types = line.split()[1:]
            elif line.startswith("COUNT"):
                counts = [int(x) for x in line.split()[1:]]
            elif line.startswith("POINTS"):
                n_pts = int(line.split()[1])
            elif line.startswith("DATA"):
                data_mode = line.split()[1]
                break
        if not counts:
            counts = [1] * len(fields)
        np_types = {("F", 4): "<f4", ("F", 8): "<f8", ("U", 1): "u1",
                    ("U", 2): "<u2", ("U", 4): "<u4", ("I", 4): "<i4"}
        dt = np.dtype([
            (name if counts[i] == 1 else name, np_types[(types[i], sizes[i])],
             (counts[i],) if counts[i] > 1 else ())
            for i, name in enumerate(fields)])
        if data_mode == "ascii":
            rows = np.loadtxt(f, dtype=np.float64, max_rows=n_pts)
            cols = {name: rows[:, i] for i, name in enumerate(fields[:rows.shape[1]])}
            return np.stack([cols["x"], cols["y"], cols["z"]], -1).astype(np.float32)
        rec = np.frombuffer(f.read(n_pts * dt.itemsize), dtype=dt, count=n_pts)
        return np.stack([rec["x"], rec["y"], rec["z"]], -1).astype(np.float32)


def smooth_vertices(verts: np.ndarray, faces: np.ndarray,
                    iterations: int = 1, lam: float = 0.5) -> np.ndarray:
    """Laplacian smoothing over the mesh graph (reference `smooth_pts` does a
    kNN Laplacian over the point map, pointcloud_rgbd.cpp:932-959; using mesh
    edges is the same operation with the connectivity we already have)."""
    v = verts.astype(np.float64).copy()
    for _ in range(iterations):
        acc = np.zeros_like(v)
        cnt = np.zeros(len(v))
        for a, b in ((0, 1), (1, 2), (2, 0)):
            np.add.at(acc, faces[:, a], v[faces[:, b]])
            np.add.at(cnt, faces[:, a], 1)
            np.add.at(acc, faces[:, b], v[faces[:, a]])
            np.add.at(cnt, faces[:, b], 1)
        has = cnt > 0
        v[has] = (1 - lam) * v[has] + lam * acc[has] / cnt[has, None]
    return v.astype(verts.dtype)


# ----------------------------------------------------------------------
# checkpointing
# ----------------------------------------------------------------------

def _leaves(obj) -> List[torch.Tensor]:
    """The tensors of a state object (EsikfState, VoxelMap, GlobalPointMap,
    TriangleStore, HashTable) in the order jax.tree_util flattens the
    reference's pytree of the same class: dataclass fields in declaration
    order, nested tables recursively, static fields (cfg, capacity,
    max_probe) skipped."""
    out = []
    for f in dataclasses.fields(obj):
        x = getattr(obj, f.name)
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif dataclasses.is_dataclass(x):
            out.extend(_leaves(x))
    return out


def _rebuild(obj, it):
    kw = {}
    for f in dataclasses.fields(obj):
        x = getattr(obj, f.name)
        if isinstance(x, torch.Tensor):
            arr = next(it)
            if tuple(arr.shape) != tuple(x.shape):
                raise ValueError(f"checkpoint leaf for {f.name} has shape "
                                 f"{arr.shape}, expected {tuple(x.shape)}")
            kw[f.name] = torch.from_numpy(np.array(arr)).to(
                device=x.device, dtype=x.dtype)
        elif dataclasses.is_dataclass(x):
            kw[f.name] = _rebuild(x, it)
    return dataclasses.replace(obj, **kw)


def save_checkpoint(path: str, obj) -> None:
    """Snapshot a state object to npz (the reference's leaf layout)."""
    leaves = _leaves(obj)
    arrs = {f"leaf_{i}": x.detach().cpu().numpy() for i, x in enumerate(leaves)}
    np.savez_compressed(path, n_leaves=np.asarray(len(leaves)), **arrs)


def load_checkpoint(path: str, example):
    """Restore a state object saved by save_checkpoint (by either package),
    taking structure, devices and dtypes from `example`."""
    with np.load(path) as data:
        n = int(data["n_leaves"])
        if n != len(_leaves(example)):
            raise ValueError(f"{path}: {n} leaves, but {type(example).__name__}"
                             f" has {len(_leaves(example))}")
        leaves = [data[f"leaf_{i}"] for i in range(n)]
    return _rebuild(example, iter(leaves))
