"""Mesh / point-cloud export and map checkpointing — port of
immesh_tpu/runtime/export.py (reference persistence layer, SURVEY.md
C20/C23):

  * binary-little-endian PLY mesh export with optional Laplacian vertex
    smoothing (`save_to_ply_file` + `smooth_all_pts`, reference
    src/meshing/mesh_rec_geometry.cpp:60-131);
  * PCD point export and import;
  * whole-state checkpoints: one npz of the state's tensors flattened in
    the JAX pytree order (`n_leaves`, `leaf_{i}`), so a checkpoint written
    by either package loads into the other.

The plane-patch PLY export (`extract_plane_patches`, `save_plane_map_ply`)
is not ported yet.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch


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
