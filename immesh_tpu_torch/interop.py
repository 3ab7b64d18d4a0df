"""Carry persistent state between the JAX reference and the port.

The reference's persistent state is four pytrees — EsikfState, VoxelMap
(with its HashTable), GlobalPointMap (with two HashTables) and
TriangleStore — plus the texture path's ColorStore.  Here they travel as
nested dicts of numpy arrays under the reference's field names, e.g.

    {"state": {"rot": ..., "pos": ..., ...},
     "vm": {"table": {"keys": ..., "fp": ...}, "sum_p": ..., ...},
     "gm": {"pts": ..., "dedup": {...}, "vox": {...}, ...},
     "store": {"tri_ids": ..., "tri_n": ..., "dirty": ...},
     "colors": {"rgb": ..., "cov": ..., "n_obs": ..., ...}}

so a test can start both implementations from one state and compare a
single step without accumulated drift.

`load_reference_checkpoint` reads the four .npz files the reference's
`ImMeshRuntime.save_state` writes (and the port's, which has the same
layout) into the port's objects.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from immesh_tpu_torch.config import ImMeshConfig
from immesh_tpu_torch.core.state import EsikfState
from immesh_tpu_torch.device import resolve_device
from immesh_tpu_torch.map.hash import HashTable
from immesh_tpu_torch.map.voxel_map import VoxelMap
from immesh_tpu_torch.mesh.global_map import GlobalPointMap
from immesh_tpu_torch.mesh.triangles import TriangleStore
from immesh_tpu_torch.runtime.export import load_checkpoint
from immesh_tpu_torch.texture.render import ColorStore

_GM_TABLE_PROBE = 32  # GlobalPointMap.create's max_probe for both tables


def _tensor_fields(cls):
    return [f.name for f in dataclasses.fields(cls)
            if f.name not in ("cfg", "capacity", "max_probe")]


def _table(d: dict, max_probe: int, dev) -> HashTable:
    keys = torch.from_numpy(np.array(d["keys"], np.int32)).to(dev)
    fp = torch.from_numpy(np.array(d["fp"], np.int32)).to(dev)
    return HashTable(keys=keys, fp=fp, capacity=keys.shape[0],
                     max_probe=int(d.get("max_probe", max_probe)))


def _build(cls, d: dict, dev, **extra):
    kw = {name: torch.from_numpy(np.array(d[name])).to(dev)
          for name in _tensor_fields(cls) if name not in extra}
    return cls(**kw, **extra)


def from_reference(tree: dict, cfg: ImMeshConfig, device="cuda") -> dict:
    """Build the port's objects from reference state given as nested dicts
    of numpy arrays.  `tree` may hold any of "state", "vm", "gm", "store";
    the result holds the same keys.  `cfg` supplies the static fields the
    reference keeps outside its pytrees (VoxelMap.cfg, table probe bounds)."""
    dev = resolve_device(device)
    out = {}
    if "state" in tree:
        out["state"] = _build(EsikfState, tree["state"], dev)
    if "vm" in tree:
        d = tree["vm"]
        out["vm"] = _build(
            VoxelMap, d, dev,
            table=_table(d["table"], cfg.voxel_map.max_probe, dev),
            cfg=cfg.voxel_map)
    if "gm" in tree:
        d = tree["gm"]
        out["gm"] = _build(
            GlobalPointMap, d, dev,
            dedup=_table(d["dedup"], _GM_TABLE_PROBE, dev),
            vox=_table(d["vox"], _GM_TABLE_PROBE, dev), cfg=cfg.mesh)
    if "store" in tree:
        out["store"] = _build(TriangleStore, tree["store"], dev, cfg=cfg.mesh)
    if "colors" in tree:
        out["colors"] = _build(ColorStore, tree["colors"], dev)
    return out


def to_numpy(obj):
    """The reverse of from_reference: a port object (or a dict of them) as
    nested dicts of numpy arrays under the reference's field names.  The
    arrays are copies, also of CPU tensors, so a snapshot does not follow
    the object's later in-place updates."""
    if isinstance(obj, dict):
        return {k: to_numpy(v) for k, v in obj.items()}
    if isinstance(obj, torch.Tensor):
        return obj.detach().to("cpu", copy=True).numpy()
    if isinstance(obj, HashTable):
        return {"keys": to_numpy(obj.keys), "fp": to_numpy(obj.fp),
                "max_probe": obj.max_probe}
    return {name: to_numpy(getattr(obj, name))
            for name in _tensor_fields(type(obj))}


def load_reference_checkpoint(prefix: str, cfg: ImMeshConfig,
                              device="cuda") -> dict:
    """State saved by `ImMeshRuntime.save_state(prefix)` of either package:
    {"state", "vm"} from `<prefix>.lio.npz` / `.vmap.npz`, plus {"gm",
    "store"} from `.gmap.npz` / `.tris.npz` when meshing was on.  Shapes
    and static fields come from `cfg`, which must be the saving run's."""
    dev = resolve_device(device)
    lio = cfg.lio
    out = {
        "state": load_checkpoint(prefix + ".lio.npz", EsikfState.identity(
            gravity=cfg.imu.gravity, init_rot_cov=lio.init_rot_cov,
            init_pos_cov=lio.init_pos_cov, init_vel_cov=lio.init_vel_cov,
            init_bias_cov=lio.init_bias_cov,
            init_grav_cov=lio.init_grav_cov, device=dev)),
        "vm": load_checkpoint(prefix + ".vmap.npz",
                              VoxelMap.create(cfg.voxel_map, device=dev)),
    }
    if os.path.exists(prefix + ".gmap.npz"):
        out["gm"] = load_checkpoint(prefix + ".gmap.npz",
                                    GlobalPointMap.create(cfg.mesh, device=dev))
        out["store"] = load_checkpoint(prefix + ".tris.npz",
                                       TriangleStore.create(cfg.mesh, device=dev))
    return out
