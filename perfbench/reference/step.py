"""One frame of the plain reference: the LIO step, the mesh step, the two
occupancy-triggered compactions and, where the configuration turns it on,
the window BA, on state given as flat dicts of tensors.

The program's state crosses into the reference only as `flatten` gives it:
a dict from a dotted field path ("table.keys", "cov") to a tensor, or to a
Python number for a size.  `unflatten` rebuilds the reference's own
dataclasses from such a dict, so nothing of the program is imported here.

A frame is the composition both entries of the program run: lio_step, then
mesh_step on the world scan and pose it made, then the plane map's
compaction and the mesh maps' compaction where their polls call for one;
with `cfg.ba.enabled`, then WindowBA.observe on the posterior pose and the
world scan, and a refined window's correction left-applied to the filter
(runtime/app.py's order).
A poll reads the occupancy the previous frame left (the program copies it
to the host one frame late), so the decision of frame k is known from the
state before frame k and from whether frame k − 1 compacted: `poll`."""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

from perfbench.reference.config import ImMeshConfig
from perfbench.reference.core.state import EsikfState
from perfbench.reference.frontend.types import ScanBundle
from perfbench.reference.lio.pipeline import (
    _keep_radius_vm, extrinsics, lio_step)
from perfbench.reference.lio.window import Window, WindowBA
from perfbench.reference.map.hash import HashTable
from perfbench.reference.map.voxel_map import VoxelMap
from perfbench.reference.mesh.global_map import GlobalPointMap
from perfbench.reference.mesh.pipeline import (
    _compact_mesh, _keep_radius_mesh, mesh_step)
from perfbench.reference.mesh.triangles import TriangleStore

_NESTED = {"HashTable": HashTable}


def flatten(obj, prefix: str = "") -> Dict[str, object]:
    """{dotted field path: tensor clone or number} of a dataclass tree;
    configs and other objects are left out."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        key = prefix + f.name
        if torch.is_tensor(v):
            out[key] = v.detach().clone()
        elif dataclasses.is_dataclass(v) and type(v).__name__ in _NESTED:
            out.update(flatten(v, key + "."))
        elif isinstance(v, (int, float, bool)):
            out[key] = v
    return out


def unflatten(cls, flat: Dict[str, object], cfg=None, prefix: str = ""):
    """The reference's `cls` from a flatten() dict (its tensors cloned);
    a field named cfg takes `cfg`."""
    kw = {}
    for f in dataclasses.fields(cls):
        key = prefix + f.name
        if f.name == "cfg":
            kw[f.name] = cfg
        elif str(f.type) in _NESTED:
            kw[f.name] = unflatten(_NESTED[str(f.type)], flat, None,
                                   key + ".")
        else:
            v = flat[key]
            kw[f.name] = v.clone() if torch.is_tensor(v) else v
    return cls(**kw)


@dataclasses.dataclass
class Frame:
    """The program's state between frames, rebuilt as the reference's."""
    state: EsikfState
    vm: VoxelMap
    gm: GlobalPointMap
    store: TriangleStore
    ba: Optional[WindowBA] = None   # the BA window, where BA is on


PARTS = ("state", "vm", "gm", "store")


def frame_from(cfg: ImMeshConfig, flat: Dict[str, Dict[str, object]]
               ) -> Frame:
    """Frame from {"state": ..., "vm": ..., "gm": ..., "store": ...}, and
    the BA window from its "ba" where there is one."""
    return Frame(unflatten(EsikfState, flat["state"]),
                 unflatten(VoxelMap, flat["vm"], cfg.voxel_map),
                 unflatten(GlobalPointMap, flat["gm"], cfg.mesh),
                 unflatten(TriangleStore, flat["store"], cfg.mesh),
                 WindowBA(cfg, unflatten(Window, flat["ba"]))
                 if "ba" in flat else None)


def flat_frame(fr: Frame) -> Dict[str, Dict[str, object]]:
    """flatten() of each part of `fr`, the BA window's under "ba"."""
    out = {n: flatten(getattr(fr, n)) for n in PARTS}
    if fr.ba is not None:
        out["ba"] = flatten(fr.ba.window())
    return out


def initial_frame(cfg: ImMeshConfig, device, static_imu=None) -> Frame:
    """The state a run starts from: the identity filter (statically
    initialised from `static_imu` = (acc, gyr) where given) and empty
    maps."""
    from perfbench.reference.lio.imu import static_init
    lio = cfg.lio
    state = EsikfState.identity(
        gravity=cfg.imu.gravity, init_rot_cov=lio.init_rot_cov,
        init_pos_cov=lio.init_pos_cov, init_vel_cov=lio.init_vel_cov,
        init_bias_cov=lio.init_bias_cov, init_grav_cov=lio.init_grav_cov,
        device=device)
    if static_imu is not None:
        acc, gyr = (torch.as_tensor(x, dtype=torch.float32, device=device)
                    for x in static_imu)
        state = static_init(acc, gyr, cfg.imu, state)
    return Frame(state, VoxelMap.create(cfg.voxel_map, device=device),
                 GlobalPointMap.create(cfg.mesh, device=device),
                 TriangleStore.create(cfg.mesh, device=device),
                 WindowBA(cfg) if cfg.ba.enabled else None)


def lio_poll(fr: Frame, cfg: ImMeshConfig) -> bool:
    """Whether the plane map's poll of the state before a frame calls for
    a compaction after it (the previous frame did not compact)."""
    mc = cfg.voxel_map
    return (mc.compact_check_every > 0
            and int(fr.vm.n_voxels()) > mc.compact_high_water * mc.capacity)


def mesh_poll(fr: Frame, cfg: ImMeshConfig) -> bool:
    """Whether the mesh maps' poll calls for a compaction after the frame."""
    mc = cfg.mesh
    return mc.compact_check_every > 0 and (
        int(fr.gm.n_points()) > mc.compact_high_water * mc.points_capacity
        or int(fr.gm.vox.occupancy())
        > mc.compact_high_water * mc.voxel_capacity)


def compact_lio(fr: Frame, cfg: ImMeshConfig) -> None:
    """The plane map's compaction around the pose (LioPipeline's)."""
    mc = cfg.voxel_map
    high = mc.compact_high_water * mc.capacity
    low = int(mc.compact_low_water * mc.capacity)
    pos = fr.state.pos
    radius = _keep_radius_vm(fr.vm, pos, low, mc.local_map_radius)
    fr.vm.compact(pos, radius)
    r = float(radius) * 0.7
    for _ in range(2):
        if int(fr.vm.n_voxels()) <= high:
            break
        fr.vm.compact(pos, torch.tensor(r, dtype=torch.float32,
                                        device=pos.device))
        r *= 0.7


def compact_mesh(fr: Frame, cfg: ImMeshConfig) -> None:
    """The mesh maps' compaction around the pose (MeshPipeline's)."""
    mc = cfg.mesh
    high_p = mc.compact_high_water * mc.points_capacity
    high_v = mc.compact_high_water * mc.voxel_capacity
    low_p = mc.compact_low_water * mc.points_capacity
    low_v = mc.compact_low_water * mc.voxel_capacity
    center = fr.state.pos
    radius = _keep_radius_mesh(fr.gm, center, int(low_p), int(low_v),
                               mc.local_map_radius)
    _compact_mesh(fr.gm, fr.store, center, radius)
    r = float(radius) * 0.7
    for _ in range(2):
        if (int(fr.gm.n_points()) <= high_p
                and int(fr.gm.vox.occupancy()) <= high_v):
            break
        _compact_mesh(fr.gm, fr.store, center, torch.tensor(
            r, dtype=torch.float32, device=center.device))
        r *= 0.7


def bundle_of(t: Dict[str, torch.Tensor]) -> ScanBundle:
    """The reference's ScanBundle from a dict of its fields' tensors."""
    return ScanBundle(**{f.name: t[f.name]
                         for f in dataclasses.fields(ScanBundle)})


def observe_window(cfg: ImMeshConfig, fr: Frame, world: torch.Tensor,
                   mask: torch.Tensor) -> bool:
    """The frame's pose and world scan into the BA window; a refined
    window's world-frame correction left-applied to the filter (velocity
    rotates with the frame).  Whether the window was refined."""
    pos = fr.state.pos.cpu().numpy()
    corr = fr.ba.observe(fr.state.rot, pos, world, mask, fr.vm)
    if corr is None:
        return False
    if cfg.ba.apply_correction:
        st = fr.state
        dR, dp = (torch.from_numpy(np.asarray(corr[key], np.float32)).to(
            st.pos.device) for key in ("d_rot", "d_pos"))
        fr.state = st.replace(rot=dR @ st.rot, pos=dR @ st.pos + dp,
                              vel=dR @ st.vel)
    return True


def run_frame(cfg: ImMeshConfig, fr: Frame, bundle: ScanBundle,
              polls=(False, False)) -> dict:
    """One frame on `fr`, in place.  `polls` = (plane map, mesh maps): a
    compaction follows the frame where its poll, taken before it, called
    for one; the BA window follows the compactions.  Returns {"world":
    world scan, "diag": LIO diag, "compacted": (lio, mesh), "ba_refined"}."""
    ext = extrinsics(cfg.imu, fr.state.pos)
    fr.state, fr.vm, world, diag = lio_step(fr.state, fr.vm, bundle, cfg,
                                            ext)
    fr.gm, fr.store, n_active, _, _, _ = mesh_step(
        fr.gm, fr.store, world, bundle.mask, fr.state.pos,
        fr.gm.cfg.mesh_chunk)
    if polls[0]:
        compact_lio(fr, cfg)
    if polls[1]:
        compact_mesh(fr, cfg)
    refined = (fr.ba is not None
               and observe_window(cfg, fr, world, bundle.mask))
    return {"world": world, "diag": dict(diag, n_active_voxels=n_active),
            "compacted": tuple(polls), "ba_refined": refined}
