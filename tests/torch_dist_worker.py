"""Rank functions of the port's multi-rank tests (tests/test_torch_dist*.py,
test_torch_sharded_map.py, test_torch_multihost.py).  Not collected by
pytest; each function runs in a process that
immesh_tpu_torch.dist.multihost.run_world spawned, so this module imports
only torch, numpy and the port — a spawned rank must not import a test
module, which imports JAX.

Every function takes (rank, world, ...) and returns numpy arrays, which the
test process compares with the JAX dist/ steps."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from immesh_tpu_torch import interop
from immesh_tpu_torch.config import PRESETS
from immesh_tpu_torch.core.state import EsikfState
from immesh_tpu_torch.dist import comm
from immesh_tpu_torch.dist import lio as dlio
from immesh_tpu_torch.dist import mesh as dmesh
from immesh_tpu_torch.dist import sharded_map as dmap
from immesh_tpu_torch.dist import window_ba as dba
from immesh_tpu_torch.frontend.sim import LidarImuSimulator
from immesh_tpu_torch.frontend.types import ScanBundle
from immesh_tpu_torch.lio import imu as imu_mod
from immesh_tpu_torch.map.voxel_map import VoxelMap
from immesh_tpu_torch.mesh.global_map import GlobalPointMap
from immesh_tpu_torch.mesh.triangles import TriangleStore

CPU = torch.device("cpu")


def run_all(rank: int, world: int, jobs: list) -> list:
    """Run each (function name, kwargs) of `jobs` in order on this rank and
    return their results in that order; every rank runs the same list, so
    their collectives line up.  One thread a rank: the test workers share
    the host's cores."""
    torch.set_num_threads(1)
    return [globals()[name](rank, world, **kw) for name, kw in jobs]


def _np(x):
    return x.detach().cpu().numpy().copy()


# ---------------------------------------------------------------------------
def comm_ops(rank, world, n=1000):
    """psum of rank-seeded f32/int32 blocks, all_gather, ppermute ±1."""
    rng = np.random.default_rng(100 + rank)
    x = torch.from_numpy(rng.standard_normal(n).astype(np.float32) * 1e3)
    i = torch.from_numpy(rng.integers(-1000, 1000, 7).astype(np.int32))
    s = comm.psum({"x": x, "i": i, "b": x[:5].clone()})
    g = comm.all_gather(torch.tensor([rank, 2 * rank], dtype=torch.int32))
    flags = comm.all_gather(torch.tensor([rank % 2 == 0, True]))
    right = comm.ppermute([torch.full((3,), float(rank)),
                           torch.tensor([rank, rank % 2 == 1])], +1)
    left = comm.ppermute([torch.full((2,), rank, dtype=torch.int32)], -1)
    return {"x": _np(s["x"]), "i": _np(s["i"]), "b": _np(s["b"]),
            "gather": np.stack([_np(t) for t in g]),
            "flags": np.stack([_np(t) for t in flags]),
            "right_f": _np(right[0]), "right_b": _np(right[1]),
            "left": _np(left[0])}


def window_ba(rank, world, prob, iterations=6):
    """The point-sharded window solve; prob is a dict of numpy arrays."""
    full = dba.WindowProblem(**{k: torch.from_numpy(v)
                                for k, v in prob.items()})
    solve, shard = dba.make_dist_window_ba(iterations=iterations)
    out = solve(shard(full))
    return {k: _np(out[k]) for k in ("rot", "pos", "normal", "d", "cost")}


def _sim_bundles(n_rays, seed, frames, cfg):
    sim = LidarImuSimulator(n_rays=n_rays, seed=seed)
    acc, gyr = sim.static_imu(100)
    out = []
    for k in range(frames):
        f = sim.frame(k)
        out.append(ScanBundle.from_numpy(
            f.pts, f.t_rel, f.imu_stamps, f.imu_acc, f.imu_gyr,
            f.scan_duration, cfg.preprocess.max_points,
            cfg.imu.max_imu_per_scan, device=CPU))
    return acc, gyr, out


def _init_state(cfg, acc, gyr):
    return imu_mod.static_init(torch.from_numpy(acc), torch.from_numpy(gyr),
                               cfg.imu, EsikfState.identity(device=CPU))


def _vm_digest(vm: VoxelMap) -> np.ndarray:
    """The replicated map's bytes, field by field (bit-identity check)."""
    t = interop.to_numpy(vm)
    parts = [t["table"]["keys"], t["table"]["fp"]] + [
        t[f] for f in VoxelMap._FIELDS]
    return np.concatenate([np.ascontiguousarray(p).view(np.uint8).ravel()
                           for p in parts])


def sim_config(update_points=None):
    """PRESETS["sim"], with map_update_points replaced where given."""
    cfg = PRESETS["sim"]()
    if update_points is None:
        return cfg
    return cfg.replace(lio=dataclasses.replace(
        cfg.lio, map_update_points=update_points))


def dp_lio(rank, world, n_rays=2048, seed=7, frames=5, update_points=None):
    """make_dp_lio_step on PRESETS["sim"] after static_init: per-frame
    state, diag and a digest of the replicated map."""
    cfg = sim_config(update_points)
    acc, gyr, bundles = _sim_bundles(n_rays, seed, frames, cfg)
    step, shard = dlio.make_dp_lio_step(cfg)
    state = _init_state(cfg, acc, gyr)
    vm = VoxelMap.create(cfg.voxel_map, device=CPU)
    pos, rot, cov, n_eff, digests, worlds = [], [], [], [], [], []
    for b in bundles:
        state, vm, world_scan, diag = step(state, vm, shard(b))
        pos.append(_np(state.pos))
        rot.append(_np(state.rot))
        cov.append(_np(state.cov))
        n_eff.append(int(diag["n_effective"]))
        digests.append(_vm_digest(vm))
        worlds.append(_np(world_scan))
    return {"pos": np.stack(pos), "rot": np.stack(rot), "cov": np.stack(cov),
            "n_eff": np.asarray(n_eff), "vm": np.stack(digests),
            "world": worlds[-1], "n_voxels": int(vm.n_voxels())}


def sharded_mesh(rank, world, frames, sensor, slab_voxels,
                 append_margin=1.5):
    """make_sharded_mesh_step over the given full scans (every rank keeps
    its P(axis) rows); the gathered mesh and the summed counters."""
    cfg = PRESETS["sim"]()
    smm = dmesh.create_sharded_mesh(cfg, slab_voxels=slab_voxels,
                                    append_margin=append_margin, device=CPU)
    step = dmesh.make_sharded_mesh_step(cfg)
    sensor = torch.tensor(sensor, dtype=torch.float32)
    n_act = n_tris = n_drop = None
    for pts, mask in frames:
        N = pts.shape[0]
        sl = slice(rank * N // world, (rank + 1) * N // world)
        smm, n_act, n_tris, n_drop = step(
            smm, torch.from_numpy(pts[sl]), torch.from_numpy(mask[sl]),
            sensor)
    g = dmesh.gather_mesh(smm)
    return {"pts": g["pts"], "tris": g["tris"], "n_active": int(n_act),
            "n_tris": int(n_tris), "n_part_drop": int(n_drop),
            "n_pts_per_shard": g["n_pts_per_shard"]}


def mp_mesh(rank, world, frames, sensor):
    """make_mp_mesh_step: the replicated store after the frames."""
    cfg = PRESETS["sim"]()
    gm = GlobalPointMap.create(cfg.mesh, device=CPU)
    store = TriangleStore.create(cfg.mesh, device=CPU)
    step = dmesh.make_mp_mesh_step(cfg)
    sensor = torch.tensor(sensor, dtype=torch.float32)
    for pts, mask in frames:
        N = pts.shape[0]
        sl = slice(rank * N // world, (rank + 1) * N // world)
        gm, store, n_act = step(gm, store, torch.from_numpy(pts[sl]),
                                torch.from_numpy(mask[sl]), sensor)
    return {"pts": _np(gm.pts), "tri_ids": _np(store.tri_ids),
            "n_active": int(n_act)}


# ---------------------------------------------------------------------------
def halo_exchange(rank, world, shards, slab_voxels, halo_capacity):
    """ShardedVoxelMap.halo_exchange in the sub-group of ranks [0, n) for
    each n of `shards` ({n: [per-shard JAX state as numpy]})."""
    cfg = PRESETS["sim"]()
    out = {}
    for size, states in shards.items():
        group = dist.new_group(list(range(size)))
        if rank >= size:
            continue
        vm = interop.from_reference({"vm": states[rank]["vm"]}, cfg,
                                    device=CPU)["vm"]
        svm = dmap.ShardedVoxelMap(
            vm=vm, is_halo=torch.from_numpy(states[rank]["is_halo"]),
            shard_id=rank, n_shards=size, slab_voxels=slab_voxels,
            halo_capacity=halo_capacity)
        svm.halo_exchange(group)
        out[size] = {"vm": interop.to_numpy(svm.vm),
                     "is_halo": _np(svm.is_halo)}
    return out


def sharded_lio(rank, world, size=2, n_rays=2048, seed=7, frames=5,
                slab_voxels=4):
    """make_sharded_lio_step on PRESETS["sim"] after static_init, in the
    sub-group of ranks [0, size)."""
    group = dist.new_group(list(range(size)))
    if rank >= size:
        return None
    cfg = PRESETS["sim"]()
    acc, gyr, bundles = _sim_bundles(n_rays, seed, frames, cfg)
    step = dmap.make_sharded_lio_step(cfg, group)
    state = _init_state(cfg, acc, gyr)
    svm = dmap.create_sharded_map(cfg, group, slab_voxels=slab_voxels,
                                  device=CPU)
    pos, n_eff = [], []
    for b in bundles:
        state, svm, _, diag = step(state, svm, b)
        pos.append(_np(state.pos))
        n_eff.append(int(diag["n_effective"]))
    keys = svm.vm.table.keys
    owned = (keys[:, 0] != 0x7FFFFFFF) & ~svm.is_halo
    return {"pos": np.stack(pos), "n_eff": np.asarray(n_eff),
            "n_owned": int(svm.n_owned_voxels()),
            "n_halo": int(svm.is_halo.sum()), "owned_keys": _np(keys[owned])}


# ---------------------------------------------------------------------------
def mesh_builders(rank, world):
    """multihost.build_mesh / build_host_mesh / host_local_sharder on the
    CPU, and the mesh's group driving a collective."""
    from immesh_tpu_torch.dist import multihost
    m = multihost.build_mesh("dp", device_type="cpu")
    hm = multihost.build_host_mesh(device_type="cpu")
    group = m.get_group("dp")
    put = multihost.host_local_sharder(m, device="cpu")
    block = put(np.arange(4, dtype=np.float32) + 10 * rank)
    total = comm.psum({"x": block}, group)["x"]
    return {"shape": tuple(m.shape), "names": m.mesh_dim_names,
            "host_shape": tuple(hm.shape), "host_names": hm.mesh_dim_names,
            "group_size": dist.get_world_size(group), "block": _np(block),
            "sum": _np(total)}
