"""Process-group set-up, device meshes, a world launcher and the scaling
harness — port of immesh_tpu/dist/multihost.py over torch.distributed.

The reference is one shared-memory process (its only IPC is ROS pub/sub,
SURVEY.md P7).  The JAX package's growth path brings every host's chips
into one global device set; here every rank is one process with one
device, joined by `torch.distributed`, and the dist/ steps (dp LIO,
sharded map, sharded mesh, window BA) take the process group where JAX
addressed a mesh axis.

Single-process use is the default: `initialize()` is a no-op unless a
coordinator is configured.  `run_world` starts a world of n ranks on this
host (spawned processes, a FileStore rendezvous under a temporary
directory, a bounded wait); the scaling harness and the tests use it.
Where n ranks share one device (the CPU, or one card — NCCL does not take
two ranks on one GPU, so those worlds use gloo), wall time cannot improve
with n: `overhead_factor_vs_1dev`, the cost of sharding and collectives at
a fixed total workload, is the metric, and `shared_device` says so.
"""

from __future__ import annotations

import json
import os
import pickle
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

# env names for headless multi-host launches (one process per rank)
ENV_COORDINATOR = "IMMESH_COORDINATOR"        # e.g. "10.0.0.1:8476"
ENV_NUM_PROCESSES = "IMMESH_NUM_PROCESSES"
ENV_PROCESS_ID = "IMMESH_PROCESS_ID"

GROUP_TIMEOUT = timedelta(seconds=180)


def default_backend(n_local: int) -> str:
    """NCCL when each of the `n_local` ranks on this host can own a GPU of
    its own; gloo otherwise (the CPU, or ranks sharing a card)."""
    if torch.cuda.is_available() and torch.cuda.device_count() >= n_local:
        return "nccl"
    return "gloo"


def rank_device(rank: int, device="cuda") -> torch.device:
    """The device of `rank`: the CPU, or card rank mod the host's card
    count (so ranks beyond the count share cards)."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run on the CPU")
    return torch.device("cuda", rank % torch.cuda.device_count())


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> bool:
    """Join the multi-process group; no-op for single-process runs.

    Arguments fall back to IMMESH_COORDINATOR / IMMESH_NUM_PROCESSES /
    IMMESH_PROCESS_ID.  Returns True iff a multi-process group was
    initialized (tcp:// rendezvous at the coordinator).  `backend` defaults
    to default_backend(n) with n the ranks on this host (LOCAL_WORLD_SIZE,
    as torchrun sets it, else all of them)."""
    coordinator_address = coordinator_address or os.environ.get(
        ENV_COORDINATOR)
    if num_processes is None and ENV_NUM_PROCESSES in os.environ:
        num_processes = int(os.environ[ENV_NUM_PROCESSES])
    if process_id is None and ENV_PROCESS_ID in os.environ:
        process_id = int(os.environ[ENV_PROCESS_ID])
    if coordinator_address is None or (num_processes or 1) <= 1:
        return False
    if process_id is None:
        raise ValueError(f"a multi-process run needs {ENV_PROCESS_ID}")
    n_local = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    dist.init_process_group(
        backend or default_backend(n_local),
        init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id, timeout=GROUP_TIMEOUT)
    return True


def build_mesh(axis: str = "dp", device_type: Optional[str] = None,
               ranks: Optional[Sequence[int]] = None):
    """1-D DeviceMesh over the world's ranks (or `ranks`), dimension name
    `axis`; `mesh.get_group(axis)` is the group the dist/ steps take.
    device_type defaults to "cuda" where a card is visible."""
    from torch.distributed.device_mesh import DeviceMesh
    device_type = device_type or ("cuda" if torch.cuda.is_available()
                                  else "cpu")
    ranks = list(ranks) if ranks is not None else list(
        range(dist.get_world_size()))
    return DeviceMesh(device_type, ranks, mesh_dim_names=(axis,))


def build_host_mesh(host_axis: str = "host", chip_axis: str = "dp",
                    device_type: Optional[str] = None,
                    local_world_size: Optional[int] = None):
    """2-D {hosts × ranks per host} DeviceMesh: collectives over
    `chip_axis` stay inside a host, `host_axis` crosses hosts.  Ranks per
    host default to LOCAL_WORLD_SIZE (as torchrun sets it), else the whole
    world on one host."""
    from torch.distributed.device_mesh import DeviceMesh
    device_type = device_type or ("cuda" if torch.cuda.is_available()
                                  else "cpu")
    world = dist.get_world_size()
    per = local_world_size or int(os.environ.get("LOCAL_WORLD_SIZE", world))
    grid = torch.arange(world).reshape(world // per, per)
    return DeviceMesh(device_type, grid, mesh_dim_names=(host_axis, chip_axis))


def host_local_sharder(mesh=None, axis: str = "dp", device="cuda"):
    """fn(np_array) → this rank's tensor.  Each rank loads its own block of
    a point-sharded array (no rank materializes the global one), so the
    JAX package's make_array_from_process_local_data is the identity on the
    local block, moved to the rank's device."""
    dev = torch.device(device)

    def put(local_block: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(local_block), device=dev)

    return put


# ======================================================================
# world launcher
# ======================================================================

def _rank_main(fn: Callable, rank: int, world: int, tmp: str, backend: str,
               args: tuple) -> None:
    # the ranks share this host's cores
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    try:
        store = dist.FileStore(os.path.join(tmp, "store"), world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world, timeout=GROUP_TIMEOUT)
        try:
            result = fn(rank, world, *args)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as fh:
            pickle.dump(result, fh)
    except BaseException:
        with open(os.path.join(tmp, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise SystemExit(1)


def run_world(fn: Callable, world: int, args: tuple = (), *,
              backend: str = "gloo", deadline_s: float = 900.0) -> List:
    """Run fn(rank, world, *args) in `world` spawned processes joined in
    one process group (FileStore rendezvous under a temporary directory,
    GROUP_TIMEOUT on every collective) and return the ranks' results in
    rank order.  `fn` and `args` must pickle (a module-level function).
    A rank that fails, or a world still running after `deadline_s`, stops
    every rank and raises RuntimeError with the failing rank's traceback."""
    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory(prefix="immesh_world_") as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, tmp, backend, args))
                 for r in range(world)]
        for p in procs:
            p.start()
        t_end = time.monotonic() + deadline_s
        failed = None
        try:
            while any(p.is_alive() for p in procs):
                bad = [r for r, p in enumerate(procs)
                       if p.exitcode not in (None, 0)]
                if bad:
                    failed = bad[0]
                    break
                if time.monotonic() > t_end:
                    raise RuntimeError(
                        f"world of {world} ranks still running after "
                        f"{deadline_s:.0f} s")
                time.sleep(0.05)
            bad = [r for r, p in enumerate(procs) if p.exitcode != 0]
            if failed is None and bad:
                failed = bad[0]
            if failed is not None:
                err = os.path.join(tmp, f"rank{failed}.err")
                msg = (open(err).read() if os.path.exists(err)
                       else f"exit code {procs[failed].exitcode}")
                raise RuntimeError(f"rank {failed} of {world} failed:\n{msg}")
            out = []
            for r in range(world):
                with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as fh:
                    out.append(pickle.load(fh))
            return out
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join(10)


# ======================================================================
# scaling harness
# ======================================================================

def bench_frames(cfg, n_frames: int, outdoor: bool = True) -> list:
    """Bench-scale simulator scans as numpy arrays (the outdoor street
    canyon and max_points-ray scans of the single-device bench):
    [(pts, t_rel, imu_stamps, imu_acc, imu_gyr, scan_duration), …]."""
    from immesh_tpu_torch.frontend.sim import (
        ForwardTrajectory, LidarImuSimulator, outdoor_scene)
    n_pts = cfg.preprocess.max_points
    if outdoor:
        sim = LidarImuSimulator(
            scene=outdoor_scene(length=400.0), traj=ForwardTrajectory(),
            n_rays=n_pts, rings=64, max_range=120.0, seed=0)
    else:
        sim = LidarImuSimulator(n_rays=n_pts, seed=0)
    out = []
    for k in range(n_frames):
        f = sim.frame(k)
        out.append((f.pts, f.t_rel, f.imu_stamps, f.imu_acc, f.imu_gyr,
                    f.scan_duration))
    return out


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _curve_rank(rank: int, world: int, cfg, frames: list, warmup: int,
                with_mesh_step: bool, device: str) -> dict:
    """One rank of one scaling-curve world: per-frame LIO and mesh times."""
    from immesh_tpu_torch.core.state import EsikfState
    from immesh_tpu_torch.dist.lio import make_dp_lio_step
    from immesh_tpu_torch.dist.mesh import (
        create_sharded_mesh, make_sharded_mesh_step)
    from immesh_tpu_torch.frontend.types import ScanBundle
    from immesh_tpu_torch.map.voxel_map import VoxelMap

    dev = rank_device(rank, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    lio_step, shard_bundle = make_dp_lio_step(cfg)
    mesh_step = make_sharded_mesh_step(cfg) if with_mesh_step else None
    state = EsikfState.identity(device=dev)
    vm = VoxelMap.create(cfg.voxel_map, device=dev)
    smm = create_sharded_mesh(cfg, device=dev) if with_mesh_step else None
    n_pts = cfg.preprocess.max_points
    local = [shard_bundle(ScanBundle.from_numpy(
        *f, n_pts, cfg.imu.max_imu_per_scan, device=dev)) for f in frames]
    t_lio, t_mesh = [], []
    for k, b in enumerate(local):
        _sync(dev)
        t0 = time.perf_counter()
        state, vm, world_scan, _ = lio_step(state, vm, b)
        _sync(dev)
        t1 = time.perf_counter()
        if mesh_step is not None:
            smm, _, _, _ = mesh_step(smm, world_scan, b.mask, state.pos)
            _sync(dev)
        t2 = time.perf_counter()
        if k >= warmup:
            t_lio.append(t1 - t0)
            t_mesh.append(t2 - t1)
    return {"t_lio": t_lio, "t_mesh": t_mesh, "device": str(dev),
            "device_name": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu")}


def scaling_curve(cfg, ns: Sequence[int], *, frames: int = 4,
                  warmup: int = 2, with_mesh_step: bool = True,
                  outdoor: bool = True, mode: str = "strong",
                  out_path: Optional[str] = None, device="cuda",
                  backend: Optional[str] = None) -> list:
    """Scaling sweep of the dp-LIO + capacity-sharded mesh step at bench
    scale: one world of n ranks per n, per-stage (LIO / mesh) timing.

    mode="strong": fixed total workload (cfg.preprocess.max_points rays per
    frame) over n ranks.  mode="weak": fixed PER-RANK workload — each
    n-rank world processes the first n·(max_points/max(ns)) points.

    A frame's stage time is its slowest rank's.  Ranks beyond the host's
    card count share cards (gloo); `shared_device` marks such worlds, whose
    honest metric is `overhead_factor_vs_1dev` = T(n)/T(1) at fixed work.
    Keys as the JAX harness's, `shared_device` in place of its
    `cpu_virtual_mesh`; `device` names the device the ranks ran on."""
    import dataclasses

    if torch.device(device).type == "cuda":
        rank_device(0, device)  # raises without a card
    n_pts_full = cfg.preprocess.max_points
    frames_np = bench_frames(cfg, warmup + frames, outdoor)
    n_max = max(ns)
    n_cards = (torch.cuda.device_count()
               if torch.device(device).type == "cuda" else 0)
    results, t_base = [], None
    for n in ns:
        if mode == "weak":
            keep = (n_pts_full // n_max) * n
            cfg_n = cfg.replace(preprocess=dataclasses.replace(
                cfg.preprocess, max_points=keep))
            frames_n = [(f[0][:keep], f[1][:keep]) + f[2:] for f in frames_np]
        else:
            cfg_n, frames_n = cfg, frames_np
        be = backend or (default_backend(n) if n_cards else "gloo")
        ranks = run_world(_curve_rank, n, (cfg_n, frames_n, warmup,
                                           with_mesh_step, device),
                          backend=be)
        t_lio = float(np.sum(np.max([r["t_lio"] for r in ranks], axis=0)))
        t_mesh = float(np.sum(np.max([r["t_mesh"] for r in ranks], axis=0)))
        dt = (t_lio + t_mesh) / frames
        if t_base is None:
            t_base = dt
        npts_n = cfg_n.preprocess.max_points
        fps, base_fps = 1.0 / dt, 1.0 / t_base
        results.append({
            "n_devices": n,
            "mode": mode,
            "frames_per_s": fps,
            "speedup": fps / base_fps,
            "efficiency": fps / (base_fps * (n / ns[0])),
            "t_lio_ms": 1e3 * t_lio / frames,
            "t_mesh_ms": 1e3 * t_mesh / frames,
            "overhead_factor_vs_1dev": (
                dt / t_base if mode == "strong"
                else dt / (t_base * npts_n / (n_pts_full // n_max))),
            "points_per_frame": npts_n,
            # per-frame collective payloads (bytes)
            "allgather_scan_bytes": int(npts_n * 3 * 4 * (n - 1) / max(n, 1)),
            # one rank's gathered ESIKF block per iteration: the 6×6 and 6
            # f32 sums and the int32 row count
            "psum_gn_bytes": 0 if n == 1 else (36 + 6) * 4 + 4,
            "shared_device": n > 1 and (n_cards == 0 or n > n_cards),
            "backend": be,
            "device": ranks[0]["device_name"],
        })
    if out_path:
        with open(out_path, "w") as f:
            json.dump(results, f, indent=1)
    return results
