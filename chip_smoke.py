"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--frames N]

Phases (each one passes or the script exits non-zero; nothing is caught):

  0. device   — requires CUDA and prints the card's name and power limit;
  1. build    — compiles every kernel of the main path from csrc/ with nvcc;
  2. kernels  — holds each kernel against its plain PyTorch version on the
                card at the main path's shapes (bit-identical results) and
                times both;
  3. ints     — the wrapping int32 hash arithmetic gives the same bits on the
                card as on the CPU, and segment sums are deterministic;
  4. main     — JointPipeline at the KITTI operating point (131,072-ray
                scans from the outdoor simulator, adaptive re-mesh budget)
                for warm-up plus N timed frames; checks that the kernel ran
                on every frame with active voxels, that poses follow the
                simulator's ground truth, that triangles exist and that a
                compaction fired;
  5. parity   — a small scan sequence run on the card and on the CPU (the
                path the tests hold against the JAX reference) agrees.

The line before the last is a JSON object describing every kernel; the last
line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and non-tensor f32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# poses lag the simulator's 2 s launch ramp (4.5 m/s², constant-twist model
# without an IMU); the reference LIO shows the same lag on these frames
POSE_TOL_M = 0.5
TIE_SCALE = 0.02  # MeshConfig.tie_scale of the kitti preset
TRI_COUNT_RTOL = 0.05


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def kitti_config():
    """bench.py::kitti_config: the kitti preset at its true operating point
    (131,072-point scans, IMU-less constant-twist mode, capacities sized so
    a 40-frame outdoor run crosses the compaction high-water mark)."""
    from immesh_tpu_torch.config import PRESETS
    base = PRESETS["kitti"]()
    return base.replace(
        preprocess=base.preprocess.__class__(
            lidar_type=100, blind=0.05, max_points=131072),
        voxel_map=dataclasses.replace(
            base.voxel_map, touched_voxels_per_scan=1024),
        mesh=base.mesh.__class__(
            pts_minimum_scale=0.15, voxel_resolution=0.6,
            points_capacity=2 ** 17, voxel_capacity=2 ** 15,
            compact_check_every=8, local_map_radius=120.0,
            active_voxels_per_frame=1024, mesh_chunk=512),
    )


def small_config():
    """A KITTI-shaped configuration cut to 8,192 rays and small capacities
    (the one tests/test_torch_joint.py holds against the JAX reference)."""
    from immesh_tpu_torch.config import PRESETS
    base = PRESETS["kitti"]()
    return base.replace(
        preprocess=base.preprocess.__class__(
            lidar_type=100, blind=0.05, max_points=8192),
        voxel_map=dataclasses.replace(
            base.voxel_map, capacity=2 ** 13, touched_voxels_per_scan=512),
        lio=dataclasses.replace(base.lio, map_update_points=2048),
        mesh=base.mesh.__class__(
            pts_minimum_scale=0.15, voxel_resolution=0.6,
            points_capacity=2 ** 13, voxel_capacity=2 ** 11,
            compact_check_every=8, local_map_radius=40.0,
            active_voxels_per_frame=128, file_voxels_per_frame=1024,
            max_pts_per_frame=2000, mesh_chunk=64),
    )


def make_sim(n_rays: int, rings: int):
    from immesh_tpu_torch.frontend.sim import (
        ForwardTrajectory, LidarImuSimulator, outdoor_scene)
    return LidarImuSimulator(
        scene=outdoor_scene(length=400.0), traj=ForwardTrajectory(speed=9.0),
        n_rays=n_rays, rings=rings, max_range=120.0, seed=0)


def bundle(f, cfg, device):
    from immesh_tpu_torch.frontend.types import ScanBundle
    return ScanBundle.from_numpy(
        f.pts, f.t_rel, f.imu_stamps, f.imu_acc, f.imu_gyr, f.scan_duration,
        cfg.preprocess.max_points, cfg.imu.max_imu_per_scan, device=device)


# ---------------------------------------------------------------------------
# phase 2: pairs_argmin against its plain version
# ---------------------------------------------------------------------------
def pairs_inputs(seed: int, A: int, K: int):
    """Channel inputs as delaunay_pairs_w builds them, from voxel-sized
    point sets with the cases the kernel must get right: ~50 % masked
    points, a gridded (cocircular) voxel, an all-masked voxel, voxels with
    one and two valid points."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-0.3, 0.3, (A, K, 2)).astype(np.float32)
    mask = rng.random((A, K)) < 0.5
    g = np.stack(np.meshgrid(np.arange(7), np.arange(7)), -1).reshape(-1, 2)
    g = (g[:K] * 0.1 - 0.3).astype(np.float32)
    uv[0, :len(g)] = g
    mask[0, :len(g)] = True
    mask[1] = False
    mask[2] = False
    mask[2, 5] = True
    mask[3] = False
    mask[3, [0, K - 1]] = True
    tb = rng.integers(-2 ** 31, 2 ** 31 - 1, (A, K), dtype=np.int32)
    return uv, mask, tb


def channels(uv, mask, tb, device):
    """(u, v, lift, valid, d_eps) as delaunay_pairs_w hands them to the
    kernel on the main path (tie_scale of the kitti preset)."""
    from immesh_tpu_torch.mesh.delaunay import pairs_channels
    return pairs_channels(
        torch.from_numpy(uv).to(device), torch.from_numpy(mask).to(device),
        tiebreak=torch.from_numpy(tb).to(device), tie_scale=TIE_SCALE)


def event_ms(fn, reps: int) -> float:
    """Median over `reps` single calls, each timed with CUDA events."""
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def pairs_bound_ms(u, v, valid, d_eps) -> tuple:
    """Least time for this data: operations the formula needs (6 per valid
    (i, j) pair for the edge terms, 5 per valid (i, j, k) for the side test
    and 8 more — difference, two products, sums and the divide — where k is
    left of the edge) over the f32 peak, against the bytes each input is
    read and the output written once over the memory rate."""
    A, K = u.shape
    ok = valid > 0
    n = ok.sum(-1).to(torch.float64)
    pairs = float((n * n).sum())
    triples = float((n * n * n).sum())
    left = 0.0
    for a0 in range(0, A, 64):
        uu, vv = u[a0:a0 + 64], v[a0:a0 + 64]
        du = uu[:, None, :] - uu[:, :, None]            # [a, i, j] = u_j − u_i
        dv = vv[:, None, :] - vv[:, :, None]
        d = (du[:, :, :, None] * dv[:, :, None, :]
             - dv[:, :, :, None] * du[:, :, None, :])   # [a, i, j, k]
        o = ok[a0:a0 + 64]
        okt = o[:, :, None, None] & o[:, None, :, None] & o[:, None, None, :]
        left += float((okt & (d > d_eps[a0:a0 + 64, None, None, None])).sum())
    ops = 6 * pairs + 5 * triples + 8 * left
    nbytes = 4 * (4 * A * K + A) + 4 * A * K * K
    t_ops = 1e3 * ops / PEAK_F32_OPS_PER_S
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def phase_kernels(dev):
    from immesh_tpu_torch.kernels import pairs_argmin as pk
    from immesh_tpu_torch.mesh.delaunay import delaunay_pairs_w

    K = 48
    max_err = 0
    for seed, A in ((0, 512), (1, 512), (2, 509)):
        uv, mask, tb = pairs_inputs(seed, A, K)
        ch = channels(uv, mask, tb, dev)
        Wk = pk.pairs_argmin_cuda(*ch)
        Wp = pk.pairs_argmin_plain(*ch)
        torch.cuda.synchronize()
        diff = int((Wk.long() - Wp.long()).abs().max())
        max_err = max(max_err, diff)
        if not torch.equal(Wk, Wp):
            raise AssertionError(
                f"pairs_argmin: kernel and plain version differ at "
                f"{int((Wk != Wp).sum())} of {Wk.numel()} entries (seed {seed})")
        # the whole Delaunay core: card (kernel) against CPU (plain version)
        Wg, eg = delaunay_pairs_w(
            torch.from_numpy(uv).to(dev), torch.from_numpy(mask).to(dev),
            tiebreak=torch.from_numpy(tb).to(dev), tie_scale=TIE_SCALE)
        Wc, ec = delaunay_pairs_w(
            torch.from_numpy(uv), torch.from_numpy(mask),
            tiebreak=torch.from_numpy(tb), tie_scale=TIE_SCALE)
        if not (torch.equal(Wg.cpu(), Wc) and torch.equal(eg.cpu(), ec)):
            raise AssertionError(
                f"delaunay_pairs_w: card and CPU differ (seed {seed}): W at "
                f"{int((Wg.cpu() != Wc).sum())}, emit at "
                f"{int((eg.cpu() != ec).sum())}")
        log(f"[kernels] pairs_argmin seed={seed} A={A} K={K}: W bit-identical "
            f"({Wk.numel()} entries, {int((Wk >= 0).sum())} with a third "
            f"vertex), delaunay_pairs_w W/emit equal, "
            f"{int(ec.sum())} triangles")

    uv, mask, tb = pairs_inputs(0, 512, K)
    ch = channels(uv, mask, tb, dev)
    for _ in range(3):
        pk.pairs_argmin_cuda(*ch)
    ms = event_ms(lambda: pk.pairs_argmin_cuda(*ch), 50)
    plain_ms = event_ms(lambda: pk.pairs_argmin_plain(*ch), 5)
    bound_ms, bound_by = pairs_bound_ms(ch[0], ch[1], ch[3], ch[4])
    log(f"[kernels] pairs_argmin (512, 48): kernel {1e3 * ms:.1f} us "
        f"(median of 50), plain version {1e3 * plain_ms:.1f} us, "
        f"bound {1e3 * bound_ms:.2f} us ({bound_by})")
    return {"name": "pairs_argmin", "route": "cuda",
            "source": "immesh_tpu_torch/csrc/pairs_argmin.cu",
            "replaces": "immesh_tpu/mesh/delaunay.py:289",
            "max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}


# ---------------------------------------------------------------------------
# phase 3: int32 arithmetic on the card
# ---------------------------------------------------------------------------
def phase_ints(dev):
    from immesh_tpu_torch.core.ops import segment_sum
    from immesh_tpu_torch.map.hash import (
        _fingerprint, _hash, frame_unique_coords)
    from immesh_tpu_torch.mesh.triangles import _pos_hash

    rng = np.random.default_rng(0)
    c = rng.integers(-2 ** 31, 2 ** 31 - 1, (4096, 4), dtype=np.int32)
    c[:8] = [[2 ** 31 - 1, -2 ** 31, 0, -1]] * 8
    p = rng.normal(0, 100, (4096, 3)).astype(np.float32)
    small = rng.integers(-3, 3, (4096, 3), dtype=np.int32)
    m = rng.random(4096) < 0.8
    tc, tp = torch.from_numpy(c), torch.from_numpy(p)
    checks = {
        "_hash": lambda x, _: _hash(x, 2 ** 18 - 1),
        "_fingerprint": lambda x, _: _fingerprint(x),
        "_pos_hash": lambda _, y: _pos_hash(y),
    }
    for name, fn in checks.items():
        a, b = fn(tc, tp), fn(tc.to(dev), tp.to(dev)).cpu()
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: card and CPU bits differ")
    ts, tm = torch.from_numpy(small), torch.from_numpy(m)
    a = frame_unique_coords(ts, tm, 100)
    b = frame_unique_coords(ts.to(dev), tm.to(dev), 100)
    for x, y in zip(a, b):
        if not torch.equal(x, y.cpu()):
            raise AssertionError("frame_unique_coords: card and CPU differ")
    # segment sums (scan aggregates, downsampling) take no atomics: the
    # same bits on every run
    vals = torch.from_numpy(rng.normal(size=(131072, 11)).astype(np.float32))
    seg = torch.from_numpy(rng.integers(0, 1025, 131072))
    a = segment_sum(vals.to(dev), seg.to(dev), 1025)
    if not torch.equal(a, segment_sum(vals.to(dev), seg.to(dev), 1025)):
        raise AssertionError("segment_sum differs between two runs on the card")
    torch.testing.assert_close(a.cpu(), segment_sum(vals, seg, 1025),
                               rtol=1e-5, atol=1e-4)
    log("[ints] _hash, _fingerprint, _pos_hash and frame_unique_coords are "
        "bit-identical on the card and the CPU; segment_sum is "
        "run-to-run deterministic on the card")


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------
def phase_main(dev, n_frames: int, warmup: int, kernel_ms: float):
    from immesh_tpu_torch.kernels import pairs_argmin as pk
    from immesh_tpu_torch.runtime.joint import JointPipeline

    cfg = kitti_config()
    N = cfg.preprocess.max_points
    t0 = time.perf_counter()
    sim = make_sim(N, 64)
    gt = [sim.frame(k) for k in range(warmup + n_frames)]
    frames = [bundle(f, cfg, dev) for f in gt]
    log(f"[main] {len(frames)} scans of {N} rays made in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")
    R0, p0 = sim.traj.pose(0.0)

    pipe = JointPipeline(cfg, adaptive_mesh_budget=2048, device=dev)
    pk.reset_launches()
    ms, launches, errs, actives = [], [], [], []
    diags = []
    for k, (f, b) in enumerate(zip(gt, frames)):
        before = pk.launches
        t1 = time.perf_counter()
        world, diag = pipe.step(b)
        torch.cuda.synchronize()
        dt = 1e3 * (time.perf_counter() - t1)
        if k == 0:
            pipe.prime_adaptive()  # run the hi-budget variant during warm-up
        pos = pipe.state.pos.cpu().numpy().astype(np.float64)
        if not (np.isfinite(pos).all()
                and bool(torch.isfinite(pipe.state.rot).all())
                and bool(torch.isfinite(world[b.mask]).all())):
            raise AssertionError(f"frame {k}: non-finite pose or world scan")
        if tuple(world.shape) != (N, 3):
            raise AssertionError(f"frame {k}: world scan shape {world.shape}")
        err = float(np.linalg.norm(R0 @ pos + p0 - f.gt_pos))
        n_act = int(diag["n_active_voxels"])
        fired = pk.launches - before
        if n_act > 0 and fired == 0:
            raise AssertionError(
                f"frame {k}: {n_act} active voxels but no pairs_argmin launch")
        if err > POSE_TOL_M:
            raise AssertionError(
                f"frame {k}: pose {err:.3f} m from ground truth "
                f"(limit {POSE_TOL_M} m)")
        errs.append(err)
        actives.append(n_act)
        launches.append(fired)
        if k >= warmup:
            ms.append(dt)
            diags.append({key: int(val) for key, val in diag.items()})
        log(f"[main] frame {k:2d}: {dt:8.1f} ms, pose err {err:.3f} m, "
            f"{n_act} active voxels, {fired} kernel launches, backlog "
            f"{int(diag['drop_deferred'])}")
    total_launches = pk.launches

    n_tris = int(pipe.store.n_triangles())
    n_pts = int(pipe.mesh.gm.n_points())
    n_comp = pipe.mesh.n_compactions + pipe.lio.n_compactions
    if n_tris <= 0:
        raise AssertionError("no live triangles after the run")
    if n_comp < 1:
        raise AssertionError("no compaction fired during the run")
    if total_launches == 0:
        raise AssertionError("pairs_argmin was never launched on the main path")
    ids = pipe.store.tri_ids.reshape(-1, 3)
    ids = ids[(ids >= 0).all(-1)]
    if int(ids.max()) >= n_pts:
        raise AssertionError("a triangle references an unallocated point")

    drops = {}
    for d in diags:
        for key, val in d.items():
            if key == "drop_deferred":
                drops[key] = val          # a backlog level: keep the last
            elif key.startswith("drop_"):
                drops[key] = drops.get(key, 0) + val
    med = statistics.median(ms)
    p90 = float(np.percentile(ms, 90))
    timed_launches = sum(launches[warmup:])
    share = kernel_ms * timed_launches / sum(ms)
    log(f"[main] {n_frames} timed frames: {med:.1f} ms/frame median, "
        f"{p90:.1f} ms p90; pairs_argmin {timed_launches} launches "
        f"(~{100 * share:.2f} % of frame time at the phase-2 kernel time); "
        f"pose err max {max(errs):.3f} m, last {errs[-1]:.3f} m")
    log(f"[main] live triangles {n_tris}, map points {n_pts}, mesh voxels "
        f"{int(pipe.mesh.gm.vox.occupancy())}, LIO voxels "
        f"{int(pipe.lio.vm.n_voxels())}, compactions {n_comp} "
        f"(mesh {pipe.mesh.n_compactions}, lio {pipe.lio.n_compactions}, "
        f"{pipe.mesh.compact_ms + pipe.lio.compact_ms:.1f} ms), drops {drops}")
    return total_launches


# ---------------------------------------------------------------------------
# phase 5: card against CPU on a small input
# ---------------------------------------------------------------------------
def phase_parity(dev, n_frames: int = 6):
    from immesh_tpu_torch.runtime.joint import JointPipeline

    cfg = small_config()
    sim = make_sim(cfg.preprocess.max_points, 16)
    gt = [sim.frame(k) for k in range(n_frames)]
    pipes = {d: JointPipeline(cfg, adaptive_mesh_budget=256, device=d)
             for d in (dev, "cpu")}
    for k, f in enumerate(gt):
        for d, p in pipes.items():
            p.step(bundle(f, cfg, d))
        a, b = (pipes[d] for d in (dev, "cpu"))
        dp = float((a.state.pos.cpu() - b.state.pos).abs().max())
        na, nb = int(a.store.n_triangles()), int(b.store.n_triangles())
        pa, pb = int(a.mesh.gm.n_points()), int(b.mesh.gm.n_points())
        # ulp-level differences in the world scan (reduction order on the
        # card) re-roll near-cocircular Delaunay diagonals, so triangle
        # counts agree to a few percent, not exactly (ROADMAP queue 3)
        if (dp > 1e-3 or abs(na - nb) > TRI_COUNT_RTOL * max(nb, 1)
                or abs(pa - pb) > 0.01 * max(pb, 1)):
            raise AssertionError(
                f"frame {k}: card and CPU disagree: |Δpos| {dp:.2e} m, "
                f"triangles {na} vs {nb}, points {pa} vs {pb}")
    log(f"[parity] {n_frames} small frames: card and CPU agree (last "
        f"|Δpos| {dp:.2e} m, triangles {na} vs {nb}, points {pa} vs {pb})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=40,
                    help="timed main-path frames after 3 warm-up frames")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False — this script "
            "runs only on a GPU")
        return 2
    dev = torch.device("cuda", 0)
    log(f"[device] {smi_line()}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)")

    from immesh_tpu_torch.kernels import pairs_argmin as pk
    t0 = time.perf_counter()
    pk.build(force=True)
    log(f"[build] {pk._SRC} built in {time.perf_counter() - t0:.1f} s")

    entry = phase_kernels(dev)
    phase_ints(dev)
    entry["launches"] = phase_main(dev, args.frames, 3, entry["ms"])
    phase_parity(dev)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(smi_line())
    print(json.dumps({"kernels": [{k: entry[k] for k in keys}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
