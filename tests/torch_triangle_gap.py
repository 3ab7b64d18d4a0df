"""Where the port's whole-slice triangle gap comes from (ROADMAP queue 3
item 9).  A script, not a test (~3 minutes on a CPU):

    JAX_PLATFORMS=cpu python tests/torch_triangle_gap.py

On the 8,192-ray sequence of tests/test_torch_joint.py (its configuration
is repeated here) it prints:
  1. triangle counts per frame of {JAX, port} mesh stage × {JAX, port} world
     scans (the mesh stages fed the same scans agree exactly);
  2. per frame: max |Δ world scan|, the pose difference of the two filters
     (position and rotation angle), and the voxels whose triangle sets
     differ, split into port-more / port-fewer / same count;
  3. the reference's mesh stage on its own world scans moved rigidly by the
     measured pose difference: exactly, mirrored (the inverse motion), and
     in DRAWS random directions at the measured size per frame; then given
     only the rigid part of the port's scan difference (fitted per frame),
     or only the rest; then the whole reference on DRAWS draws of 1e-6 m
     noise on its input points — where the port's mean relative gap ranks
     among the random draws;
  4. the port's mean relative gap, and the summed split of differing
     voxels, on other simulator seeds;
  5. per frame, one port step started from the reference's state: the pose
     and world-scan differences and the triangle count difference.
"""

import dataclasses
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from scipy.spatial.transform import Rotation  # noqa: E402

jax.config.update("jax_platforms", "cpu")

import immesh_tpu.runtime.joint as jjoint  # noqa: E402
import immesh_tpu_torch.runtime.joint as tjoint  # noqa: E402
from immesh_tpu.config import PRESETS  # noqa: E402
from immesh_tpu_torch import interop  # noqa: E402
from immesh_tpu.frontend.sim import (  # noqa: E402
    ForwardTrajectory, LidarImuSimulator, outdoor_scene)
from immesh_tpu.frontend.types import ScanBundle as JBundle  # noqa: E402
from immesh_tpu.mesh.pipeline import MeshPipeline as JMesh  # noqa: E402
from immesh_tpu_torch.config import ImMeshConfig as TConfig  # noqa: E402
from immesh_tpu_torch.frontend.types import ScanBundle as TBundle  # noqa: E402
from immesh_tpu_torch.mesh.pipeline import MeshPipeline as TMesh  # noqa: E402

N_RAYS, N_FRAMES = 8192, 8
DRAWS = 32
SEEDS = (1, 2, 3, 4, 5, 6)


def config():
    """tests/test_torch_joint.py's configuration: the kitti preset cut to
    8,192 rays and capacities small enough that compaction fires."""
    base = PRESETS["kitti"]()
    return base.replace(
        preprocess=base.preprocess.__class__(
            lidar_type=100, blind=0.05, max_points=N_RAYS),
        voxel_map=dataclasses.replace(
            base.voxel_map, capacity=2 ** 13, touched_voxels_per_scan=512),
        lio=dataclasses.replace(base.lio, map_update_points=2048),
        mesh=base.mesh.__class__(
            pts_minimum_scale=0.15, voxel_resolution=0.6,
            points_capacity=2 ** 13, voxel_capacity=2 ** 11,
            compact_check_every=8, local_map_radius=40.0,
            active_voxels_per_frame=128, file_voxels_per_frame=1024,
            max_pts_per_frame=2000, mesh_chunk=64))


def voxel_tris(keys, tri_ids, tri_n, pts):
    """{voxel key: set of triangles as sorted vertex-position triples}."""
    return {tuple(keys[s, :3]): {tuple(sorted(map(tuple, pts[t])))
                                 for t in tri_ids[s, :tri_n[s]]}
            for s in np.nonzero(tri_n > 0)[0]}


def split(jax_tris, port_tris):
    """Voxels whose triangle sets differ: (port more, port fewer, same)."""
    out = [0, 0, 0]
    for key in set(jax_tris) | set(port_tris):
        a, b = jax_tris.get(key, set()), port_tris.get(key, set())
        if a != b:
            out[0 if len(b) > len(a) else 1 if len(b) < len(a) else 2] += 1
    return tuple(out)


def run_pair(cfg, tcfg, seed):
    """Chained JAX and port JointPipelines; per frame the world scans,
    poses, triangle counts and the differing-voxel split."""
    sim = LidarImuSimulator(scene=outdoor_scene(length=400.0),
                            traj=ForwardTrajectory(speed=9.0), n_rays=N_RAYS,
                            rings=16, max_range=120.0, seed=seed)
    jp = jjoint.JointPipeline(cfg, adaptive_mesh_budget=256,
                              adaptive_threshold=600)
    tp = tjoint.JointPipeline(tcfg, adaptive_mesh_budget=256,
                              adaptive_threshold=600, device="cpu")
    out = []
    for k in range(N_FRAMES):
        f = sim.frame(k)
        args = (f.pts, f.t_rel, f.imu_stamps, f.imu_acc, f.imu_gyr,
                f.scan_duration, N_RAYS, cfg.imu.max_imu_per_scan)
        jb = JBundle.from_numpy(*args)
        jw, _ = jp.step(jb)
        tw, _ = tp.step(TBundle.from_numpy(*args, device="cpu"))
        m = np.array(jb.mask)
        out.append(dict(
            jax=(np.array(jw), m, np.array(jp.state.pos)),
            port=(tw.numpy(), m, tp.state.pos.numpy()),
            rot=(np.asarray(jp.state.rot, np.float64),
                 tp.state.rot.numpy().astype(np.float64)),
            tris=(int(jp.store.n_triangles()), int(tp.store.n_triangles())),
            split=split(
                voxel_tris(np.asarray(jp.mesh.gm.vox.keys),
                           np.asarray(jp.store.tri_ids),
                           np.asarray(jp.store.tri_n),
                           np.asarray(jp.mesh.gm.pts)),
                voxel_tris(tp.mesh.gm.vox.keys.numpy(),
                           tp.store.tri_ids.numpy(), tp.store.tri_n.numpy(),
                           tp.mesh.gm.pts.numpy()))))
    return out


def mesh_counts(cfg, seq, port=False):
    mp = TMesh(TConfig.from_dict(cfg.to_dict()), device="cpu") if port \
        else JMesh(cfg)
    counts = []
    for w, m, p in seq:
        if port:
            w, m, p = (torch.from_numpy(np.array(x)) for x in (w, m, p))
        mp.step(w, m, p)
        counts.append(int(mp.store.n_triangles()))
    return counts


def moved(seq, motions):
    """World scans moved rigidly about each frame's sensor position:
    w' = dR (w − p) + p + dp, with (dR, dp) per frame."""
    out = []
    for (w, m, p), (dR, dp) in zip(seq, motions):
        p64 = p.astype(np.float64)
        w2 = (w.astype(np.float64) - p64) @ dR.T + p64 + dp
        out.append((w2.astype(np.float32), m, (p64 + dp).astype(np.float32)))
    return out


def kabsch(X, Y):
    """The rigid motion (R, t) that best maps the points X onto Y."""
    cx, cy = X.mean(0), Y.mean(0)
    U, _, Vt = np.linalg.svd((X - cx).T @ (Y - cy))
    D = np.diag([1.0, 1.0, np.sign(np.linalg.det(Vt.T @ U.T))])
    R = Vt.T @ D @ U.T
    return R, cy - R @ cx


def noisy_reference(cfg, draw, base_pos):
    """Triangle counts per frame of the reference JointPipeline on the
    seed-0 sequence with N(0, 1e-6 m) noise on every input point, and its
    largest position difference from the noiseless run (base_pos)."""
    sim = LidarImuSimulator(scene=outdoor_scene(length=400.0),
                            traj=ForwardTrajectory(speed=9.0), n_rays=N_RAYS,
                            rings=16, max_range=120.0, seed=0)
    jp = jjoint.JointPipeline(cfg, adaptive_mesh_budget=256,
                              adaptive_threshold=600)
    r = np.random.default_rng(1000 + draw)
    counts, dp = [], 0.0
    for k in range(N_FRAMES):
        f = sim.frame(k)
        pts = (f.pts + r.normal(0, 1e-6, f.pts.shape)).astype(np.float32)
        jp.step(JBundle.from_numpy(
            pts, f.t_rel, f.imu_stamps, f.imu_acc, f.imu_gyr,
            f.scan_duration, N_RAYS, cfg.imu.max_imu_per_scan))
        counts.append(int(jp.store.n_triangles()))
        dp = max(dp, float(np.abs(np.asarray(jp.state.pos)
                                  - base_pos[k]).max()))
    return counts, dp


def tree(obj):
    """A reference pytree as nested dicts of numpy arrays, the form
    interop.from_reference takes."""
    if dataclasses.is_dataclass(obj):
        return {f.name: tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if f.metadata.get("pytree_node", True)}
    return np.asarray(obj)


def one_step(cfg, tcfg):
    """Per frame of the seed-0 sequence, one port step started from the
    reference's state: (|Δpos| m, share of bit-identical world
    coordinates, max |Δworld| m, converged, port − reference triangles)."""
    sim = LidarImuSimulator(scene=outdoor_scene(length=400.0),
                            traj=ForwardTrajectory(speed=9.0), n_rays=N_RAYS,
                            rings=16, max_range=120.0, seed=0)
    jp = jjoint.JointPipeline(cfg, adaptive_mesh_budget=256,
                              adaptive_threshold=600)
    tp = tjoint.JointPipeline(tcfg, adaptive_mesh_budget=256,
                              adaptive_threshold=600, device="cpu")
    out = []
    for k in range(N_FRAMES):
        f = sim.frame(k)
        o = interop.from_reference(
            {"state": tree(jp.lio.state), "vm": tree(jp.lio.vm),
             "gm": tree(jp.mesh.gm), "store": tree(jp.mesh.store)},
            tcfg, device="cpu")
        tp.lio.state, tp.lio.vm = o["state"], o["vm"]
        tp.mesh.gm, tp.mesh.store = o["gm"], o["store"]
        args = (f.pts, f.t_rel, f.imu_stamps, f.imu_acc, f.imu_gyr,
                f.scan_duration, N_RAYS, cfg.imu.max_imu_per_scan)
        jb = JBundle.from_numpy(*args)
        jw, jd = jp.step(jb)
        tw, td = tp.step(TBundle.from_numpy(*args, device="cpu"))
        m = np.array(jb.mask)
        jw, tw = np.array(jw)[m], tw.numpy()[m]
        out.append((float(np.abs(tp.state.pos.numpy()
                                 - np.asarray(jp.state.pos)).max()),
                    float(np.mean(jw == tw)), float(np.abs(jw - tw).max()),
                    bool(jd["converged"]) and bool(td["converged"]),
                    int(tp.store.n_triangles()) - int(jp.store.n_triangles())))
    return out


def rel_gap(counts, base):
    c, b = np.asarray(counts, float), np.asarray(base, float)
    return float(np.mean((c[1:] - b[1:]) / b[1:]))


def summary(name, d, port_gap):
    d = np.asarray(d)
    print(f"   {name}: mean {100 * d.mean():+.2f} % sd "
          f"{100 * d.std(ddof=1):.2f} % range {100 * d.min():+.2f}…"
          f"{100 * d.max():+.2f} %; draws ≥ port {(d >= port_gap).sum()}"
          f"/{len(d)}; z {(port_gap - d.mean()) / d.std(ddof=1):.2f}",
          flush=True)


def main():
    cfg = config()
    tcfg = TConfig.from_dict(cfg.to_dict())

    frames = run_pair(cfg, tcfg, 0)
    wj = [f["jax"] for f in frames]
    wt = [f["port"] for f in frames]
    A = [f["tris"][0] for f in frames]
    B = [f["tris"][1] for f in frames]
    print("1. triangles per frame")
    print(f"   JAX joint              {A}")
    print(f"   port joint             {B}")
    print(f"   JAX mesh, JAX scans    {mesh_counts(cfg, wj)}")
    print(f"   port mesh, JAX scans   {mesh_counts(cfg, wj, port=True)}")
    print(f"   JAX mesh, port scans   {mesh_counts(cfg, wt)}")
    print(f"   port mesh, port scans  {mesh_counts(cfg, wt, port=True)}")
    print("2. per frame: max|Δworld| m, |Δpos| m, Δrot rad, voxels port "
          "more/fewer/same")
    exact, dpos, drot = [], [], []
    for k, f in enumerate(frames):
        (jw, m, jpos), (tw, _, tpos) = f["jax"], f["port"]
        Rj, Rt = f["rot"]
        dR = Rt @ Rj.T
        dp = tpos.astype(np.float64) - jpos
        exact.append((dR, dp))
        dpos.append(float(np.linalg.norm(dp)))
        drot.append(float(np.linalg.norm(Rotation.from_matrix(dR).as_rotvec())))
        print(f"   frame {k}: {np.abs(jw[m] - tw[m]).max():.2e}, "
              f"{dpos[-1]:.2e}, {drot[-1]:.2e}, "
              f"{'/'.join(map(str, f['split']))}", flush=True)
    port_gap = rel_gap(B, A)
    print(f"3. port mean relative gap, frames 1-{N_FRAMES - 1}: "
          f"{100 * port_gap:+.2f} %")
    ex = rel_gap(mesh_counts(cfg, moved(wj, exact)), A)
    mi = rel_gap(mesh_counts(cfg, moved(wj, [(dR.T, -dp)
                                             for dR, dp in exact])), A)
    print(f"   reference scans moved by the port's pose difference: "
          f"{100 * ex:+.2f} %; by its inverse: {100 * mi:+.2f} %", flush=True)
    d = []
    for s in range(DRAWS):
        r = np.random.default_rng(100 + s)
        axis, direction = (v / np.linalg.norm(v) for v in r.normal(size=(2, 3)))
        d.append(rel_gap(mesh_counts(cfg, moved(wj, [
            (Rotation.from_rotvec(th * axis).as_matrix(), dist * direction)
            for th, dist in zip(drot, dpos)])), A))
    summary(f"{DRAWS} random directions at the measured size", d, port_gap)
    rigid, rest, worst = [], [], 0.0
    for (jw, m, jpos), (tw, _, tpos) in zip(wj, wt):
        R, t = kabsch(jw[m].astype(np.float64), tw[m].astype(np.float64))
        fit = jw.astype(np.float64) @ R.T + t
        res = np.where(m[:, None], tw - fit, 0.0)
        worst = max(worst, float(np.abs(res).max()))
        rigid.append((fit.astype(np.float32), m, tpos))
        rest.append(((jw + res).astype(np.float32), m, jpos))
    print(f"   reference scans given only the rigid part of the port's scan "
          f"difference (a fit per frame): "
          f"{100 * rel_gap(mesh_counts(cfg, rigid), A):+.2f} %; only the "
          f"rest (≤ {worst:.1e} m): "
          f"{100 * rel_gap(mesh_counts(cfg, rest), A):+.2f} %", flush=True)
    noisy = [noisy_reference(cfg, s, [p for _, _, p in wj])
             for s in range(DRAWS)]
    summary(f"the reference against itself, {DRAWS} draws of N(0, 1e-6 m) "
            f"noise on its input points (max |Δpos| "
            f"{min(x for _, x in noisy):.1e}…{max(x for _, x in noisy):.1e} m)",
            [rel_gap(c, A) for c, _ in noisy], port_gap)
    print("4. port mean relative gap on other seeds")
    for seed in SEEDS:
        fr = run_pair(cfg, tcfg, seed)
        g = rel_gap([f["tris"][1] for f in fr], [f["tris"][0] for f in fr])
        sp = np.sum([f["split"][:2] for f in fr], axis=0)
        print(f"   seed {seed}: {100 * g:+.2f} %; differing voxels port "
              f"more/fewer, summed over frames: {sp[0]}/{sp[1]}", flush=True)
    print("5. one port step from the reference's state, seed 0: |Δpos| m, "
          "bit-identical world coordinates, max |Δworld| m, both converged, "
          "port − reference triangles")
    for k, (dp, same, dw, conv, dt) in enumerate(one_step(cfg, tcfg)):
        print(f"   frame {k}: {dp:.2e}, {100 * same:.1f} %, {dw:.2e}, "
              f"{conv}, {dt:+d}", flush=True)


if __name__ == "__main__":
    main()
