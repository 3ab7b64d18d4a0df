"""Port parity, the whole slice: JointPipeline (LIO step, mesh step, both
maps' occupancy-triggered compaction, the reference's adaptive hi-budget
variant) run side by side with the JAX reference on a KITTI-shaped scan
sequence cut to 8,192 rays and capacities small enough that compaction
fires every few frames.

End-to-end parity cannot be exact: the LIO posterior differs from the
reference's by f32 ulps (reduction order), the world scan inherits them,
and the Delaunay tie keys hash raw position bits, so an ulp re-rolls
near-cocircular diagonals.  Held invariants, per frame:
  * pose within 1e-3 m of the reference's;
  * the same stored vertex sets at 1e-4 m, but for ≤ 0.1 % of points;
  * compactions on the same frames, with the reference's lo and hi
    budgets both run (the hi one never reaches its mesh step, reference
    behaviour 7; the port computes no hi-budget config);
  * live triangle counts within 5 % (the port runs 1-3 % above the
    reference on this sequence, seed 0, and -1.5…+0.2 % from it on seeds
    1-6; why seed 0 leans one way is open, ROADMAP queue 3 item 9).

Where the triangle gap enters: either side's mesh stage, fed the other
side's world scans, reproduces the other side's counts exactly, so the gap
is carried by the world scans alone, which differ by the ulp-level pose
difference of the two ESIKFs."""

import dataclasses

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import immesh_tpu.runtime.joint as jjoint
import immesh_tpu_torch.runtime.joint as tjoint
from immesh_tpu.config import PRESETS as JPRESETS
from immesh_tpu.mesh.pipeline import MeshPipeline as JMeshPipe
from immesh_tpu.frontend.sim import (
    ForwardTrajectory, LidarImuSimulator, outdoor_scene)
from immesh_tpu.frontend.types import ScanBundle as JBundle
from immesh_tpu_torch.config import ImMeshConfig as TConfig
from immesh_tpu_torch.frontend.types import ScanBundle as TBundle
from immesh_tpu_torch.mesh.pipeline import MeshPipeline as TMeshPipe

N_RAYS, N_FRAMES = 8192, 8
TRI_RTOL = 0.05
VERTEX_MISS = 1e-3
MIN_SPLIT_SHARE = 0.25  # measured minimum 0.30 (frame 2: 21 more, 9 fewer)


def _config():
    base = JPRESETS["kitti"]()
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


def _voxel_tris(keys, tri_ids, tri_n, pts):
    """{voxel key: set of triangles as sorted vertex-position triples}."""
    out = {}
    for s in np.nonzero(tri_n > 0)[0]:
        out[tuple(keys[s, :3])] = {
            tuple(sorted(map(tuple, pts[t]))) for t in tri_ids[s, :tri_n[s]]}
    return out


def _split(jax_tris, port_tris):
    """Voxels whose triangle sets differ: (port has more, port has fewer,
    same count)."""
    more = fewer = same = 0
    for key in set(jax_tris) | set(port_tris):
        a, b = jax_tris.get(key, set()), port_tris.get(key, set())
        if a != b:
            more += len(b) > len(a)
            fewer += len(b) < len(a)
            same += len(b) == len(a)
    return more, fewer, same


def _budget_recorder(module, name, log):
    """Wrap module.<name>, whose last argument is the frame's config, to log
    the re-mesh budget of each call: the reference's joint_step."""
    inner = getattr(module, name)

    def recorded(*args):
        log.append(args[-1].mesh.active_voxels_per_frame)
        return inner(*args)
    return recorded


@pytest.fixture(scope="module")
def runs():
    cfg = _config()
    tcfg = TConfig.from_dict(cfg.to_dict())
    sim = LidarImuSimulator(scene=outdoor_scene(length=400.0),
                            traj=ForwardTrajectory(speed=9.0), n_rays=N_RAYS,
                            rings=16, max_range=120.0, seed=0)
    jp = jjoint.JointPipeline(cfg, adaptive_mesh_budget=256,
                              adaptive_threshold=600)
    tp = tjoint.JointPipeline(tcfg, adaptive_mesh_budget=256,
                              adaptive_threshold=600, device="cpu")
    budgets = []
    mp = pytest.MonkeyPatch()
    mp.setattr(jjoint, "joint_step",
               _budget_recorder(jjoint, "joint_step", budgets))
    frames = []
    try:
        for k in range(N_FRAMES):
            f = sim.frame(k)
            args = (f.pts, f.t_rel, f.imu_stamps, f.imu_acc, f.imu_gyr,
                    f.scan_duration, N_RAYS, cfg.imu.max_imu_per_scan)
            jb = JBundle.from_numpy(*args)
            jw, jd = jp.step(jb)
            tw, td = tp.step(TBundle.from_numpy(*args, device="cpu"))
            n_j = int(jp.mesh.gm.pt_count)
            split = _split(
                _voxel_tris(np.asarray(jp.mesh.gm.vox.keys),
                            np.asarray(jp.store.tri_ids),
                            np.asarray(jp.store.tri_n),
                            np.asarray(jp.mesh.gm.pts)),
                _voxel_tris(tp.mesh.gm.vox.keys.numpy(),
                            tp.store.tri_ids.numpy(), tp.store.tri_n.numpy(),
                            tp.mesh.gm.pts.numpy()))
            frames.append(dict(
                scans=((np.array(jw), np.array(jb.mask),
                        np.array(jp.state.pos)),
                       (tw.numpy(), np.asarray(jb.mask), tp.state.pos.numpy())),
                split=split,
                pos=(np.asarray(jp.state.pos), tp.state.pos.numpy()),
                n_pts=(n_j, int(tp.mesh.gm.pt_count)),
                # a copy: the port's map is updated in place, compaction too
                pts=(np.asarray(jp.mesh.gm.pts)[:n_j],
                     tp.mesh.gm.pts[:n_j].numpy().copy()),
                tris=(int(jp.store.n_triangles()), int(tp.store.n_triangles())),
                comp=((jp.mesh.n_compactions, jp.lio.n_compactions),
                      (tp.mesh.n_compactions, tp.lio.n_compactions)),
                active=(int(jd["n_active_voxels"]),
                        int(td["n_active_voxels"]))))
    finally:
        mp.undo()
    return frames, budgets


@pytest.mark.parametrize("k", range(N_FRAMES))
def test_joint_pipeline_tracks_the_reference(runs, k):
    f = runs[0][k]
    np.testing.assert_allclose(*f["pos"], atol=1e-3)
    assert f["n_pts"][0] == f["n_pts"][1]
    # the stored vertex SETS agree at 1e-4 m; a point within an ulp of a
    # dedup-cell face may land in the neighbouring cell on one side only
    # (≤ 2 of ~4k points on this sequence)
    dist, _ = cKDTree(f["pts"][0]).query(f["pts"][1])
    assert (dist > 1e-4).sum() <= VERTEX_MISS * len(dist), (dist > 1e-4).sum()
    assert f["comp"][0] == f["comp"][1]
    assert f["active"][0] == f["active"][1]
    nj, nt = f["tris"]
    assert nt > 0 and abs(nt - nj) <= TRI_RTOL * nj, (nj, nt)


def test_joint_pipeline_exercises_compaction_and_budgets(runs):
    frames, budgets = runs
    assert len(budgets) == N_FRAMES
    assert set(budgets) == {128, 256}  # the reference ran both variants
    assert frames[-1]["comp"][1][0] >= 1           # the mesh map compacted


def test_triangle_gap_enters_through_the_world_scan(runs):
    """Each side's mesh stage, fed the other side's world scans, gives the
    other side's triangle counts exactly; the scans differ by the pose
    difference of the two filters (≤ 1e-4 m in position).  The voxels whose
    triangle sets differ lean toward the port on this sequence (9/5 … 78/58
    port-more/port-fewer, at most 70 % one way on a frame); why is open
    (ROADMAP queue 3 item 9), and the lean is held where it was measured:
    on every frame each way holds at least MIN_SPLIT_SHARE of them."""
    frames = runs[0]
    cfg = _config()
    jm = JMeshPipe(cfg)
    tm = TMeshPipe(TConfig.from_dict(cfg.to_dict()), device="cpu")
    for f in frames:
        (jw, m, jpos), (tw, _, tpos) = f["scans"]
        jm.step(tw, m, tpos)
        tm.step(torch.from_numpy(jw), torch.from_numpy(m),
                torch.from_numpy(jpos))
        nj, nt = f["tris"]
        assert (int(jm.store.n_triangles()), int(tm.store.n_triangles())) \
            == (nt, nj)
        assert np.abs(jpos - tpos).max() <= 1e-4
        more, fewer, _ = f["split"]
        assert min(more, fewer) >= MIN_SPLIT_SHARE * (more + fewer), \
            (more, fewer)


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    cfg = TConfig.from_dict(_config().to_dict())
    with pytest.raises(RuntimeError, match="cuda"):
        tjoint.JointPipeline(cfg)
    z = np.zeros((4, 3), np.float32)
    with pytest.raises(RuntimeError, match="cuda"):
        TBundle.from_numpy(z, z[:, 0], z[:1, 0], z[:1], z[:1], 0.1, 8, 2)
