"""Port parity, the runtime entry point: ImMeshRuntime (IMU on) beside the
JAX reference's, the PLY/PCD and checkpoint formats, a reference checkpoint
carried into the port, offline point-cloud meshing and the demo CLI.

Tolerances, with their reasons:
  * pose per frame: 1e-3 m — five chained IMU-on frames, each ESIKF update
    summing its normal equations in another order than XLA;
  * one frame from the reference's checkpoint: 1e-4 m, as the single LIO
    step of tests/test_torch_lio_mesh.py;
  * formats: exact (the same bytes are written and read)."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from immesh_tpu.config import PRESETS as JPRESETS
from immesh_tpu.frontend.sim import LidarImuSimulator
from immesh_tpu.frontend.types import ScanBundle as JBundle
from immesh_tpu.runtime import export as jexport
from immesh_tpu.runtime.app import ImMeshRuntime as JRuntime
from immesh_tpu_torch import interop
from immesh_tpu_torch.config import ImMeshConfig as TConfig
from immesh_tpu_torch.frontend.types import ScanBundle as TBundle
from immesh_tpu_torch.runtime import demo as tdemo
from immesh_tpu_torch.runtime import export as texport
from immesh_tpu_torch.runtime.app import ImMeshRuntime as TRuntime
from immesh_tpu_torch.runtime.app import run_offline_pointcloud

N_RAYS, N_FRAMES = 2048, 5


def _config():
    base = JPRESETS["sim"]()
    return base.replace(preprocess=dataclasses.replace(
        base.preprocess, max_points=N_RAYS))


def _args(sim, k, cfg):
    f = sim.frame(k)
    return (f.pts, f.t_rel, f.imu_stamps, f.imu_acc, f.imu_gyr,
            f.scan_duration, N_RAYS, cfg.imu.max_imu_per_scan)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both runtimes over N_FRAMES frames of the IMU-on simulator, logging
    into their own directories; then frame N_FRAMES's arguments."""
    cfg = _config()
    tcfg = TConfig.from_dict(cfg.to_dict())
    sim = LidarImuSimulator(n_rays=N_RAYS, seed=6)
    acc, gyr = sim.static_imu(50)
    dirs = {n: str(tmp_path_factory.mktemp(n)) for n in ("jax", "port")}
    jr = JRuntime(cfg, log_dir=dirs["jax"])
    tr = TRuntime(tcfg, log_dir=dirs["port"], device="cpu")
    jr.static_init(acc, gyr)
    tr.static_init(acc, gyr)
    poses = []
    for k in range(N_FRAMES):
        a = _args(sim, k, cfg)
        js = jr.process_frame(JBundle.from_numpy(*a), t=0.1 * k)
        ts = tr.process_frame(TBundle.from_numpy(*a, device="cpu"), t=0.1 * k)
        poses.append((js["pos"], ts["pos"]))
    return dict(cfg=cfg, tcfg=tcfg, jr=jr, tr=tr, dirs=dirs, poses=poses,
                next_args=_args(sim, N_FRAMES, cfg))


@pytest.mark.parametrize("k", range(N_FRAMES))
def test_runtime_pose_tracks_the_reference(runs, k):
    jp, tp = runs["poses"][k]
    np.testing.assert_allclose(jp, tp, atol=1e-3)


def test_runtime_logs_have_the_reference_schema(runs):
    runs["jr"].close()
    runs["tr"].close()
    for name in ("kitti_log.txt", "mesh_cost_time.log"):
        j, t = (np.loadtxt(os.path.join(runs["dirs"][n], name))
                for n in ("jax", "port"))
        assert j.shape == t.shape == (N_FRAMES, 8 if name[0] == "k" else 5)
        np.testing.assert_array_equal(j[:, 0], t[:, 0])   # stamps / frames
    jt, tt = (np.loadtxt(os.path.join(runs["dirs"][n], "kitti_log.txt"))
              for n in ("jax", "port"))
    np.testing.assert_allclose(jt[:, 1:], tt[:, 1:], atol=1e-3)
    assert runs["tr"].mesh.store.n_triangles() > 100


def test_reference_checkpoint_carries_into_the_port(runs, tmp_path):
    jr, cfg, tcfg = runs["jr"], runs["cfg"], runs["tcfg"]
    prefix = str(tmp_path / "ckpt")
    jr.save_state(prefix)
    o = interop.load_reference_checkpoint(prefix, tcfg, device="cpu")
    assert set(o) == {"state", "vm", "gm", "store"}
    want = {"state": jr.lio.state, "vm": jr.lio.vm, "gm": jr.mesh.gm,
            "store": jr.mesh.store}
    for name, obj in o.items():
        got = interop.to_numpy(obj)
        for field, x in got.items():
            ref = getattr(want[name], field)
            if isinstance(x, dict):    # a hash table
                np.testing.assert_array_equal(x["keys"], np.asarray(ref.keys))
                np.testing.assert_array_equal(x["fp"], np.asarray(ref.fp))
            else:
                np.testing.assert_array_equal(x, np.asarray(ref), field)
    tr = TRuntime(tcfg, device="cpu")
    tr.lio.state, tr.lio.vm = o["state"], o["vm"]
    tr.mesh.gm, tr.mesh.store = o["gm"], o["store"]
    a = runs["next_args"]
    js = jr.process_frame(JBundle.from_numpy(*a))
    ts = tr.process_frame(TBundle.from_numpy(*a, device="cpu"))
    np.testing.assert_allclose(js["pos"], ts["pos"], atol=1e-4)
    assert int(tr.mesh.store.n_triangles()) > 0


def test_port_checkpoint_round_trip_is_exact(runs, tmp_path):
    tr = runs["tr"]
    prefix = str(tmp_path / "ckpt")
    tr.save_state(prefix)
    o = interop.load_reference_checkpoint(prefix, runs["tcfg"], device="cpu")
    for name, obj in (("state", tr.lio.state), ("vm", tr.lio.vm),
                      ("gm", tr.mesh.gm), ("store", tr.mesh.store)):
        a, b = texport._leaves(obj), texport._leaves(o[name])
        assert len(a) == len(b)
        assert all(torch.equal(x, y) for x, y in zip(a, b)), name


def test_ply_and_pcd_round_trips(tmp_path):
    rng = np.random.default_rng(0)
    verts = rng.normal(size=(50, 3)).astype(np.float32)
    faces = rng.integers(0, 50, (80, 3)).astype(np.int32)
    colors = rng.integers(0, 256, (50, 3)).astype(np.uint8)
    p = str(tmp_path / "m.ply")
    texport.save_ply(p, verts, faces)
    for load in (texport.load_ply, jexport.load_ply):
        v, f = load(p)
        np.testing.assert_array_equal(v, verts)
        np.testing.assert_array_equal(f, faces)
    texport.save_ply(p, verts, faces, colors)
    v, f, c = jexport.load_ply(p)
    np.testing.assert_array_equal(c, colors)
    q = str(tmp_path / "c.pcd")
    texport.save_pcd(q, verts)
    np.testing.assert_array_equal(jexport.load_pcd(q), verts)
    np.testing.assert_array_equal(texport.load_pcd(q), verts)
    np.testing.assert_allclose(texport.smooth_vertices(verts, faces, 2),
                               jexport.smooth_vertices(verts, faces, 2))


def test_offline_pointcloud_to_mesh():
    """tests/test_runtime.py::TestOfflineMode on the port."""
    rng = np.random.default_rng(0)
    t = rng.uniform(0, 3, (4000, 2)).astype(np.float32)
    pts = np.stack(
        [t[:, 0], t[:, 1],
         0.01 * rng.standard_normal(4000).astype(np.float32)], -1)
    cfg = TConfig.from_dict(JPRESETS["sim"]().to_dict())
    mesh = run_offline_pointcloud(pts, cfg, frame_size=2000, device="cpu")
    verts, faces = mesh.extract()
    v = verts[faces]
    area = 0.5 * np.linalg.norm(
        np.cross(v[:, 1] - v[:, 0], v[:, 2] - v[:, 0]), axis=1).sum()
    assert 6.0 < area < 10.5, area


def test_unported_paths_raise():
    """No option of the runtime is left unported: a runtime with window BA
    on constructs (tests/test_torch_window_ba.py and
    tests/test_torch_render.py drive BA, the viewer and reinforcement), and
    a frame under MeshConfig.ablate="skip_tri" (tests/test_torch_ablate.py
    holds every cut to the reference) runs and leaves no live triangle."""
    cfg = TConfig.from_dict(_config().to_dict())
    rt = TRuntime(cfg.replace(ba=dataclasses.replace(cfg.ba, enabled=True)),
                  mesh_enabled=False, device="cpu")
    assert rt.ba is not None and not rt.paused
    rt = TRuntime(cfg.replace(mesh=dataclasses.replace(
        cfg.mesh, ablate="skip_tri")), device="cpu")
    sim = LidarImuSimulator(n_rays=N_RAYS, seed=6)
    rt.static_init(*sim.static_imu(50))
    rt.process_frame(TBundle.from_numpy(*_args(sim, 0, _config()),
                                        device="cpu"))
    assert int(rt.mesh.store.n_triangles()) == 0
    assert int(rt.mesh.gm.n_points()) > 0


def test_demo_main_runs_on_the_cpu(tmp_path, capsys):
    tdemo.main(["--device", "cpu", "--frames", "2", "--out", str(tmp_path)])
    out = capsys.readouterr().out
    assert "frame   1" in out and "faces" in out
    for name in ("mesh.ply", "kitti_log.txt", "mesh_cost_time.log",
                 "ckpt.lio.npz", "ckpt.vmap.npz", "ckpt.gmap.npz",
                 "ckpt.tris.npz"):
        assert os.path.exists(tmp_path / name), name
    verts, faces = texport.load_ply(str(tmp_path / "mesh.ply"))
    assert len(faces) > 0 and np.isfinite(verts).all()


def test_eval_copies_match_the_reference():
    """ATE/RPE and the analytic-scene mesh metrics the runtime reports."""
    from immesh_tpu.eval import ate as jate
    from immesh_tpu.eval import mesh_quality as jmq
    from immesh_tpu_torch.eval import ate as tate
    from immesh_tpu_torch.eval import mesh_quality as tmq

    rng = np.random.default_rng(0)
    t = np.arange(40) * 0.1
    gt = np.stack([np.cos(t), np.sin(t), 0.1 * t], -1)
    est = gt @ np.array([[0, -1, 0], [1, 0, 0], [0, 0, 1.0]]).T + [1, 2, 3]
    est = est + rng.normal(0, 0.01, est.shape)
    q = np.tile([0.0, 0.0, 0.0, 1.0], (40, 1))
    rows = lambda p: [(s, *x, *y) for s, x, y in zip(t, p, q)]  # noqa: E731
    want = jate.evaluate_ate(jate.from_rows(rows(est)),
                             jate.from_rows(rows(gt)))
    got = tate.evaluate_ate(tate.from_rows(rows(est)),
                            tate.from_rows(rows(gt)))
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-12)
    sim = LidarImuSimulator(n_rays=256, seed=0)
    verts = rng.uniform(-6, 6, (500, 3))
    np.testing.assert_array_equal(
        tmq.vertex_surface_distance(verts, sim.scene),
        jmq.vertex_surface_distance(verts, sim.scene))
    faces = rng.integers(0, 500, (300, 3))
    assert tmq.hole_stats(faces) == jmq.hole_stats(faces)
