"""Port parity, the runtime entry point: ImMeshRuntime (IMU on) beside the
JAX reference's, the PLY/PCD and checkpoint formats, a reference checkpoint
carried into the port, offline point-cloud meshing and the demo CLI.

Tolerances, with their reasons:
  * pose per frame: 1e-3 m — five chained IMU-on frames, each ESIKF update
    summing its normal equations in another order than XLA;
  * one frame from the reference's checkpoint: 1e-4 m, as the single LIO
    step of tests/test_torch_lio_mesh.py;
  * formats: exact (the same bytes are written and read).

On the card (`cuda`, skips here; the JAX reference is imported on first
use, so on the GPU machine

    python -m pytest --noconftest -m cuda tests/test_torch_runtime.py

runs it): the runtime with its mesh half on its own stream against
graph=False, bit for bit, the active count read after a join, with the
mesh half's counters in the frame trace."""

import dataclasses
import os
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from immesh_tpu_torch import interop
from immesh_tpu_torch.config import ImMeshConfig as TConfig
from immesh_tpu_torch.frontend.types import ScanBundle as TBundle
from immesh_tpu_torch.runtime import demo as tdemo
from immesh_tpu_torch.runtime import export as texport
from immesh_tpu_torch.runtime.app import ImMeshRuntime as TRuntime
from immesh_tpu_torch.runtime.app import run_offline_pointcloud

N_RAYS, N_FRAMES = 2048, 5


def _jax():
    """The JAX reference's modules, imported on first use: the card's
    tests run where JAX is not installed."""
    from immesh_tpu.config import PRESETS
    from immesh_tpu.frontend.sim import LidarImuSimulator
    from immesh_tpu.frontend.types import ScanBundle
    from immesh_tpu.runtime import export
    from immesh_tpu.runtime.app import ImMeshRuntime
    return SimpleNamespace(PRESETS=PRESETS, Sim=LidarImuSimulator,
                           Bundle=ScanBundle, export=export,
                           Runtime=ImMeshRuntime)


def _config():
    base = _jax().PRESETS["sim"]()
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
    J = _jax()
    sim = J.Sim(n_rays=N_RAYS, seed=6)
    acc, gyr = sim.static_imu(50)
    dirs = {n: str(tmp_path_factory.mktemp(n)) for n in ("jax", "port")}
    jr = J.Runtime(cfg, log_dir=dirs["jax"])
    tr = TRuntime(tcfg, log_dir=dirs["port"], device="cpu")
    jr.static_init(acc, gyr)
    tr.static_init(acc, gyr)
    poses = []
    for k in range(N_FRAMES):
        a = _args(sim, k, cfg)
        js = jr.process_frame(J.Bundle.from_numpy(*a), t=0.1 * k)
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
    js = jr.process_frame(_jax().Bundle.from_numpy(*a))
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
    jexport = _jax().export
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
    cfg = TConfig.from_dict(_jax().PRESETS["sim"]().to_dict())
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
    sim = _jax().Sim(n_rays=N_RAYS, seed=6)
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
    sim = _jax().Sim(n_rays=256, seed=0)
    verts = rng.uniform(-6, 6, (500, 3))
    np.testing.assert_array_equal(
        tmq.vertex_surface_distance(verts, sim.scene),
        jmq.vertex_surface_distance(verts, sim.scene))
    faces = rng.integers(0, 500, (300, 3))
    assert tmq.hole_stats(faces) == jmq.hole_stats(faces)


@pytest.mark.cuda
def test_pipelined_runtime_equals_eager_on_the_card():
    """The Avia runtime on the card (chip_smoke's small Avia config with a
    16,384-point mesh map, which compacts every few frames on its own), its
    mesh step a captured graph on its own stream, against graph=False
    (eager, serial) from the same start over 26 IMU-on frames, the frame
    trace on: the pose, the compaction counts, the active count and the
    mesh step's drop counters read as ints after a join of the mesh half
    (no synchronize), and the state as the benchmark's check reads it
    straight after the frame (every tensor of the filter state, the plane
    map, the point map and the store cloned on the current stream, no
    synchronize) bit for bit every frame, then after 10 frames with the
    pose read alone; the cost log's active counts equal.  The trace's
    counters: pose_before_mesh on every replayed frame without a mesh
    compaction, mesh_joins on the joins, lio_over_mesh in the pose-only
    frames; none on the eager runtime."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    import chip_smoke
    from immesh_tpu_torch.utils.graphs import named_tensors
    from immesh_tpu_torch.utils.timers import trace
    dev = torch.device("cuda")
    cfg = chip_smoke.small_avia_config()
    cfg = cfg.replace(mesh=dataclasses.replace(cfg.mesh,
                                               points_capacity=2 ** 14))
    sim = chip_smoke.make_avia_sim(cfg)
    static = sim.static_imu(100)
    bundles = [chip_smoke.bundle(sim.frame(k), cfg, dev) for k in range(36)]
    counters = ("pose_before_mesh", "lio_over_mesh", "mesh_joins")

    def counted():   # the trace's counters of its newest frame
        counts = trace.frame_counts()[-1]
        return np.array([counts.get(c, 0) for c in counters])

    def read(rt):
        return [(n, t.clone()) for n, t in named_tensors(
            {"state": rt.lio.state, "vm": rt.lio.vm, "gm": rt.mesh.gm,
             "store": rt.mesh.store})]

    def differs(a, b):
        return [n for (n, x), (_, y) in zip(a, b)
                if not chip_smoke.same_bits(x, y)]

    trace.disable()
    trace.clear()
    trace.enable()
    try:
        rts = [TRuntime(cfg, device=dev, graph=g) for g in (False, True)]
        for rt in rts:
            rt.static_init(*static)
        eager, piped = rts
        assert eager.mesh.stream is None and piped.mesh.stream is not None
        totals = {id(rt): np.zeros(3, np.int64) for rt in rts}
        steady, compacted, active = [], 0, ([], [])
        for k in range(26):
            got = []
            for rt, act in zip(rts, active):
                before = rt.mesh.n_compactions
                out = rt.process_frame(bundles[k], t=0.1 * k)
                act.append(out["n_active_voxels"])
                rt.mesh.join()
                ints = [int(out["n_active_voxels"])] + [
                    int(v) for v in rt.mesh.last_drops.values()]
                got.append((out["pos"], ints, read(rt), counted(),
                            rt.mesh.n_compactions - before))
                totals[id(rt)] += got[-1][3]
            (pe, ie, se, _, ce), (pp, ip, sp, count, cp) = got
            assert np.array_equal(pe, pp) and ie == ip and ce == cp, k
            assert differs(se, sp) == [], k
            compacted += cp
            if k >= 2 and not cp:
                steady.append(int(count[0]))
        assert compacted >= 3 and len(steady) >= 8
        assert steady == [1] * len(steady)
        assert totals[id(piped)][2] >= len(steady)
        over = totals[id(piped)][1]
        for rt in rts:   # the pose alone, each runtime on its own
            for k in range(26, 36):
                rt.process_frame(bundles[k], t=0.1 * k)
                totals[id(rt)] += counted()
        assert totals[id(piped)][1] - over >= 3
        assert totals[id(eager)].tolist() == [0, 0, 0]
        assert differs(read(eager), read(piped)) == []
        assert eager.mesh.n_compactions == piped.mesh.n_compactions
        torch.cuda.synchronize()
        assert [int(x) for x in active[0]] == [int(x) for x in active[1]]
        for rt in rts:
            rt.close()
    finally:
        trace.disable()
        trace.clear()
