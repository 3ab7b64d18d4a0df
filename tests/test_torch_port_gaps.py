"""Port parity of the entry points the port lacked or got wrong:
JointPipeline.static_init (the IMU static initialization the reference's
JointPipeline delegates to its LIO), the ATE/RPE command line
eval/ate.py::main, and MeshPipeline.step on a zero-row scan.

JointPipeline runs PRESETS["sim"] with its bundles cut to the 2,048 rays
the simulator casts.  Tolerances: the IMU-on JointPipeline pose 1e-3 m per
chained frame (as tests/test_torch_runtime.py holds chained IMU-on
frames), static_init's state 1e-6 (tests/test_torch_imu.py); the ATE
command line's printed numbers 1e-12 (the same NumPy code on the same
files); the zero-row mesh step EXACT."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import immesh_tpu.runtime.joint as jjoint
import immesh_tpu_torch.runtime.joint as tjoint
from immesh_tpu.config import PRESETS as JPRESETS
from immesh_tpu.eval import ate as jate
from immesh_tpu.frontend.sim import LidarImuSimulator
from immesh_tpu.frontend.types import ScanBundle as JBundle
from immesh_tpu.mesh.pipeline import MeshPipeline as JMeshPipe
from immesh_tpu_torch.config import ImMeshConfig as TConfig
from immesh_tpu_torch.eval import ate as tate
from immesh_tpu_torch.frontend.types import ScanBundle as TBundle
from immesh_tpu_torch.mesh.pipeline import MeshPipeline as TMeshPipe

N_RAYS, N_STEPS = 2048, 4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores; eager torch ops on small
    tensors gain nothing from threads, and oversubscribed threads slow
    every worker, so this module runs torch on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_joint_pipeline_static_init_matches_reference():
    base = JPRESETS["sim"]()
    cfg = base.replace(preprocess=dataclasses.replace(
        base.preprocess, max_points=N_RAYS))
    tcfg = TConfig.from_dict(cfg.to_dict())
    sim = LidarImuSimulator(n_rays=N_RAYS, seed=3)
    acc, gyr = sim.static_imu(100)
    jp = jjoint.JointPipeline(cfg)
    tp = tjoint.JointPipeline(tcfg, device="cpu")
    jp.static_init(acc, gyr)
    tp.static_init(acc, gyr)
    for name in ("rot", "pos", "vel", "bg", "ba", "grav", "cov"):
        np.testing.assert_allclose(getattr(tp.state, name).numpy(),
                                   np.asarray(getattr(jp.state, name)),
                                   atol=1e-6, err_msg=name)
    for k in range(N_STEPS):
        f = sim.frame(k)
        args = (f.pts, f.t_rel, f.imu_stamps, f.imu_acc, f.imu_gyr,
                f.scan_duration, cfg.preprocess.max_points,
                cfg.imu.max_imu_per_scan)
        jp.step(JBundle.from_numpy(*args))
        tp.step(TBundle.from_numpy(*args, device="cpu"))
        np.testing.assert_allclose(tp.state.pos.numpy(),
                                   np.asarray(jp.state.pos), atol=1e-3,
                                   err_msg=f"frame {k}")
    assert int(tp.store.n_triangles()) > 0


def _write_tum(path, stamps, pos, quat):
    with open(path, "w") as fh:
        fh.write("# timestamp tx ty tz qx qy qz qw\n")
        for t, p, q in zip(stamps, pos, quat):
            fh.write(" ".join(f"{x:.9f}" for x in (t, *p, *q)) + "\n")


@pytest.mark.parametrize("scale", [False, True])
def test_ate_command_line_matches_reference(tmp_path, capsys, scale):
    rng = np.random.default_rng(5)
    n = 60
    t = np.arange(n) * 0.1
    gt = np.cumsum(rng.normal(0, 0.3, (n, 3)), axis=0)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    est = 1.02 * gt + rng.normal(0, 0.02, (n, 3)) + [0.5, -0.2, 0.1]
    _write_tum(tmp_path / "gt.txt", t, gt, q)
    _write_tum(tmp_path / "est.txt", t + 0.003, est, q)
    argv = [str(tmp_path / "est.txt"), str(tmp_path / "gt.txt")]
    argv += ["--scale"] if scale else []
    outs = []
    for main in (jate.main, tate.main):
        assert main(argv) == 0
        outs.append(json.loads(capsys.readouterr().out))
    want, got = outs
    assert set(got) == set(want) and got["n_pairs"] == want["n_pairs"] == n
    for key in want:
        assert got[key] == pytest.approx(want[key], abs=1e-12), key


def test_mesh_step_on_a_zero_row_scan_matches_reference():
    cfg = JPRESETS["sim"]()
    cfg = cfg.replace(mesh=cfg.mesh.__class__(
        points_capacity=2 ** 12, voxel_capacity=2 ** 9,
        active_voxels_per_frame=64, mesh_chunk=16))
    tcfg = TConfig.from_dict(cfg.to_dict())
    rng = np.random.default_rng(2)
    pts = np.stack([rng.uniform(-1, 1, 500), rng.uniform(-1, 1, 500),
                    rng.normal(0, 0.005, 500)], -1).astype(np.float32)
    sensor = np.array([0.0, 0.0, 2.0], np.float32)
    jm, tm = JMeshPipe(cfg), TMeshPipe(tcfg, device="cpu")
    for p, m in ((pts, np.ones(500, bool)),
                 (np.zeros((0, 3), np.float32), np.zeros(0, bool))):
        n_j = int(jm.step(p, m, sensor))
        n_t = int(tm.step(p, m, sensor)[0])
        assert n_t == n_j
    assert int(tm.gm.pt_count) == int(jm.gm.pt_count) > 0
    np.testing.assert_array_equal(tm.gm.pts.numpy(), np.asarray(jm.gm.pts))
    np.testing.assert_array_equal(tm.store.tri_ids.numpy(),
                                  np.asarray(jm.store.tri_ids))
    np.testing.assert_array_equal(tm.gm.vox_new.numpy(),
                                  np.asarray(jm.gm.vox_new))
