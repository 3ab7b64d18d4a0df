"""Port parity, sliding-window plane BA: dist/window_ba.py (the Gauss-Newton
blocks, the Schur solve, solve_window), lio/window.py (landmark extraction
from the live VoxelMap, keyframe gating, refine) and the BA hook of
ImMeshRuntime against the JAX reference, on the CPU.

Tolerances, with their reasons:
  * tangent basis: 1e-7 (two cross products and a norm of unit vectors);
  * GN blocks: rtol 1e-5 of each block's largest entry — einsums and
    segment sums over 256 points per keyframe taken in another order;
  * Schur solve and solve_window: 1e-5 on poses, planes and steps (the
    pose system's Cholesky in LAPACK against XLA's; the fixture measures
    ≤ 1.2e-7 after 8 iterations), cost rtol 1e-4 or 1e-8 absolute (a
    converged window's cost, ~1e-7 over 1,280 points, is f32 residual
    noise: the two differ by 1.2e-9 after 4 iterations); in pose-graph
    mode (fix_planes) 1e-4: the 1e12 plane prior leaves every step an f32
    noise floor of ~1e-5, within which both wander once converged (JAX
    6e-8…4e-6 m from the truth, the port ~1e-5 m), so after 8 chained
    iterations they differ by 4.3e-5 (their last steps and costs, noise
    themselves, by 1.0e-4 and 4.4e-6; cost atol 1e-5) although one iteration from the same state agrees to
    4.5e-8;
  * build_window_problem: EXACT (the same map slots and plane parameters
    gathered from the same tensors);
  * WindowBA.refine: 1e-5 on the correction, cost rtol 1e-4;
  * the BA-on runtime: 1e-3 m per frame, as tests/test_torch_runtime.py
    (chained IMU-on frames), cost rtol 1e-3."""

import dataclasses
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from immesh_tpu.config import PRESETS as JPRESETS
from immesh_tpu.config import BaConfig as JBaConfig
from immesh_tpu.dist import window_ba as jba
from immesh_tpu.frontend.sim import LidarImuSimulator
from immesh_tpu.frontend.types import ScanBundle as JBundle
from immesh_tpu.lio import window as jwin
from immesh_tpu.lio.pipeline import LioPipeline as JLio
from immesh_tpu.runtime.app import ImMeshRuntime as JRuntime
from immesh_tpu_torch import interop
from immesh_tpu_torch.config import ImMeshConfig as TConfig
from immesh_tpu_torch.dist import window_ba as tba
from immesh_tpu_torch.frontend.types import ScanBundle as TBundle
from immesh_tpu_torch.lio import window as twin
from immesh_tpu_torch.runtime.app import ImMeshRuntime as TRuntime

sys.path.insert(0, os.path.dirname(__file__))
from test_window_ba import _make_problem  # noqa: E402

N_RAYS = 2048
N_LIO = 6      # reference LIO frames behind the carried map
BLOCKS = ("Hpp", "Hpl", "Hll", "bp", "bl", "cost")


def _t(x):
    return torch.from_numpy(np.array(x))


def _tprob(jprob):
    """A reference WindowProblem carried across field by field."""
    return tba.WindowProblem(*(_t(x) for x in jprob))


def _tree(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if f.metadata.get("pytree_node", True)}
    return np.asarray(obj)


def _bundle_args(f, cfg):
    return (f.pts, f.t_rel, f.imu_stamps, f.imu_acc, f.imu_gyr,
            f.scan_duration, cfg.preprocess.max_points,
            cfg.imu.max_imu_per_scan)


# ---------------------------------------------------------------------------
# the solver
# ---------------------------------------------------------------------------
def test_plane_tangent_basis_matches_reference():
    rng = np.random.default_rng(1)
    n = rng.normal(size=(256, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    n[:4] = [[1, 0, 0], [0.95, 0.31, 0], [0, 1, 0], [0, 0, -1]]
    want = np.asarray(jba.plane_tangent_basis(jnp.asarray(n)))
    got = tba.plane_tangent_basis(_t(n)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-7)


def test_schur_solve_matches_reference():
    """The BA-structured SPD system of tests/test_window_ba.py."""
    rng = np.random.default_rng(2)
    K, M = 3, 5
    np_, nl = 6 * K, 3 * M
    Ap = rng.normal(size=(np_, np_))
    Hpp = (Ap @ Ap.T + 10.0 * np.eye(np_)).astype(np.float32)
    Hll = np.stack([a @ a.T + 10.0 * np.eye(3)
                    for a in rng.normal(size=(M, 3, 3))]).astype(np.float32)
    Hpl = (0.3 * rng.normal(size=(K, M, 6, 3))).astype(np.float32)
    bp = rng.normal(size=np_).astype(np.float32)
    bl = rng.normal(size=(M, 3)).astype(np.float32)
    for damping in (0.0, 1e-6):
        jdp, jdl = jba.schur_solve(*map(jnp.asarray, (Hpp, Hpl, Hll, bp, bl)),
                                   damping=damping)
        tdp, tdl = tba.schur_solve(*map(_t, (Hpp, Hpl, Hll, bp, bl)),
                                   damping=damping)
        np.testing.assert_allclose(tdp.numpy(), np.asarray(jdp), atol=1e-5)
        np.testing.assert_allclose(tdl.numpy(), np.asarray(jdl), atol=1e-5)


def test_schur_solve_failure_is_nan_like_the_reference():
    """A zero plane block without damping is singular: XLA's inverse gives
    non-finite values and the port's inv_ex/cholesky_ex give NaN, with no
    exception in either."""
    K, M = 2, 3
    Hpp = torch.eye(6 * K) * 5.0
    Hpl = torch.ones((K, M, 6, 3))
    Hll = torch.zeros((M, 3, 3))
    bp, bl = torch.ones(6 * K), torch.ones((M, 3))
    jdp, jdl = jba.schur_solve(
        *(jnp.asarray(x.numpy()) for x in (Hpp, Hpl, Hll, bp, bl)),
        damping=0.0)
    tdp, tdl = tba.schur_solve(Hpp, Hpl, Hll, bp, bl, damping=0.0)
    assert not np.isfinite(np.asarray(jdp)).any()
    assert torch.isnan(tdp).all() and torch.isnan(tdl).all()


@pytest.fixture(scope="module")
def problem():
    prob, gt_rot, gt_pos = _make_problem(np.random.default_rng(0))
    return prob, gt_pos


@pytest.mark.parametrize("block", BLOCKS)
def test_point_factor_blocks_match_reference(problem, block):
    prob, _ = problem
    args = (prob.rot, prob.pos, prob.normal, prob.d, prob.pts,
            prob.plane_id, prob.weight)
    want = np.asarray(jba._point_factor_blocks(*args, huber_delta=0.5)[block])
    got = tba._point_factor_blocks(*map(_t, args), huber_delta=0.5)[block]
    scale = max(float(np.abs(want).max()), 1e-30)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("iterations,fix_planes,noisy", [
    (1, False, False), (4, False, False), (8, False, True),
    (8, True, False)])
def test_solve_window_matches_reference(problem, iterations, fix_planes,
                                        noisy):
    """The _make_problem fixture (K=5, M=8, Np=256); `noisy` perturbs the
    planes as TestWindowBA.test_improves_noisy_planes_too does."""
    prob, gt_pos = problem
    if noisy:
        rng = np.random.default_rng(5)
        n = np.asarray(prob.normal) + rng.normal(scale=0.02,
                                                 size=prob.normal.shape)
        n /= np.linalg.norm(n, axis=1, keepdims=True)
        prob = prob._replace(normal=jnp.asarray(n, jnp.float32),
                             d=prob.d + 0.02)
    want = jax.jit(lambda p: jba.solve_window(
        p, iterations=iterations, fix_planes=fix_planes))(prob)
    got = tba.solve_window(_tprob(prob), iterations=iterations,
                           fix_planes=fix_planes)
    atol = 1e-4 if fix_planes else 1e-5
    keys = ("rot", "pos", "normal", "d") + (() if fix_planes
                                           else ("last_step_norm",))
    for key in keys:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=atol, err_msg=key)
    np.testing.assert_allclose(float(got["cost"]), float(want["cost"]),
                               rtol=1e-4, atol=1e-5 if fix_planes else 1e-8)
    if iterations == 8:
        assert np.abs(got["pos"].numpy() - gt_pos).max() < 5e-3
    if fix_planes:  # planes held; the last steps are both at the floor
        np.testing.assert_array_equal(got["normal"].numpy(),
                                      np.asarray(want["normal"]))
        assert max(float(got["last_step_norm"]),
                   float(want["last_step_norm"])) < 2e-4


# ---------------------------------------------------------------------------
# the runtime bridge, on a map the reference LIO built
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def lio_run():
    """The reference LIO over N_LIO IMU-on sim frames: each frame's
    posterior (rot, pos, world scan, mask), the final map, and that map
    carried into the port."""
    cfg = JPRESETS["sim"]()
    cfg = cfg.replace(preprocess=dataclasses.replace(
        cfg.preprocess, max_points=N_RAYS))
    tcfg = TConfig.from_dict(cfg.to_dict())
    sim = LidarImuSimulator(n_rays=N_RAYS, seed=4)
    lio = JLio(cfg)
    lio.static_init(*sim.static_imu(50))
    frames = []
    for k in range(N_LIO):
        b = JBundle.from_numpy(*_bundle_args(sim.frame(k), cfg))
        world, _ = lio.step(b)
        frames.append((np.asarray(lio.state.rot), np.asarray(lio.state.pos),
                       np.asarray(world), np.asarray(b.mask)))
    tvm = interop.from_reference({"vm": _tree(lio.vm)}, tcfg,
                                 device="cpu")["vm"]
    return dict(cfg=cfg, tcfg=tcfg, frames=frames, jvm=lio.vm, tvm=tvm)


@pytest.mark.parametrize("max_planes", [256, 8])
def test_build_window_problem_matches_reference(lio_run, max_planes):
    """Landmarks from the same live map; with max_planes=8 the window hits
    more planes than the cap, and points on the planes past it get weight
    0 in both."""
    K, Np = 3, 128
    rng = np.random.default_rng(3)
    rot = np.stack([f[0] for f in lio_run["frames"][-K:]]).astype(np.float32)
    pos = np.stack([f[1] for f in lio_run["frames"][-K:]]).astype(np.float32)
    pts = np.zeros((K, Np, 3), np.float32)
    for k, (R, p, world, mask) in enumerate(lio_run["frames"][-K:]):
        sel = rng.choice(np.nonzero(mask)[0], Np, replace=False)
        pts[k] = (world[sel] - p) @ R
    mask = rng.random((K, Np)) < 0.9
    odo_rot = np.einsum("kji,kjl->kil", rot[:-1], rot[1:])
    odo_t = np.einsum("kji,kj->ki", rot[:-1], pos[1:] - pos[:-1])
    args = (rot, pos, pts, mask, odo_rot, odo_t)
    want = jwin.build_window_problem(lio_run["jvm"], *map(jnp.asarray, args),
                                     1e2, 1e3, max_planes)
    got = twin.build_window_problem(lio_run["tvm"], *map(_t, args), 1e2, 1e3,
                                    max_planes)
    for name in tba.WindowProblem._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    w = got.weight.numpy()
    n_hit = len(np.unique(lio_run["tvm"].query_planes(
        torch.einsum("kij,kpj->kpi", _t(rot), _t(pts)).reshape(-1, 3)
        + _t(pos).repeat_interleave(Np, 0))["slot"].numpy()))
    if max_planes == 8:
        assert n_hit > 8 and 0 < w.sum() < mask.sum()
    else:
        assert w.sum() > 0.5 * mask.sum()


def test_window_ba_gating_and_refine_match_reference(lio_run):
    """Both managers observe the reference LIO's frames against the same
    map: keyframes fall on the same frames, and every refined window gives
    the same correction and cost."""
    bc = dict(enabled=True, window_size=3, kf_trans_thresh=0.02,
              kf_rot_thresh_deg=1.0, pts_per_keyframe=256)
    jcfg = lio_run["cfg"].replace(ba=JBaConfig(**bc))
    tcfg = TConfig.from_dict(jcfg.to_dict())
    jw, tw = jwin.WindowBA(jcfg), twin.WindowBA(tcfg)
    n_corr = 0
    for rot, pos, world, mask in lio_run["frames"]:
        jc = jw.observe(rot, pos, world, mask, lio_run["jvm"])
        tc = tw.observe(_t(rot), _t(pos), _t(world), _t(mask),
                        lio_run["tvm"])
        assert len(jw.kf_rot) == len(tw.kf_rot)
        assert (jc is None) == (tc is None)
        if jc is None:
            continue
        n_corr += 1
        for key in ("d_rot", "d_pos", "rot", "pos"):
            np.testing.assert_allclose(tc[key], jc[key], atol=1e-5,
                                       err_msg=key)
        np.testing.assert_allclose(tc["cost"], jc["cost"], rtol=1e-4)
    assert n_corr >= 2 and tw.n_refinements == jw.n_refinements == n_corr


def test_runtime_with_ba_matches_reference():
    """ImMeshRuntime, BA on at the sim preset cut small (2,048 rays, meshing
    off, window of 3 keyframes, a keyframe every 5 cm): the refinements
    fall on the same frames, with the same cost, and the corrected poses
    agree."""
    cfg = JPRESETS["sim"]()
    cfg = cfg.replace(
        preprocess=dataclasses.replace(cfg.preprocess, max_points=N_RAYS),
        ba=JBaConfig(enabled=True, window_size=3, kf_trans_thresh=0.05,
                     pts_per_keyframe=256))
    sim = LidarImuSimulator(n_rays=N_RAYS, seed=6)
    acc, gyr = sim.static_imu(50)
    jr = JRuntime(cfg, mesh_enabled=False)
    tr = TRuntime(TConfig.from_dict(cfg.to_dict()), mesh_enabled=False,
                  device="cpu")
    jr.static_init(acc, gyr)
    tr.static_init(acc, gyr)
    costs = []
    for k in range(8):
        a = _bundle_args(sim.frame(k), cfg)
        js = jr.process_frame(JBundle.from_numpy(*a), t=0.1 * k)
        ts = tr.process_frame(TBundle.from_numpy(*a, device="cpu"),
                              t=0.1 * k)
        np.testing.assert_allclose(ts["pos"], js["pos"], atol=1e-3)
        assert (js["ba_cost"] is None) == (ts["ba_cost"] is None), k
        if js["ba_cost"] is not None:
            np.testing.assert_allclose(ts["ba_cost"], js["ba_cost"],
                                       rtol=1e-3)
            costs.append(ts["ba_cost"])
    assert tr.ba.n_refinements == jr.ba.n_refinements >= 2
    assert all(np.isfinite(costs))
