"""Port parity, the IMU path of the LIO step: imu_propagate, deskew,
static_init, reset_filter and one lio_step with the IMU on and non-identity
LiDAR→IMU extrinsics, against the JAX reference on the same seeded inputs.

Tolerances, with their reasons:
  * propagated rot/pos/vel and the pose knots: 1e-5 — the rotation prefix
    products and the cumsums run in another association order (the port's
    Hillis-Steele scan against lax.associative_scan's tree);
  * propagated covariance: rtol 1e-4 of its largest entry — a product of up
    to 63 18×18 (F, Q) pairs composed in that other order;
  * deskewed points: 1e-5 m (ulps of the knot poses times ~10 m ranges);
  * one lio_step: pose 1e-4 m and 1e-5 rad, covariance 1e-3 of its largest
    entry, as tests/test_torch_lio_mesh.py holds the IMU-less step (the
    ESIKF normal equations summed in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from immesh_tpu.config import PRESETS as JPRESETS
from immesh_tpu.config import ImuConfig as JImuConfig
from immesh_tpu.core import so3 as jso3
from immesh_tpu.core.state import EsikfState as JState
from immesh_tpu.frontend.sim import LidarImuSimulator
from immesh_tpu.frontend.types import ScanBundle as JBundle
from immesh_tpu.lio import imu as jimu
from immesh_tpu.lio.pipeline import LioPipeline as JLio
from immesh_tpu.lio.pipeline import lio_step as j_lio_step
from immesh_tpu_torch import interop
from immesh_tpu_torch.config import ImMeshConfig as TConfig
from immesh_tpu_torch.config import ImuConfig as TImuConfig
from immesh_tpu_torch.core import so3
from immesh_tpu_torch.core.state import EsikfState as TState
from immesh_tpu_torch.frontend.types import ScanBundle as TBundle
from immesh_tpu_torch.lio import imu as timu
from immesh_tpu_torch.lio.pipeline import LioPipeline as TLio
from immesh_tpu_torch.lio.pipeline import extrinsics
from immesh_tpu_torch.lio.pipeline import lio_step as t_lio_step

M = 64            # IMU window slots (ImuConfig.max_imu_per_scan)
N_PTS = 512
N_RAYS = 2048     # lio_step test scans
N_PRE = 3         # reference frames run before the compared lio_step


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree(obj):
    """A reference pytree as nested dicts of numpy arrays (data fields
    only), the form interop.from_reference takes."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if f.metadata.get("pytree_node", True)}
    return np.asarray(obj)


def _state(seed):
    """A reference state with every field away from its default."""
    rng = np.random.default_rng(seed)
    rot = np.asarray(jso3.exp(jnp.asarray(
        rng.normal(size=3).astype(np.float32))))
    a = rng.normal(size=(18, 18)).astype(np.float32) * 0.05
    f32 = lambda x: jnp.asarray(np.asarray(x, np.float32))  # noqa: E731
    return JState(
        rot=f32(rot), pos=f32(rng.normal(size=3)), vel=f32(rng.normal(size=3)),
        bg=f32(rng.normal(size=3) * 0.01), ba=f32(rng.normal(size=3) * 0.05),
        grav=f32([0.05, -0.02, -9.81]), cov=f32(a @ a.T + 1e-4 * np.eye(18)))


def _port_state(js):
    return interop.from_reference({"state": _tree(js)}, TConfig(),
                                  device="cpu")["state"]


def _bundle_args(seed, n_imu):
    """A 0.1 s scan with `n_imu` IMU samples at 200 Hz in M slots."""
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-10, 10, (N_PTS, 3)).astype(np.float32)
    t_rel = np.sort(rng.uniform(0, 0.1, N_PTS)).astype(np.float32)
    stamps = (np.arange(n_imu) * 0.005).astype(np.float32)
    acc = (np.array([0.3, -0.2, 9.81]) + rng.normal(size=(n_imu, 3))
           ).astype(np.float32)
    gyr = rng.normal(size=(n_imu, 3)).astype(np.float32) * 0.5
    return (pts, t_rel, stamps, acc, gyr, 0.1, N_PTS, M)


@pytest.mark.parametrize("n_imu", [M, 21], ids=["full", "padded21of64"])
def test_imu_propagate_and_deskew_match_reference(n_imu):
    js = _state(n_imu)
    ts = _port_state(js)
    args = _bundle_args(n_imu, n_imu)
    jb, tb = JBundle.from_numpy(*args), TBundle.from_numpy(*args, device="cpu")
    jout, jseg = jax.jit(jimu.imu_propagate, static_argnums=2)(
        js, jb, JImuConfig())
    tout, tseg = timu.imu_propagate(ts, tb, TImuConfig())
    for name in ("rot", "pos", "vel"):
        np.testing.assert_allclose(np.asarray(getattr(jout, name)),
                                   getattr(tout, name).numpy(), atol=1e-5)
    jc = np.asarray(jout.cov)
    np.testing.assert_allclose(jc, tout.cov.numpy(),
                               atol=1e-4 * np.abs(jc).max())
    for f in dataclasses.fields(tseg):
        np.testing.assert_allclose(np.asarray(getattr(jseg, f.name)),
                                   getattr(tseg, f.name).numpy(), atol=1e-5,
                                   err_msg=f.name)
    if n_imu < M:
        # the last knot reads the window's last slot, a zero padding row
        np.testing.assert_allclose(tseg.gyr[-1].numpy(), -ts.bg.numpy())
    jd = jimu.deskew(jseg, jout, jb.pts, jb.t_rel)
    td = timu.deskew(tseg, tout, tb.pts, tb.t_rel)
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), atol=1e-5)


def test_padded_imu_samples_are_no_ops():
    """dt = 0 past the last valid sample and so3.exp(0) is exactly I: the
    21-of-64 window propagates to the state of the same 21 samples in a
    21-slot window, up to the association order of the prefix products
    (which depends on the window length)."""
    assert torch.equal(so3.exp(torch.zeros(5, 3)),
                       torch.eye(3).expand(5, 3, 3))
    ts = _port_state(_state(3))
    pts, t_rel, stamps, acc, gyr, T, n, _ = _bundle_args(3, 21)
    a, sa = timu.imu_propagate(ts, TBundle.from_numpy(
        pts, t_rel, stamps, acc, gyr, T, n, M, device="cpu"), TImuConfig())
    b, sb = timu.imu_propagate(ts, TBundle.from_numpy(
        pts, t_rel, stamps, acc, gyr, T, n, 21, device="cpu"), TImuConfig())
    for name in ("rot", "pos", "vel"):
        torch.testing.assert_close(getattr(a, name), getattr(b, name),
                                   rtol=0, atol=1e-6)
    torch.testing.assert_close(a.cov, b.cov, rtol=0,
                               atol=1e-6 * float(b.cov.abs().max()))
    # the padded knots all sit at the scan-end pose
    torch.testing.assert_close(sa.pos[21:], a.pos.expand(M - 21, 3),
                               rtol=0, atol=1e-6)


@pytest.mark.parametrize("tilted", [False, True])
def test_static_init_matches_reference(tilted):
    rng = np.random.default_rng(int(tilted))
    g = np.array([0.4, -0.3, 9.8]) if tilted else np.array([0.0, 0.0, 9.81])
    acc = (g + rng.normal(size=(100, 3)) * 0.02).astype(np.float32)
    gyr = (rng.normal(size=(100, 3)) * 0.002).astype(np.float32)
    js = jimu.static_init(jnp.asarray(acc), jnp.asarray(gyr), JImuConfig(),
                          JState.identity())
    ts = timu.static_init(_t(acc), _t(gyr), TImuConfig(),
                          TState.identity(device="cpu"))
    for name in ("rot", "bg", "grav", "pos", "cov"):
        np.testing.assert_allclose(np.asarray(getattr(js, name)),
                                   getattr(ts, name).numpy(), atol=1e-6,
                                   err_msg=name)


@pytest.mark.parametrize("keep_pose", [True, False])
def test_reset_filter_matches_reference(keep_pose):
    cfg = JPRESETS["avia"]()
    jl, tl = JLio(cfg), TLio(TConfig.from_dict(cfg.to_dict()), device="cpu")
    jl.state = _state(7)
    tl.state = _port_state(jl.state)
    jl.reset_filter(keep_pose=keep_pose)
    tl.reset_filter(keep_pose=keep_pose)
    for f in dataclasses.fields(tl.state):
        np.testing.assert_array_equal(np.asarray(getattr(jl.state, f.name)),
                                      getattr(tl.state, f.name).numpy())


def _ext_config():
    """PRESETS["sim"] cut to 2,048-ray scans and a 2¹³-slot plane map, with
    the LiDAR mounted 8° in yaw and offset from the IMU (as
    tests/test_real_data.py::TestExtrinsics)."""
    th = np.deg2rad(8.0)
    ext_r = np.array([[np.cos(th), -np.sin(th), 0],
                      [np.sin(th), np.cos(th), 0], [0, 0, 1]])
    ext_t = np.array([0.1, -0.05, 0.2])
    base = JPRESETS["sim"]()
    cfg = base.replace(
        preprocess=dataclasses.replace(base.preprocess, max_points=N_RAYS),
        imu=JImuConfig(extrinsic_t=tuple(ext_t),
                       extrinsic_r=tuple(ext_r.ravel())),
        voxel_map=dataclasses.replace(base.voxel_map, capacity=2 ** 13,
                                      touched_voxels_per_scan=1024),
        lio=dataclasses.replace(base.lio, map_update_points=1024))
    return cfg, ext_r, ext_t


def test_lio_step_with_imu_and_extrinsics_matches_reference():
    cfg, ext_r, ext_t = _ext_config()
    tcfg = TConfig.from_dict(cfg.to_dict())
    assert tcfg.imu.imu_en and tcfg.imu.extrinsic_t != (0.0, 0.0, 0.0)
    sim = LidarImuSimulator(n_rays=N_RAYS, seed=2, ext_r=ext_r, ext_t=ext_t)
    lio = JLio(cfg)
    lio.static_init(*sim.static_imu(100))

    def args(k):
        f = sim.frame(k)
        return (f.pts, f.t_rel, f.imu_stamps, f.imu_acc, f.imu_gyr,
                f.scan_duration, N_RAYS, cfg.imu.max_imu_per_scan)

    for k in range(N_PRE):
        lio.step(JBundle.from_numpy(*args(k)))
    o = interop.from_reference(
        {"state": _tree(lio.state), "vm": _tree(lio.vm)}, tcfg, device="cpu")
    a = args(N_PRE)
    js, jvm, jworld, jdiag = j_lio_step(lio.state, lio.vm,
                                        JBundle.from_numpy(*a), cfg)
    tb = TBundle.from_numpy(*a, device="cpu")
    ts, tvm, tworld, tdiag = t_lio_step(
        o["state"], o["vm"], tb, tcfg, extrinsics(tcfg.imu, tb.pts))
    assert int(tdiag["n_effective"]) > 300
    assert abs(int(jdiag["n_effective"]) - int(tdiag["n_effective"])) <= 2
    np.testing.assert_allclose(np.asarray(js.pos), ts.pos.numpy(), atol=1e-4)
    assert float(so3.log(_t(np.asarray(js.rot)).T @ ts.rot).norm()) < 1e-5
    for name in ("vel", "bg", "ba"):
        np.testing.assert_allclose(np.asarray(getattr(js, name)),
                                   getattr(ts, name).numpy(), atol=1e-3)
    jc = np.asarray(js.cov)
    np.testing.assert_allclose(jc, ts.cov.numpy(),
                               atol=1e-3 * np.abs(jc).max())
    m = np.asarray(JBundle.from_numpy(*a).mask)
    np.testing.assert_allclose(np.asarray(jworld)[m], tworld.numpy()[m],
                               atol=1e-4)
    np.testing.assert_array_equal(np.asarray(jvm.table.keys),
                                  tvm.table.keys.numpy())

