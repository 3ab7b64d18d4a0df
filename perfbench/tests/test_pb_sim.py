"""The benchmark's simulator against the port's NumPy one
(immesh_tpu_torch/frontend/sim.py) at a small ray count, noise off.

Both cast the same rays from the same poses through the same float32
formula, so the points, their times and the hit mask agree to rounding
only: the NumPy raycast sums its dot products inside a matmul, this one
elementwise in axis order, which may differ in the last bit; a ray that
grazes a plane's edge could then flip, and none does at these poses.  The
IMU agrees to the port's float32 rounding of the same float64 values."""

import numpy as np
import pytest
import torch

from immesh_tpu_torch.frontend import sim as port_sim
from perfbench.sim import routes, scene
from perfbench.sim.lidar import Lidar
from perfbench.sim.stream import make_route

N_RAYS = 2048


def _quiet(**kw):
    return dict(range_noise=0.0, accel_noise=0.0, gyro_noise=0.0, **kw)


CASES = {
    "street": (lambda: port_sim.LidarImuSimulator(
                   scene=port_sim.outdoor_scene(400.0),
                   traj=port_sim.ForwardTrajectory(9.0), n_rays=N_RAYS,
                   rings=64, max_range=120.0, seed=0, **_quiet()),
               lambda: Lidar(scene.street(400.0, 12.0, 3).arrays(),
                             routes.Forward(9.0), "cpu", n_rays=N_RAYS,
                             rings=64, max_range=120.0, **_quiet()),
               (0, 5, 30, 60, 200)),
    "room": (lambda: port_sim.LidarImuSimulator(
                 n_rays=N_RAYS, seed=0, ext_t=(0.04165, 0.02326, -0.0284),
                 **_quiet()),
             lambda: Lidar(scene.room().arrays(), routes.Orbit(), "cpu",
                           n_rays=N_RAYS, ext_t=(0.04165, 0.02326, -0.0284),
                           **_quiet()),
             (0, 7, 40)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_scans_and_imu_match_the_port_simulator(case):
    make_port, make_ours, ks = CASES[case]
    port, ours = make_port(), make_ours()
    gen = torch.Generator().manual_seed(0)
    pts, ok = ours.scans(list(ks), [0.7 * k for k in ks], gen)
    _, acc, gyr = ours.imu(list(ks), np.random.default_rng(0))
    for b, k in enumerate(ks):
        f = port.frame(k)
        assert int(ok[b].sum()) == len(f.pts)
        np.testing.assert_allclose(pts[b][ok[b]].numpy(), f.pts,
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(ours.t_rel[ok[b]].numpy(), f.t_rel,
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(acc[b], f.imu_acc, rtol=1e-6, atol=1e-5)
        np.testing.assert_allclose(gyr[b], f.imu_gyr, rtol=1e-6, atol=1e-6)


def test_planes_out_of_range_change_no_hit():
    """Casting against every plane of the street or only those within range
    of the batch's poses gives the same points."""
    lid = Lidar(scene.street(400.0, 12.0, 3).arrays(), routes.Forward(9.0),
                "cpu", n_rays=N_RAYS, rings=64, max_range=120.0, **_quiet())
    gen = torch.Generator().manual_seed(0)
    near, near_ok = lid.scans([300], [0.0], gen)
    in_range = lid._planes
    along = np.array([[x, 0.0, 0.0] for x in range(-200, 800, 50)], float)
    lid._planes = lambda p: in_range(np.concatenate([p, along]))
    assert len(lid._planes(np.zeros((1, 3)))["N"]) == len(
        scene.street().rows)
    every, every_ok = lid.scans([300], [0.0],
                                torch.Generator().manual_seed(0))
    assert torch.equal(near_ok, every_ok)
    assert torch.equal(near[near_ok], every[every_ok])


@pytest.mark.parametrize("traffic", ["loop-urban", "loop-revisit",
                                     "orbit-room"])
def test_routes_close_on_a_whole_lap(traffic):
    """A lap of lap_frames scans ends where it began, pose and all, so the
    lap's scans can be replayed lap after lap."""
    import json
    import os
    from perfbench.harness.cell import PERFBENCH
    with open(os.path.join(PERFBENCH, "traffic", traffic + ".json")) as f:
        t = json.load(f)
    r = make_route(t["route"], t["lap_frames"], 0.1, t["t_ramp"])
    t0 = t["lead_in"] * 0.1 + np.linspace(0.0, 0.1, 7)
    R0, p0 = r.pose(t0)
    R1, p1 = r.pose(t0 + t["lap_frames"] * 0.1)
    np.testing.assert_allclose(p1, p0, atol=1e-6)
    np.testing.assert_allclose(R1, R0, atol=1e-9)
    if t["route"]["kind"] == "loop":  # no seam where a lap meets the next
        loop = r.loop
        pa, ha = loop.centre(np.array([0.0, loop.length - 1e-6]))
        np.testing.assert_allclose(pa[0], pa[1], atol=1e-5)
        assert abs((ha[1] - ha[0]) - 2 * np.pi) < 1e-6
    # at rest at t = 0, moving once the ramp is over
    _, pa = r.pose(np.array([0.0, 1e-3]))
    assert np.linalg.norm(pa[1] - pa[0]) < 1e-5
