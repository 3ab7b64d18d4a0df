"""The JAX dp LIO step's own distance from the single-device pipeline — the
cut-size figures chip_smoke.py's phase 13a comment cites.  A script, not a
test (~3 min on a CPU at 32,768 rays, ~6 min at 65,536):

    JAX_PLATFORMS=cpu python tests/torch_dist_reference.py [--frames 23] [--rays 8192]

Runs the reference make_dp_lio_step on a 2-device CPU mesh and the
reference single-device LioPipeline side by side on chip_smoke.py's KITTI
operating point cut to `--rays` rays (the outdoor street canyon, 64 rings,
seed 0, IMU-less, kitti_config's map and LIO settings), and prints per
frame both poses' error from ground truth and their gap |p_dp − p_single|,
then the maxima.  The dp step downsamples each shard on its own
(map_update_points / n per shard), so the two part by more than
reduction-order ulps; where a shard's rows hold more cells than its
budget, it drops its forward-most cells and they part further.
"""

import argparse
import dataclasses
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=2").strip()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from immesh_tpu.config import PRESETS  # noqa: E402
from immesh_tpu.dist.lio import make_dp_lio_step  # noqa: E402
from immesh_tpu.frontend.sim import (  # noqa: E402
    ForwardTrajectory, LidarImuSimulator, outdoor_scene)
from immesh_tpu.frontend.types import ScanBundle  # noqa: E402
from immesh_tpu.lio.pipeline import LioPipeline  # noqa: E402


def kitti_config(n_rays: int):
    """chip_smoke.kitti_config's LIO and map settings at n_rays rays."""
    base = PRESETS["kitti"]()
    return base.replace(
        preprocess=base.preprocess.__class__(
            lidar_type=100, blind=0.05, max_points=n_rays),
        voxel_map=dataclasses.replace(
            base.voxel_map, touched_voxels_per_scan=1024))


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=23)
    ap.add_argument("--rays", type=int, default=8192)
    args = ap.parse_args()
    cfg = kitti_config(args.rays)
    sim = LidarImuSimulator(
        scene=outdoor_scene(length=400.0), traj=ForwardTrajectory(speed=9.0),
        n_rays=args.rays, rings=64, max_range=120.0, seed=0)
    R0, p0 = sim.traj.pose(0.0)
    ref = LioPipeline(cfg)
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    step, shard = make_dp_lio_step(mesh, cfg)
    state = ref.state
    vm = ref.vm.__class__.create(cfg.voxel_map)
    gaps, e_dp, e_single = [], [], []
    for k in range(args.frames):
        f = sim.frame(k)
        b = ScanBundle.from_numpy(f.pts, f.t_rel, f.imu_stamps, f.imu_acc,
                                  f.imu_gyr, f.scan_duration, args.rays,
                                  cfg.imu.max_imu_per_scan)
        ref.step(b)
        state, vm, _, _ = step(state, vm, shard(b))
        p_s = np.asarray(ref.state.pos, np.float64)
        p_d = np.asarray(state.pos, np.float64)
        gaps.append(float(np.linalg.norm(p_d - p_s)))
        e_single.append(float(np.linalg.norm(R0 @ p_s + p0 - f.gt_pos)))
        e_dp.append(float(np.linalg.norm(R0 @ p_d + p0 - f.gt_pos)))
        print(f"frame {k:2d}: gap {gaps[-1]:.4f} m, err dp {e_dp[-1]:.4f} m, "
              f"single {e_single[-1]:.4f} m", flush=True)
    print(f"{args.frames} frames at {args.rays} rays, 2 shards: gap max "
          f"{max(gaps):.4f} m (frame {int(np.argmax(gaps))}), err max dp "
          f"{max(e_dp):.4f} m, single {max(e_single):.4f} m")


if __name__ == "__main__":
    main()
