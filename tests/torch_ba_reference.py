"""The JAX reference's own error at the BA-on Avia operating point — the
source of chip_smoke.py's BA_POSE_TOL_M and BA_FRAMES.  A script, not a
test (a few minutes on a CPU):

    JAX_PLATFORMS=cpu python tests/torch_ba_reference.py [--frames 80] [--no-ba]

Runs the reference ImMeshRuntime on the CPU exactly as chip_smoke.py's
phase 8 runs the port: PRESETS["avia"] with window BA on at its defaults
(BaConfig(enabled=True): 8 keyframes, 512 points each, 256 landmarks, 4 GN
iterations, a keyframe every 0.5 m or 10°), meshing on, the indoor
simulator with the LiDAR at the preset's extrinsics, seed 0, static init
drawn first, the initial frame aligned to ground truth.  Prints per frame
the pose error, the window cost where a window was refined and the count
of refinements; then the max and last pose error, the frames that refined
and the ATE of the logged trajectory.  --no-ba runs the same frames with BA
off, for comparison.
"""

import argparse
import os
import sys
import tempfile

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from immesh_tpu.config import PRESETS, BaConfig  # noqa: E402
from immesh_tpu.eval.ate import evaluate_ate, from_rows, load_tum  # noqa: E402
from immesh_tpu.frontend.sim import LidarImuSimulator  # noqa: E402
from immesh_tpu.frontend.types import ScanBundle  # noqa: E402
from immesh_tpu.runtime.app import ImMeshRuntime  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--no-ba", action="store_true")
    args = ap.parse_args()
    cfg = PRESETS["avia"]().replace(ba=BaConfig(enabled=not args.no_ba))
    sim = LidarImuSimulator(n_rays=cfg.preprocess.max_points,
                            ext_r=np.reshape(cfg.imu.extrinsic_r, (3, 3)),
                            ext_t=cfg.imu.extrinsic_t, seed=0)
    acc, gyr = sim.static_imu(100)
    log_dir = tempfile.mkdtemp(prefix="ba_reference_")
    rt = ImMeshRuntime(cfg, log_dir=log_dir)
    rt.static_init(acc, gyr)
    R0, p0 = sim.traj.pose(0.0)
    R_align = R0 @ np.asarray(rt.lio.state.rot, np.float64).T
    errs, refined, gt_rows = [], [], []
    for k in range(args.frames):
        f = sim.frame(k)
        st = rt.process_frame(ScanBundle.from_numpy(
            f.pts, f.t_rel, f.imu_stamps, f.imu_acc, f.imu_gyr,
            f.scan_duration, cfg.preprocess.max_points,
            cfg.imu.max_imu_per_scan), t=k * sim.scan_T)
        errs.append(float(np.linalg.norm(R_align @ st["pos"] + p0
                                         - f.gt_pos)))
        gt_rows.append((k * sim.scan_T, *f.gt_pos, 0, 0, 0, 1))
        line = f"frame {k:2d}: pose err {errs[-1]:.4f} m"
        if st["ba_cost"] is not None:
            refined.append(k)
            line += (f", window refined (cost {st['ba_cost']:.4f}, "
                     f"refinement {rt.ba.n_refinements})")
        print(line, flush=True)
    rt.close()
    ate = evaluate_ate(load_tum(os.path.join(log_dir, "kitti_log.txt")),
                       from_rows(gt_rows))
    print(f"pose err max {max(errs):.4f} m (frame {int(np.argmax(errs))}), "
          f"last {errs[-1]:.4f} m; {len(refined)} refinements on frames "
          f"{refined}; ATE {ate['ate_rmse']:.4f} m RMSE over "
          f"{ate['n_pairs']} frames; live triangles "
          f"{int(rt.mesh.store.n_triangles())}")


if __name__ == "__main__":
    main()
