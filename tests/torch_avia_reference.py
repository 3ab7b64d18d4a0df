"""The JAX reference's own error at the Avia operating point — the source of
chip_smoke.py's AVIA_POSE_TOL_M, AVIA_MESH_RMS_TOL_M and IMU_WARM_GT_TOL_M.
A script, not a test (~45 s on a CPU):

    JAX_PLATFORMS=cpu python tests/torch_avia_reference.py [--frames 33] [--port-frames 8]

Runs the reference ImMeshRuntime on the CPU exactly as chip_smoke.py's
phase 6 runs the port: PRESETS["avia"], the indoor simulator with the LiDAR
at the preset's extrinsics, seed 0, static init drawn first, the initial
frame aligned to ground truth.  Prints the pose error per frame, its max
and last, and the mesh's vertex RMS from the analytic scene.  With
--port-frames N the port runs beside it on the CPU for the first N frames
and the pose difference is printed too.  Then the reference JointPipeline
runs the first frames of chip_smoke.py's small Avia-shaped configuration
(phase 5) and prints their pose error.
"""

import argparse
import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import numpy as np  # noqa: E402

jax.config.update("jax_platforms", "cpu")

from immesh_tpu.config import PRESETS  # noqa: E402
from immesh_tpu.eval.mesh_quality import vertex_surface_distance  # noqa: E402
from immesh_tpu.frontend.sim import LidarImuSimulator  # noqa: E402
from immesh_tpu.frontend.types import ScanBundle  # noqa: E402
from immesh_tpu.runtime.app import ImMeshRuntime  # noqa: E402
from immesh_tpu_torch.config import ImMeshConfig as TConfig  # noqa: E402
from immesh_tpu_torch.frontend.types import ScanBundle as TBundle  # noqa: E402
from immesh_tpu_torch.runtime.app import ImMeshRuntime as TRuntime  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=33)
    ap.add_argument("--port-frames", type=int, default=0)
    args = ap.parse_args()
    cfg = PRESETS["avia"]()
    sim = LidarImuSimulator(n_rays=cfg.preprocess.max_points,
                            ext_r=np.reshape(cfg.imu.extrinsic_r, (3, 3)),
                            ext_t=cfg.imu.extrinsic_t, seed=0)
    acc, gyr = sim.static_imu(100)
    rt = ImMeshRuntime(cfg)
    rt.static_init(acc, gyr)
    tr = None
    if args.port_frames:
        tr = TRuntime(TConfig.from_dict(cfg.to_dict()), device="cpu")
        tr.static_init(acc, gyr)
    R0, p0 = sim.traj.pose(0.0)
    R_align = R0 @ np.asarray(rt.lio.state.rot, np.float64).T
    errs = []
    for k in range(args.frames):
        f = sim.frame(k)
        a = (f.pts, f.t_rel, f.imu_stamps, f.imu_acc, f.imu_gyr,
             f.scan_duration, cfg.preprocess.max_points,
             cfg.imu.max_imu_per_scan)
        st = rt.process_frame(ScanBundle.from_numpy(*a), t=k * sim.scan_T)
        errs.append(float(np.linalg.norm(R_align @ st["pos"] + p0
                                         - f.gt_pos)))
        line = (f"frame {k:2d}: pose err {errs[-1]:.4f} m, "
                f"{int(st['n_effective'])} matches")
        if tr is not None and k < args.port_frames:
            ts = tr.process_frame(TBundle.from_numpy(*a, device="cpu"))
            line += (f"; port {int(ts['n_effective'])} matches, |Δpos| "
                     f"{np.abs(st['pos'] - ts['pos']).max():.2e} m")
        print(line, flush=True)
    verts, _ = rt.mesh.extract()
    vd = vertex_surface_distance(verts @ R_align.T + p0, sim.scene)
    print(f"pose err max {max(errs):.4f} m (frame {int(np.argmax(errs))}), "
          f"last {errs[-1]:.4f} m; mesh vertex RMS "
          f"{np.sqrt(np.mean(vd ** 2)):.4f} m (p95 "
          f"{np.percentile(vd, 95):.4f} m) over {len(verts)} vertices")
    small_warm_frames()


def small_warm_frames():
    """The reference JointPipeline on chip_smoke.py's 4,096-ray Avia-shaped
    configuration (phase 5) over its first IMU_WARM frames: the source of
    IMU_WARM_GT_TOL_M."""
    import chip_smoke
    from immesh_tpu.config import ImMeshConfig
    from immesh_tpu.runtime.joint import JointPipeline

    cfg = ImMeshConfig.from_dict(chip_smoke.small_avia_config().to_dict())
    sim = LidarImuSimulator(n_rays=cfg.preprocess.max_points,
                            ext_r=np.reshape(cfg.imu.extrinsic_r, (3, 3)),
                            ext_t=cfg.imu.extrinsic_t, seed=0)
    jp = JointPipeline(cfg)
    jp.static_init(*sim.static_imu(100))
    R0, p0 = sim.traj.pose(0.0)
    R_align = R0 @ np.asarray(jp.lio.state.rot, np.float64).T
    errs = []
    for k in range(chip_smoke.IMU_WARM):
        f = sim.frame(k)
        _, diag = jp.step(ScanBundle.from_numpy(
            f.pts, f.t_rel, f.imu_stamps, f.imu_acc, f.imu_gyr,
            f.scan_duration, cfg.preprocess.max_points,
            cfg.imu.max_imu_per_scan))
        errs.append(float(np.linalg.norm(
            R_align @ np.asarray(jp.state.pos, np.float64) + p0 - f.gt_pos)))
        print(f"small Avia-shaped frame {k}: pose err {errs[-1]:.4f} m, "
              f"{int(diag['n_effective'])} matches", flush=True)
    print(f"small Avia-shaped, frames 0-{len(errs) - 1}: pose err max "
          f"{max(errs):.4f} m")


if __name__ == "__main__":
    main()
