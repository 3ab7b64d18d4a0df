"""End-to-end demo: simulated LiDAR-inertial sequence → odometry + mesh.

    python -m immesh_tpu_torch.runtime.demo [--frames N] [--out DIR]
        [--preset sim] [--device cuda]

Port of immesh_tpu/runtime/demo.py, the runnable counterpart of
`roslaunch ImMesh mapping_avia.launch` plus a bag replay (reference
README.md:93-134), with the built-in simulator standing in for the sensor.
`--device cpu` runs it without a card.  As in the reference demo, the
printed |p-gt| is the raw filter position against the simulator's ground
truth, without aligning the initial frame.  The LIO and mesh times are
the frame trace's device spans (utils/timers.py), which the log directory
turns on; "-" where a frame has none (its stream was still busy as it
began).
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def _ms(ms: Optional[float]) -> str:
    return "     -" if ms is None else f"{ms:6.1f}"


def main(argv: Optional[Sequence[str]] = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--frames", type=int, default=20)
    ap.add_argument("--out", default="immesh_torch_out")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--preset", default="sim")
    args = ap.parse_args(argv)

    import numpy as np

    from immesh_tpu_torch.config import PRESETS
    from immesh_tpu_torch.frontend.sim import LidarImuSimulator
    from immesh_tpu_torch.frontend.types import ScanBundle
    from immesh_tpu_torch.runtime.app import ImMeshRuntime
    from immesh_tpu_torch.utils.timers import trace

    cfg = PRESETS[args.preset]()
    sim = LidarImuSimulator(n_rays=cfg.preprocess.max_points, seed=0)
    rt = ImMeshRuntime(cfg, log_dir=args.out, device=args.device)
    rt.static_init(*sim.static_imu(100))

    for k in range(args.frames):
        f = sim.frame(k)
        b = ScanBundle.from_numpy(
            f.pts, f.t_rel, f.imu_stamps, f.imu_acc, f.imu_gyr,
            f.scan_duration, cfg.preprocess.max_points,
            cfg.imu.max_imu_per_scan, device=rt.device)
        stats = rt.process_frame(b, t=k * sim.scan_T)
        err = np.linalg.norm(stats["pos"] - f.gt_pos)
        n_vox = stats["n_active_voxels"]
        if rt.mesh is not None:   # written by the mesh half: join it first
            rt.mesh.join()
        lio_ms, mesh_ms = (trace.span_ms(k, n) for n in ("lio", "mesh"))
        print(f"frame {k:3d}  lio {_ms(lio_ms)} ms  mesh {_ms(mesh_ms)} ms  "
              f"voxels {0 if n_vox is None else int(n_vox):4d}  "
              f"matches {int(stats['n_effective']):5d}  |p-gt| {err:.3f} m")

    mesh_path = os.path.join(args.out, "mesh.ply")
    verts, faces = rt.save_mesh(mesh_path, smooth_iters=1)
    rt.save_state(os.path.join(args.out, "ckpt"))
    rt.close()
    print(f"mesh: {len(verts)} verts, {len(faces)} faces → {mesh_path}")
    print(f"trajectory: {os.path.join(args.out, 'kitti_log.txt')}")
    print(f"timing:     {trace.report()}")


if __name__ == "__main__":
    main()
