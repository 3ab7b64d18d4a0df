"""The source of chip_smoke.py's texture bounds (TEX_COLOR_TOL and the LK
bounds).  A script, not a test: pytest does not collect it.

    python tests/torch_texture_bounds.py [--frames 30] [--scales 4 2]

1. Phases 11-12 of chip_smoke.py on the CPU at a cut size: the Avia wire
   path at 4,096 rays with the mesh map enlarged so no compaction fires
   (as none does at the preset's size), 3 + `frames` frames, camera images
   cut to 1280/s × 1024/s with the focal length cut alike; prints the median
   |colour − paint| over the coloured points for each s.
2. lk_track at full size (1280×1024) on the CPU between chip_smoke's
   LK_FRAME and the next frame: the chosen features (lk_truth), how many
   are tracked, the median error and the share within 1 px.

CUDA synchronisation and events are replaced by host stand-ins, and the
launch counter is held non-zero, since the CPU launches no kernel.
"""

import argparse
import dataclasses
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402
from immesh_tpu_torch.kernels import pairs_argmin as pk  # noqa: E402
from immesh_tpu_torch.texture.camera import PinholeCamera, to_gray  # noqa: E402
from immesh_tpu_torch.texture.optical_flow import (  # noqa: E402
    build_pyramid, lk_track)


class _HostEvent:
    def __init__(self, **_):
        self.t = None

    def record(self):
        self.t = time.perf_counter()

    def elapsed_time(self, other):
        return 1e3 * (other.t - self.t)


def colour_error(frames: int, scale: int) -> float:
    cs.CAM_W, cs.CAM_H, cs.CAM_F = 1280 // scale, 1024 // scale, 863.0 / scale
    cs.LK_STEP, cs.LK_MARGIN = 32 // scale, 40 // scale
    tex = cs.TexturePhase(torch.device("cpu"), frames + 3)
    rt, _, R_align, p0, _ = cs.phase_replay_avia(
        torch.device("cpu"), frames, 3, on_frame=tex.on_frame)
    return tex.finish(rt, R_align, p0)["color_err"]


def lk_full_size() -> None:
    cs.CAM_W, cs.CAM_H, cs.CAM_F = 1280, 1024, 863.0
    cs.LK_STEP, cs.LK_MARGIN = 32, 40
    sim = cs.make_avia_sim(cs.avia_config())
    cam = PinholeCamera.create(cs.CAM_F, cs.CAM_F, (cs.CAM_W - 1) / 2,
                               (cs.CAM_H - 1) / 2, cs.CAM_W, cs.CAM_H)
    a = cs.LK_FRAME
    poses = [cs.camera_pose(*sim.traj.pose((k + 1) * sim.scan_T))
             for k in (a, a + 1)]
    (img_a, hit_a), (img_b, _) = (cs.make_image(sim, cam, *p) for p in poses)
    pyr = [build_pyramid(to_gray(torch.from_numpy(x)), 3)
           for x in (img_a, img_b)]
    u, v = np.meshgrid(np.arange(cs.LK_MARGIN, cs.CAM_W - cs.LK_MARGIN,
                                 cs.LK_STEP),
                       np.arange(cs.LK_MARGIN, cs.CAM_H - cs.LK_MARGIN,
                                 cs.LK_STEP))
    feats = np.stack([u, v], -1).reshape(-1, 2).astype(np.float32)
    out, ok = (x.numpy() for x in lk_track(*pyr, torch.from_numpy(feats),
                                           win=21, iters=10))
    truth, chosen = cs.lk_truth(sim, cam, hit_a, poses[1], feats)
    tracked = chosen & ok
    err = np.linalg.norm(out[tracked] - truth[tracked], axis=1)
    print(f"LK {a} → {a + 1} at {cs.CAM_W}x{cs.CAM_H}: {len(feats)} "
          f"features, {int(ok.sum())} tracked; {int(chosen.sum())} chosen, "
          f"{int(tracked.sum())} tracked, error median {np.median(err):.3f}"
          f" px, within 1 px {np.mean(err <= 1.0):.3f}, p95 "
          f"{np.percentile(err, 95):.3f} px")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=30)
    ap.add_argument("--scales", type=int, nargs="+", default=[4, 2])
    args = ap.parse_args()

    torch.cuda.synchronize = lambda *a, **k: None
    torch.cuda.Event = _HostEvent
    pk.reset_launches = lambda: setattr(pk, "launches", 1)
    small = cs.small_avia_config()
    small = small.replace(mesh=dataclasses.replace(
        small.mesh, points_capacity=2 ** 18, voxel_capacity=2 ** 14))
    cs.avia_config = lambda: small
    # measure, do not judge: the bounds under test are what this prints
    cs.TEX_COLOR_TOL = cs.LK_MEDIAN_TOL_PX = np.inf
    cs.RENDER_FLIPS = cs.LK_STATUS_FLIPS = 10 ** 9
    cs.LK_WITHIN_1PX = cs.LK_MIN_TRACKED = 0.0
    for s in args.scales:
        err = colour_error(args.frames, s)
        print(f"colour: median |colour − paint| {err:.3f} at "
              f"{1280 // s}x{1024 // s}")
    lk_full_size()


if __name__ == "__main__":
    main()
