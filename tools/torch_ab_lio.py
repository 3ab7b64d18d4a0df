"""Time the KITTI LIO step and joint frame of one checkout of the port on
the card, for parent/change comparisons.

    python tools/torch_ab_lio.py [--root DIR] [--frames N] [--warmup W]

Imports `chip_smoke` and `immesh_tpu_torch` from DIR (default: the
checkout this file lies in) and makes chip_smoke's phase 4 scans: the KITTI
operating point, 131,072-ray scans of the outdoor simulator.  Over W warm-up
and N timed frames it steps a LioPipeline (each step synchronised and timed
with the host clock), then, on the same scans, a JointPipeline with phase
4's adaptive re-mesh budget (each frame timed the same way).  Both use the
pipelines' defaults on the card, so each checkout runs its own LIO step as a
user would.  Prints the card's name and power limit, then one JSON line: ms
per timed step and frame, their medians and p90s, the last pose and the
live triangles.

Run it against two checkouts in turns within one call on one card
(parent, change, change, parent): times move between calls with the host's
load, so only times of one call compare.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np


def _timed(step, frames, warmup: int) -> list:
    import torch
    ms = []
    for k, b in enumerate(frames):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(k, b)
        torch.cuda.synchronize()
        if k >= warmup:
            ms.append(1e3 * (time.perf_counter() - t0))
    return ms


def _summary(ms: list) -> dict:
    return {"median": statistics.median(ms),
            "p90": float(np.percentile(ms, 90)), "all": ms}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--frames", type=int, default=40)
    ap.add_argument("--warmup", type=int, default=3)
    args = ap.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("torch_ab_lio: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke
    from immesh_tpu_torch.lio.pipeline import LioPipeline
    from immesh_tpu_torch.runtime.joint import JointPipeline
    if not chip_smoke.__file__.startswith(root):
        raise RuntimeError(f"chip_smoke imported from {chip_smoke.__file__}")

    dev = torch.device("cuda", 0)
    cfg = chip_smoke.kitti_config()
    sim = chip_smoke.make_sim(cfg.preprocess.max_points, 64)
    frames = [chip_smoke.bundle(sim.frame(k), cfg, dev)
              for k in range(args.warmup + args.frames)]

    lio = LioPipeline(cfg, device=dev)
    lio_ms = _timed(lambda k, b: lio.step(b), frames, args.warmup)

    joint = JointPipeline(cfg, adaptive_mesh_budget=2048, device=dev)

    def joint_step(k, b):
        joint.step(b)
        if k == 0:
            joint.prime_adaptive()  # the hi-budget variant, as phase 4

    frame_ms = _timed(joint_step, frames, args.warmup)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(smi)
    print(json.dumps({
        "root": root, "lio_step_ms": _summary(lio_ms),
        "frame_ms": _summary(frame_ms),
        "lio_pos": lio.state.pos.cpu().tolist(),
        "joint_pos": joint.state.pos.cpu().tolist(),
        "triangles": int(joint.store.n_triangles())}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
