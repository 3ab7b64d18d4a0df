"""A cell's poses against its route's truth, frame by frame, with the BA
window's corrections and the refinement frames' latency.  It answers
whether the program keeps the route on a cell's traffic (a pose more than
`--tol` m from the truth loses it), which the check cannot: the reference
follows the program step by step.

    python3 perfbench/tools/route_error.py --workload avia-indoor-ba.ba-window \
        [--config avia-indoor-ba --traffic ba-window] \
        --seed 1002 --frames 400 [--lap-frames 66] [--ba 0|1] [--apply 0|1] \
        [--device cuda]

From the root of a checkout.  With --config and --traffic the cell is
configs/<config>.json under traffic/<traffic>.json, listed in
BENCHMARK.json or not.  --ba and --apply override the configuration's
ba.enabled and ba.apply_correction."""

from __future__ import annotations

import argparse
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--config")
    ap.add_argument("--traffic")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--frames", type=int, required=True)
    ap.add_argument("--lap-frames", type=int)
    ap.add_argument("--ba", type=int, choices=(0, 1))
    ap.add_argument("--apply", type=int, choices=(0, 1))
    ap.add_argument("--tol", type=float, default=0.072)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from perfbench.run import cache_dirs
    cache_dirs()
    import numpy as np
    import torch

    import immesh_tpu_torch.lio.window as pw
    from immesh_tpu_torch.config import ImMeshConfig
    from perfbench.harness import cell as cells
    from perfbench.sim.stream import make_stream

    w = args.workload
    c = (cells.assemble(w, args.config, args.traffic) if args.config
         else cells.load(w))
    cfgd = c.config["config"]
    if args.lap_frames:
        c.traffic["lap_frames"] = args.lap_frames
    if args.ba is not None:
        cfgd["ba"]["enabled"] = bool(args.ba)
    if args.apply is not None:
        cfgd["ba"]["apply_correction"] = bool(args.apply)
    stream = make_stream(cfgd, c.config["sensor"], c.traffic, args.seed,
                         args.device)
    entry = c.entry()(ImMeshConfig.from_dict(cfgd), c.config["entry_args"],
                      stream.static_imu, torch.device(args.device))
    route, T = stream.lidar.route, stream.lidar.scan_T
    R0, p0 = route.pose(np.array([0.0]))
    align = R0[0] @ entry.lio.state.rot.cpu().numpy().astype(np.float64).T

    corr, inner = [], pw.WindowBA.refine

    def refine(self, vm):
        out = inner(self, vm)
        c = np.clip((np.trace(out["d_rot"].astype(np.float64)) - 1) / 2,
                    -1, 1)
        corr.append((float(np.linalg.norm(out["d_pos"])),
                     float(np.degrees(np.arccos(c)))))
        return out
    pw.WindowBA.refine = refine

    errs, lat, refined = [], [], []
    for k in range(args.frames):
        t0 = time.perf_counter()
        pos, diag = entry.step(stream.feed(k))
        lat.append(1e3 * (time.perf_counter() - t0))
        refined.append(bool(diag.get("ba_refined", False)))
        _, truth = route.pose(np.array([(k + 1) * T]))
        errs.append(float(np.linalg.norm(
            align @ pos.astype(np.float64) + p0[0] - truth[0])))
        if refined[-1]:
            print(f"frame {k}: pose {errs[-1]!r} m from the truth, "
                  f"correction {corr[-1][0]!r} m, {corr[-1][1]!r} deg, "
                  f"{lat[-1]!r} ms", flush=True)
        if not np.isfinite(errs[-1]):
            print(f"frame {k}: the pose is not finite", flush=True)
            break
    e = np.array(errs)
    over = np.flatnonzero(e > args.tol)
    print(f"{w} seed {args.seed} lap {c.traffic['lap_frames']} ba "
          f"{cfgd['ba']['enabled']} apply {cfgd['ba']['apply_correction']}: "
          f"{len(errs)} frames, largest error {float(np.nanmax(e))!r} m (frame "
          f"{int(np.nanargmax(e))}), first over {args.tol} m: "
          f"{int(over[0]) if len(over) else None}", flush=True)
    lat, refined = np.array(lat[200:]), np.array(refined[200:], bool)
    if refined.any() and (~refined).any():
        print(f"frames 200 on: {int(refined.sum())} refinements in "
              f"{len(refined)} frames; a refinement frame "
              f"{float(np.median(lat[refined]))!r} ms median, the others "
              f"{float(np.median(lat[~refined]))!r} ms; p95 of all "
              f"{float(np.percentile(lat, 95))!r} ms", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
