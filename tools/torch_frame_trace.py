"""One benchmark cell with the port's frame trace on, and its readers.

    python3 tools/torch_frame_trace.py --workload W --seed N --seconds S \
        --trace 0|1 [--frame-trace 0|1]

Runs the cell as `perfbench/run.py` does (perfbench/harness/window.py),
with two differences: the frame trace (immesh_tpu_torch/utils/timers.py::
trace) is turned on before the entry is built (`--frame-trace 0` leaves it
off), and the KITTI entry reads the pose with JointPipeline.read_pose, its
`pose_read` span.  With `--trace 1` the result line also holds the frame
trace's per-layer metrics (perfbench/metrics/ and perfbench/harness/
frame_trace.py: `outside.*`, `pose_wait_ms`, `lio_device_ms`,
`map_update_device_ms`, `mesh_device_ms`, `compact_ms`); with `--trace 0`
it holds the end-to-end metrics, so a pair of runs on one seed, the trace
on and off, gives the trace's cost a frame.  With the trace on, the result
line also holds the mesh half's counters (mesh/pipeline.py::MeshPipeline:
`pose_before_mesh`, `lio_over_mesh`, `mesh_joins`) summed over the
window's frames and over the traced segment's, and standard error the
trace's report.  Needs a CUDA device."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from perfbench import run as bench_run  # noqa: E402

METRICS = [f"outside.{p}" for p in ("copy_in", "launch", "clone_out",
                                     "compact", "pose_read", "other")] + [
    "pose_wait_ms", "lio_device_ms", "map_update_device_ms",
    "mesh_device_ms", "compact_ms"]
COUNTERS = ("pose_before_mesh", "lio_over_mesh", "mesh_joins")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--frame-trace", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    bench_run.cache_dirs()
    import torch

    from perfbench.entries import joint
    from perfbench.harness import cell as cells
    from perfbench.harness.window import TRACE_FRAMES, run_cell
    from immesh_tpu_torch.utils.timers import trace

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2

    class PoseReadJoint(joint.Entry):
        def step(self, b: dict):
            _, diag = self.pipe.step(self._bundle(**b))
            return self.pipe.read_pose(), diag

    cell = cells.load(args.workload)
    if cell.config["entry"] == "joint":
        cell.entry = lambda: PoseReadJoint
    cell.per_layer += [{"name": m, "unit": "ms"} for m in METRICS]
    if args.frame_trace:
        trace.enable()
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START)
    for line in out["lines"]:
        print(line, file=sys.stderr)
    result = dict(out["result"], frame_trace=bool(args.frame_trace))
    if args.frame_trace:
        print(f"frame trace: {trace.report()}", file=sys.stderr)
        counts = trace.frame_counts()
        n, p = result["attempted"], TRACE_FRAMES if args.trace else 0
        end = len(counts) - p
        result["counters"] = {
            part: dict(frames=len(rows), **{c: sum(r.get(c, 0) for r in rows)
                                           for c in COUNTERS})
            for part, rows in (("window", counts[max(0, end - n):end]),
                               ("traced", counts[end:]))}
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
