"""The segmented sum (csrc/segment_sum.cu) at the benchmark's call shapes,
beside the composition it replaced and the library's call.

    python3 tools/torch_segment_sum.py [--ptxas] [--out segsum.json]
    python3 tools/torch_segment_sum.py --cell W [--seed N] [--frames 40]

For each of chip_smoke.SUM_SHAPES (the kitti-hdl64 revisit scan's
downsample, (131,072, 4) into 8,192 with a 3,229-row segment and 32,212
rows of the discarded id, and a map-update level, (8,192, 11) into 4,096
with 5,920) and the same shapes with every row kept: the kernel bit for
bit against the parent's `values[order]` + `torch.segment_reduce` (one
segment more, sliced off) and the plain version on the CPU, then the
device time of a launch, of the library's call on the same rows and of the
parent's composition (chip_smoke.time_sum), beside the bound from the
call's bytes.  `--ptxas` first builds the source once more with
`-Xptxas -v` into immesh_tpu_torch/_build/ and prints each kernel's
registers, shared memory and spills.  Prints the card's name and power
limit first; the last line is one JSON object, also written to --out.
Raises without a card.

With `--cell W` it runs the benchmark cell W instead (perfbench/: its
configuration, traffic, entry, set-up frames and seed), then `--frames`
frames under torch.profiler (perfbench/harness/trace.py::profile, as a
`--trace 1` run's traced segment) and prints the device ms a frame of
every kernel whose name holds `segment_sum_kernel` or `segment_reduce`,
with the launches of each.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from immesh_tpu_torch.kernels import build  # noqa: E402


def ptxas_report() -> str:
    """nvcc's -Xptxas -v report of csrc/segment_sum.cu, built with the
    port's own flags."""
    out = os.path.join(build.BUILD_DIR, "libsegment_sum_ptxas.so")
    os.makedirs(build.BUILD_DIR, exist_ok=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", out,
           build.source_path("segment_sum")]
    res = subprocess.run(cmd, capture_output=True, text=True, check=True)
    return res.stdout + res.stderr


KERNEL_NAMES = ("segment_sum_kernel", "segment_reduce")


def cell_kernels(workload: str, seed: int, frames: int) -> dict:
    """Device ms a frame and launches of the segmented-sum kernels over
    `frames` profiled frames of a benchmark cell, after its set-up."""
    from immesh_tpu_torch.config import ImMeshConfig
    from perfbench.harness import cell as cells
    from perfbench.harness.trace import profile
    from perfbench.sim.stream import make_stream
    cell = cells.load(workload)
    dev = torch.device("cuda", 0)
    cfgd = cell.config["config"]
    stream = make_stream(cfgd, cell.config["sensor"], cell.traffic, seed,
                         dev)
    entry = cell.entry()(ImMeshConfig.from_dict(cfgd),
                         cell.config.get("entry_args", {}),
                         stream.static_imu, dev)
    k = cell.traffic["lead_in"] + cell.traffic["warmup"]
    for i in range(k):
        entry.step(stream.bundle(i))
    prof = profile(frames, lambda i: entry.step(stream.bundle(k + i)))
    out = {}
    for name, _, d in prof.ops:
        hit = next((n for n in KERNEL_NAMES if n in name), None)
        if hit:
            o = out.setdefault(hit, {"ms_a_frame": 0.0, "launches": 0})
            o["ms_a_frame"] += d * 1e-3 / frames
            o["launches"] += 1
    entry.release()
    return {"workload": workload, "seed": seed, "frames": frames,
            "kernels": out, "busy_ms_a_frame": 1e3 * prof.busy_s / frames}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--cell", default=None)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--frames", type=int, default=40)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("tools/torch_segment_sum.py runs only on a card")
    dev = torch.device("cuda", 0)
    print(chip_smoke.smi_line(), flush=True)
    if args.cell:
        print(json.dumps(cell_kernels(args.cell, args.seed, args.frames)))
        return 0
    if args.ptxas:
        print(ptxas_report(), flush=True)
    shapes = [*chip_smoke.SUM_SHAPES,
              *((f"{what}, every row kept", n, c, S, longest, 0)
                for what, n, c, S, longest, _ in chip_smoke.SUM_SHAPES)]
    result = {"device": torch.cuda.get_device_name(0),
              "smi": chip_smoke.smi_line(), "shapes": {}}
    for i, shape in enumerate(shapes):
        c = chip_smoke.sum_synthetic(dev, *shape, seed=101 + i)
        chip_smoke.check_sum(c, shape[0])
        result["shapes"][c.label()] = chip_smoke.time_sum(c, shape[0])
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
