"""Where a frame of the PyTorch port's main path spends its time on the GPU.

    python3 tools/torch_profile.py [--path kitti|avia] [--frames N] [--out FILE]

Runs one of chip_smoke.py's paths — JointPipeline at the KITTI operating
point (131,072-ray outdoor scans), or ImMeshRuntime.process_frame at the
Avia preset (32,768-point scans, IMU on) — warms up, then profiles N frames
with torch.profiler and prints: wall ms per frame, the device's busy share (sum of kernel times over
wall time), host↔device synchronisations per frame, and the top operators by
device time and by host time; --out FILE also gets the full operator table.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

import torch
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the main path's configuration and scans)

from immesh_tpu_torch.utils.timers import COPY_CALLS, SYNC_CALLS  # noqa: E402


def _self_dev_us(evt) -> float:
    """Self device time of a key_averages() row (named per torch version)."""
    for n in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(evt, n):
            return float(getattr(evt, n))
    return 0.0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("kitti", "avia"), default="kitti")
    ap.add_argument("--frames", type=int, default=5)
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("tools/torch_profile.py needs a CUDA device")
        return 2
    from immesh_tpu_torch.runtime.app import ImMeshRuntime
    from immesh_tpu_torch.runtime.joint import JointPipeline

    dev = torch.device("cuda", 0)
    n = args.warmup + args.frames
    if args.path == "kitti":
        cfg = chip_smoke.kitti_config()
        sim = chip_smoke.make_sim(cfg.preprocess.max_points, 64)
        pipe = JointPipeline(cfg, adaptive_mesh_budget=2048, device=dev)
        step = pipe.step
    else:
        cfg = chip_smoke.avia_config()
        sim = chip_smoke.make_avia_sim(cfg)
        rt = ImMeshRuntime(cfg, device=dev)
        rt.static_init(*sim.static_imu(100))
        step = rt.process_frame
    frames = [chip_smoke.bundle(sim.frame(k), cfg, dev) for k in range(n)]
    for b in frames[:args.warmup]:
        step(b)
    torch.cuda.synchronize()

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for b in frames[args.warmup:]:
            step(b)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0) / args.frames

    ka = prof.key_averages()
    kernels = [e for e in prof.events()
               if getattr(e, "device_type", None) == torch.autograd.DeviceType.CUDA]
    busy_ms = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / args.frames
    syncs = sum(e.count for e in ka if e.key in SYNC_CALLS + COPY_CALLS)
    by_dev = sorted(ka, key=lambda e: _self_dev_us(e), reverse=True)
    by_host = sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)

    lines = [f"{chip_smoke.smi_line()}",
             f"path {args.path}: frames {args.frames} (after {args.warmup} warm-up): "
             f"{wall_ms:.1f} ms/frame wall (profiler on), device busy "
             f"{busy_ms:.1f} ms/frame ({100 * busy_ms / wall_ms:.1f} %), "
             f"{syncs / args.frames:.0f} sync/copy calls per frame",
             "top operators by device time (self, ms/frame, calls/frame):"]
    for e in by_dev[:15]:
        lines.append(f"  {_self_dev_us(e) / 1e3 / args.frames:8.3f}  "
                     f"{e.count / args.frames:7.1f}  {e.key[:90]}")
    lines.append("top operators by host time (self, ms/frame, calls/frame):")
    for e in by_host[:15]:
        lines.append(f"  {e.self_cpu_time_total / 1e3 / args.frames:8.3f}  "
                     f"{e.count / args.frames:7.1f}  {e.key[:90]}")
    print("\n".join(lines))
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            fh.write("\n".join(lines) + "\n\n")
            fh.write(ka.table(sort_by="self_cpu_time_total", row_limit=60))
    return 0


if __name__ == "__main__":
    sys.exit(main())
