"""Host-side tracing/profiling utilities — a copy of
immesh_tpu/utils/timers.py (importing that one imports jax through
immesh_tpu/__init__.py).

Mirrors the reference's `Common_tools::Timer` named tic/toc maps and
`Cost_time_logger` per-stage file flush (reference src/tools/tools_timer.hpp:
118-257), which the reference threads through its LIO loop into ring stats
(voxel_mapping.cpp:2005-2025) and `mesh_cost_time.log`
(ImMesh_mesh_reconstruction.cpp:248-255).  The same log schemas are emitted so
runs are directly comparable with the reference's timing plots (BASELINE.md).
`profile_counts`, the port's own, counts a call's kernel launches, host
syncs and device time under torch.profiler for the stage profilers.
"""

from __future__ import annotations

import time
from collections import defaultdict
from typing import Dict, Optional


class Timer:
    """Named tic/toc with running means (reference Timer, tools_timer.hpp:118)."""

    def __init__(self):
        self._t0: Dict[str, float] = {}
        self._sum = defaultdict(float)
        self._cnt = defaultdict(int)
        self._last = defaultdict(float)

    def tic(self, name: str = "") -> None:
        self._t0[name] = time.perf_counter()

    def toc(self, name: str = "") -> float:
        dt = (time.perf_counter() - self._t0.get(name, time.perf_counter())) * 1e3
        self._sum[name] += dt
        self._cnt[name] += 1
        self._last[name] = dt
        return dt

    def last_ms(self, name: str = "") -> float:
        return self._last[name]

    def mean_ms(self, name: str = "") -> float:
        c = self._cnt[name]
        return self._sum[name] / c if c else 0.0

    def report(self) -> str:
        return ", ".join(
            f"{k}: {self.mean_ms(k):.2f} ms (n={self._cnt[k]})"
            for k in sorted(self._sum)
        )


class CostTimeLogger:
    """Per-frame cost rows flushed to file (reference Cost_time_logger,
    tools_timer.hpp:200; mesh schema ImMesh_mesh_reconstruction.cpp:248-255:
    `frame_idx mesh_ms n_voxels vx_map_ms avg_ms`)."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self._f = open(path, "w") if path else None
        self._total = 0.0
        self._n = 0

    def record(self, frame_idx: int, mesh_ms: float, n_voxels: int,
               vx_map_ms: float) -> None:
        self._total += mesh_ms
        self._n += 1
        if self._f:
            avg = self._total / self._n
            self._f.write(
                f"{frame_idx} {mesh_ms:.3f} {n_voxels} {vx_map_ms:.3f} {avg:.3f}\n"
            )
            self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


class TrajectoryLogger:
    """TUM-format pose trace `t x y z qx qy qz qw` (reference `kitti_log`,
    voxel_mapping_common.cpp:43-70) — the hook external ATE evaluators (evo)
    consume."""

    def __init__(self, path: Optional[str] = None):
        self._f = open(path, "w") if path else None
        self.rows = []

    def record(self, t: float, pos, quat_xyzw) -> None:
        row = (t, *pos, *quat_xyzw)
        self.rows.append(row)
        if self._f:
            self._f.write(" ".join(f"{v:.6f}" for v in row) + "\n")
            self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None


# the host's waits on the device and its device↔host copies, by CUDA runtime
# call (tools/torch_profile.py counts the same names)
SYNC_CALLS = ("cudaStreamSynchronize", "cudaDeviceSynchronize")
COPY_CALLS = ("cudaMemcpyAsync",)
_PROFILED = "profiled_call"


def profile_counts(fn):
    """Run fn() once under torch.profiler.  Returns (fn's result, counts):
    "launches" the device kernels it ran, "syncs" and "copies" its
    SYNC_CALLS and COPY_CALLS, "busy_ms" the summed device time of its
    kernels and copies.  Host calls are counted inside a record_function
    range around fn, which leaves out the profiler's own closing
    synchronisation; without a CUDA device no device activity is traced
    and every count reads 0."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        with record_function(_PROFILED):
            out = fn()
    events = prof.events()
    cuda = torch.autograd.DeviceType.CUDA
    span = next(e.time_range for e in events
                if e.name == _PROFILED and e.device_type != cuda)
    host = [e.name for e in events if e.device_type != cuda
            and span.start <= e.time_range.start <= span.end]
    dev = [e for e in events if e.device_type == cuda and e.name != _PROFILED]
    return out, {
        "launches": sum(not e.name.startswith(("Memcpy", "Memset"))
                        for e in dev),
        "syncs": sum(n in SYNC_CALLS for n in host),
        "copies": sum(n in COPY_CALLS for n in host),
        "busy_ms": sum(e.time_range.elapsed_us() for e in dev) / 1e3,
    }
