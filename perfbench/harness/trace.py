"""The traced segment of a `--trace 1` run: frames after the measured window
under torch.profiler (CUDA activity through CUPTI), read back from its
Chrome trace: every device operation (kernels, copies, sets) with its name,
start and length, and the host's operations around the idle gaps."""

from __future__ import annotations

import dataclasses
import json
import os
import tempfile
import time
from typing import Callable, List, Tuple

import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
NAME_CHARS = 160  # of a kernel's demangled name in the breakdown


@dataclasses.dataclass
class Profile:
    ops: List[Tuple[str, float, float]]   # (name, start µs, length µs)
    window_s: float                       # the traced segment's wall time
    busy_s: float                         # the union of the ops' intervals
    host: List[Tuple[str, float, float]]  # the host's operations
    frames: int

    def gaps(self) -> List[Tuple[float, float]]:
        """(start µs, length µs) of the device's idle gaps between ops."""
        out, end = [], None
        for _, s, d in sorted(self.ops, key=lambda o: o[1]):
            if end is not None and s > end:
                out.append((end, s - end))
            end = s + d if end is None else max(end, s + d)
        return out

    def breakdown(self) -> dict:
        """The ten device operations that took most time, and the ten
        longest idle gaps by the host operation under them, in seconds."""
        tot = {}
        for name, _, d in self.ops:
            tot[name] = tot.get(name, 0.0) + d * 1e-6
        ops = sorted(tot.items(), key=lambda kv: -kv[1])[:10]
        host = sorted(self.host, key=lambda h: h[1])
        gaps = []
        for s, d in sorted(self.gaps(), key=lambda g: -g[1])[:10]:
            mid = s + d / 2
            under = [h for h in host if h[1] <= mid <= h[1] + h[2]]
            name = min(under, key=lambda h: h[2])[0] if under else "host"
            gaps.append([name, d * 1e-6])
        return {"device_ops": [[n[:NAME_CHARS], t] for n, t in ops],
                "idle_gaps": [[n[:NAME_CHARS], t] for n, t in gaps]}


def _union_s(ops) -> float:
    busy, end = 0.0, None
    for _, s, d in sorted(ops, key=lambda o: o[1]):
        e = s + d
        if end is None or s >= end:
            busy += d
            end = e
        elif e > end:
            busy += e - end
            end = e
    return busy * 1e-6


def profile(frames: int, step: Callable[[int], None]) -> Profile:
    """Run step(i) for i < frames under the profiler."""
    from torch.profiler import ProfilerActivity, profile as prof_ctx
    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU,
                              ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(frames):
            step(i)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)
    finally:
        os.remove(path)
    events = events.get("traceEvents", events)
    ops, host = [], []
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        row = (e.get("name", "?"), float(e["ts"]), float(e["dur"]))
        if e.get("cat") in _DEVICE_CATS:
            ops.append(row)
        elif e.get("cat") in ("cpu_op", "cuda_runtime", "user_annotation",
                              "python_function", "cuda_driver"):
            host.append(row)
    return Profile(ops, wall, _union_s(ops), host, frames)
