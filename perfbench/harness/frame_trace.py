"""The program's frame trace (immesh_tpu_torch/utils/timers.py::trace) as
the per-layer readers that take it see it.

A run records it only where the trace was turned on before the entry was
built (`trace.enable()`); otherwise, and for a program without one, every
reader here returns nothing.  The ring's frames are, in order, the set-up
frames, the window's and the traced segment's (`run.profile.frames`): the
window's are the `len(run.frame_ms)` frames before the traced segment.

A window frame's latency [t0, t] (run.frame_ms) less its `graph` spans (the
device spans of its replays, placed on the host clock) is its time outside
the graphs (outside_graph_ms).  Each instant of it goes to the one of the
five host spans OUTSIDE open at it (none nests in another), or to `other`:
under `frame` alone, or outside the program.  The six sum to the frame's
time outside the graphs."""

from __future__ import annotations

from typing import List, Optional

OUTSIDE = ("copy_in", "launch", "clone_out", "compact", "pose_read")


def program_frames() -> Optional[list]:
    """The program's ring of frames (each its records), or None where the
    program has no frame trace."""
    try:
        from immesh_tpu_torch.utils.timers import trace
    except ImportError:
        return None
    return trace.frames()


def window(run) -> Optional[List[list]]:
    """The window frames' records, or None where the ring does not hold
    them."""
    frames = program_frames()
    n = len(run.frame_ms)
    p = run.profile.frames if run.profile is not None else 0
    if not frames or n == 0 or len(frames) < n + p:
        return None
    return frames[len(frames) - p - n:len(frames) - p]


def _union(spans) -> List[tuple]:
    out = []
    for s, e in sorted(spans):
        if out and s <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], e))
        else:
            out.append((s, e))
    return out


def _less(s: int, e: int, cover: List[tuple]) -> int:
    """ns of [s, e] outside the intervals `cover`."""
    return (e - s) - sum(max(0, min(e, ce) - max(s, cs)) for cs, ce in cover)


def outside_parts(run) -> Optional[List[dict]]:
    """Each window frame's time outside its graphs by part (OUTSIDE and
    "other"), in ms; None without a trace or where a frame has no `graph`
    span."""
    frames = window(run)
    if frames is None:
        return None
    out = []
    for lat, recs in zip(run.frame_ms, frames):
        graph = _union((r.start_ns, r.end_ns) for r in recs
                       if r.name == "graph")
        if not graph:
            return None
        part = {h: 1e-6 * sum(_less(r.start_ns, r.end_ns, graph)
                              for r in recs if r.name == h)
                for h in OUTSIDE}
        part["other"] = (lat - 1e-6 * sum(e - s for s, e in graph)
                         - sum(part.values()))
        out.append(part)
    return out


def outside(run, part: str) -> Optional[float]:
    """The window's mean ms a frame of one part of the time outside the
    graphs."""
    parts = outside_parts(run)
    return None if parts is None else sum(p[part] for p in parts) / len(parts)


def device_ms(run, name: str) -> Optional[float]:
    """The mean ms of the device span `name` over the window frames that
    have it; the frames without it (no anchor: the stream was busy as the
    frame began) go to standard error."""
    frames = window(run)
    if frames is None:
        return None
    ms = [sum(r.end_ns - r.start_ns for r in recs if r.name == name) * 1e-6
          for recs in frames if any(r.name == name for r in recs)]
    if not ms:
        return None
    run.notes.append(f"{name}: a device span in {len(ms)} of "
                     f"{len(frames)} window frames")
    return sum(ms) / len(ms)


def pose_wait(run) -> Optional[float]:
    """The mean ms from the `lio` span's device end to the end of the
    frame's last `pose_read`, over the window frames that have both."""
    frames = window(run)
    if frames is None:
        return None
    waits = []
    for recs in frames:
        lio = [r.end_ns for r in recs if r.name == "lio"]
        read = [r.end_ns for r in recs if r.name == "pose_read"]
        if lio and read:
            waits.append(1e-6 * (max(read) - max(lio)))
    return sum(waits) / len(waits) if waits else None


def compact(run) -> Optional[float]:
    """The mean ms of the window's `compact` spans, with their count to
    standard error; None where none compacted."""
    frames = window(run)
    if frames is None:
        return None
    ms = [1e-6 * (r.end_ns - r.start_ns) for recs in frames for r in recs
          if r.name == "compact"]
    if not ms:
        return None
    run.notes.append(f"compact_ms: {len(ms)} compactions in the window")
    return sum(ms) / len(ms)
