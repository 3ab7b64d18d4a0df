"""The port's tracing: the frame trace, the reference's log formats and
the profiler's call counts.

`trace`, the frame trace, is off by default.  `trace.enable()`, called
before the pipelines are built (a captured graph holds its device spans'
event nodes from its capture on), records each frame's spans into a ring
of the last FRAMES frames, in memory:

  * a record is (frame, name, parent, start_ns, end_ns) on one host clock,
    time.perf_counter_ns(); `frame` is the pipeline's frame_idx, shared by
    every span of the frame, and `parent` the innermost span open when it
    began (None at the top);
  * host spans (`span`, `frame`, `pose_read`) time the host; while
    torch.profiler records, each also opens a record_function range of
    its name, so the spans sit on the profiler's clock in its trace;
  * device spans (`device_span`, and the `graph` span of each replay,
    utils/graphs.py) are pairs of CUDA events, recorded on the current
    stream; under a graph's capture they become event-record nodes, which
    every replay records again, so a device span sits only at a graph's
    outer level, never inside an IF body.  They are placed on the host
    clock from an anchor event recorded as the frame begins: in a closed
    loop the stream is idle then, so the anchor fires at once (a frame
    whose stream is still busy gets no anchor, and no device span); a
    device instant is the anchor's host time plus anchor.elapsed_time(ev).
    They are read once the frame's pose read has synchronised
    (`pose_read`), or as the next frame begins, so no read waits; a span
    whose end has not completed as the next frame begins (a mesh half on
    its own stream, still running) is read once it has, or, where a
    replay of its graph would record its events again first, just before
    that replay, after a wait for its end (`replaying`): the one wait the
    trace makes, on the host only, for work the replay's stream runs
    before it anyway.  On the CPU, whose ops finish before they return, a
    device span is timed on the host clock;
  * counters (`count`): a frame's count of a named event, such as the
    mesh half's pose_before_mesh (mesh/pipeline.py::MeshPipeline).

Off, a site costs one call that tests one attribute and returns a shared
no-op context: no CUDA call, no allocation, no record_function.

`CostTimeLogger` and `TrajectoryLogger` write the reference's
`mesh_cost_time.log` and `kitti_log.txt` schemas (reference
src/tools/tools_timer.hpp:200, voxel_mapping_common.cpp:43-70), so runs
compare with the reference's timing plots (BASELINE.md).
`profile_counts` counts a call's kernel launches, host syncs and device
time under torch.profiler for the stage profilers.
"""

from __future__ import annotations

import math
import time
from collections import Counter, deque
from typing import Dict, List, NamedTuple, Optional

import torch


class Record(NamedTuple):
    """One span of the frame trace, on the host clock (perf_counter_ns)."""
    frame: int
    name: str
    parent: Optional[str]
    start_ns: int
    end_ns: int

    @property
    def ms(self) -> float:
        return 1e-6 * (self.end_ns - self.start_ns)


class _Off:
    """A span of the trace while it is off: enters and leaves doing
    nothing."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Frame:
    """One frame of the ring: its records, and its device spans until they
    are read (name, parent, start event, end event) against its anchor."""
    __slots__ = ("id", "records", "anchor", "anchor_ns", "pending", "counts")

    def __init__(self, frame_id: int):
        self.id = frame_id
        self.records: List[Record] = []
        self.anchor = None
        self.anchor_ns = 0
        self.pending: list = []
        self.counts: Dict[str, int] = {}


class _HostSpan:
    __slots__ = ("trace", "name", "parent", "t0", "rf")

    def __init__(self, trace: "FrameTrace", name: str):
        self.trace, self.name = trace, name

    def __enter__(self):
        tr = self.trace
        self.parent = tr._open[-1] if tr._open else None
        tr._open.append(self.name)
        self.rf = None
        if torch.autograd._profiler_enabled():
            self.rf = torch.profiler.record_function(self.name)
            self.rf.__enter__()
        self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        t1 = time.perf_counter_ns()
        if self.rf is not None:
            self.rf.__exit__(*exc)
        tr = self.trace
        tr._open.pop()
        tr._add(Record(tr._frame_id(), self.name, self.parent, self.t0, t1))
        return False


class _FrameSpan(_HostSpan):
    __slots__ = ("frame_id", "device")

    def __init__(self, trace, frame_id: int, device: torch.device):
        super().__init__(trace, "frame")
        self.frame_id, self.device = frame_id, device

    def __enter__(self):
        self.trace._begin_frame(self.frame_id, self.device)
        super().__enter__()


class _PoseRead(_HostSpan):
    __slots__ = ()

    def __init__(self, trace):
        super().__init__(trace, "pose_read")

    def __exit__(self, *exc):
        super().__exit__(*exc)
        self.trace._read_device()
        return False


class _DeviceSpan:
    __slots__ = ("trace", "name", "parent", "cuda", "t0", "e0")

    def __init__(self, trace: "FrameTrace", name: str, device: torch.device):
        self.trace, self.name = trace, name
        self.cuda = device.type == "cuda"

    def __enter__(self):
        tr = self.trace
        self.parent = tr._open[-1] if tr._open else None
        tr._open.append(self.name)
        if self.cuda:
            self.e0 = _event()
            self.e0.record()
        else:
            self.t0 = time.perf_counter_ns()

    def __exit__(self, *exc):
        tr = self.trace
        tr._open.pop()
        if not self.cuda:
            tr._add(Record(tr._frame_id(), self.name, self.parent, self.t0,
                           time.perf_counter_ns()))
            return False
        e1 = _event()
        e1.record()
        span = (self.name, self.parent, self.e0, e1)
        if tr._capture is not None:
            tr._capture.append(span)
        elif tr._frames:
            tr._frames[-1].pending.append(span)
        return False


class _Capture:
    __slots__ = ("trace", "spans", "saved")

    def __init__(self, trace: "FrameTrace", spans: list):
        self.trace, self.spans = trace, spans

    def __enter__(self):
        tr = self.trace
        self.saved = tr._open
        tr._open, tr._capture = ["graph"], self.spans

    def __exit__(self, *exc):
        self.trace._open, self.trace._capture = self.saved, None
        return False


def _event():
    # external: under a graph's capture the record is an event-record node
    return torch.cuda.Event(enable_timing=True, external=True)


class FrameTrace:
    """The frame trace (the module's docstring).  `on` is the switch every
    site tests; `frames()` reads the ring."""

    # holds a 20 s window of the fastest cell (2,659 frames) with its
    # set-up and traced frames
    FRAMES = 8192

    def __init__(self, frames: int = FRAMES):
        self.on = False
        self._frames: deque = deque(maxlen=frames)
        self._open: List[str] = []   # names of the open spans, innermost last
        self._capture: Optional[list] = None  # device spans being captured
        # (frame, span): device spans whose end had not completed as their
        # next frame began, read later (_read_device, replaying)
        self._late: list = []

    def enable(self) -> None:
        self.on = True

    def disable(self) -> None:
        self.on = False

    def clear(self) -> None:
        self._frames.clear()
        self._open = []
        self._late = []

    # the sites ---------------------------------------------------------
    def frame(self, frame_id: int, device: torch.device):
        """The `frame` span: a pipeline's step of frame `frame_id`, which
        the spans recorded until the next frame belong to."""
        return _FrameSpan(self, frame_id, device) if self.on else _OFF

    def span(self, name: str):
        """A host span."""
        return _HostSpan(self, name) if self.on else _OFF

    def pose_read(self):
        """The `pose_read` host span: the pose's copy to the host.  The
        frame's device spans are read as it ends (the copy has
        synchronised the stream)."""
        return _PoseRead(self) if self.on else _OFF

    def device_span(self, name: str, device: torch.device):
        """A device span of the work enqueued inside it on `device`; at a
        graph's outer level only (the module's docstring)."""
        return _DeviceSpan(self, name, device) if self.on else _OFF

    def capture(self, spans: list):
        """Around a graph's capture: the device spans recorded inside it
        go into `spans` as (name, parent, start event, end event), their
        outermost parent "graph", for `replayed` to read at each replay."""
        return _Capture(self, spans) if self.on else _OFF

    def count(self, name: str) -> None:
        """One event `name` of the frame, counted."""
        if self.on and self._frames:
            counts = self._frames[-1].counts
            counts[name] = counts.get(name, 0) + 1

    def replaying(self, spans) -> None:
        """Before a graph's replay records the events of its device spans
        (`spans`, from its capture) again: its earlier replay's spans that
        are late (_read_device) are waited for and read."""
        if not self._late:
            return
        late = []
        for fr, span in self._late:
            if any(span is s for s in spans):
                span[3].synchronize()
                self._place(fr, span)
            else:
                late.append((fr, span))
        self._late = late

    def replayed(self, events, spans) -> None:
        """A graph's replay: its `graph` span, the pair of events recorded
        around it, and the device spans captured into it."""
        if not (self.on and self._frames):
            return
        parent = self._open[-1] if self._open else None
        pending = self._frames[-1].pending
        pending.append(("graph", parent, *events))
        pending.extend(spans)

    # the ring -----------------------------------------------------------
    def _frame_id(self) -> int:
        return self._frames[-1].id if self._frames else -1

    def _add(self, rec: Record) -> None:
        if self._frames:
            self._frames[-1].records.append(rec)

    def _begin_frame(self, frame_id: int, device: torch.device) -> None:
        self._read_device(begin=True)
        fr = _Frame(frame_id)
        self._frames.append(fr)
        if device.type == "cuda":
            stream = torch.cuda.current_stream(device)
            if stream.query():   # idle: the anchor fires at once
                fr.anchor = torch.cuda.Event(enable_timing=True)
                fr.anchor.record(stream)
                fr.anchor_ns = time.perf_counter_ns()

    def _read_device(self, begin: bool = False) -> None:
        """Place device spans on the host clock once their events have
        completed: the late ones, then the last frame's, all at once.  As a
        frame `begin`s, those of the last frame's that have not completed
        become late: each is read once it has, or before its graph's next
        replay (replaying)."""
        late = []
        for fr, span in self._late:
            if span[3].query():
                self._place(fr, span)
            else:
                late.append((fr, span))
        self._late = late
        fr = self._frames[-1] if self._frames else None
        if fr is None or not fr.pending:
            return
        if fr.anchor is None:   # no anchor, no device span
            fr.pending = []
            return
        done = [span[3].query() for span in fr.pending]
        if not all(done) and not begin:
            return
        for span, d in zip(fr.pending, done):
            if d:
                self._place(fr, span)
            else:
                self._late.append((fr, span))
        fr.pending = []

    def _place(self, fr: _Frame, span) -> None:
        name, parent, e0, e1 = span
        fr.records.append(Record(fr.id, name, parent, self._host_ns(fr, e0),
                                 self._host_ns(fr, e1)))

    @staticmethod
    def _host_ns(fr: _Frame, ev) -> int:
        return fr.anchor_ns + round(1e6 * fr.anchor.elapsed_time(ev))

    def frames(self) -> List[List[Record]]:
        """The ring's frames, oldest first, each its records ordered by
        start (the outer span first where two start together)."""
        self._read_device()
        return [sorted(fr.records, key=lambda r: (r.start_ns, -r.end_ns))
                for fr in self._frames]

    def span_ms(self, frame_id: int, name: str) -> Optional[float]:
        """The summed ms of the spans `name` of the latest frame
        `frame_id`, or None where it has none."""
        for fr in reversed(self._frames):
            if fr.id == frame_id:
                ms = [r.ms for r in fr.records if r.name == name]
                return sum(ms) if ms else None
        return None

    def frame_counts(self) -> List[Dict[str, int]]:
        """Each ring frame's counters (`count`), oldest first, as frames()
        lists the frames."""
        return [dict(fr.counts) for fr in self._frames]

    def means(self) -> Dict[str, tuple]:
        """{name: (mean ms a frame that has it, frames)} over the ring."""
        tot: Dict[str, list] = {}
        for recs in self.frames():
            per: Dict[str, float] = {}
            for r in recs:
                per[r.name] = per.get(r.name, 0.0) + r.ms
            for name, ms in per.items():
                t = tot.setdefault(name, [0.0, 0])
                t[0] += ms
                t[1] += 1
        return {k: (s / n, n) for k, (s, n) in sorted(tot.items())}

    def report(self) -> str:
        """Each span's mean ms a frame, then each counter's total, over the
        ring."""
        totals = Counter()
        for counts in self.frame_counts():
            totals.update(counts)
        return ", ".join([f"{k}: {ms:.2f} ms (n={n})"
                          for k, (ms, n) in self.means().items()]
                         + [f"{k}: {n}" for k, n in sorted(totals.items())])


trace = FrameTrace()


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
        """One row; a time not measured is nan, and left out of avg_ms."""
        if math.isfinite(mesh_ms):
            self._total += mesh_ms
            self._n += 1
        if self._f:
            avg = self._total / self._n if self._n else math.nan
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
# call
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
