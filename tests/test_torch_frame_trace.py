"""The frame trace (immesh_tpu_torch/utils/timers.py::trace).

On the CPU, over small_config frames at 1,024 rays with both maps
compacting on their first poll:

  * off (the default), a JointPipeline and an ImMeshRuntime frame leave
    the ring empty and open no record_function range;
  * on, every span the CPU path has (`frame`, `compact`, `pose_read` on the
    host; `lio`, `lio.map_update`, `mesh`, which the CPU times on the host
    clock) is there under its frame id and parent, nested in its parent
    and in the order the frame runs them, and the host spans are
    record_function ranges while the profiler records;
  * JointPipeline.read_pose is state.pos.cpu(), and each pipeline's
    pending_occupancy the poll its next maybe_compact reads;
  * the ring keeps the last frames it is sized for;
  * the runtime's cost log carries the frame's `mesh` and `lio` spans, and
    a log directory turns the trace on until close().

On the card (`cuda`, skips here; on the GPU machine

    python -m pytest --noconftest -m cuda tests/test_torch_frame_trace.py

runs them): the frame's two graphs captured with the trace off hold no
event-record node; captured with it on, the same kernel nodes and one
event-record node a device span end, and their replays are bit for bit
the trace-off ones; every `graph` start, placed on the host clock, falls
no more than 10 us before its `launch` span's start, the device spans
nest in their graph, the mesh half's after the LIO graph, every frame's
mesh span is read though no frame synchronises, and the trace counts
pose_before_mesh.
"""

import dataclasses

import numpy as np
import pytest
import torch

from immesh_tpu_torch.utils.timers import FrameTrace, trace

N_RAYS, N_FRAMES = 1024, 3


@pytest.fixture
def tr():
    trace.disable()
    trace.clear()
    yield trace
    trace.disable()
    trace.clear()


def _config():
    import chip_smoke
    cfg = chip_smoke.small_config()
    # both maps compact on their first poll (frame 1)
    return cfg.replace(
        preprocess=dataclasses.replace(cfg.preprocess, max_points=N_RAYS),
        voxel_map=dataclasses.replace(cfg.voxel_map,
                                      compact_high_water=1e-4,
                                      compact_low_water=1e-4),
        mesh=dataclasses.replace(cfg.mesh, compact_high_water=1e-4,
                                 compact_low_water=1e-4))


def _bundles(cfg, n, device):
    import chip_smoke
    sim = chip_smoke.make_sim(cfg.preprocess.max_points, 16)
    return [chip_smoke.bundle(sim.frame(k), cfg, device) for k in range(n)]


def _joint(cfg, bundles, device="cpu"):
    from immesh_tpu_torch.runtime.joint import JointPipeline
    pipe = JointPipeline(cfg, device=device)
    poses = []
    for b in bundles:
        pipe.step(b)
        poses.append(pipe.read_pose())
    return pipe, poses


def _runtime(cfg, bundles, log_dir=None):
    from immesh_tpu_torch.runtime.app import ImMeshRuntime
    rt = ImMeshRuntime(cfg, log_dir=log_dir, device="cpu")
    for k, b in enumerate(bundles):
        rt.process_frame(b, t=0.1 * k)
    return rt


def _profiled(fn):
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


def _nested_in_order(frame, want):
    """Every record of one frame inside a record of its parent's name, and
    the names' first starts in the order `want`."""
    for r in frame:
        if r.parent is None:
            continue
        assert any(p.name == r.parent and p.start_ns <= r.start_ns
                   and r.end_ns <= p.end_ns for p in frame), r
    first = {}
    for r in frame:
        first.setdefault(r.name, r.start_ns)
    assert sorted(first, key=first.get) == want


def test_off_records_nothing_and_opens_no_range(tr, monkeypatch):
    """Off, with the profiler taken as recording: no record, no range."""
    opened = []
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: True)
    monkeypatch.setattr(torch.profiler, "record_function", opened.append)
    cfg = _config()
    bundles = _bundles(cfg, 2, "cpu")
    _joint(cfg, bundles)
    _runtime(cfg, bundles)
    assert not tr.on and tr.frames() == [] and opened == []


def test_host_spans_are_profiler_ranges(tr):
    cfg = _config()
    bundles = _bundles(cfg, 1, "cpu")
    tr.enable()
    assert {"frame", "pose_read"} <= _profiled(
        lambda: _runtime(cfg, bundles))


def test_joint_spans_nest_under_their_frames(tr):
    cfg = _config()
    bundles = _bundles(cfg, N_FRAMES, "cpu")
    tr.enable()
    _joint(cfg, bundles)
    frames = tr.frames()
    assert [{r.frame for r in fr} for fr in frames] == [
        {k} for k in range(N_FRAMES)]
    parents = {"frame": None, "lio": "frame", "lio.map_update": "lio",
               "mesh": "frame", "compact": "frame", "pose_read": None}
    for k, fr in enumerate(frames):
        assert {r.name: r.parent for r in fr} == (
            parents if k == 1 else
            {n: p for n, p in parents.items() if n != "compact"})
        # both maps compact on frame 1, after the step
        assert sum(r.name == "compact" for r in fr) == (2 if k == 1 else 0)
        _nested_in_order(fr, [n for n in parents
                              if k == 1 or n != "compact"])
    # the CPU's mesh half is serial: nothing counted
    assert tr.frame_counts() == [{}] * N_FRAMES


def test_runtime_spans_nest_under_their_frames(tr):
    cfg = _config()
    tr.enable()
    _runtime(cfg, _bundles(cfg, N_FRAMES, "cpu"))
    frames = tr.frames()
    assert len(frames) == N_FRAMES
    for k, fr in enumerate(frames):
        assert {r.frame for r in fr} == {k}
        assert [r.name for r in fr if r.name == "pose_read"] == [
            "pose_read"] * 2  # the position, then the quaternion
        assert {r.name: r.parent for r in fr} == {
            "frame": None, "lio": "frame", "lio.map_update": "lio",
            "mesh": "frame", "pose_read": "frame",
            **({"compact": "frame"} if k == 1 else {})}
        # the runtime's LioPipeline.step compacts before the mesh step
        _nested_in_order(fr, ["frame", "lio", "lio.map_update",
                              *(["compact"] if k == 1 else []), "mesh",
                              "pose_read"])


def test_read_pose_is_the_state_pos(tr):
    cfg = _config()
    pipe, poses = _joint(cfg, _bundles(cfg, 1, "cpu"))
    assert poses[0].device.type == "cpu"
    assert torch.equal(poses[0], pipe.state.pos.cpu())


def test_pending_occupancy_is_the_poll(tr):
    """The public read of each pipeline's pending compaction poll: None
    before a frame, then the host copies maybe_compact reads next."""
    cfg = _config()
    from immesh_tpu_torch.runtime.joint import JointPipeline
    pipe = JointPipeline(cfg, device="cpu")
    assert pipe.lio.pending_occupancy() is None
    assert pipe.mesh.pending_occupancy() is None
    pipe.step(_bundles(cfg, 1, "cpu")[0])
    assert pipe.lio.pending_occupancy() == int(pipe.lio.vm.n_voxels()) > 0
    assert pipe.mesh.pending_occupancy() == (
        int(pipe.mesh.gm.n_points()), int(pipe.mesh.gm.vox.occupancy()))


def test_ring_keeps_the_last_frames():
    ring = FrameTrace(frames=3)
    ring.enable()
    cpu = torch.device("cpu")
    for k in range(5):
        with ring.frame(k, cpu):
            with ring.span("copy_in"):
                pass
    frames = ring.frames()
    assert [[(r.frame, r.name) for r in fr] for fr in frames] == [
        [(k, "frame"), (k, "copy_in")] for k in (2, 3, 4)]
    assert ring.span_ms(1, "frame") is None
    assert ring.span_ms(4, "frame") >= ring.span_ms(4, "copy_in") >= 0


def test_cost_log_rows_are_the_device_spans(tr, tmp_path):
    cfg = _config()
    rt = _runtime(cfg, _bundles(cfg, N_FRAMES, "cpu"), str(tmp_path))
    assert tr.on
    rt.close()
    assert not tr.on
    rows = np.loadtxt(tmp_path / "mesh_cost_time.log")
    assert rows.shape == (N_FRAMES, 5)
    for k, row in enumerate(rows):
        assert row[0] == k
        assert row[1] == pytest.approx(tr.span_ms(k, "mesh"), abs=1e-3)
        assert row[3] == pytest.approx(tr.span_ms(k, "lio"), abs=1e-3)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


@pytest.mark.cuda
def test_trace_adds_event_nodes_only(tr):
    """The same frames through the frame's two graphs (the LIO's, the mesh
    half's) captured with the trace off and on: no event-record node off;
    on, the same kernel nodes and one event-record node a device span end;
    every frame bit for bit."""
    import chip_smoke
    dev = _card()
    cfg = chip_smoke.small_config()
    bundles = _bundles(cfg, 6, dev)
    off, off_poses = _joint(cfg, bundles, dev)
    tr.enable()
    on, on_poses = _joint(cfg, bundles, dev)
    gs_off, gs_on = off.captured.graphs, on.captured.graphs
    assert len(gs_off) == len(gs_on) == 2
    assert [[s[0] for s in g.spans] for g in gs_on] == [
        ["lio.map_update", "lio"], ["mesh"]]
    for g_off, g_on in zip(gs_off, gs_on):
        n_off, n_on = g_off.nodes(), g_on.nodes()
        assert "event_record" not in n_off and not g_off.spans
        assert n_on["event_record"] == 2 * len(g_on.spans)
        # a capture after the first in a process may hold stream-ordered
        # allocations (mem_alloc, mem_free) trace or no trace: compared are
        # the nodes chip_smoke.py compares
        for kind in ("kernel", "memcpy", "memset", "conditional"):
            assert n_on[kind] == n_off[kind], kind
    assert all(torch.equal(a, b) for a, b in zip(off_poses, on_poses))
    assert chip_smoke.lio_differs(off.lio.state, on.lio.state, off.lio.vm,
                                  on.lio.vm) == []
    assert chip_smoke.mesh_differs(off.mesh, on.mesh) == []


class _Event:
    """A CUDA event's stand-in: recorded at `ms` on the device clock,
    complete or not."""

    def __init__(self, ms: float, done: bool = True):
        self.ms, self.done, self.waited = ms, done, False

    def query(self) -> bool:
        return self.done

    def synchronize(self) -> None:
        self.done = self.waited = True

    def elapsed_time(self, end) -> float:
        return end.ms - self.ms


def test_late_device_spans_are_read_later():
    """A device span whose end has not completed as the next frame begins
    is read later, on its own frame: once it has completed, or, before a
    replay of the graph that records it, after a wait for its end."""
    tr = FrameTrace()
    tr.enable()
    cpu = torch.device("cpu")
    tr._begin_frame(0, cpu)
    fr = tr._frames[-1]
    fr.anchor, fr.anchor_ns = _Event(0.0), 10_000_000
    lio = ("lio", "graph", _Event(1.0), _Event(3.0))
    mesh = ("mesh", "graph", _Event(3.0), _Event(5.0, done=False))
    tail = ("graph", None, _Event(3.0), _Event(6.0, done=False))
    fr.pending += [lio, mesh, tail]
    tr._read_device()   # the pose read: not all complete, none read
    assert fr.records == [] and len(fr.pending) == 3
    tr._begin_frame(1, cpu)   # the next frame: the LIO span read
    assert [r.name for r in fr.records] == ["lio"] and len(tr._late) == 2
    tr.replaying([lio])   # another graph's replay: no wait
    assert not mesh[3].waited and len(tr._late) == 2
    tail[3].done = True
    tr._read_device()   # completed on its own: read without a wait
    assert [r.name for r in fr.records] == ["lio", "graph"]
    tr.replaying([mesh])   # its own graph's next replay: waited for, read
    assert mesh[3].waited and tr._late == []
    assert [(r.frame, r.name, r.start_ns, r.end_ns) for r in tr.frames()[0]] \
        == [(0, "lio", 11_000_000, 13_000_000),
            (0, "graph", 13_000_000, 16_000_000),
            (0, "mesh", 13_000_000, 15_000_000)]


@pytest.mark.cuda
def test_device_spans_sit_on_the_host_clock(tr):
    """Each replayed frame: its two `graph` spans placed on the host clock
    start no more than 10 us before their `launch` spans, the `lio` span
    nests in the LIO graph's and the `mesh` span in the mesh half's, which
    starts after the LIO graph's end, and the pose read ends after the LIO
    graph's end.  No frame synchronises but its pose read, so a mesh
    half's spans may not have completed as the next frame begins: each
    frame has them all the same (read before the mesh graph's next replay
    at the latest).  The trace counted pose_before_mesh, at most once a
    frame."""
    import chip_smoke
    from immesh_tpu_torch.runtime.joint import JointPipeline
    dev = _card()
    cfg = chip_smoke.small_config()
    tr.enable()
    pipe = JointPipeline(cfg, device=dev)
    for b in _bundles(cfg, 8, dev):
        pipe.step(b)
        pipe.read_pose()
    torch.cuda.synchronize()
    frames = tr.frames()
    assert len(frames) == 8
    for fr in frames[2:]:   # frame 0 eager, frame 1 captured then replayed
        by = {}
        for r in fr:
            by.setdefault(r.name, []).append(r)
        (lg, mg), (ll, ml) = by["graph"], by["launch"]
        (lio,), (mesh,), (mu,) = by["lio"], by["mesh"], by["lio.map_update"]
        (read,) = by["pose_read"]
        for g, launch in ((lg, ll), (mg, ml)):
            assert g.start_ns >= launch.start_ns - 10_000, (g, launch)
        assert lg.start_ns <= lio.start_ns <= lio.end_ns <= lg.end_ns \
            <= mg.start_ns <= mesh.start_ns <= mesh.end_ns <= mg.end_ns
        assert lio.start_ns <= mu.start_ns <= mu.end_ns <= lio.end_ns
        assert read.end_ns >= lg.end_ns
        assert {r.parent for r in fr if r.name in ("lio", "mesh")} == {
            "graph"}
    counted = [c.get("pose_before_mesh", 0) for c in tr.frame_counts()]
    assert max(counted) == 1 and sum(counted) > 0
