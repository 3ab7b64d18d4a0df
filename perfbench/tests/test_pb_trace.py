"""The frame trace's per-layer readers (perfbench/harness/frame_trace.py)
on synthetic window frames, and on runs with nothing to read."""

import pytest

from perfbench.harness import cell as cells
from perfbench.harness import frame_trace
from perfbench.harness.trace import Profile
from perfbench.harness.window import Run

OUTSIDE = [f"outside.{p}" for p in (*frame_trace.OUTSIDE, "other")]
READERS = OUTSIDE + ["pose_wait_ms", "lio_device_ms",
                     "map_update_device_ms", "mesh_device_ms", "compact_ms"]
MS = 1_000_000  # ns


def _run(**kw):
    base = dict(config=cells.load("kitti-hdl64.loop-urban").config,
                frame_ms=[], window_s=0.0, spans_ms=None,
                diag={"iterations": [], "n_active_voxels": []},
                compacted=[], graph_nodes=None, profile=None, notes=[],
                card="")
    base.update(kw)
    return Run(**base)


def _frame(k, t0, compact=False):
    """One joint frame from t0 (ns): frame 0-12 ms holding copy_in 0.1-0.3,
    the graph 0.4-10.4 (launch 0.35-0.65; lio 0.5-6.5, the map update
    3.5-5.5, mesh 6.6-10.3), clone_out 10.0-10.5, a compaction 10.6-11.6;
    then the pose read 12.0-12.2.  Outside the graph: copy_in 0.2, launch
    0.05, clone_out 0.1, compact 1.0 (0 without), pose_read 0.2, other
    the rest of the latency."""
    from immesh_tpu_torch.utils.timers import Record

    def r(name, parent, a, b):
        return Record(k, name, parent, t0 + int(a * MS), t0 + int(b * MS))
    out = [r("frame", None, 0, 12), r("copy_in", "frame", 0.1, 0.3),
           r("launch", "frame", 0.35, 0.65), r("graph", "frame", 0.4, 10.4),
           r("lio", "graph", 0.5, 6.5), r("lio.map_update", "lio", 3.5, 5.5),
           r("mesh", "graph", 6.6, 10.3),
           r("clone_out", "frame", 10.0, 10.5),
           r("pose_read", None, 12.0, 12.2)]
    if compact:
        out.append(r("compact", "frame", 10.6, 11.6))
    return sorted(out, key=lambda x: (x.start_ns, -x.end_ns))


@pytest.fixture
def frames(monkeypatch):
    """Two set-up frames, two window frames (the second compacting) and
    one traced-segment frame, as the program's ring."""
    ring = [_frame(k, k * 20 * MS, compact=(k == 3)) for k in range(5)]
    monkeypatch.setattr(frame_trace, "program_frames", lambda: ring)
    return ring


def test_window_is_before_the_traced_segment(frames):
    prof = Profile([], 0.0, 0.0, [], 1)
    run = _run(frame_ms=[13.0, 14.0], profile=prof)
    assert frame_trace.window(run) == frames[2:4]
    assert frame_trace.window(_run(frame_ms=[13.0] * 5, profile=prof)) \
        is None


def test_readers_read(frames):
    prof = Profile([], 0.0, 0.0, [], 1)
    run = _run(frame_ms=[13.0, 14.0], window_s=0.027, spans_ms=[10.0, 10.0],
               profile=prof)
    r = {m: cells.reader(m)(run) for m in READERS + ["outside_graph_ms"]}
    want = {"outside.copy_in": 0.2, "outside.launch": 0.05,
            "outside.clone_out": 0.1, "outside.compact": 0.5,
            "outside.pose_read": 0.2, "pose_wait_ms": 5.7,
            "lio_device_ms": 6.0, "map_update_device_ms": 2.0,
            "mesh_device_ms": 3.7, "compact_ms": 1.0}
    for m, v in want.items():
        assert r[m] == pytest.approx(v, abs=1e-6), m
    # the latency less the graph, 3.0 and 4.0 ms, is the six parts
    assert r["outside_graph_ms"] == 3.5
    assert sum(r[m] for m in OUTSIDE) == pytest.approx(3.5, abs=1e-9)
    assert r["outside.other"] == pytest.approx(3.5 - 1.05, abs=1e-9)


@pytest.mark.parametrize("ring", [None, []])
@pytest.mark.parametrize("metric", READERS)
def test_a_reader_with_nothing_to_read_returns_nothing(metric, ring,
                                                       monkeypatch):
    monkeypatch.setattr(frame_trace, "program_frames", lambda: ring)
    assert cells.reader(metric)(_run(frame_ms=[13.0])) is None


@pytest.mark.parametrize("metric", READERS)
def test_an_untraced_program_gives_nothing(metric):
    """The program's own ring, the trace never turned on."""
    from immesh_tpu_torch.utils.timers import trace
    assert not trace.on
    trace.clear()
    assert cells.reader(metric)(_run(frame_ms=[13.0])) is None
