"""compact_ms: the mean ms of the window's compactions of either map (the
`compact` host spans of LioPipeline.maybe_compact and
MeshPipeline.maybe_compact); nothing where none compacted
(perfbench/harness/frame_trace.py)."""

from perfbench.harness import frame_trace


def read(run):
    return frame_trace.compact(run)
