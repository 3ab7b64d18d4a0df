"""outside.other: the window's mean ms a frame, of its time outside the
graphs, that no host span of the five covers: the entry's Python under
`frame` alone, and the harness's between handing the scan over and the
pose's return (perfbench/harness/frame_trace.py)."""

from perfbench.harness import frame_trace


def read(run):
    return frame_trace.outside(run, "other")
