"""outside.compact: the window's mean ms a frame, of its time outside the
graphs, that the maps' compactions (`compact` spans) take
(perfbench/harness/frame_trace.py)."""

from perfbench.harness import frame_trace


def read(run):
    return frame_trace.outside(run, "compact")
