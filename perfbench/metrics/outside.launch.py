"""outside.launch: the window's mean ms a frame, of its time outside the
graphs, that the graph launch calls (`launch` spans), where the graph's
device span has not begun (perfbench/harness/frame_trace.py)."""

from perfbench.harness import frame_trace


def read(run):
    return frame_trace.outside(run, "launch")
