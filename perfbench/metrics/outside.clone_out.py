"""outside.clone_out: the window's mean ms a frame, of its time outside the
graphs, that the clones of the graphs' outputs (`clone_out` spans), where
no graph runs (perfbench/harness/frame_trace.py)."""

from perfbench.harness import frame_trace


def read(run):
    return frame_trace.outside(run, "clone_out")
