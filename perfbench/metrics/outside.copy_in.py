"""outside.copy_in: the window's mean ms a frame, of its time outside the
graphs, that the replay's pointer check and its copies into the static
inputs (`copy_in` spans) (perfbench/harness/frame_trace.py)."""

from perfbench.harness import frame_trace


def read(run):
    return frame_trace.outside(run, "copy_in")
