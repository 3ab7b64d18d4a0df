"""outside.pose_read: the window's mean ms a frame, of its time outside the
graphs, that the pose's copy to the host (`pose_read` spans) after the
graphs end (perfbench/harness/frame_trace.py)."""

from perfbench.harness import frame_trace


def read(run):
    return frame_trace.outside(run, "pose_read")
