"""pose_wait_ms: the mean ms from the end of the LIO step on the device
(the `lio` span's end, placed on the host clock) to the end of the pose's
copy to the host (the frame's last `pose_read` span): what publishing the
pose before the mesh half would save at most
(perfbench/harness/frame_trace.py)."""

from perfbench.harness import frame_trace


def read(run):
    return frame_trace.pose_wait(run)
