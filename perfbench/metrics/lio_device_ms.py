"""lio_device_ms: the mean device ms a frame of the LIO step up to the
plane map's growth (the `lio` span: event nodes at the outer level of the
joint frame graph, or of Avia's LIO graph), placed on the host clock
(perfbench/harness/frame_trace.py)."""

from perfbench.harness import frame_trace


def read(run):
    return frame_trace.device_ms(run, "lio")
