"""map_update_device_ms: the mean device ms a frame of the plane map's
growth, grow_map in lio_step (the `lio.map_update` span: event nodes
around its refinement levels' IF nodes), placed on the host clock
(perfbench/harness/frame_trace.py)."""

from perfbench.harness import frame_trace


def read(run):
    return frame_trace.device_ms(run, "lio.map_update")
