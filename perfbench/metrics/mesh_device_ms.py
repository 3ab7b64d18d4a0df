"""mesh_device_ms: the mean device ms a frame of the mesh step (the `mesh`
span: event nodes around mesh_step in the joint frame graph, or in Avia's
mesh graph), placed on the host clock (perfbench/harness/frame_trace.py)."""

from perfbench.harness import frame_trace


def read(run):
    return frame_trace.device_ms(run, "mesh")
