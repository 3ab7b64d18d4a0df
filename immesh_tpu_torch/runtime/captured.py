"""The frame's two captured steps, as one object.

The reference's frame is one donated, jitted program: joint_step runs
lio_step, then mesh_step on the world scan and pose it made
(immesh_tpu/runtime/joint.py:32-42).  On the card `JointPipeline` replays
it as two CUDA graphs, lio/captured.py's step on the caller's stream and
mesh/captured.py's on the MeshPipeline's own stream after it
(mesh/pipeline.py::MeshPipeline.step), so the pose is read before the mesh
half ends.  `FrameSteps` shows the pair as the frame's captured step: both
graphs, the frames replayed, and one device span a frame.
"""

from __future__ import annotations

from typing import List, Optional

from immesh_tpu_torch.lio.captured import CapturedLioStep
from immesh_tpu_torch.mesh.captured import CapturedMeshStep
from immesh_tpu_torch.utils.graphs import Graph


class FrameSteps:
    """A frame's LIO step and mesh step (utils/graphs.py::CapturedStep),
    each captured once per input shape and replayed, the LIO's first."""

    def __init__(self, lio: CapturedLioStep, mesh: CapturedMeshStep):
        self.lio, self.mesh = lio, mesh

    @property
    def graphs(self) -> List[Graph]:
        """Both halves' graphs, the LIO's first."""
        return self.lio.graphs + self.mesh.graphs

    @property
    def replays(self) -> int:
        """Frames replayed: each replays the LIO graph, then the mesh
        graph."""
        return self.lio.replays

    @property
    def replay_events(self) -> Optional[list]:
        """Where set to a list: one (start, end) CUDA event pair a replayed
        frame, start recorded on the caller's stream before the LIO replay,
        end on the mesh stream after the mesh replay."""
        lio, mesh = self.lio.replay_events, self.mesh.replay_events
        if lio is None or mesh is None:
            return None
        return [(a[0], b[1]) for a, b in zip(lio, mesh)]

    @replay_events.setter
    def replay_events(self, events: Optional[list]) -> None:
        for step in (self.lio, self.mesh):
            step.replay_events = None if events is None else list(events)
