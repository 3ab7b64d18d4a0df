"""The KITTI-style entry: immesh_tpu_torch.runtime.joint.JointPipeline.step,
one captured frame graph a frame on the card, then the pose read to the
host.  Entry arguments (the configuration file's "entry_args"):
adaptive_mesh_budget."""

from __future__ import annotations

import torch


class Entry:
    def __init__(self, cfg, args: dict, static_imu, device):
        from immesh_tpu_torch.frontend.types import ScanBundle
        from immesh_tpu_torch.runtime.joint import JointPipeline
        self._bundle = ScanBundle
        self.pipe = JointPipeline(
            cfg, adaptive_mesh_budget=args.get("adaptive_mesh_budget", 0),
            device=device)
        if static_imu is not None:
            self.pipe.static_init(*static_imu)
        self.lio, self.mesh = self.pipe.lio, self.pipe.mesh

    def step(self, b: dict):
        """One frame; returns (pose on the host, the frame's diag)."""
        _, diag = self.pipe.step(self._bundle(**b))
        return self.pipe.state.pos.cpu(), diag

    def parts(self) -> dict:
        return {"state": self.lio.state, "vm": self.lio.vm,
                "gm": self.mesh.gm, "store": self.mesh.store}

    def captured(self) -> list:
        """The captured steps a frame replays, in frame order."""
        return [] if self.pipe.captured is None else [self.pipe.captured]

    def release(self) -> None:
        self.pipe = self.lio = self.mesh = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
