"""The system's own entry: immesh_tpu_torch.runtime.app.ImMeshRuntime.
process_frame, which runs the LIO graph, then the mesh graph, and reads the
pose to the host.  No log directory: the trajectory and cost logs write
nothing.  Entry arguments: none."""

from __future__ import annotations

import numpy as np
import torch


class Entry:
    def __init__(self, cfg, args: dict, static_imu, device):
        from immesh_tpu_torch.frontend.types import ScanBundle
        from immesh_tpu_torch.runtime.app import ImMeshRuntime
        self._bundle = ScanBundle
        self.rt = ImMeshRuntime(cfg, log_dir=None, device=device)
        if static_imu is not None:
            self.rt.static_init(*static_imu)
        self.lio, self.mesh = self.rt.lio, self.rt.mesh
        self.k = 0

    def step(self, b: dict):
        """One frame; returns (pose on the host, the frame's diag)."""
        out = self.rt.process_frame(self._bundle(**b), t=0.1 * self.k)
        self.k += 1
        return np.asarray(out["pos"]), {
            "iterations": out["iterations"],
            "n_active_voxels": out["n_active_voxels"]}

    def parts(self) -> dict:
        return {"state": self.lio.state, "vm": self.lio.vm,
                "gm": self.mesh.gm, "store": self.mesh.store}

    def captured(self) -> list:
        return [c for c in (self.lio.captured, self.mesh.captured)
                if c is not None]

    def release(self) -> None:
        self.rt.close()
        self.rt = self.lio = self.mesh = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
