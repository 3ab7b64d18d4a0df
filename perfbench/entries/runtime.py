"""The system's own entry: immesh_tpu_torch.runtime.app.ImMeshRuntime.
process_frame, which runs the LIO graph, then the mesh graph, and reads the
pose to the host, then, with `ba.enabled`, hands the pose and world scan
to the runtime's WindowBA.  No log directory: the trajectory and cost logs
write nothing.  Entry arguments: none.

With BA on, the window crosses into the check as the reference's `Window`
(`parts()["ba"]`), and a frame's diag says whether it refined the window
(`ba_refined`: process_frame returned a `ba_cost`)."""

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
        return self._frame(self._bundle(**b))

    def _frame(self, bundle, imu_gap: bool = False):
        out = self.rt.process_frame(bundle, t=0.1 * self.k, imu_gap=imu_gap)
        self.k += 1
        return np.asarray(out["pos"]), {
            "iterations": out["iterations"],
            "n_active_voxels": out["n_active_voxels"],
            "ba_refined": out["ba_cost"] is not None}

    def parts(self) -> dict:
        p = {"state": self.lio.state, "vm": self.lio.vm,
             "gm": self.mesh.gm, "store": self.mesh.store}
        if self.rt.ba is not None:
            from perfbench.reference.lio.window import window_of
            p["ba"] = window_of(self.rt.ba, self.rt.cfg.ba.pts_per_keyframe)
        return p

    def keyframes(self) -> int:
        """Keyframes the BA window holds (BA on only)."""
        return len(self.rt.ba.kf_rot)

    def captured(self) -> list:
        return [c for c in (self.lio.captured, self.mesh.captured)
                if c is not None]

    def release(self) -> None:
        self.rt.close()
        self.rt = self.lio = self.mesh = None
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
