"""The system's own entry fed from the wire, for a traffic with a wire
layout: the program's receiver turns a frame's IMU messages and scan packet
into the bundle that entries/runtime.py's ImMeshRuntime.process_frame
takes.  For each frame: PacketSynchronizer.push_imu for each IMU message;
push_scan of decode_raw_buffer (csrc/scanpack.cpp's decode with its gates
fused in); next_bundle (Preprocessor.process's gates and time rebase, the
IMU window, ScanBundle.from_numpy's padding and upload); then
process_frame with the synchronizer's IMU-gap flag.

`receive_ms` holds each frame's host time from its first push_imu to
next_bundle's return, which a traced segment sees as the profiler range
`wire.receive` (the device's idle gaps under it carry that name).  A frame
whose next_bundle gives nothing is not run and is listed in `failed`.  The
frame's bundle crosses into the check (`parts()["bundle"]`), to be held to
the reference receiver's."""

from __future__ import annotations

import time

import torch

from perfbench.entries import runtime


class Entry(runtime.Entry):
    def __init__(self, cfg, args: dict, static_imu, device):
        super().__init__(cfg, args, static_imu, device)
        from immesh_tpu_torch.frontend import preprocess
        from immesh_tpu_torch.frontend.sync import PacketSynchronizer
        self._pre = preprocess
        self.sync = PacketSynchronizer(cfg, device=device)
        self.bundle = None
        self.receive_ms, self.failed = [], []
        zero = torch.zeros((), device=device)   # beside the device's counts
        self._pos, self._none = None, {"iterations": zero,
                                       "n_active_voxels": zero,
                                       "ba_refined": False}

    def step(self, f):
        """One frame from its messages (a sim.wire.WireFrame); returns (pose
        on the host, the frame's diag)."""
        t0 = time.perf_counter()
        with torch.profiler.record_function("wire.receive"):
            for t, a, g in zip(f.imu_t.tolist(), f.imu_acc, f.imu_gyr):
                self.sync.push_imu(t, a, g)
            self.sync.push_scan(self._pre.decode_raw_buffer(
                f.data, f.n, f.layout, self.rt.cfg.preprocess, stamp=f.stamp,
                duration=f.duration))
            b = self.sync.next_bundle()
        self.receive_ms.append(1e3 * (time.perf_counter() - t0))
        if b is None:
            self.failed.append(self.k)
            self.k += 1
            return self._pos, self._none
        self.bundle = b
        self._pos, diag = self._frame(b, imu_gap=self.sync.consume_gap())
        return self._pos, diag

    def parts(self) -> dict:
        p = super().parts()
        if self.bundle is not None:
            p["bundle"] = self.bundle
        return p
