"""The receiver: IMU messages and scans in, a padded ScanBundle out.  A
frozen plain copy of the port's immesh_tpu_torch/frontend/sync.py::
PacketSynchronizer (its IMU buffer with the backwards-time drop, and
next_bundle's window: the samples from the scan's start to its end, both
included, stamped from its start), over the reference's decode, gates and
ScanBundle.from_numpy padding."""

from __future__ import annotations

from collections import deque
from typing import Optional, Sequence

import numpy as np

from perfbench.reference.config import ImMeshConfig
from perfbench.reference.frontend.preprocess import (
    Preprocessor, RawScan, decode_raw_buffer)
from perfbench.reference.frontend.types import ScanBundle


class Receiver:
    def __init__(self, cfg: ImMeshConfig, device):
        self.cfg, self.device = cfg, device
        self.pre = Preprocessor(cfg.preprocess)
        self.scans: deque = deque()
        self.imu_t, self.imu_acc, self.imu_gyr = [], [], []
        self.last_imu_t = -np.inf

    def push_imu(self, t: float, acc, gyr) -> None:
        if t < self.last_imu_t:          # backwards in time: dropped
            return
        self.last_imu_t = t
        self.imu_t.append(t)
        self.imu_acc.append(np.asarray(acc, np.float32))
        self.imu_gyr.append(np.asarray(gyr, np.float32))

    def push_scan(self, scan: RawScan) -> None:
        self.scans.append(scan)

    def next_bundle(self) -> Optional[ScanBundle]:
        """The oldest scan's bundle once the IMU reaches its end."""
        if not self.scans:
            return None
        scan = self.scans[0]
        end_t = scan.stamp + scan.duration
        use_imu = self.cfg.imu.imu_en
        if use_imu and (not self.imu_t or self.imu_t[-1] < end_t):
            return None
        self.scans.popleft()
        pts, t_rel = self.pre.process(scan)
        if use_imu:
            ts = np.asarray(self.imu_t)
            m = (ts >= scan.stamp) & (ts <= end_t)
            stamps = ts[m] - scan.stamp
            idx = np.flatnonzero(m)
            acc = (np.stack([self.imu_acc[i] for i in idx]) if len(idx)
                   else np.zeros((0, 3), np.float32))
            gyr = (np.stack([self.imu_gyr[i] for i in idx]) if len(idx)
                   else np.zeros((0, 3), np.float32))
            keep = np.flatnonzero(ts >= scan.stamp)
            self.imu_t = [self.imu_t[i] for i in keep]
            self.imu_acc = [self.imu_acc[i] for i in keep]
            self.imu_gyr = [self.imu_gyr[i] for i in keep]
        else:
            stamps = np.zeros(1, np.float32)
            acc = np.zeros((1, 3), np.float32)
            gyr = np.zeros((1, 3), np.float32)
        return ScanBundle.from_numpy(
            pts, t_rel, stamps, acc, gyr, scan.duration,
            self.cfg.preprocess.max_points, self.cfg.imu.max_imu_per_scan,
            device=self.device)


def receive(cfg: ImMeshConfig, frames: Sequence, device) -> ScanBundle:
    """The bundle of the last of `frames`, each what a frame sends (IMU
    messages `imu_t`, `imu_acc`, `imu_gyr`, then the packet `data` of `n`
    records of `layout`, stamped `stamp`, lasting `duration`): the frames
    before it give their IMU messages, as far back as its window reaches.
    Raises where the IMU does not reach the scan's end."""
    rx = Receiver(cfg, device)
    for f in frames:
        for t, a, g in zip(f.imu_t.tolist(), f.imu_acc, f.imu_gyr):
            rx.push_imu(t, a, g)
    f = frames[-1]
    rx.push_scan(decode_raw_buffer(f.data, f.n, f.layout, cfg.preprocess,
                                   stamp=f.stamp, duration=f.duration))
    b = rx.next_bundle()
    if b is None:
        raise ValueError(f"no bundle: the IMU ends before the scan at "
                         f"{f.stamp!r} s does")
    return b
