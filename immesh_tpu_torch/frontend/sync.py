"""Measurement synchronization: LiDAR scans + IMU windows → ScanBundles.

Port of immesh_tpu/frontend/sync.py.  The one difference in interface: the
synchronizer takes the `device` its bundles are built on (default "cuda",
resolved by device.py, which raises without a card).

Re-design of the reference's buffer/callback layer (reference
src/voxel_mapping_common.cpp:290-441): `standard_pcl_cbk`/`livox_pcl_cbk`/
`imu_cbk` fill deques under a mutex and `sync_packages` bundles one scan with
every IMU message up to its end time.  Here the same logic is a plain
single-threaded class (the device pipeline provides the concurrency), keeping
the reference's stream-anomaly guards:

  * IMU timestamp going backwards → drop sample (imu_cbk :348-354);
  * IMU gap > 0.4 s → reset flag for the filter (:356-362);
  * LiDAR loop-back (bag restart) → clear buffers (:296-299).
"""

from __future__ import annotations

from collections import deque
from typing import Optional

import numpy as np

from immesh_tpu_torch.config import ImMeshConfig
from immesh_tpu_torch.device import resolve_device
from immesh_tpu_torch.frontend.preprocess import Preprocessor, RawScan
from immesh_tpu_torch.frontend.types import ScanBundle


class PacketSynchronizer:
    def __init__(self, cfg: ImMeshConfig, device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.pre = Preprocessor(cfg.preprocess)
        self.scans: deque = deque()
        self.imu_t: list = []
        self.imu_acc: list = []
        self.imu_gyr: list = []
        self.last_imu_t = -np.inf
        self.last_scan_t = -np.inf
        self.imu_gap_detected = False

    # ---- callbacks (reference imu_cbk / *_pcl_cbk) -----------------------
    def push_imu(self, t: float, acc, gyr) -> None:
        if t < self.last_imu_t:          # backwards time → drop (:348-354)
            return
        if t - self.last_imu_t > 0.4 and np.isfinite(self.last_imu_t):
            self.imu_gap_detected = True  # gap guard (:356-362)
        self.last_imu_t = t
        self.imu_t.append(t)
        self.imu_acc.append(np.asarray(acc, np.float32))
        self.imu_gyr.append(np.asarray(gyr, np.float32))

    def consume_gap(self) -> bool:
        """Return-and-clear the IMU-gap flag.  The runtime consumes this to
        re-initialize the filter (reference m_flg_reset handling,
        src/voxel_mapping.cpp:1791-1797)."""
        flag = self.imu_gap_detected
        self.imu_gap_detected = False
        return flag

    def push_scan(self, scan: RawScan) -> None:
        if scan.stamp < self.last_scan_t:  # loop-back → clear (:296-299)
            self.scans.clear()
            self.imu_t.clear(); self.imu_acc.clear(); self.imu_gyr.clear()
            self.last_imu_t = -np.inf
        self.last_scan_t = scan.stamp
        self.scans.append(scan)

    # ---- sync_packages (reference :372-441) ------------------------------
    def next_bundle(self) -> Optional[ScanBundle]:
        """Emit the oldest scan once IMU coverage reaches its end time."""
        if not self.scans:
            return None
        scan = self.scans[0]
        end_t = scan.stamp + scan.duration
        use_imu = self.cfg.imu.imu_en
        if use_imu and (not self.imu_t or self.imu_t[-1] < end_t):
            return None  # wait for IMU to catch up

        self.scans.popleft()
        pts, t_rel = self.pre.process(scan)

        if use_imu:
            ts = np.asarray(self.imu_t)
            m = (ts >= scan.stamp) & (ts <= end_t)
            stamps = ts[m] - scan.stamp
            acc = np.stack([a for a, k in zip(self.imu_acc, m) if k]) \
                if m.any() else np.zeros((0, 3), np.float32)
            gyr = np.stack([g for g, k in zip(self.imu_gyr, m) if k]) \
                if m.any() else np.zeros((0, 3), np.float32)
            # drop consumed history older than this scan
            keep = ts >= scan.stamp
            self.imu_t = list(ts[keep])
            self.imu_acc = [a for a, k in zip(self.imu_acc, keep) if k]
            self.imu_gyr = [g for g, k in zip(self.imu_gyr, keep) if k]
        else:
            stamps = np.zeros(1, np.float32)
            acc = np.zeros((1, 3), np.float32)
            gyr = np.zeros((1, 3), np.float32)

        return ScanBundle.from_numpy(
            pts, t_rel, stamps, acc, gyr, scan.duration,
            self.cfg.preprocess.max_points, self.cfg.imu.max_imu_per_scan,
            device=self.device,
        )
