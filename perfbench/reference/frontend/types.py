"""Statically-shaped measurement bundles handed from host to device.

Port of immesh_tpu/frontend/types.py: one LiDAR scan plus the IMU packets
covering it, padded to a fixed (n_pts, n_imu) bucket so every frame has the
same tensor shapes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from perfbench.reference.device import resolve_device


@dataclass
class ScanBundle:
    # LiDAR
    pts: torch.Tensor        # (N, 3) body-frame points
    t_rel: torch.Tensor      # (N,) per-point time, seconds from scan start
    mask: torch.Tensor       # (N,) bool validity (padding / blind / decimation)
    # IMU (interval-boundary samples spanning [0, scan_duration])
    imu_stamps: torch.Tensor  # (M,) seconds from scan start, ascending
    imu_acc: torch.Tensor     # (M, 3) m/s²
    imu_gyr: torch.Tensor     # (M, 3) rad/s
    imu_mask: torch.Tensor    # (M,) bool validity (padding)
    scan_duration: torch.Tensor  # () seconds

    @classmethod
    def from_numpy(cls, pts, t_rel, imu_stamps, imu_acc, imu_gyr,
                   scan_duration, n_pts: int, n_imu: int,
                   mask=None, dtype=np.float32, device="cuda") -> "ScanBundle":
        """Pad/truncate host arrays to the static bucket (n_pts, n_imu)."""
        dev = resolve_device(device)
        n = min(len(pts), n_pts)
        m = min(len(imu_stamps), n_imu)
        P = np.zeros((n_pts, 3), dtype)
        T = np.zeros((n_pts,), dtype)
        K = np.zeros((n_pts,), bool)
        P[:n] = pts[:n]
        T[:n] = t_rel[:n]
        K[:n] = True if mask is None else mask[:n]
        S = np.zeros((n_imu,), dtype)
        A = np.zeros((n_imu, 3), dtype)
        G = np.zeros((n_imu, 3), dtype)
        M_ = np.zeros((n_imu,), bool)
        S[:m] = imu_stamps[:m]
        A[:m] = imu_acc[:m]
        G[:m] = imu_gyr[:m]
        M_[:m] = True
        # padded stamps repeat the last valid stamp so searchsorted stays sane
        if m > 0:
            S[m:] = S[m - 1]

        def t(x):
            return torch.from_numpy(x).to(dev)

        return cls(
            pts=t(P), t_rel=t(T), mask=t(K), imu_stamps=t(S), imu_acc=t(A),
            imu_gyr=t(G), imu_mask=t(M_),
            scan_duration=t(np.asarray(dtype(scan_duration))),
        )
