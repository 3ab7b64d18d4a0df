"""Per-sensor scan decoding & filtering — the "receiver" frontend.

Port of immesh_tpu/frontend/preprocess.py (host NumPy): every output is
byte-identical to the JAX package's on the same input.

Re-design of the reference's `Preprocess` class (reference src/preprocess.{h,cpp}):
per-LiDAR-model handlers that decode raw point records into {xyz, per-point
relative time}, apply blind-range/decimation/NaN gates, and (for KITTI)
re-calibrate vertical angles.  The reference walks points in scalar loops with
per-ring state (preprocess.cpp:139-900); here every handler is a vectorized
NumPy transform on the host (decode is IO-bound, not a TPU workload), feeding
padded `ScanBundle`s to the device.

Handler parity map (reference file:line):
  avia      — preprocess.cpp:139-232  (Livox tag filter, offset_time in ms)
  l515      — preprocess.cpp:234-275
  oust64    — preprocess.cpp:277-496  (t field in ns)
  velodyne  — preprocess.cpp:497-528  (KITTI: ring from elevation angle,
              time synthesized from azimuth — the bin files carry no time)
  velodyne32— preprocess.cpp:530-743  (time field in s or synthesized)
  xt32      — preprocess.cpp:745-898  (timestamp field, s)
KITTI vertical-angle recalibration mirrors `calib_laser`
(reference src/voxel_mapping.cpp:1844-1859).
"""

from __future__ import annotations

import dataclasses
import os
from typing import Iterator, Optional, Tuple

import numpy as np

from immesh_tpu_torch.config import LidarType, PreprocessConfig
from immesh_tpu_torch.frontend import native as _native
from immesh_tpu_torch.frontend.features import extract_features


@dataclasses.dataclass
class RawScan:
    """Sensor-agnostic decoded record batch (one scan/message)."""

    xyz: np.ndarray                       # (N, 3) float32, sensor frame
    time_off: Optional[np.ndarray] = None  # (N,) seconds from scan start
    ring: Optional[np.ndarray] = None      # (N,) int
    intensity: Optional[np.ndarray] = None
    tag: Optional[np.ndarray] = None       # livox tag byte
    stamp: float = 0.0                     # scan-start time, seconds
    duration: float = 0.1                  # nominal scan period


class Preprocessor:
    """`Preprocess::process` equivalent: RawScan → (pts, t_rel) float32."""

    def __init__(self, cfg: PreprocessConfig):
        self.cfg = cfg

    def process(self, scan: RawScan) -> Tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        xyz = np.asarray(scan.xyz, np.float32)
        n = len(xyz)
        keep = np.isfinite(xyz).all(axis=1)

        # blind / max range gates (reference `blind`, preprocess.cpp:208-212)
        r2 = np.einsum("ij,ij->i", xyz, xyz)
        keep &= (r2 > cfg.blind ** 2) & (r2 < cfg.max_range ** 2)

        # livox tag filter: keep normal/high-confidence returns
        # (reference avia_handler, preprocess.cpp:166-176)
        if scan.tag is not None and cfg.lidar_type == LidarType.AVIA:
            tag = np.asarray(scan.tag)
            keep &= ((tag & 0x30) == 0x10) | ((tag & 0x30) == 0x00)

        # 1-in-N decimation (reference point_filter_num)
        if cfg.point_filter_num > 1:
            dec = np.zeros(n, bool)
            dec[:: cfg.point_filter_num] = True
            keep &= dec

        t_rel = self._relative_time(scan, n)
        xyz = xyz[keep]
        t_rel = t_rel[keep].astype(np.float32)

        if cfg.calib_laser and cfg.lidar_type == LidarType.KITTI64:
            xyz = kitti_vertical_angle_calib(xyz)

        # optional LOAM feature extraction (reference feature_extract_en →
        # give_feature, preprocess.cpp:900-1210): when enabled, downstream
        # registration consumes the classified feature cloud instead of the
        # raw scan — surf (plane) features feed the point-to-plane ESIKF,
        # edge features ride along for completeness (the plane voxel map
        # still χ²-gates them per residual)
        if cfg.feature_extract_en:
            ring = (np.asarray(scan.ring)[keep] if scan.ring is not None
                    else self._ring_from_elevation(xyz))
            surf, edge = extract_features(xyz, ring, t_rel)
            sel = surf | edge
            # degenerate scans (too few classified points to constrain the
            # 6-DoF update) fall back to the raw cloud — the reference's
            # configs sidestep this by shipping feature_extract_en: 0
            if int(sel.sum()) >= 64:
                xyz, t_rel = xyz[sel], t_rel[sel]
        return xyz, t_rel

    def _ring_from_elevation(self, xyz: np.ndarray) -> np.ndarray:
        """Synthesize a ring index by binning elevation into n_scans bands
        (the reference's velodyne handler derives ring from the vertical
        angle the same way, preprocess.cpp:515-523)."""
        if len(xyz) == 0:
            return np.zeros(0, np.int32)
        el = np.arctan2(xyz[:, 2], np.linalg.norm(xyz[:, :2], axis=1))
        lo, hi = el.min(), el.max() + 1e-9
        n = max(self.cfg.n_scans, 1)
        return np.minimum(((el - lo) / (hi - lo) * n).astype(np.int32), n - 1)

    # ------------------------------------------------------------------
    def _relative_time(self, scan: RawScan, n: int) -> np.ndarray:
        cfg = self.cfg
        if scan.time_off is not None:
            t = np.asarray(scan.time_off, np.float64) * cfg.timestamp_unit
            # some drivers emit absolute stamps; rebase to scan start
            t = t - t.min() if len(t) else t
            return t.astype(np.float32)
        # no per-point time (KITTI bins): synthesize from azimuth sweep,
        # mirroring what the reference's velodyne handler derives from the
        # horizontal angle (preprocess.cpp:515-528)
        if n == 0:
            return np.zeros(0, np.float32)
        az = np.arctan2(scan.xyz[:, 1], scan.xyz[:, 0])
        # spinning CW from +x: unwrap into [0, 2π) sweep order
        sweep = np.mod(-(az - az[0]), 2 * np.pi)
        return (sweep / (2 * np.pi) * scan.duration).astype(np.float32)


def kitti_vertical_angle_calib(xyz: np.ndarray) -> np.ndarray:
    """KITTI HDL-64 systematic vertical-angle correction (reference
    `calib_laser`, voxel_mapping.cpp:1844-1859: rotate each return's
    elevation by 0.205°)."""
    ang = np.deg2rad(0.205)
    r_xy = np.linalg.norm(xyz[:, :2], axis=1)
    el = np.arctan2(xyz[:, 2], r_xy) + ang
    r = np.linalg.norm(xyz, axis=1)
    scale_xy = np.cos(el) * r / np.maximum(r_xy, 1e-9)
    out = np.empty_like(xyz)
    out[:, 0] = xyz[:, 0] * scale_xy
    out[:, 1] = xyz[:, 1] * scale_xy
    out[:, 2] = np.sin(el) * r
    return out


def decode_raw_buffer(buf, n_points: int, layout: str,
                      cfg: PreprocessConfig, stamp: float = 0.0,
                      duration: float = 0.1) -> RawScan:
    """Decode a raw strided sensor buffer (PointCloud2-style) into a RawScan
    using the native scanpack library (fused gates in C++,
    csrc/scanpack.cpp), mirroring the reference's byte-level handlers
    (preprocess.cpp:277-898)."""
    step, off_xyz, t_off, t_dt, t_sc, ring_off, ring_dt = \
        _native.LAYOUTS[layout]
    xyz, t, ring = _native.decode_filter(
        buf, n_points, point_step=step, off_xyz=off_xyz,
        t_off=t_off, t_dtype=t_dt, t_scale=t_sc,
        ring_off=ring_off, ring_dtype=ring_dt,
        blind=cfg.blind, max_range=cfg.max_range,
        filter_num=cfg.point_filter_num, want_ring=True)
    return RawScan(xyz=xyz, time_off=t / cfg.timestamp_unit, ring=ring,
                   stamp=stamp, duration=duration)


# ----------------------------------------------------------------------
# Dataset readers
# ----------------------------------------------------------------------

def read_kitti_bin(path: str, duration: float = 0.1) -> RawScan:
    """KITTI odometry .bin file → RawScan (x, y, z, intensity float32)."""
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    return RawScan(xyz=raw[:, :3], intensity=raw[:, 3], duration=duration)


def kitti_sequence(velodyne_dir: str, duration: float = 0.1
                   ) -> Iterator[RawScan]:
    """Iterate a KITTI odometry sequence directory of .bin scans."""
    files = sorted(f for f in os.listdir(velodyne_dir) if f.endswith(".bin"))
    for k, f in enumerate(files):
        s = read_kitti_bin(os.path.join(velodyne_dir, f), duration)
        s.stamp = k * duration
        yield s


def read_npz_sequence(path: str) -> Iterator[Tuple[RawScan, dict]]:
    """Converted-rosbag format: one .npz per sequence holding, per frame k:
      scan{k}_xyz, scan{k}_time (optional), scan{k}_stamp, and global arrays
      imu_stamps, imu_acc, imu_gyr.  (The rosbag→npz converter runs wherever
      ROS is available; this runtime is ROS-free by design.)
    Yields (RawScan, imu window dict) per frame."""
    data = np.load(path)
    imu_stamps = data.get("imu_stamps", np.zeros(0))
    imu_acc = data.get("imu_acc", np.zeros((0, 3)))
    imu_gyr = data.get("imu_gyr", np.zeros((0, 3)))
    k = 0
    prev_stamp = None
    while f"scan{k}_xyz" in data:
        stamp = float(data[f"scan{k}_stamp"]) if f"scan{k}_stamp" in data else k * 0.1
        duration = 0.1 if prev_stamp is None else max(stamp - prev_stamp, 1e-3)
        scan = RawScan(
            xyz=data[f"scan{k}_xyz"],
            time_off=data.get(f"scan{k}_time"),
            stamp=stamp, duration=duration,
        )
        lo, hi = stamp, stamp + duration
        m = (imu_stamps >= lo) & (imu_stamps <= hi)
        imu = {
            "stamps": imu_stamps[m] - stamp,
            "acc": imu_acc[m],
            "gyr": imu_gyr[m],
        }
        prev_stamp = stamp
        yield scan, imu
        k += 1
