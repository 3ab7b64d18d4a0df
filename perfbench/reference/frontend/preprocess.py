"""A scan's decode and gates: frozen copies of the port's
immesh_tpu_torch/frontend/preprocess.py (`RawScan`, `decode_raw_buffer`
over the NumPy decode, `Preprocessor.process`'s gates and time rebase).
A decoded buffer carries no Livox tag, so the tag filter is left out; the
KITTI recalibration and the feature extraction, which no wire
configuration turns on, are refused."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np

from perfbench.reference.config import LidarType, PreprocessConfig
from perfbench.reference.frontend import native


@dataclasses.dataclass
class RawScan:
    """Sensor-agnostic decoded record batch (one scan/message)."""

    xyz: np.ndarray                       # (N, 3) float32, sensor frame
    time_off: Optional[np.ndarray] = None  # (N,) in timestamp units
    ring: Optional[np.ndarray] = None      # (N,) int
    stamp: float = 0.0                     # scan-start time, seconds
    duration: float = 0.1                  # nominal scan period


class Preprocessor:
    """RawScan → (pts, t_rel) float32."""

    def __init__(self, cfg: PreprocessConfig):
        if cfg.feature_extract_en or (cfg.calib_laser and cfg.lidar_type
                                      == LidarType.KITTI64):
            raise NotImplementedError(
                "the reference receiver has no feature extraction or KITTI "
                "recalibration")
        self.cfg = cfg

    def process(self, scan: RawScan) -> Tuple[np.ndarray, np.ndarray]:
        cfg = self.cfg
        xyz = np.asarray(scan.xyz, np.float32)
        n = len(xyz)
        keep = np.isfinite(xyz).all(axis=1)
        # blind and max range gates
        r2 = np.einsum("ij,ij->i", xyz, xyz)
        keep &= (r2 > cfg.blind ** 2) & (r2 < cfg.max_range ** 2)
        # 1-in-N decimation
        if cfg.point_filter_num > 1:
            dec = np.zeros(n, bool)
            dec[:: cfg.point_filter_num] = True
            keep &= dec
        t_rel = self._relative_time(scan, n)
        return xyz[keep], t_rel[keep].astype(np.float32)

    def _relative_time(self, scan: RawScan, n: int) -> np.ndarray:
        if scan.time_off is None:
            raise NotImplementedError(
                "the reference receiver takes per-point times only")
        t = np.asarray(scan.time_off, np.float64) * self.cfg.timestamp_unit
        t = t - t.min() if len(t) else t
        return t.astype(np.float32)


def decode_raw_buffer(buf, n_points: int, layout: str,
                      cfg: PreprocessConfig, stamp: float = 0.0,
                      duration: float = 0.1) -> RawScan:
    """A raw strided sensor buffer decoded, with the decode's gates, into a
    RawScan."""
    step, off_xyz, t_off, t_dt, t_sc, ring_off, ring_dt = \
        native.LAYOUTS[layout]
    raw = np.frombuffer(buf, np.uint8)
    if raw.size < n_points * step:
        raise ValueError(f"buffer of {raw.size} bytes holds fewer than "
                         f"{n_points} points of {step} bytes")
    xyz, t, ring = native.decode_filter(
        raw, int(n_points), step, off_xyz, t_off, t_dt, t_sc, ring_off,
        ring_dt, cfg.blind, cfg.max_range, cfg.point_filter_num, True)
    return RawScan(xyz=xyz, time_off=t / cfg.timestamp_unit, ring=ring,
                   stamp=stamp, duration=duration)
