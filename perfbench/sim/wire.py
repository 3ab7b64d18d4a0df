"""A cell's scans as the sensor puts them on the wire, made in set-up.

A traffic file's `"wire": {"layout": <name>}` names the point record.  The
one layout is livox_ros_driver's CustomMsg point (`livox_custommsg`, 19 B,
the message ImMesh's Avia bags carry on /livox/lidar and the reference's
avia_handler reads, preprocess.cpp:139): offset_time u32 ns @0, x/y/z f32
@4/8/12, reflectivity u8 @16, tag u8 @17, line u8 @18.

Each lead-in and lap scan is serialised once, when the stream is made: its
bundle's valid rows in sweep order, offset_time the row's t_rel rounded to
the nearest ns, tag 0x10 (a normal return), line the ray's ring,
reflectivity 0 (the simulator has none).

The IMU goes out one message a sample (/livox/imu), at absolute stamps:
frame k's scan starts at k·T, T the scan period as float32, and its
messages are its bundle's valid IMU samples at k·T + imu_stamps.  Every
such sum, and its difference with k·T, is exact in double.  A scan's last
sample lies at the next scan's start, where that scan's first sample lies
too: each boundary sample is sent once, with the scan it ends, so frame
k > 0 leaves out its own first sample."""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import numpy as np
import torch

CUSTOM_POINT = np.dtype({
    "names": ["offset_time", "x", "y", "z", "reflectivity", "tag", "line"],
    "formats": ["<u4", "<f4", "<f4", "<f4", "u1", "u1", "u1"],
    "offsets": [0, 4, 8, 12, 16, 17, 18], "itemsize": 19})
LAYOUTS = {"livox_custommsg": CUSTOM_POINT}
TAG_NORMAL = 0x10


@dataclasses.dataclass
class WireFrame:
    """What frame k sends: its IMU messages, then its scan's packet."""
    layout: str
    data: bytes             # the scan's points, `n` records of the layout
    n: int
    stamp: float            # the scan's start, s
    duration: float         # its period, s
    imu_t: np.ndarray       # (m,) float64 absolute stamps, ascending
    imu_acc: np.ndarray     # (m, 3) float32
    imu_gyr: np.ndarray     # (m, 3) float32


@dataclasses.dataclass
class _Scan:
    data: bytes
    n: int
    imu_st: np.ndarray      # (q,) float32 stamps from the scan's start
    imu_acc: np.ndarray
    imu_gyr: np.ndarray


class Wire:
    """The serialised scans of a stream: frame k is lead-in scan k, or lap
    scan (k − lead_in) mod lap_frames, sent at k·T."""

    def __init__(self, layout: str, lead: List[_Scan], lap: List[_Scan],
                 period: float):
        self.layout, self.lead, self.lap = layout, lead, lap
        self.period = period

    def frame(self, k: int) -> WireFrame:
        s = (self.lead[k] if k < len(self.lead)
             else self.lap[(k - len(self.lead)) % len(self.lap)])
        stamp = k * self.period
        first = 1 if k > 0 else 0
        return WireFrame(self.layout, s.data, s.n, stamp, self.period,
                         stamp + s.imu_st[first:].astype(np.float64),
                         s.imu_acc[first:], s.imu_gyr[first:])

    def nbytes(self) -> int:
        return sum(len(s.data) for s in self.lead + self.lap)


def _serialise(layout: str, b: Dict[str, torch.Tensor], n_rays: int,
               rings: int, scan_T: float, period: float) -> List[_Scan]:
    """The stacked bundles `b` (on any device) as one _Scan each."""
    if not b:
        return []
    rec_t = LAYOUTS[layout]
    pts, t_rel, mask = (b[k].cpu().numpy() for k in ("pts", "t_rel", "mask"))
    st, acc, gyr, im = (b[k].cpu().numpy() for k in
                        ("imu_stamps", "imu_acc", "imu_gyr", "imu_mask"))
    out = []
    for j in range(len(pts)):
        n = int(mask[j].sum())
        if not mask[j, :n].all():
            raise ValueError("a bundle's valid rows are not its first rows")
        t = t_rel[j, :n].astype(np.float64)
        rec = np.zeros(n, rec_t)
        rec["offset_time"] = np.round(t * 1e9).astype(np.uint32)
        for c, name in enumerate("xyz"):
            rec[name] = pts[j, :n, c]
        rec["tag"] = TAG_NORMAL
        # the ray index from its time (t_rel = T·i / n_rays in float32)
        rec["line"] = np.rint(t * n_rays / scan_T).astype(np.int64) % rings
        q = int(im[j].sum())
        if q > 0 and float(st[j, q - 1]) != period:
            raise ValueError(f"a scan's last IMU sample at {st[j, q - 1]!r} "
                             f"s, not at its end {period!r} s")
        out.append(_Scan(rec.tobytes(), n, st[j, :q].copy(),
                         acc[j, :q].copy(), gyr[j, :q].copy()))
    return out


def make_wire(spec: dict, lead: Dict[str, torch.Tensor],
              lap: Dict[str, torch.Tensor], lidar) -> Wire:
    """The wire of a traffic's `"wire"` spec over the stream's stacked
    lead-in and lap bundles."""
    layout = spec["layout"]
    if layout not in LAYOUTS:
        raise ValueError(f"wire layout {layout!r} (known: {sorted(LAYOUTS)})")
    period = float(np.float32(lidar.scan_T))
    args = (lidar.n_rays, lidar.rings, lidar.scan_T, period)
    return Wire(layout, _serialise(layout, lead, *args),
                _serialise(layout, lap, *args), period)
