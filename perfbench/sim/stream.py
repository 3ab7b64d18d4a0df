"""The scan stream of one cell: a traffic file's scene and route seen by a
configuration's sensor, made on the device from the run's seed.

A route is driven in `lead_in` frames through the launch ramp, then round a
closed lap of `lap_frames` scans, which repeat exactly lap after lap: the
lap's scans are made once and replayed, frame k ≥ lead_in being lap scan
(k − lead_in) mod lap_frames.  Traffic parameters (traffic/<name>.json):

  scene:  {"kind": "room", "extent", "height"}
          {"kind": "street_loop", "half_width", "boxes_per_m", "clear",
           "seed"}
  route:  {"kind": "orbit", "radius", "z0", "z_amp", "sway", "bob",
           "pitch", "roll"} (omega from lap_frames: one lap a circle)
          {"kind": "loop", "b", "rc", "speed", "weave_amp", "weaves", "bob",
           "pitch", "roll", "sway", "z0"} (the straight a from lap_frames:
           one lap is lap_frames scans at speed)
  lead_in, lap_frames, t_ramp, warmup (frames of set-up after the lead-in).
  wire:   {"layout": "livox_custommsg"} (optional): each scan also
          serialised to the sensor's packets and IMU messages
          (sim/wire.py), which the entry then takes in place of the bundle.

The sensor (config file's "sensor": rings, max_range, noise, IMU rate,
clockwise) and the scan width (preprocess.max_points), the IMU capacity
(imu.max_imu_per_scan) and extrinsics come from the configuration.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from perfbench.sim import routes, scene as scenes
from perfbench.sim.lidar import Lidar
from perfbench.sim.wire import Wire, make_wire

BUNDLE_FIELDS = ("pts", "t_rel", "mask", "imu_stamps", "imu_acc", "imu_gyr",
                 "imu_mask", "scan_duration")


def make_route(r: dict, lap_frames: int, scan_T: float, t_ramp: float):
    kind = r["kind"]
    if kind == "orbit":
        omega = 2 * math.pi / (lap_frames * scan_T)
        return routes.Orbit(r["radius"], omega, r["z0"], r["z_amp"],
                            r["sway"], t_ramp, r["bob"], r["pitch"],
                            r["roll"])
    if kind == "loop":
        L = lap_frames * r["speed"] * scan_T
        a = (L - 2 * r["b"] - 2 * math.pi * r["rc"]) / 2
        if a <= 0:
            raise ValueError(f"a loop of {L} m cannot hold straights of "
                             f"{r['b']} m and corners of {r['rc']} m")
        loop = routes.RoundedLoop(a, r["b"], r["rc"])
        return routes.Loop(loop, r["speed"], r["z0"], r["weave_amp"],
                           r["weaves"], r["sway"], t_ramp, r["bob"],
                           r["pitch"], r["roll"])
    raise ValueError(f"route kind {kind!r}")


def make_scene(s: dict, route) -> scenes.Rects:
    kind = s["kind"]
    if kind == "room":
        return scenes.room(s["extent"], s["height"])
    if kind == "street_loop":
        return scenes.street_loop(route.loop, s["half_width"],
                                  s["boxes_per_m"], s["clear"], s["seed"])
    raise ValueError(f"scene kind {kind!r}")


@dataclasses.dataclass
class Stream:
    """The cell's scans on the device, each a dict of ScanBundle fields."""
    lead: List[Dict[str, torch.Tensor]]   # the lead-in frames
    lap: Dict[str, torch.Tensor]          # the lap's scans, stacked
    lap_frames: int
    static_imu: Optional[Tuple[np.ndarray, np.ndarray]]
    lidar: Lidar
    wire: Optional[Wire] = None           # the scans on the wire, if sent

    def bundle(self, k: int) -> Dict[str, torch.Tensor]:
        """Frame k of the run."""
        if k < len(self.lead):
            return self.lead[k]
        j = (k - len(self.lead)) % self.lap_frames
        return {n: t[j] for n, t in self.lap.items()}

    def feed(self, k: int):
        """What the entry takes for frame k: its bundle, or with a wire
        its packets and IMU messages (a sim.wire.WireFrame)."""
        if self.wire is None:
            return self.bundle(k)
        return self.wire.frame(k)


_BATCH_RAYS = 1 << 20  # rays cast in one batch of scans


def _bundles(lidar: Lidar, ks, n_pts: int, n_imu: int,
             gen: torch.Generator, rng: np.random.Generator) -> dict:
    """ScanBundle.from_numpy's padded bundles of scans ks, stacked, on the
    device: hits first in sweep order, then zero rows masked out."""
    dev = lidar.dev
    pts, ok = lidar.scans(ks, [lidar.phase_step * k for k in ks], gen)
    B, n = ok.shape
    order = torch.argsort((~ok).to(torch.int8), dim=1, stable=True)
    order = order[:, :n_pts]
    m = order.shape[1]
    valid = (torch.arange(m, device=dev)[None]
             < ok.sum(dim=1, keepdim=True))
    P = torch.zeros((B, n_pts, 3), dtype=torch.float32, device=dev)
    T = torch.zeros((B, n_pts), dtype=torch.float32, device=dev)
    M = torch.zeros((B, n_pts), dtype=torch.bool, device=dev)
    P[:, :m] = torch.where(valid[..., None],
                           torch.gather(pts, 1, order[..., None].expand(
                               B, m, 3)), 0.0)
    T[:, :m] = torch.where(valid, lidar.t_rel[order], 0.0)
    M[:, :m] = valid
    st, acc, gyr = lidar.imu(ks, rng)
    q = min(len(st), n_imu)
    S = np.zeros((B, n_imu), np.float32)
    A = np.zeros((B, n_imu, 3), np.float32)
    G = np.zeros((B, n_imu, 3), np.float32)
    IM = np.zeros((B, n_imu), bool)
    S[:, :q], A[:, :q], G[:, :q], IM[:, :q] = st[:q], acc[:, :q], \
        gyr[:, :q], True
    if q > 0:
        S[:, q:] = S[:, q - 1:q]
    return {"pts": P, "t_rel": T, "mask": M,
            "imu_stamps": torch.from_numpy(S).to(dev),
            "imu_acc": torch.from_numpy(A).to(dev),
            "imu_gyr": torch.from_numpy(G).to(dev),
            "imu_mask": torch.from_numpy(IM).to(dev),
            "scan_duration": torch.full((B,), lidar.scan_T,
                                        dtype=torch.float32, device=dev)}


def _stacked(lidar, first: int, count: int, n_pts, n_imu, gen, rng) -> dict:
    """The bundles of scans first .. first + count − 1, stacked."""
    per = max(1, _BATCH_RAYS // lidar.n_rays)
    out = {}
    for s in range(0, count, per):
        ks = list(range(first + s, first + min(s + per, count)))
        b = _bundles(lidar, ks, n_pts, n_imu, gen, rng)
        for name in BUNDLE_FIELDS:
            if name not in out:
                out[name] = torch.empty((count,) + tuple(b[name].shape[1:]),
                                        dtype=b[name].dtype,
                                        device=lidar.dev)
            out[name][s:s + len(ks)] = b[name]
    return out


def make_stream(cfg: dict, sensor: dict, traffic: dict, seed: int,
                device) -> Stream:
    """The cell's stream: `cfg` the configuration's dict (the program's
    ImMeshConfig fields), `sensor` its sensor, `traffic` the mix."""
    scan_T = 1.0 / sensor.get("scan_rate", 10.0)
    lap_frames, lead_in = traffic["lap_frames"], traffic["lead_in"]
    route = make_route(traffic["route"], lap_frames, scan_T,
                       traffic["t_ramp"])
    rects = make_scene(traffic["scene"], route).arrays()
    imu = cfg["imu"]
    lidar = Lidar(rects, route, device,
                  n_rays=cfg["preprocess"]["max_points"],
                  rings=sensor["rings"], scan_rate=1.0 / scan_T,
                  imu_rate=sensor["imu_rate"],
                  range_noise=sensor["range_noise"],
                  max_range=sensor["max_range"],
                  accel_noise=sensor["accel_noise"],
                  gyro_noise=sensor["gyro_noise"], gravity=imu["gravity"],
                  ext_r=np.reshape(imu["extrinsic_r"], (3, 3)),
                  ext_t=imu["extrinsic_t"], clockwise=sensor["clockwise"],
                  phase_step=sensor["phase_step"])
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (2 ** 63))
    rng = np.random.default_rng(seed)
    static = (lidar.static_imu(sensor["static_imu"], rng)
              if sensor["static_imu"] > 0 else None)
    n_pts, n_imu = cfg["preprocess"]["max_points"], imu["max_imu_per_scan"]
    lead = _stacked(lidar, 0, lead_in, n_pts, n_imu, gen, rng)
    stacked = _stacked(lidar, lead_in, lap_frames, n_pts, n_imu, gen, rng)
    wire = (make_wire(traffic["wire"], lead, stacked, lidar)
            if "wire" in traffic else None)
    lead = [{n: t[k] for n, t in lead.items()} for k in range(lead_in)]
    return Stream(lead, stacked, lap_frames, static, lidar, wire)
