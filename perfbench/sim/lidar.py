"""A spinning LiDAR with an IMU, cast on the device.

The model is immesh_tpu_torch/frontend/sim.py's LidarImuSimulator: n_rays
a scan swept in azimuth over `rings` elevations between −20° and 5°, each
ray cast from the pose at its own time (the nearest earlier of 64 poses a
scan), the LiDAR mounted at (ext_r, ext_t) in the body frame, points
returned in the LiDAR frame with Gaussian range noise, and IMU samples
finite-differenced from the pose with Gaussian noise.  The raycast runs in
float32 on the device, in the order of the NumPy one; the poses, ray
directions and IMU in float64 as there.  Scans are cast a batch at a time,
each batch against the planes that can lie within range of it (a plane
whose bounding sphere lies wholly beyond max_range of every pose of the
batch gives no hit that counts).  Noise comes from the run's seed, the
range noise from a torch.Generator on the device.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

_CHUNK = 131072  # rays a raycast block: (chunk, K) temporaries
_N_POSE = 64     # poses a scan


def log_so3(R: np.ndarray) -> np.ndarray:
    """(n, 3) rotation vectors of (n, 3, 3) rotations."""
    c = np.clip((np.trace(R, axis1=-2, axis2=-1) - 1) / 2, -1, 1)
    th = np.arccos(c)
    v = np.stack([R[:, 2, 1] - R[:, 1, 2], R[:, 0, 2] - R[:, 2, 0],
                  R[:, 1, 0] - R[:, 0, 1]], -1)
    k = np.where(th < 1e-8, 0.0, th / (2 * np.sin(np.maximum(th, 1e-8))))
    return k[:, None] * v


class Lidar:
    """Scans of one sensor in one scene along one route.

    `scene` is scene.Rects.arrays(), `route` a routes.* object; the other
    arguments are LidarImuSimulator's, and `phase_step` the azimuth offset
    a scan (its 0.7 rad)."""

    def __init__(self, scene: Dict[str, np.ndarray], route, device,
                 n_rays=4096, rings=16, scan_rate=10.0, imu_rate=200.0,
                 range_noise=0.01, max_range=60.0, accel_noise=0.02,
                 gyro_noise=0.002, gravity=9.81, ext_r=None, ext_t=None,
                 clockwise=False, phase_step=0.7):
        self.route, self.dev = route, torch.device(device)
        self.n_rays, self.rings = n_rays, rings
        self.scan_T, self.imu_dt = 1.0 / scan_rate, 1.0 / imu_rate
        self.range_noise, self.max_range = range_noise, max_range
        self.accel_noise, self.gyro_noise = accel_noise, gyro_noise
        self.g_vec = np.array([0.0, 0.0, -gravity])
        self.ext_r = np.eye(3) if ext_r is None else np.asarray(ext_r, float)
        self.ext_t = np.zeros(3) if ext_t is None else np.asarray(ext_t, float)
        self.sweep = -1.0 if clockwise else 1.0
        self.phase_step = phase_step
        self.scene = scene
        C = scene["C"]
        self._d0 = np.einsum("kj,kj->k", C, scene["N"])
        self._u0 = np.einsum("kj,kj->k", C, scene["T1"])
        self._v0 = np.einsum("kj,kj->k", C, scene["T2"])
        self._reach = np.hypot(scene["E1"], scene["E2"]).astype(float)
        i = np.arange(n_rays)
        el = np.deg2rad(np.linspace(-20, 5, rings))[i % rings]
        self._i = torch.as_tensor(i, dtype=torch.float64, device=self.dev)
        self._el = torch.as_tensor(el, dtype=torch.float64, device=self.dev)
        self.t_rel = torch.as_tensor(self.scan_T * i / n_rays,
                                     dtype=torch.float32, device=self.dev)
        self._pidx = torch.as_tensor(np.minimum(
            (self.scan_T * i / n_rays / self.scan_T * (_N_POSE - 1)).astype(
                int), _N_POSE - 1), device=self.dev)

    def _planes(self, near: np.ndarray) -> Dict[str, torch.Tensor]:
        """The scene's planes that can lie within max_range of a point of
        `near` (m, 3), on the device."""
        d = np.linalg.norm(self.scene["C"][:, None, :].astype(float)
                           - near[None], axis=-1).min(axis=1)
        keep = np.nonzero(d - self._reach <= self.max_range + 1.0)[0]
        f32 = dict(dtype=torch.float32, device=self.dev)
        out = {k: torch.as_tensor(self.scene[k][keep], **f32)
               for k in ("N", "T1", "T2", "E1", "E2")}
        for k, v in (("d0", self._d0), ("u0", self._u0), ("v0", self._v0)):
            out[k] = torch.as_tensor(v[keep], **f32)
        return out

    @staticmethod
    def raycast(o: torch.Tensor, d: torch.Tensor, pl) -> torch.Tensor:
        """Nearest bounded-plane hit range of each ray (f32) among the
        planes `pl`, inf if none."""
        out = torch.empty(o.shape[0], dtype=torch.float32, device=o.device)
        if pl["N"].shape[0] == 0:
            return out.fill_(float("inf"))
        inf = torch.tensor(float("inf"), device=o.device)

        def dot(x, A):  # (c, 3) · (K, 3) → (c, K), summed in axis order
            return (x[:, None, 0] * A[None, :, 0]
                    + x[:, None, 1] * A[None, :, 1]
                    + x[:, None, 2] * A[None, :, 2])

        for s in range(0, o.shape[0], _CHUNK):
            oc, dc = o[s:s + _CHUNK], d[s:s + _CHUNK]
            denom = dot(dc, pl["N"])
            num = pl["d0"][None] - dot(oc, pl["N"])
            ok = torch.abs(denom) > 1e-8
            t = num / torch.where(ok, denom, torch.ones_like(denom))
            ok &= t > 0.05
            tf = torch.where(ok, t, torch.zeros_like(t))
            u = (dot(oc, pl["T1"]) - pl["u0"][None]) + tf * dot(dc, pl["T1"])
            v = (dot(oc, pl["T2"]) - pl["v0"][None]) + tf * dot(dc, pl["T2"])
            ok &= (torch.abs(u) <= pl["E1"][None]) & (torch.abs(v)
                                                       <= pl["E2"][None])
            out[s:s + _CHUNK] = torch.where(ok, t, inf).amin(dim=1)
        return out

    def scans(self, ks: Sequence[int], phases: Sequence[float],
              gen: torch.Generator):
        """Scans k ∈ ks (starting at k·T) at the given azimuth phases, in
        one batch: (pts (B, n, 3) f32 in the LiDAR frame, hit (B, n)
        bool), rays in sweep order.  The range noise is drawn scan after
        scan."""
        B, n = len(ks), self.n_rays
        tg = (np.asarray(ks, float)[:, None] * self.scan_T
              + np.linspace(0, self.scan_T, _N_POSE)[None])
        Rg, pg = self.route.pose(tg.reshape(-1))
        R_lid = torch.as_tensor(Rg @ self.ext_r, device=self.dev).reshape(
            B, _N_POSE, 3, 3)
        p_np = pg + Rg @ self.ext_t
        p_lid = torch.as_tensor(p_np, device=self.dev).reshape(B, _N_POSE, 3)
        ph = torch.as_tensor(np.asarray(phases, float), device=self.dev)
        az = self.sweep * 2 * math.pi * (self._i / n)[None] + ph[:, None]
        el = self._el[None]
        d_b = torch.stack([torch.cos(el) * torch.cos(az),
                           torch.cos(el) * torch.sin(az),
                           torch.sin(el).expand_as(az)], -1)   # (B, n, 3)
        R_r = R_lid[:, self._pidx]                              # (B, n, 3, 3)
        d_w = torch.einsum("bnij,bnj->bni", R_r, d_b)
        o_w = p_lid[:, self._pidx]
        hit = self.raycast(o_w.reshape(-1, 3).float(),
                           d_w.reshape(-1, 3).float(),
                           self._planes(p_np)).reshape(B, n)
        ok = torch.isfinite(hit) & (hit < self.max_range)
        noise = torch.stack([torch.randn(n, generator=gen,
                                         dtype=torch.float64,
                                         device=self.dev) for _ in range(B)])
        rng = hit.double() + noise * self.range_noise
        return (d_b * rng[..., None]).float(), ok

    def imu(self, ks: Sequence[int], rng: np.random.Generator):
        """(stamps (m + 1,), acc, gyr (B, m + 1, 3)) over [k·T, (k + 1)·T]
        of each k ∈ ks, the noise drawn scan after scan."""
        m = int(round(self.scan_T / self.imu_dt))
        st = np.linspace(0.0, self.scan_T, m + 1)
        h = 1e-4
        t = (np.asarray(ks, float)[:, None] * self.scan_T + st[None]).ravel()
        Rm, pm = self.route.pose(t - h)
        R0, p0 = self.route.pose(t)
        Rp, pp = self.route.pose(t + h)
        a_w = (pp - 2 * p0 + pm) / h ** 2
        gyr = (log_so3(np.transpose(R0, (0, 2, 1)) @ Rp) / h).reshape(
            len(ks), m + 1, 3)
        acc = np.einsum("nji,nj->ni", R0, a_w - self.g_vec).reshape(
            len(ks), m + 1, 3)
        for b in range(len(ks)):
            acc[b] += rng.normal(size=acc[b].shape) * self.accel_noise
            gyr[b] += rng.normal(size=gyr[b].shape) * self.gyro_noise
        return st, acc, gyr

    def static_imu(self, n: int, rng: np.random.Generator):
        """n stationary IMU samples at the starting pose."""
        R0, _ = self.route.pose(np.array([0.0]))
        acc = np.tile(R0[0].T @ (-self.g_vec), (n, 1))
        acc = acc + rng.normal(size=acc.shape) * self.accel_noise
        gyr = rng.normal(size=(n, 3)) * self.gyro_noise
        return acc.astype(np.float32), gyr.astype(np.float32)
