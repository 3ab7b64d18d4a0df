"""Trajectories: the body pose (R (n, 3, 3), p (n, 3)) at an array of times.

`Forward` and `Orbit` follow immesh_tpu_torch/frontend/sim.py's
ForwardTrajectory and Trajectory; `Loop` drives ForwardTrajectory's weave
and sway round a closed rounded rectangle (RoundedLoop).  All start at rest and reach
their speed through the same quadratic launch ramp (`warp`), so the filter's
static start holds."""

from __future__ import annotations

import numpy as np


def warp(t: np.ndarray, t_ramp: float) -> np.ndarray:
    """Time through the quadratic ramp: at rest at 0, full speed from
    t_ramp on (frontend/sim.py's _warp)."""
    t = np.asarray(t, float)
    return np.where(t <= 0, 0.0, np.where(t < t_ramp, t * t / (2 * t_ramp),
                                          t - t_ramp / 2))


def rot_zyx(yaw, pitch, roll) -> np.ndarray:
    """(n, 3, 3) Rz(yaw) · Ry(pitch) · Rx(roll)."""
    yaw, pitch, roll = (np.broadcast_to(np.asarray(a, float),
                                        np.shape(yaw)) for a in
                        (yaw, pitch, roll))
    cy, sy = np.cos(yaw), np.sin(yaw)
    cp, sp = np.cos(pitch), np.sin(pitch)
    cr, sr = np.cos(roll), np.sin(roll)
    o, z = np.ones_like(cy), np.zeros_like(cy)
    Rz = np.stack([cy, -sy, z, sy, cy, z, z, z, o], -1).reshape(-1, 3, 3)
    Ry = np.stack([cp, z, sp, z, o, z, -sp, z, cp], -1).reshape(-1, 3, 3)
    Rx = np.stack([o, z, z, z, cr, -sr, z, sr, cr], -1).reshape(-1, 3, 3)
    return Rz @ Ry @ Rx


class Orbit:
    """A circle with a vertical bob and attitude sway (Trajectory); `bob`,
    `pitch` and `roll` are the multiples of omega that frontend/sim.py
    fixes at 2.3, 1.7 and 2.9."""

    def __init__(self, radius=5.0, omega=0.35, z0=1.5, z_amp=0.3, sway=0.04,
                 t_ramp=2.0, bob=2.3, pitch=1.7, roll=2.9):
        self.r, self.w, self.z0, self.za, self.sway = (radius, omega, z0,
                                                       z_amp, sway)
        self.t_ramp, self.k = t_ramp, (bob, pitch, roll)

    def pose(self, t):
        wt = self.w * warp(t, self.t_ramp)
        p = np.stack([self.r * np.cos(wt), self.r * np.sin(wt),
                      self.z0 + self.za * np.sin(self.k[0] * wt)], -1)
        return rot_zyx(wt + np.pi / 2, self.sway * np.sin(self.k[1] * wt),
                       self.sway * np.cos(self.k[2] * wt)), p


class Forward:
    """Forward driving along +x with a 1 − cos lateral weave, its yaw, and
    a small sway (ForwardTrajectory)."""

    def __init__(self, speed=9.0, z0=1.7, weave_amp=0.8, weave_freq=0.02,
                 sway=0.01, t_ramp=2.0):
        self.v, self.z0, self.wa, self.wf = speed, z0, weave_amp, weave_freq
        self.sway, self.t_ramp = sway, t_ramp

    def pose(self, t):
        s = self.v * warp(t, self.t_ramp)
        w = 2 * np.pi * self.wf
        yv = self.wa * (1.0 - np.cos(w * s))
        p = np.stack([s, yv, self.z0 + 0.05 * np.sin(0.9 * w * s)], -1)
        return rot_zyx(np.arctan(self.wa * w * np.sin(w * s)),
                       self.sway * np.sin(1.3 * w * s),
                       self.sway * (1.0 - np.cos(2.1 * w * s))), p


class RoundedLoop:
    """A closed counter-clockwise centre line: straights of a (along x) and
    b (along y) joined by quarter circles of radius rc.  Arc length 0 is
    the middle of the bottom straight, at the origin, heading +x.  The line
    is integrated on a 5 cm grid and interpolated."""

    STEP = 0.05

    def __init__(self, a: float, b: float, rc: float):
        self.a, self.b, self.rc = a, b, rc
        corner = [(np.pi * rc / 2, "arc")]
        pieces = [(a / 2, "s")] + corner + [(b, "s")] + corner + \
            [(a, "s")] + corner + [(b, "s")] + corner + [(a / 2, "s")]
        self.pieces, s0 = [], 0.0
        for ln, kind in pieces:
            self.pieces.append((s0, s0 + ln, kind))
            s0 += ln
        self.length = s0
        n = int(np.ceil(self.length / self.STEP))
        self._s = np.linspace(0.0, self.length, n + 1)
        h = self.heading(self._s)
        # each step's displacement integrated exactly for its linear
        # heading: the loop closes to rounding
        dh, ds = np.diff(h), np.diff(self._s)
        turn = np.abs(dh) > 1e-12
        safe = np.where(turn, dh, 1.0)
        dx = np.where(turn, (np.sin(h[1:]) - np.sin(h[:-1])) / safe,
                      np.cos(h[:-1])) * ds
        dy = np.where(turn, (np.cos(h[:-1]) - np.cos(h[1:])) / safe,
                      np.sin(h[:-1])) * ds
        self._p = np.stack([np.concatenate([[0.0], np.cumsum(dx)]),
                            np.concatenate([[0.0], np.cumsum(dy)])], -1)
        self._h = h

    def heading(self, s) -> np.ndarray:
        """The centre line's heading at arc lengths s ∈ [0, length], piece
        by piece in closed form."""
        s = np.asarray(s, float)
        h = np.zeros(s.shape)
        h0 = 0.0
        for s0, s1, kind in self.pieces:
            m = (s >= s0) & (s <= s1)
            h[m] = h0 + ((s[m] - s0) / self.rc if kind == "arc" else 0.0)
            h0 += (s1 - s0) / self.rc if kind == "arc" else 0.0
        return h

    def centre(self, s):
        """(p (n, 2), heading (n,)) at arc lengths s (taken mod length)."""
        s = np.mod(np.asarray(s, float), self.length)
        p = np.stack([np.interp(s, self._s, self._p[:, 0]),
                      np.interp(s, self._s, self._p[:, 1])], -1)
        return p, np.interp(s, self._s, self._h)

    def straight(self, s0: float, s1: float) -> bool:
        """Whether [s0, s1] lies on one straight."""
        return any(kind == "s" and a <= s0 and s1 <= b
                   for a, b, kind in self.pieces)

    def inner_room(self, s: float) -> float:
        """Distance from the centre line at s to the loop's middle line."""
        _, h = self.centre(np.array([s]))
        lo, hi = self.bounds()
        along_x = abs(np.cos(h[0])) > 0.5
        return (hi[1] - lo[1]) / 2 if along_x else (hi[0] - lo[0]) / 2

    def bounds(self):
        return self._p.min(axis=0), self._p.max(axis=0)


class Loop:
    """Driving a RoundedLoop at `speed` with Forward's weave (an amplitude
    and `weaves` whole periods a lap), bob and sway, so the pose repeats
    exactly every lap."""

    def __init__(self, loop: RoundedLoop, speed: float, z0=1.7,
                 weave_amp=0.8, weaves=14, sway=0.01, t_ramp=2.0,
                 bob=13, pitch=18, roll=29):
        self.loop, self.v, self.z0, self.wa = loop, speed, z0, weave_amp
        self.n, self.sway, self.t_ramp = weaves, sway, t_ramp
        self.k = (bob, pitch, roll)

    def pose(self, t):
        s = self.v * warp(t, self.t_ramp)
        L = self.loop.length
        w = 2 * np.pi * self.n / L
        c, head = self.loop.centre(s)
        lat = self.wa * (1.0 - np.cos(w * s))
        nrm = np.stack([-np.sin(head), np.cos(head)], -1)
        xy = c + lat[..., None] * nrm
        kz, kp, kr = (2 * np.pi * k / L for k in self.k)
        p = np.concatenate([xy, (self.z0 + 0.05 * np.sin(kz * s))[..., None]],
                           -1)
        yaw = head + np.arctan(self.wa * w * np.sin(w * s))
        return rot_zyx(yaw, self.sway * np.sin(kp * s),
                       self.sway * (1.0 - np.cos(kr * s))), p
