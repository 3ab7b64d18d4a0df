"""Scenes of bounded plane patches, as (K,)-row arrays.

`room` and `street` follow immesh_tpu_torch/frontend/sim.py's
default_scene and outdoor_scene draw for draw; `street_loop` lays
outdoor_scene's facades and parked boxes along a closed route
(routes.RoundedLoop) instead of a straight road."""

from __future__ import annotations

from typing import Dict, List

import numpy as np

_Z = np.array([0.0, 0.0, 1.0])
_X = np.array([1.0, 0.0, 0.0])
_Y = np.array([0.0, 1.0, 0.0])


class Rects:
    """Bounded planes: centre, unit normal, tangent axes, half extents."""

    def __init__(self):
        self.rows: List[tuple] = []

    def add(self, c, n, t1, t2, e1, e2) -> None:
        self.rows.append((np.asarray(c, float), np.asarray(n, float),
                          np.asarray(t1, float), np.asarray(t2, float),
                          float(e1), float(e2)))

    def box(self, c_xy, heading: float, hw: float, hh: float) -> None:
        """A box of half width hw and height 2·hh standing on the ground at
        c_xy, its faces along `heading` and across it, and its lid."""
        f = np.array([np.cos(heading), np.sin(heading), 0.0])
        g = np.array([-np.sin(heading), np.cos(heading), 0.0])
        c = np.array([c_xy[0], c_xy[1], hh / 2])
        for n, t in ((f, g), (g, f)):
            for s in (1.0, -1.0):
                self.add(c + s * n * hw, s * n, t, _Z, hw, hh / 2)
        self.add(np.array([c_xy[0], c_xy[1], hh]), _Z, f, g, hw, hw)

    def arrays(self) -> Dict[str, np.ndarray]:
        """{"C", "N", "T1", "T2": (K, 3); "E1", "E2": (K,)} in float32."""
        cols = list(zip(*self.rows))
        out = {k: np.stack(v).astype(np.float32)
               for k, v in zip(("C", "N", "T1", "T2"), cols[:4])}
        out["E1"] = np.array(cols[4], np.float32)
        out["E2"] = np.array(cols[5], np.float32)
        return out


def room(extent: float = 12.0, height: float = 5.0) -> Rects:
    """A closed room: floor, four walls, two boxes (default_scene)."""
    r = Rects()
    r.add([0.0, 0.0, 0.0], _Z, _X, _Y, extent, extent)
    r.add([extent, 0, height / 2], -_X, _Y, _Z, extent, height / 2)
    r.add([-extent, 0, height / 2], _X, _Y, _Z, extent, height / 2)
    r.add([0, extent, height / 2], -_Y, _X, _Z, extent, height / 2)
    r.add([0, -extent, height / 2], _Y, _X, _Z, extent, height / 2)
    r.box((4.0, -3.0), 0.0, 1.0, 2.0)
    r.box((-5.0, 4.0), 0.0, 1.5, 1.5)
    return r


def street(length: float = 400.0, half_width: float = 12.0,
           seed: int = 3) -> Rects:
    """outdoor_scene: a straight street canyon along +x."""
    rng = np.random.default_rng(seed)
    r = Rects()
    r.add([length / 2, 0.0, 0.0], _Z, _X, _Y, length / 2 + 30.0,
          half_width + 30.0)
    for side in (-1.0, 1.0):
        s = -20.0
        while s < length + 20.0:
            seg = rng.uniform(12.0, 30.0)
            gap = rng.uniform(0.0, 8.0)
            h = rng.uniform(5.0, 14.0)
            off = half_width + rng.uniform(0.0, 6.0)
            r.add([s + seg / 2, side * off, h / 2], -side * _Y, _X, _Z,
                  seg / 2, h / 2)
            s += seg + gap
    for _ in range(16):
        cx = rng.uniform(5.0, length)
        cy = rng.uniform(-1.0, 1.0) * (half_width - 4.0)
        hw = rng.uniform(0.8, 1.6)
        hh = rng.uniform(0.8, 1.8)
        r.box((cx, cy), 0.0, hw, hh)
    return r


def street_loop(route, half_width: float = 12.0, boxes_per_m: float = 0.04,
                clear=(-0.5, 2.1), seed: int = 3) -> Rects:
    """outdoor_scene's street canyon bent round a closed route: on each side
    facades of 12-30 m with gaps of 0-8 m, 5-14 m high, set back 0-6 m
    behind `half_width`, each a plane tangent to the route at its middle;
    boxes_per_m parked boxes (outdoor_scene's 16 in 400 m), 0.8-1.6 m half
    wide and 0.8-1.8 m high, their centres up to half_width − 4 m either
    side of the centre line, as there, but none across the band `clear`
    (offsets from the centre line) that the route's weave sweeps: a box
    that would cross it is drawn again.  On the inner side a facade stands
    only along a straight and clear of the loop's middle
    (route.inner_room), so the inside of a tight loop is an open square."""
    rng = np.random.default_rng(seed)
    L = route.length
    r = Rects()
    lo, hi = route.bounds()
    mid = (lo + hi) / 2
    ext = (hi - lo) / 2 + 40.0
    r.add([mid[0], mid[1], 0.0], _Z, _X, _Y, ext[0], ext[1])
    for side in (-1.0, 1.0):  # −1: right (outer), +1: left (inner)
        s = 0.0
        while s < L:
            seg = rng.uniform(12.0, 30.0)
            gap = rng.uniform(0.0, 8.0)
            h = rng.uniform(5.0, 14.0)
            off = half_width + rng.uniform(0.0, 6.0)
            s_end = min(s + seg, L)
            if side < 0 or (route.straight(s, s_end)
                            and off + 2.0 < route.inner_room(s)):
                sm = (s + s_end) / 2
                p, head = route.centre(np.array([sm]))
                t = np.array([np.cos(head[0]), np.sin(head[0]), 0.0])
                n = np.array([-np.sin(head[0]), np.cos(head[0]), 0.0])
                c = np.array([p[0, 0], p[0, 1], 0.0]) + side * off * n
                c[2] = h / 2
                r.add(c, -side * n, t, _Z, (s_end - s) / 2, h / 2)
            s += seg + gap
    for _ in range(int(round(boxes_per_m * L))):
        while True:
            sb = rng.uniform(0.0, L)
            off = rng.uniform(-1.0, 1.0) * (half_width - 4.0)
            hw = rng.uniform(0.8, 1.6)
            hh = rng.uniform(0.8, 1.8)
            if off + hw < clear[0] or off - hw > clear[1]:
                break
        p, head = route.centre(np.array([sb]))
        n = np.array([-np.sin(head[0]), np.cos(head[0])])
        r.box(p[0, :2] + off * n, head[0], hw, hh)
    return r
