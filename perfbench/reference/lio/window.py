"""Sliding-window plane BA between frames: a frozen plain copy of the port's
lio/window.py, with the window's crossing form.

Flow per window:
  1. `observe(rot, pos, world_scan, mask)` each frame gates keyframes by
     relative motion and stores a fixed-size body-frame point subset;
  2. when the window fills, `build_window_problem` re-associates every
     stored keyframe point against the current map planes
     (VoxelMap.query_planes, the plain hash probe), collapses the touched
     plane set to ≤ max_planes landmarks, and assembles odometry factors
     from the LIO's relative poses;
  3. `solve_window` refines poses + planes;
  4. the last keyframe's world-frame correction ΔT = T_ref ∘ T_odo⁻¹ is
     returned for the caller to left-apply to the live filter state, and
     the refined last keyframe seeds the next window (overlap of one).

Keyframe gating and the stored points stay on the host in numpy.

`Window` is the window as it crosses between the program and the reference
(step.py's flatten / unflatten): the keyframes stacked into tensors on the
host, the refinement count and the last window's cost (NaN before the
first).  `window_of` reads it off either side's WindowBA."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from perfbench.reference.config import ImMeshConfig
from perfbench.reference.dist.window_ba import WindowProblem, solve_window
from perfbench.reference.map.voxel_map import VoxelMap

_SENT = 1 << 30


def build_window_problem(vm: VoxelMap, rot: torch.Tensor, pos: torch.Tensor,
                         pts: torch.Tensor, mask: torch.Tensor,
                         odo_rot: torch.Tensor, odo_t: torch.Tensor,
                         w_rot: float, w_t: float,
                         max_planes: int) -> WindowProblem:
    """A WindowProblem from the live map.

    rot (K,3,3), pos (K,3): keyframe poses (the linearization points).
    pts (K,Np,3), mask (K,Np): stored body-frame keyframe points.
    odo_rot (K-1,3,3), odo_t (K-1,3): measured LIO relative poses.

    Landmarks are the ≤ max_planes distinct map planes hit by the window's
    points, the smallest slot ids first; points whose voxel has no plane,
    or whose plane is past the cap, get weight 0."""
    K, Np, _ = pts.shape
    dev = pts.device
    q = torch.einsum("kij,kpj->kpi", rot, pts) + pos[:, None, :]
    res = vm.query_planes(q.reshape(K * Np, 3))
    found = res["found"] & mask.reshape(-1)

    slot = torch.where(found, res["slot"], _SENT)
    present = torch.unique(slot)[:max_planes]        # sorted, SENT last
    uniq = torch.full((max_planes,), _SENT, dtype=slot.dtype, device=dev)
    uniq[:present.shape[0]] = present
    lid = torch.searchsorted(uniq, slot).to(torch.int32)
    lid = lid.clamp(0, max_planes - 1)
    ok = found & (uniq[lid.long()] == slot)
    plane_id = lid.reshape(K, Np)
    weight = ok.to(pts.dtype).reshape(K, Np)

    uvalid = uniq != _SENT
    us = torch.where(uvalid, uniq, 0).long()
    normal = vm.normal[us]
    d = torch.where(uvalid, vm.d[us], 0.0)

    Km1 = K - 1
    return WindowProblem(
        rot=rot, pos=pos, normal=normal, d=d, pts=pts,
        plane_id=plane_id, weight=weight, odo_rot=odo_rot, odo_t=odo_t,
        odo_w_rot=torch.full((Km1,), w_rot, dtype=pts.dtype, device=dev),
        odo_w_t=torch.full((Km1,), w_t, dtype=pts.dtype, device=dev),
    )


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@dataclasses.dataclass
class Window:
    """The window between frames: K keyframes of Np stored points."""
    rot: torch.Tensor    # (K, 3, 3) float32
    pos: torch.Tensor    # (K, 3)
    pts: torch.Tensor    # (K, Np, 3) body-frame points
    mask: torch.Tensor   # (K, Np) bool
    n_refinements: int
    last_cost: float     # NaN before the first refinement


def window_of(ba, pts_per_keyframe: int) -> Window:
    """The Window of a WindowBA (the program's or the reference's: both keep
    kf_rot, kf_pos, kf_pts, kf_mask host lists)."""
    def stack(xs, shape, dtype):
        a = np.stack(xs) if xs else np.zeros((0,) + shape, dtype)
        return torch.from_numpy(np.ascontiguousarray(a, dtype))
    n = pts_per_keyframe
    return Window(stack(ba.kf_rot, (3, 3), np.float32),
                  stack(ba.kf_pos, (3,), np.float32),
                  stack(ba.kf_pts, (n, 3), np.float32),
                  stack(ba.kf_mask, (n,), bool),
                  int(ba.n_refinements),
                  math.nan if ba.last_cost is None else float(ba.last_cost))


class WindowBA:
    """Host-side keyframe window manager around the window solver."""

    def __init__(self, cfg: ImMeshConfig, window: Optional[Window] = None):
        self.cfg = cfg
        self.bc = cfg.ba
        self.kf_rot: list = []
        self.kf_pos: list = []
        self.kf_pts: list = []
        self.kf_mask: list = []
        self.n_refinements = 0
        self.last_cost = None
        if window is not None:
            self.kf_rot = [r.numpy().copy() for r in window.rot]
            self.kf_pos = [p.numpy().copy() for p in window.pos]
            self.kf_pts = [p.numpy().copy() for p in window.pts]
            self.kf_mask = [m.numpy().copy() for m in window.mask]
            self.n_refinements = window.n_refinements
            self.last_cost = (None if math.isnan(window.last_cost)
                              else window.last_cost)

    def window(self) -> Window:
        return window_of(self, self.bc.pts_per_keyframe)

    # ------------------------------------------------------------------
    def _is_keyframe(self, rot: np.ndarray, pos: np.ndarray) -> bool:
        if not self.kf_rot:
            return True
        dp = np.linalg.norm(pos - self.kf_pos[-1])
        dR = self.kf_rot[-1].T @ rot
        ang = np.degrees(np.arccos(np.clip((np.trace(dR) - 1) / 2, -1, 1)))
        return (dp > self.bc.kf_trans_thresh
                or ang > self.bc.kf_rot_thresh_deg)

    def _sample_points(self, world_scan, mask, rot, pos):
        """Fixed-size body-frame subset of the frame's valid points."""
        Np = self.bc.pts_per_keyframe
        world = _host(world_scan)
        idx = np.nonzero(_host(mask))[0]
        if idx.size == 0:
            return np.zeros((Np, 3), np.float32), np.zeros(Np, bool)
        stride = max(1, idx.size // Np)
        sel = idx[::stride][:Np]
        body = (world[sel] - pos) @ rot  # R.T applied from the right
        out = np.zeros((Np, 3), np.float32)
        ok = np.zeros(Np, bool)
        out[:len(sel)] = body
        ok[:len(sel)] = True
        return out, ok

    # ------------------------------------------------------------------
    def observe(self, rot, pos, world_scan, mask,
                vm: VoxelMap) -> Optional[dict]:
        """Feed one frame's posterior pose + world scan (tensors or arrays).
        Returns the window correction dict once per filled window, else
        None."""
        rot = _host(rot)
        pos = _host(pos)
        if not self._is_keyframe(rot, pos):
            return None
        pts, pmask = self._sample_points(world_scan, mask, rot, pos)
        self.kf_rot.append(rot)
        self.kf_pos.append(pos)
        self.kf_pts.append(pts)
        self.kf_mask.append(pmask)
        if len(self.kf_rot) < self.bc.window_size:
            return None
        return self.refine(vm)

    def refine(self, vm: VoxelMap) -> dict:
        """Solve the current window on the map's device; slide it; return
        the feedback dict {"d_rot": ΔR (3,3), "d_pos": Δt (3,), "cost",
        "rot" (K,3,3), "pos" (K,3)} with ΔT = T_refined[-1] ∘
        T_odometry[-1]⁻¹ (world-frame left correction)."""
        bc = self.bc
        dev = vm.normal.device
        R_np = np.stack(self.kf_rot)
        p_np = np.stack(self.kf_pos)

        def dev_f32(a):
            a = np.ascontiguousarray(a, np.float32)
            return torch.from_numpy(a).to(dev)

        # measured LIO relative poses between consecutive keyframes
        odo_rot = np.einsum("kji,kjl->kil", R_np[:-1], R_np[1:])
        odo_t = np.einsum("kji,kj->ki", R_np[:-1], p_np[1:] - p_np[:-1])
        prob = build_window_problem(
            vm, dev_f32(R_np), dev_f32(p_np), dev_f32(np.stack(self.kf_pts)),
            torch.from_numpy(np.stack(self.kf_mask)).to(dev),
            dev_f32(odo_rot), dev_f32(odo_t), bc.odo_w_rot, bc.odo_w_t,
            bc.max_planes)
        sol = solve_window(prob, iterations=bc.iterations,
                           huber_delta=bc.huber_delta)

        rot_ref = _host(sol["rot"])
        pos_ref = _host(sol["pos"])
        R_ref, p_ref = rot_ref[-1], pos_ref[-1]
        d_rot = R_ref @ R_np[-1].T
        d_pos = p_ref - d_rot @ p_np[-1]
        self.n_refinements += 1
        self.last_cost = float(sol["cost"])

        # slide: the refined last keyframe anchors the next window
        self.kf_rot = [R_ref]
        self.kf_pos = [p_ref]
        self.kf_pts = [self.kf_pts[-1]]
        self.kf_mask = [self.kf_mask[-1]]
        return {"d_rot": d_rot, "d_pos": d_pos, "cost": self.last_cost,
                "rot": rot_ref, "pos": pos_ref}
