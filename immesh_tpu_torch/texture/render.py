"""Per-point RGB estimation — the texture-reconstruction path (SURVEY C26).

Port of immesh_tpu/texture/render.py (reference
src/meshing/r3live/pointcloud_rgbd.cpp: `RGB_pts::update_rgb` :126-195,
`render_pts_in_voxels` :554-605, `thread_render_pts_in_voxel` /
`render_pts_in_voxels_mp` :613-686).  The whole render is one batched
masked pass: project all candidate points, bilinear-sample the image, and
scatter a per-channel scalar-Kalman colour update into the colour store.
Per-point `if/continue` gates become boolean masks.

Behavior kept from the reference:
  * view-angle gate: skip points >30° off the optical axis, with angle
    floored at 5° and distance at 1 m for the observation noise
    (pointcloud_rgbd.cpp:641-650);
  * observation-distance gate: once colored, a point only accepts closer or
    similar-range views (`obs_dis > m_obs_dis * 1.1` skip, :138-141);
  * zero-color and over-exposure rejection (:128-136);
  * scalar Kalman per channel with process noise scaled by time since last
    observation (:159-166, "State estimation for robotics" §2.2.6), noise
    σ_obs = image_obs_cov · view_dis · view_angle (:652-653);
  * exposure-time normalization: colors are stored as radiance
    (pixel · inverse_exposure) and read back normalized by the running mean
    first-observation exposure (:100-103, :167-175, :190-193);
  * >255 renormalization (:167-175).

The JAX scatter drops the lanes that do not update (`mode="drop"`); here
`core.ops.set_drop` writes only those lanes.  The ids of one call are
distinct (one point per voxel slot), so the write order does not matter.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

import torch

from immesh_tpu_torch.core.ops import set_drop
from immesh_tpu_torch.device import resolve_device
from immesh_tpu_torch.texture.camera import (
    PinholeCamera, bilinear_sample, project_points)

IMAGE_OBS_COV = 1.5          # reference pointcloud_rgbd.cpp:119 image_obs_cov
PROCESS_NOISE_SIGMA = 0.15   # :121 process_noise_sigma
OVEREXPOSURE = 255.0         # :125 THRESHOLD_OVEREXPOSURE
MAX_VIEW_ANGLE_DEG = 30.0    # :647-650


@dataclass
class ColorStore:
    """SoA per-point color state, parallel to GlobalPointMap.pts.

    Fields mirror RGB_pts (reference pointcloud_rgbd.hpp:77-163) minus
    position (owned by the point map).
    """

    rgb: torch.Tensor        # (P, 3) f32 radiance (pixel · inv_exposure)
    cov: torch.Tensor        # (P, 3) f32 per-channel σ
    n_obs: torch.Tensor      # (P,) int32 observation count (m_N_rgb)
    obs_dis: torch.Tensor    # (P,) f32 closest observation distance
    last_obs_t: torch.Tensor  # (P,) f32 last observation time
    first_exp: torch.Tensor  # (P,) f32 running-mean first-obs inverse exposure

    @classmethod
    def create(cls, capacity: int, dtype=torch.float32,
               device="cuda") -> "ColorStore":
        dev = resolve_device(device)
        return cls(
            rgb=torch.zeros((capacity, 3), dtype=dtype, device=dev),
            cov=torch.zeros((capacity, 3), dtype=dtype, device=dev),
            n_obs=torch.zeros(capacity, dtype=torch.int32, device=dev),
            obs_dis=torch.zeros(capacity, dtype=dtype, device=dev),
            last_obs_t=torch.zeros(capacity, dtype=dtype, device=dev),
            first_exp=torch.ones(capacity, dtype=dtype, device=dev),
        )

    def colors_u8(self) -> torch.Tensor:
        """(P, 3) display colors in [0, 255]: radiance / first exposure
        (reference get_rgb, pointcloud_rgbd.cpp:96-99)."""
        c = self.rgb / torch.clamp(self.first_exp[:, None], min=1e-6)
        return torch.clamp(c, 0.0, 255.0)


def render_points(store: ColorStore, pts_w: torch.Tensor, ids: torch.Tensor,
                  mask: torch.Tensor, img: torch.Tensor, cam: PinholeCamera,
                  R_w2c: torch.Tensor, t_w2c: torch.Tensor,
                  obs_time, inv_exposure) -> Tuple[ColorStore, torch.Tensor]:
    """Fuse one image into the color store for candidate points.

    pts_w: (N, 3) world positions; ids: (N,) rows into the store; mask: (N,).
    Returns (new_store, n_rendered as a device scalar); `store` is left as
    it was.  obs_time and inv_exposure are f32 scalars (numbers or 0-d
    tensors).
    """
    def f32(x):
        return torch.as_tensor(x, dtype=pts_w.dtype, device=pts_w.device)

    obs_time, inv_exposure = f32(obs_time), f32(inv_exposure)
    cam_pos = -R_w2c.T @ t_w2c                     # camera center in world
    optical_axis = R_w2c[2]                        # world-frame +z of camera

    uv, _, in_img = project_points(pts_w, R_w2c, t_w2c, cam)
    view_vec = pts_w - cam_pos
    view_dis = torch.linalg.vector_norm(view_vec, dim=-1)
    cosang = (view_vec * optical_axis).sum(-1) / (view_dis + 1e-4)
    view_angle = torch.rad2deg(torch.arccos(cosang.clamp(-1.0, 1.0)))
    ok = mask & in_img & (view_angle <= MAX_VIEW_ANGLE_DEG)

    rgb_obs = bilinear_sample(img, uv)             # (N, 3) in [0,255]
    # zero-color (under-exposure) and over-exposure rejection (:128-136)
    ok = ok & (torch.linalg.vector_norm(rgb_obs, dim=-1) > 0)
    ok = ok & ~(rgb_obs > OVEREXPOSURE).all(-1)

    P = store.rgb.shape[0]
    sid = ids.long().clamp(0, P - 1)
    n_obs = store.n_obs[sid]
    prev_dis = store.obs_dis[sid]
    # once observed, only accept similar-or-closer views (:138-141)
    ok = ok & ((n_obs == 0) | (view_dis <= prev_dis * 1.1))

    # observation noise grows with range and obliquity (:641-653)
    ang = torch.clamp(view_angle, min=5.0)
    dis = torch.clamp(view_dis, min=1.0)
    obs_sigma = (IMAGE_OBS_COV * dis * ang)[:, None]

    first = ok & (n_obs == 0)
    update = ok & (n_obs > 0)

    # ---- Kalman fusion in radiance units (:144-166) ----------------------
    rgb_old, cov_old = store.rgb[sid], store.cov[sid]
    old_cov = cov_old + PROCESS_NOISE_SIGMA * torch.clamp(
        obs_time - store.last_obs_t[sid], min=0.0)[:, None]
    old_cov = torch.clamp(old_cov, min=1e-6)
    new_var = 1.0 / (1.0 / old_cov ** 2 + 1.0 / obs_sigma ** 2)
    obs_rad = rgb_obs * inv_exposure
    fused = new_var * (rgb_old / old_cov ** 2 + obs_rad / obs_sigma ** 2)
    new_cov = torch.sqrt(new_var)

    rgb_new = torch.where(update[:, None], fused,
                          torch.where(first[:, None], obs_rad, rgb_old))
    cov_new = torch.where(update[:, None], new_cov,
                          torch.where(first[:, None], obs_sigma, cov_old))

    # >255 display renormalization (:167-175)
    fe_old = store.first_exp[sid]
    n_f = n_obs.to(pts_w.dtype)
    first_exp_new = torch.where(
        first, inv_exposure,
        torch.where(update, (fe_old * (n_f + 1) + inv_exposure) / (n_f + 2),
                    fe_old))
    disp_max = rgb_new.amax(-1) / torch.clamp(first_exp_new, min=1e-6)
    # a tensor numerator: a Python scalar over a tensor would round as a
    # reciprocal times the scalar, not as one division
    scale = torch.where(disp_max > 255.0,
                        f32(254.999) / torch.clamp(disp_max, min=1e-6),
                        f32(1.0))
    rgb_new = rgb_new * torch.where(ok, scale, f32(1.0))[:, None]

    dis_new = torch.where(first, view_dis,
                          torch.where(update, torch.minimum(prev_dis, view_dis),
                                      prev_dis))
    t_new = torch.where(ok, obs_time, store.last_obs_t[sid])
    cnt_new = n_obs + ok.to(torch.int32)

    new = {}
    for name, val in (("rgb", rgb_new), ("cov", cov_new), ("n_obs", cnt_new),
                      ("obs_dis", dis_new), ("last_obs_t", t_new),
                      ("first_exp", first_exp_new)):
        dst = getattr(store, name).clone()
        set_drop(dst, sid, val, ok)
        new[name] = dst
    return dataclasses.replace(store, **new), ok.sum(dtype=torch.int32)


def render_active_voxels(store: ColorStore, gm, slots: torch.Tensor,
                         smask: torch.Tensor, img: torch.Tensor,
                         cam: PinholeCamera, R_w2c: torch.Tensor,
                         t_w2c: torch.Tensor, obs_time, inv_exposure=1.0
                         ) -> Tuple[ColorStore, torch.Tensor]:
    """Colorize the points of the recently-visited voxels of a GlobalPointMap
    (the reference renders `m_voxels_recent_visited`,
    pointcloud_rgbd.cpp:676-686).  `slots`/`smask` is the active-voxel work
    list produced by GlobalPointMap.append_frame — same set the mesher uses,
    keeping candidate count static (A × pts_per_voxel)."""
    own = gm.vox_pt_idx[slots.long().clamp(min=0)]
    ids = torch.where(smask[:, None], own, torch.full_like(own, -1))
    ids = ids.reshape(-1)
    mask = ids >= 0
    ids = ids.clamp(min=0)
    pts = gm.pts[ids.long()]
    return render_points(store, pts, ids, mask, img, cam, R_w2c, t_w2c,
                         obs_time, inv_exposure)
