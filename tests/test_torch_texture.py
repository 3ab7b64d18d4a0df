"""Port parity of the texture path: immesh_tpu_torch.texture against
immesh_tpu.texture on the same inputs (made from a seed with numpy).

Tolerances, with their reasons:
  * projection, sampling and grey conversion: 1e-5 relative (pixels and
    colours are O(100); XLA:CPU and PyTorch round the 3×3 product and the
    bilinear weights in another order or with FMAs, ROADMAP queue 3 item 6);
  * ColorStore fields after render_points: 1e-5 relative plus 1e-6
    absolute (the reference's jitted Kalman update contracts multiply-adds
    into FMAs and takes XLA's arccos; the port rounds every op); counts
    and n_rendered EXACT: the gate cases are built with margins, and on
    the random batch no decision falls within ulps of its threshold (0
    exceptions on these inputs, so none is allowed);
  * the pyramid: EXACT (shifted sums in the reference's order, eager ops);
  * LK flows: 1e-3 px (ten Gauss-Newton updates on 441-pixel sums in
    another order); status EXACT on features whose min-eigenvalue test
    is not within 1e-3 relative of its threshold (the count of such
    borderline features is asserted to be 0 on these inputs).
"""

import dataclasses
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from immesh_tpu.config import PRESETS as JPRESETS
from immesh_tpu.core.so3 import exp as jso3_exp
from immesh_tpu.mesh.pipeline import MeshPipeline as JMeshPipe
from immesh_tpu.runtime.export import save_ply as jsave_ply
from immesh_tpu.texture import camera as jcam
from immesh_tpu.texture import optical_flow as jof
from immesh_tpu.texture import render as jrender
from immesh_tpu.texture.pipeline import TexturePipeline as JTex
from immesh_tpu_torch import interop
from immesh_tpu_torch.config import ImMeshConfig as TConfig
from immesh_tpu_torch.mesh.pipeline import MeshPipeline as TMeshPipe
from immesh_tpu_torch.runtime.export import load_ply, save_ply
from immesh_tpu_torch.texture import camera as tcam
from immesh_tpu_torch.texture import optical_flow as tof
from immesh_tpu_torch.texture import render as trender
from immesh_tpu_torch.texture.pipeline import TexturePipeline as TTex

RTOL = 1e-5
FLOW_ATOL = 1e-3

JCAM = jcam.PinholeCamera.create(fx=200.0, fy=200.0, cx=160.0, cy=120.0,
                                 width=320, height=240)
TCAM = tcam.PinholeCamera.create(fx=200.0, fy=200.0, cx=160.0, cy=120.0,
                                 width=320, height=240)
EYE = np.eye(3, dtype=np.float32)
ZERO = np.zeros(3, np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(j, t, rtol=RTOL, atol=1e-6):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol)


def _pose(seed):
    rng = np.random.default_rng(seed)
    R = np.asarray(jso3_exp(jnp.asarray(rng.normal(0, 0.2, 3),
                                        jnp.float32)))
    return R.astype(np.float32), rng.normal(0, 0.3, 3).astype(np.float32)


def _image(rng, h=240, w=320, c=3):
    """A smooth random image in (0, 255): (h, w, c), or (h, w) if c is
    None."""
    from scipy.ndimage import gaussian_filter
    shape = (h, w) if c is None else (h, w, c)
    img = rng.uniform(0, 255, shape)
    img = gaussian_filter(img, 2.0 if c is None else (2.0, 2.0, 0))
    return np.clip(img, 5, 250).astype(np.float32)


# ---------------------------------------------------------------------------
# camera
# ---------------------------------------------------------------------------
def test_pinhole_camera_fields_match_reference():
    K = np.array([[863.0, 0, 640.5], [0, 861.5, 511.0], [0, 0, 1]])
    j = jcam.PinholeCamera.from_K(K, 1280, 1024)
    t = tcam.PinholeCamera.from_K(K, 1280, 1024)
    for f in ("fx", "fy", "cx", "cy", "gamma0", "gamma1"):
        assert np.float32(getattr(j, f)) == np.float32(getattr(t, f)), f
    assert (j.width, j.height) == (t.width, t.height) == (1280, 1024)


@pytest.mark.parametrize("seed", [0, 1])
def test_project_points_matches_reference(seed):
    rng = np.random.default_rng(seed)
    R, tv = _pose(seed)
    pts = rng.uniform(-3, 3, (500, 3)).astype(np.float32)
    pts[:, 2] += 3.0
    pts[:5] = [[0, 0, -1], [0, 0, 1e-7], [50, 0, 1], [0.0, 0.0, 2.0],
               [0.6, 0.45, 1.0]]
    juv, jz, jok = jcam.project_points(jnp.asarray(pts), jnp.asarray(R),
                                       jnp.asarray(tv), JCAM)
    tuv, tz, tok = tcam.project_points(_t(pts), _t(R), _t(tv), TCAM)
    _close(juv, tuv, atol=1e-3)
    _close(jz, tz)
    np.testing.assert_array_equal(np.asarray(jok), tok.numpy())
    assert 50 < int(tok.sum()) < 500


def test_bilinear_and_gradient_sampling_match_reference():
    rng = np.random.default_rng(2)
    img = _image(rng)
    uv = np.stack([rng.uniform(-5, 330, 400), rng.uniform(-5, 250, 400)],
                  -1).astype(np.float32)
    uv[:4] = [[0, 0], [319, 239], [2.0, 1.0], [0.5, 0.5]]
    _close(jcam.bilinear_sample(jnp.asarray(img), jnp.asarray(uv)),
           tcam.bilinear_sample(_t(img), _t(uv)))
    for a, b in zip(jcam.sample_with_gradient(jnp.asarray(img),
                                              jnp.asarray(uv)),
                    tcam.sample_with_gradient(_t(img), _t(uv))):
        _close(a, b, atol=1e-3)
    gray = np.arange(12, dtype=np.float32).reshape(3, 4, 1)
    assert float(tcam.bilinear_sample(_t(gray), _t(np.float32(
        [[2.0, 1.0]])))[0, 0]) == 6.0


def test_to_gray_matches_reference():
    img = _image(np.random.default_rng(3))
    _close(jcam.to_gray(jnp.asarray(img)), tcam.to_gray(_t(img)))


# ---------------------------------------------------------------------------
# render_points
# ---------------------------------------------------------------------------
def _stores(n, rng=None):
    """An empty store, or (with rng) one with a mix of observed and
    unobserved points, identical in both packages."""
    j = jrender.ColorStore.create(n)
    if rng is not None:
        seen = rng.random(n) < 0.5
        j = j.replace(
            rgb=jnp.asarray(np.where(seen[:, None], rng.uniform(
                10, 240, (n, 3)), 0).astype(np.float32)),
            cov=jnp.asarray(np.where(seen[:, None], rng.uniform(
                1, 50, (n, 3)), 0).astype(np.float32)),
            n_obs=jnp.asarray(np.where(seen, rng.integers(1, 9, n), 0)
                              .astype(np.int32)),
            obs_dis=jnp.asarray(np.where(seen, rng.uniform(1, 6, n), 0)
                                .astype(np.float32)),
            last_obs_t=jnp.asarray(np.where(seen, rng.uniform(0, 1, n), 0)
                                   .astype(np.float32)),
            first_exp=jnp.asarray(np.where(seen, rng.uniform(0.5, 2, n), 1)
                                  .astype(np.float32)))
    t = interop.from_reference({"colors": _tree(j)}, None,
                               device="cpu")["colors"]
    return j, t


def _tree(store):
    return {f.name: np.asarray(getattr(store, f.name))
            for f in dataclasses.fields(store)}


def _same_store(j, t):
    got = interop.to_numpy(t)
    for name, want in _tree(j).items():
        if want.dtype.kind in "iub":
            np.testing.assert_array_equal(got[name], want, name)
        else:
            np.testing.assert_allclose(got[name], want, rtol=RTOL,
                                       atol=1e-6, err_msg=name)


def _render_both(stores, pts, img, t=0.0, ids=None, mask=None, R=EYE,
                 tvec=ZERO, inv_exp=1.0):
    n = len(pts)
    ids = np.arange(n, dtype=np.int32) if ids is None else ids
    mask = np.ones(n, bool) if mask is None else mask
    js, ts = stores
    js, jn = jrender.render_points(
        js, jnp.asarray(pts, jnp.float32), jnp.asarray(ids),
        jnp.asarray(mask), jnp.asarray(img), JCAM, jnp.asarray(R),
        jnp.asarray(tvec), jnp.float32(t), jnp.float32(inv_exp))
    ts, tn = trender.render_points(
        ts, _t(np.asarray(pts, np.float32)), _t(ids), _t(mask), _t(img),
        TCAM, _t(R), _t(tvec), t, inv_exp)
    assert int(jn) == int(tn)
    _same_store(js, ts)
    return (js, ts), int(tn)


def _const(rgb, h=240, w=320):
    return np.broadcast_to(np.asarray(rgb, np.float32), (h, w, 3)).copy()


ONE = np.asarray([[0.0, 0.0, 2.0]], np.float32)


def test_render_first_observation_matches_reference():
    st, n = _render_both(_stores(8), ONE, _const([120, 80, 40]))
    assert n == 1
    np.testing.assert_allclose(st[1].colors_u8()[0].numpy(), [120, 80, 40],
                               atol=1e-3)


def test_render_kalman_updates_match_reference():
    """A wrong first colour, then 30 views of the true one (reference
    update_rgb, pointcloud_rgbd.cpp:144-166): every step's store agrees."""
    st, _ = _render_both(_stores(8), ONE, _const([10, 10, 10]), t=0.0)
    for k in range(30):
        st, n = _render_both(st, ONE, _const([200, 100, 50]),
                             t=0.1 * (k + 1))
        assert n == 1
    assert int(st[1].n_obs[0]) == 31
    assert np.all(np.abs(st[1].colors_u8()[0].numpy() - [200, 100, 50]) < 15)


def test_render_view_angle_gate_matches_reference():
    pts = np.asarray([[0.75, 0.0, 1.0], [0.5, 0.0, 1.0]], np.float32)
    _, n = _render_both(_stores(8), pts, _const([100, 100, 100]))
    assert n == 1        # 36.9° skipped, 26.6° kept


def test_render_distance_gate_matches_reference():
    st, _ = _render_both(_stores(8), ONE, _const([50, 50, 50]), t=0.0)
    st, n = _render_both(st, ONE, _const([250, 250, 250]), t=1.0,
                         tvec=np.asarray([0.0, 0.0, 4.0], np.float32))
    assert n == 0
    st, n = _render_both(st, ONE, _const([250, 250, 250]), t=2.0,
                         tvec=np.asarray([0.0, 0.0, 0.1], np.float32))
    assert n == 1        # 2.1 m ≤ 1.1 × 2 m: accepted


def test_render_zero_and_overexposure_gates_match_reference():
    st, n0 = _render_both(_stores(8), ONE, _const([0, 0, 0]))
    st, n1 = _render_both(st, ONE, _const([256, 256, 256]))
    st, n2 = _render_both(st, ONE, _const([256, 256, 100]))
    assert (n0, n1, n2) == (0, 0, 1)


def test_render_exposure_normalisation_matches_reference():
    st, _ = _render_both(_stores(8), ONE, _const([100, 100, 100]),
                         inv_exp=2.0)
    np.testing.assert_allclose(st[1].colors_u8()[0].numpy(), 100, atol=1e-3)
    # a brighter exposure pushes the fused radiance past 255 display units:
    # renormalized to 254.999 (:167-175)
    st, _ = _render_both(_stores(8), ONE, _const([250, 250, 250]))
    st, _ = _render_both(st, ONE, _const([250, 250, 250]), t=0.1,
                         inv_exp=10.0)
    np.testing.assert_allclose(st[1].colors_u8()[0].numpy(), 254.999,
                               rtol=1e-6)


def test_render_random_batch_matches_reference():
    """400 candidates over a part-observed store: mask, ids scattered in a
    larger store, every gate mixed in one call, a posed camera."""
    rng = np.random.default_rng(5)
    n, cap = 400, 1000
    R, tv = _pose(5)
    pts = rng.uniform(-2.5, 2.5, (n, 3)).astype(np.float32)
    pts[:, 2] += 3.5
    pts = (pts - tv) @ R          # so that R p + t lands in front
    ids = rng.permutation(cap)[:n].astype(np.int32)
    mask = rng.random(n) < 0.9
    img = _image(rng)
    img[:40] = 0.0                 # zero-colour band
    img[200:] = 300.0              # over-exposed band
    st = _stores(cap, rng)
    st, n1 = _render_both(st, pts, img, t=1.5, ids=ids, mask=mask, R=R,
                          tvec=tv, inv_exp=1.3)
    st, n2 = _render_both(st, pts + 0.01, img, t=2.0, ids=ids, mask=mask,
                          R=R, tvec=tv, inv_exp=0.8)
    assert 50 < n1 < n and 50 < n2 < n


# ---------------------------------------------------------------------------
# optical flow
# ---------------------------------------------------------------------------
def _texture(rng, h=96, w=128):
    return _image(rng, h, w, c=None)


def test_build_pyramid_matches_reference_exactly():
    img = _texture(np.random.default_rng(6), 97, 131)
    for a, b in zip(jof.build_pyramid(jnp.asarray(img), 4),
                    tof.build_pyramid(_t(img), 4)):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def _borderline(prev_pyr, pts, half, min_eig):
    """Features whose finest-level min-eigenvalue test lies within 1e-3
    relative of its threshold (reported, expected none)."""
    prev = prev_pyr[0]
    offs = tof._patch_coords(half, torch.float32, "cpu")
    base = pts[:, None, :] + offs
    du = torch.tensor([0.5, 0.0])
    dv = torch.tensor([0.0, 0.5])
    gx = tof._sample(prev, base + du) - tof._sample(prev, base - du)
    gy = tof._sample(prev, base + dv) - tof._sample(prev, base - dv)
    gxx, gxy, gyy = ((a * b).sum(-1).double() for a, b in
                     ((gx, gx), (gx, gy), (gy, gy)))
    tr, det = gxx + gyy, gxx * gyy - gxy * gxy
    eig = 0.5 * (tr - torch.sqrt(torch.clamp(tr * tr - 4 * det, min=0)))
    return int(((eig / offs.shape[0] / min_eig - 1).abs() < 1e-3).sum())


@pytest.mark.parametrize("shift", [(3, 2), (-2, -4)])
def test_lk_track_matches_reference(shift):
    rng = np.random.default_rng(7)
    img = _texture(rng)
    img[40:56, 60:76] = 128.0      # a flat patch: status False
    dx, dy = shift
    nxt = np.roll(np.roll(img, dy, axis=0), dx, axis=1)
    pts = np.stack(np.meshgrid(np.arange(6, 124, 9), np.arange(6, 92, 9)),
                   -1).reshape(-1, 2).astype(np.float32)
    jp = [jof.build_pyramid(jnp.asarray(x), 3) for x in (img, nxt)]
    tp = [tof.build_pyramid(_t(x), 3) for x in (img, nxt)]
    jout, jok = jof.lk_track(*jp, jnp.asarray(pts), win=15, iters=10)
    tout, tok = tof.lk_track(*tp, _t(pts), win=15, iters=10)
    assert _borderline(tp[0], _t(pts), 7, 1e-4) == 0
    np.testing.assert_array_equal(tok.numpy(), np.asarray(jok))
    ok = tok.numpy()
    np.testing.assert_allclose(tout.numpy()[ok], np.asarray(jout)[ok],
                               atol=FLOW_ATOL)
    assert 0.3 * len(pts) < ok.sum() < len(pts)
    # the known shift, away from the border (np.roll's seam) and from the
    # flat patch, which the shift moves under some windows
    inner = ok & (pts[:, 0] > 20) & (pts[:, 0] < 108) & (pts[:, 1] > 20) \
        & (pts[:, 1] < 76) & ((np.abs(pts[:, 0] - 68) > 20)
                              | (np.abs(pts[:, 1] - 48) > 20))
    err = tout.numpy()[inner] - (pts[inner] + [dx, dy])
    assert np.abs(err).max() < 0.35


def test_lk_flat_image_fails_every_feature():
    pyr = tof.build_pyramid(torch.zeros(64, 64), 2)
    _, ok = tof.lk_track(pyr, pyr, torch.tensor([[32.0, 32.0]]), win=15,
                         iters=5)
    assert not bool(ok[0])


# ---------------------------------------------------------------------------
# TexturePipeline on a meshed plane carried across
# ---------------------------------------------------------------------------
def _plane_config():
    base = JPRESETS["sim"]()
    return base.replace(mesh=dataclasses.replace(
        base.mesh, points_capacity=2 ** 13, voxel_capacity=2 ** 10,
        active_voxels_per_frame=128, file_voxels_per_frame=256))


def test_texture_pipeline_matches_reference(tmp_path):
    """The reference meshes a noisy plane; the port takes its map and
    store through interop; both render the same camera frames (a constant
    image, then a textured one from a moved camera) and export the same
    vertex-coloured PLY, byte for byte."""
    rng = np.random.default_rng(8)
    cfg = _plane_config()
    tcfg = TConfig.from_dict(cfg.to_dict())
    jm = JMeshPipe(cfg)
    x, y = np.meshgrid(np.linspace(-2, 2, 40), np.linspace(-2, 2, 40))
    pts = np.stack([x, y, np.zeros_like(x)], -1).reshape(-1, 3)
    pts = (pts + rng.normal(0, 0.005, pts.shape)).astype(np.float32)
    sensor = np.asarray([0, 0, 5.0], np.float32)
    jm.step(pts, np.ones(len(pts), bool), sensor)
    o = interop.from_reference({"gm": _gm_tree(jm.gm),
                                "store": _tree(jm.store)}, tcfg,
                               device="cpu")
    tm = TMeshPipe(tcfg, device="cpu")
    tm.gm, tm.store = o["gm"], o["store"]
    slots, smask = (np.asarray(a) for a in jm.last_active)
    tm.last_active = (_t(slots), _t(smask))

    jt, tt = JTex(cfg, JCAM), TTex(tcfg, TCAM, device="cpu")
    R = np.diag([1.0, -1.0, -1.0]).astype(np.float32)
    frames = [(_const([30, 200, 90]), R, -R @ sensor, 0.0, 1.0),
              (_image(rng), R, -R @ (sensor + [0.3, -0.2, -0.5]), 0.1, 1.2)]
    for img, Rw, tw, t, inv_exp in frames:
        nj = jt.render(jm, img, Rw, tw, t, inv_exp)
        nt = tt.render(tm, img, Rw, tw, t, inv_exp)
        assert nj == nt > 100
        _same_store(jt.colors, tt.colors)
    assert jt.n_rendered_total == tt.n_rendered_total

    jv, jf, jc = jt.extract_colored(jm)
    tv, tf, tc = tt.extract_colored(tm)
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    assert np.abs(tc.astype(int) - jc.astype(int)).max() <= 1  # u8 of ≈
    assert len(tf) > 50
    pj, pt = str(tmp_path / "j.ply"), str(tmp_path / "t.ply")
    jsave_ply(pj, jv, jf, jc)
    save_ply(pt, tv, tf, jc)
    assert open(pj, "rb").read() == open(pt, "rb").read()
    save_ply(pt, tv, tf, tc)
    v2, f2, c2 = load_ply(pt)
    np.testing.assert_array_equal(v2, tv)
    np.testing.assert_array_equal(f2, tf)
    np.testing.assert_array_equal(c2, tc)


def _gm_tree(gm):
    out = {}
    for f in dataclasses.fields(gm):
        v = getattr(gm, f.name)
        if f.name == "cfg":
            continue
        if hasattr(v, "keys") and hasattr(v, "fp"):
            out[f.name] = {"keys": np.asarray(v.keys), "fp": np.asarray(v.fp)}
        else:
            out[f.name] = np.asarray(v)
    return out


def test_texture_pipeline_without_a_mesh_step_renders_nothing():
    tcfg = TConfig.from_dict(_plane_config().to_dict())
    tm = SimpleNamespace(last_active=None)
    tt = TTex(tcfg, TCAM, device="cpu")
    assert tt.render(tm, _const([1, 2, 3]), EYE, ZERO, 0.0) == 0
