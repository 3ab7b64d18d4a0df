"""Port parity, core layer: config, frontend bundles and simulator, SO(3),
the manifold state and the batched geometry, each held against the JAX
reference on the same seeded inputs; plus the port's import hygiene.

Tolerances: the port runs the reference's formulas op for op in f32, but
transcendentals (sin/cos/arccos/sqrt) and 3×3 matrix products come from
different libraries (XLA vs ATen), so results agree to a few f32 ulps of
the magnitudes involved — rtol 1e-5 / atol 1e-6 throughout, except where
noted."""

import ast
import glob
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from immesh_tpu import config as jcfg
from immesh_tpu.core import geometry as jgeo
from immesh_tpu.core import so3 as jso3
from immesh_tpu.core.state import EsikfState as JState
from immesh_tpu.frontend import sim as jsim
from immesh_tpu.frontend.types import ScanBundle as JBundle
from immesh_tpu_torch import config as tcfg
from immesh_tpu_torch.core import geometry as tgeo
from immesh_tpu_torch.core import so3 as tso3
from immesh_tpu_torch.core.state import EsikfState as TState
from immesh_tpu_torch.frontend import sim as tsim
from immesh_tpu_torch.frontend.types import ScanBundle as TBundle

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RTOL, ATOL = 1e-5, 1e-6


def _t(x):
    return torch.from_numpy(np.array(x))


def _close(j, t, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(j), t.numpy(), rtol=rtol, atol=atol)


# ---------------------------------------------------------------------------
# config
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(jcfg.PRESETS))
def test_config_presets_match_reference(name):
    assert tcfg.PRESETS[name]().to_dict() == jcfg.PRESETS[name]().to_dict()


def test_config_round_trip_and_guard():
    cfg = tcfg.PRESETS["kitti"]()
    assert tcfg.ImMeshConfig.from_dict(cfg.to_dict()) == cfg
    with pytest.raises(KeyError):
        tcfg.ImMeshConfig.from_dict({"mesh": {"no_such_field": 1}})
    # the reference asserts; the port raises a ValueError at the same bound
    with pytest.raises(ValueError):
        tcfg.MeshConfig(points_capacity=2 ** 24)
    tcfg.MeshConfig(points_capacity=2 ** 24 - 1)


# ---------------------------------------------------------------------------
# frontend
# ---------------------------------------------------------------------------
def test_scan_bundle_from_numpy_matches_reference():
    rng = np.random.default_rng(0)
    pts = rng.normal(size=(50, 3)).astype(np.float32)
    t_rel = np.sort(rng.uniform(0, 0.1, 50)).astype(np.float32)
    stamps = np.linspace(0, 0.1, 5).astype(np.float32)
    acc = rng.normal(size=(5, 3)).astype(np.float32)
    gyr = rng.normal(size=(5, 3)).astype(np.float32)
    mask = rng.random(50) < 0.7
    for n_pts, n_imu, m in ((64, 8, None), (40, 4, mask)):
        args = (pts, t_rel, stamps, acc, gyr, 0.1, n_pts, n_imu)
        j = JBundle.from_numpy(*args, mask=m)
        t = TBundle.from_numpy(*args, mask=m, device="cpu")
        for name in ("pts", "t_rel", "mask", "imu_stamps", "imu_acc",
                     "imu_gyr", "imu_mask", "scan_duration"):
            np.testing.assert_array_equal(np.asarray(getattr(j, name)),
                                          getattr(t, name).numpy(), name)
    # padded stamps repeat the last valid stamp
    assert float(t.imu_stamps[-1]) == float(stamps[3])


def test_simulator_copy_makes_the_same_scans():
    kw = dict(n_rays=512, rings=16, max_range=120.0, seed=3)
    js = jsim.LidarImuSimulator(scene=jsim.outdoor_scene(length=100.0),
                                traj=jsim.ForwardTrajectory(speed=9.0), **kw)
    ts = tsim.LidarImuSimulator(scene=tsim.outdoor_scene(length=100.0),
                                traj=tsim.ForwardTrajectory(speed=9.0), **kw)
    for k in (0, 3):
        a, b = js.frame(k), ts.frame(k)
        for name in ("pts", "t_rel", "imu_stamps", "imu_acc", "imu_gyr",
                     "gt_rot", "gt_pos"):
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))


# ---------------------------------------------------------------------------
# so3 and the manifold state
# ---------------------------------------------------------------------------
def _rotvecs(rng):
    w = rng.normal(size=(64, 3)).astype(np.float32)
    w[:8] *= 1e-5              # Taylor branch
    w[8:16] *= np.float32(3.0) / np.linalg.norm(w[8:16], axis=-1,
                                                keepdims=True)  # near π
    w[16] = 0.0
    return w


@pytest.mark.parametrize("fn", ["hat", "exp", "jr_inv", "a_matrix"])
def test_so3_maps_of_rotation_vectors(fn):
    w = _rotvecs(np.random.default_rng(1))
    _close(getattr(jso3, fn)(jnp.asarray(w)), getattr(tso3, fn)(_t(w)))


def test_so3_log_vee_and_quaternions():
    rng = np.random.default_rng(2)
    w = _rotvecs(rng)
    R = np.asarray(jso3.exp(jnp.asarray(w)))
    # log loses precision near π (arccos); compare at 1e-4 there
    _close(jso3.log(jnp.asarray(R)), tso3.log(_t(R)), rtol=1e-4, atol=1e-4)
    _close(jso3.vee(jnp.asarray(R)), tso3.vee(_t(R)))
    q = rng.normal(size=(32, 4)).astype(np.float32)
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    _close(jso3.quat_to_rot(jnp.asarray(q)), tso3.quat_to_rot(_t(q)))
    _close(jso3.rot_to_quat(jnp.asarray(R[17:])), tso3.rot_to_quat(_t(R[17:])))


def test_state_manifold_ops():
    rng = np.random.default_rng(3)
    js = JState.identity(gravity=9.7, init_rot_cov=2e-5)
    ts = TState.identity(gravity=9.7, init_rot_cov=2e-5, device="cpu")
    for name in ("rot", "pos", "vel", "bg", "ba", "grav", "cov"):
        np.testing.assert_array_equal(np.asarray(getattr(js, name)),
                                      getattr(ts, name).numpy())
    d1 = rng.normal(size=18).astype(np.float32) * 0.3
    d2 = rng.normal(size=18).astype(np.float32) * 0.3
    ja, jb = js.boxplus(jnp.asarray(d1)), js.boxplus(jnp.asarray(d2))
    ta, tb = ts.boxplus(_t(d1)), ts.boxplus(_t(d2))
    for name in ("rot", "pos", "vel", "bg", "ba", "grav"):
        _close(getattr(ja, name), getattr(ta, name))
    _close(ja.boxminus(jb), ta.boxminus(tb), atol=1e-5)
    pts = rng.normal(size=(100, 3)).astype(np.float32) * 20
    _close(ja.transform_points(jnp.asarray(pts)), ta.transform_points(_t(pts)),
           atol=1e-5)
    _close(ja.pose_matrix(), ta.pose_matrix())


# ---------------------------------------------------------------------------
# geometry
# ---------------------------------------------------------------------------
def _sym_batch(rng):
    B = rng.normal(size=(128, 3, 3)).astype(np.float32)
    A = B @ B.transpose(0, 2, 1)
    A[0] = np.eye(3) * 2.0                              # scalar
    A[1] = np.diag([1.0, 1.0, 3.0])                     # repeated min pair
    A[2] = np.diag([1.0, 3.0, 3.0])                     # repeated max pair
    A[3] = np.outer([1.0, 2.0, 3.0], [1.0, 2.0, 3.0])   # rank one
    A[4] = 0.0                                          # zero
    A[5] = np.diag([1e-9, 1.0, 1.0])                    # thin plane
    return A.astype(np.float32)


def test_eigh3x3_matches_reference_including_degenerate_cases():
    A = _sym_batch(np.random.default_rng(4))
    jv, jV = jgeo.eigh3x3(jnp.asarray(A))
    tv, tV = tgeo.eigh3x3(_t(A))
    _close(jv, tv, rtol=1e-4, atol=1e-5)
    # eigenvectors up to the sign of each column; both must be orthonormal
    jV, tV = np.asarray(jV), tV.numpy()
    dots = np.abs(np.einsum("nik,nik->nk", jV, tV))
    np.testing.assert_allclose(dots, 1.0, atol=1e-3)
    np.testing.assert_allclose(tV.transpose(0, 2, 1) @ tV,
                               np.broadcast_to(np.eye(3), tV.shape), atol=1e-5)
    # the scalar, repeated, zero and thin cases take the same fallback
    # branches and give the same axes bit for bit (the rank-one case goes
    # through arccos/cos and agrees only to ulps, checked above)
    for i in (0, 1, 2, 4, 5):
        np.testing.assert_array_equal(jV[i], tV[i])


def test_plane_fit_and_noise_models():
    rng = np.random.default_rng(5)
    n = 256
    pts = rng.normal(size=(n, 20, 3)).astype(np.float32) * [1.0, 1.0, 0.01]
    sum_p = pts.sum(1).astype(np.float32)
    sum_ppT = np.einsum("nki,nkj->nij", pts, pts).astype(np.float32)
    count = rng.integers(0, 30, n).astype(np.float32)
    s2 = rng.uniform(1e-4, 1e-2, n).astype(np.float32)
    anchor = rng.normal(size=(n, 3)).astype(np.float32) * 50
    jf = jgeo.plane_from_moments(jnp.asarray(sum_p), jnp.asarray(sum_ppT),
                                 jnp.asarray(count), jnp.asarray(s2),
                                 anchor=jnp.asarray(anchor))
    tf = tgeo.plane_from_moments(_t(sum_p), _t(sum_ppT), _t(count), _t(s2),
                                 anchor=_t(anchor))
    np.testing.assert_array_equal(np.asarray(jf["valid"]), tf["valid"].numpy())
    for k in ("center", "lam", "var_c"):
        _close(jf[k], tf[k], rtol=1e-4, atol=1e-5)
    # normals up to sign; d follows the normal's sign
    sgn = np.sign(np.sum(np.asarray(jf["normal"]) * tf["normal"].numpy(), -1))
    _close(jf["normal"], tf["normal"] * _t(sgn)[:, None], rtol=1e-4, atol=1e-4)
    _close(jf["d"], tf["d"] * _t(sgn), rtol=1e-4, atol=1e-3)
    _close(jf["cov_nn"], tf["cov_nn"], rtol=1e-3, atol=1e-7)

    body = rng.normal(size=(64, 3)).astype(np.float32) * 10
    body[0] = [0.0, 0.0, 5.0]     # along the reference axis
    _close(jgeo.lidar_point_cov_body(jnp.asarray(body), 0.05, 0.02),
           tgeo.lidar_point_cov_body(_t(body), 0.05, 0.02), atol=1e-6)
    q = rng.normal(size=(64, 3)).astype(np.float32)
    cov = np.abs(rng.normal(size=(64, 3, 3))).astype(np.float32) * 1e-3
    args = (q, cov, q[::-1].copy(), q * 0.5, cov, s2[:64])
    _close(jgeo.point_to_plane_sigma2(*map(jnp.asarray, args)),
           tgeo.point_to_plane_sigma2(*map(_t, args)), atol=1e-7)


# the reference's f32 moments (bit patterns) of two plane-map voxels after
# frame 1 of tests/torch_fault_c.py's sequence, both of near-line point
# sets: (key, Σ(p − anchor), packed Σ(p − anchor)(p − anchor)ᵀ, N, Σσ²)
NEAR_LINE_VOXELS = (
    ((-3, -9, -2, 1), (3163543552, 3214864904, 1082209543),
     (1061054952, 997860544, 1011542080, 1048815324, 3210079064, 1076753303),
     6.0, 1050264716),
    ((2, 4, 0, 0), (3238341893, 1082733478, 3229700944),
     (1094239671, 3233699030, 1085417646, 1078204286, 3224970376, 1082153414),
     6.0, 1053257060),
)


@pytest.mark.parametrize("voxel", NEAR_LINE_VOXELS, ids=("6211", "2606"))
def test_plane_fit_of_a_near_line_voxel_is_the_reference_as_written(voxel):
    """ROADMAP queue 3 item 9: where the two smallest eigenvalues nearly
    coincide, eigh3x3's arccos(det(B)/2) turns one ulp into ~1e-5 of λ_min
    and degrees of normal.  The port computes what the reference's code
    says op by op (jax.disable_jit) bit for bit; the jitted reference
    rounds otherwise (XLA:CPU), which is where the chained runs part."""
    import jax
    from immesh_tpu.map.voxel_map import _sym_unpack as jsym
    from immesh_tpu_torch.map.voxel_map import _key_centers, _sym_unpack
    key, sp, spp, n, s2 = voxel
    sum_p = np.array(sp, np.uint32).view(np.float32)[None]
    sum_pp = np.array(spp, np.uint32).view(np.float32)[None]
    count = np.array([n], np.float32)
    s2m = np.array([s2], np.uint32).view(np.float32) / count
    anchor = _key_centers(torch.tensor([key], dtype=torch.int32), 3.0,
                          torch.float32)
    tf = tgeo.plane_from_moments(_t(sum_p), _sym_unpack(_t(sum_pp)),
                                 _t(count), _t(s2m), anchor=anchor)
    with jax.disable_jit():
        jf = jgeo.plane_from_moments(
            jnp.asarray(sum_p), jsym(jnp.asarray(sum_pp)), jnp.asarray(count),
            jnp.asarray(s2m), anchor=jnp.asarray(anchor.numpy()))
    for k in ("lam", "normal", "d", "center"):
        np.testing.assert_array_equal(tf[k].numpy(), np.asarray(jf[k]),
                                      err_msg=k)
    lam_min = tf["lam"][0, 0].item()
    assert lam_min < tf["lam"][0, 1].item() < 1e-4 < tf["lam"][0, 2].item()


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------
def _port_sources():
    root = os.path.join(REPO, "immesh_tpu_torch")
    for d, _, files in os.walk(root):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)
    yield os.path.join(REPO, "chip_smoke.py")
    yield from glob.glob(os.path.join(REPO, "tools", "torch_*.py"))


@pytest.mark.parametrize("path", sorted(_port_sources()),
                         ids=lambda p: os.path.relpath(p, REPO))
def test_port_imports_neither_jax_nor_the_reference(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "flax", "immesh_tpu"), (
                f"{os.path.relpath(path, REPO)}:{node.lineno} imports {name}")


def test_importing_the_port_loads_no_jax():
    code = ("import sys, immesh_tpu_torch, immesh_tpu_torch.runtime.joint, "
            "immesh_tpu_torch.interop, immesh_tpu_torch.runtime.app, "
            "immesh_tpu_torch.runtime.demo, immesh_tpu_torch.eval, "
            "immesh_tpu_torch.eval.mesh_quality, "
            "immesh_tpu_torch.lio.window, immesh_tpu_torch.dist.window_ba, "
            "immesh_tpu_torch.dist.comm, immesh_tpu_torch.dist.lio, "
            "immesh_tpu_torch.dist.mesh, immesh_tpu_torch.dist.sharded_map, "
            "immesh_tpu_torch.dist.multihost, "
            "immesh_tpu_torch.render.raster, immesh_tpu_torch.render.live, "
            "immesh_tpu_torch.render.viewer, immesh_tpu_torch.utils.console, "
            "immesh_tpu_torch.frontend.native, "
            "immesh_tpu_torch.frontend.preprocess, "
            "immesh_tpu_torch.frontend.features, "
            "immesh_tpu_torch.frontend.sync, immesh_tpu_torch.texture, "
            "immesh_tpu_torch.texture.pipeline; "
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'flax', 'immesh_tpu')]; "
            "assert not bad, bad")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
