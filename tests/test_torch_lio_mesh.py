"""Port parity, one frame at a time: the LIO step and the mesh step of the
port against the JAX reference, both started from the SAME state — the
reference's state after a few frames of a KITTI-shaped scan sequence,
carried across with interop.from_reference — so one step is compared
without accumulated drift.

Tolerances, with their reasons:
  * pose: 1e-4 m and 1e-5 rad — the ESIKF sums HᵀR⁻¹H over ~2k points in
    another order than XLA and solves an 18×18 system with another
    Cholesky, which moves the posterior by f32 ulps (1e-7 m measured);
  * covariance: rtol 1e-3 of its largest entry (ulps of the inverse of a
    matrix whose entries span 1e-5…1e5);
  * world scan: 1e-4 m (ulps of the pose times ranges of ~100 m);
  * the mesh step, fed the reference's own world scan: point ids, voxel
    slots, work lists and triangles EXACT; smoothed positions 1e-5 m (a
    Gaussian-weighted mean summed in another order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from immesh_tpu.config import PRESETS as JPRESETS
from immesh_tpu.core.geometry import lidar_point_cov_body as j_pcov
from immesh_tpu.frontend.sim import (
    ForwardTrajectory, LidarImuSimulator, outdoor_scene)
from immesh_tpu.frontend.types import ScanBundle as JBundle
from immesh_tpu.lio import imu as jimu
from immesh_tpu.lio.association import associate as j_associate
from immesh_tpu.lio.downsample import voxel_downsample as j_downsample
from immesh_tpu.lio.pipeline import lio_step as j_lio_step
from immesh_tpu.mesh.pipeline import (
    _compact_mesh_jit, _keep_radius_mesh as j_keep_radius, mesh_step as j_mesh_step)
from immesh_tpu.mesh.global_map import GlobalPointMap as JGM
from immesh_tpu.mesh.pipeline import MeshPipeline as JMeshPipe
from immesh_tpu.mesh.triangles import TriangleStore as JStore
from immesh_tpu.lio.pipeline import LioPipeline as JLio
from immesh_tpu_torch import interop
from immesh_tpu_torch.config import ImMeshConfig as TConfig
from immesh_tpu_torch.core import so3
from immesh_tpu_torch.core.geometry import lidar_point_cov_body as t_pcov
from immesh_tpu_torch.frontend.types import ScanBundle as TBundle
from immesh_tpu_torch.lio import imu as timu
from immesh_tpu_torch.lio.association import associate as t_associate
from immesh_tpu_torch.lio.downsample import voxel_downsample as t_downsample
from immesh_tpu_torch.lio.pipeline import extrinsics
from immesh_tpu_torch.lio.pipeline import lio_step as t_lio_step
from immesh_tpu_torch.mesh.pipeline import (
    MeshPipeline as TMeshPipe, _compact_mesh, _keep_radius_mesh as t_keep_radius,
    mesh_step as t_mesh_step)

N_RAYS = 8192
N_PRE = 3    # reference frames run before the compared step
N_CHAIN = 7  # frames of the chained mesh-pipeline comparison


def _config():
    base = JPRESETS["kitti"]()
    return base.replace(
        preprocess=base.preprocess.__class__(
            lidar_type=100, blind=0.05, max_points=N_RAYS),
        voxel_map=dataclasses.replace(
            base.voxel_map, capacity=2 ** 13, touched_voxels_per_scan=512),
        lio=dataclasses.replace(base.lio, map_update_points=2048),
        mesh=base.mesh.__class__(
            pts_minimum_scale=0.15, voxel_resolution=0.6,
            points_capacity=2 ** 13, voxel_capacity=2 ** 11,
            compact_check_every=8, local_map_radius=40.0,
            active_voxels_per_frame=128, file_voxels_per_frame=1024,
            max_pts_per_frame=2000, mesh_chunk=64))


def _tree(obj):
    """A reference pytree as nested dicts of numpy arrays (data fields
    only), the form interop.from_reference takes."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if f.metadata.get("pytree_node", True)}
    return np.asarray(obj)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def ref():
    """The reference after N_PRE frames, frame N_PRE's bundle, and the
    reference LIO's world scans of frames 0..N_CHAIN-1."""
    cfg = _config()
    sim = LidarImuSimulator(scene=outdoor_scene(length=400.0),
                            traj=ForwardTrajectory(speed=9.0), n_rays=N_RAYS,
                            rings=16, max_range=120.0, seed=0)
    lio = JLio(cfg)
    state, vm = lio.state, lio.vm
    gm, store = JGM.create(cfg.mesh), JStore.create(cfg.mesh)
    out = dict(cfg=cfg, tcfg=TConfig.from_dict(cfg.to_dict()), worlds=[])
    for k in range(N_CHAIN):
        f = sim.frame(k)
        args = (f.pts, f.t_rel, f.imu_stamps, f.imu_acc, f.imu_gyr,
                f.scan_duration, N_RAYS, cfg.imu.max_imu_per_scan)
        if k == N_PRE:
            out.update(state=state, vm=vm, gm=gm, store=store, args=args)
        b = JBundle.from_numpy(*args)
        state, vm, world, _ = j_lio_step(state, vm, b, cfg)
        out["worlds"].append((np.asarray(world), np.asarray(b.mask),
                              np.asarray(state.pos)))
        if k < N_PRE:
            gm, store, *_ = j_mesh_step(gm, store, world, b.mask, state.pos,
                                        cfg.mesh.mesh_chunk)
    return out


def _port(ref, *names):
    return interop.from_reference({n: _tree(ref[n]) for n in names},
                                  ref["tcfg"], device="cpu")


def test_interop_round_trip(ref):
    objs = _port(ref, "state", "vm", "gm", "store")
    back = interop.to_numpy(objs)
    for name in ("state", "vm", "gm", "store"):
        want = _tree(ref[name])
        flat_w = jax.tree_util.tree_leaves_with_path(want)
        got = back[name]
        for path, leaf in flat_w:
            x = got
            for p in path:
                x = x[p.key]
            np.testing.assert_array_equal(leaf, x, str((name, path)))


def test_lio_step_matches_reference(ref):
    cfg, tcfg = ref["cfg"], ref["tcfg"]
    o = _port(ref, "state", "vm")
    js, jvm, jworld, jdiag = j_lio_step(ref["state"], ref["vm"],
                                        JBundle.from_numpy(*ref["args"]), cfg)
    tb = TBundle.from_numpy(*ref["args"], device="cpu")
    ts, tvm, tworld, tdiag = t_lio_step(
        o["state"], o["vm"], tb, tcfg, extrinsics(tcfg.imu, tb.pts))
    assert int(tdiag["n_effective"]) > 1000
    assert abs(int(jdiag["n_effective"]) - int(tdiag["n_effective"])) <= 2
    assert bool(jdiag["converged"]) == bool(tdiag["converged"])
    np.testing.assert_allclose(np.asarray(js.pos), ts.pos.numpy(), atol=1e-4)
    dR = so3.log(_t(np.asarray(js.rot)).T @ ts.rot)
    assert float(dR.norm()) < 1e-5
    for name in ("vel", "bg"):
        np.testing.assert_allclose(np.asarray(getattr(js, name)),
                                   getattr(ts, name).numpy(), atol=1e-3)
    jc, tc = np.asarray(js.cov), ts.cov.numpy()
    np.testing.assert_allclose(jc, tc, atol=1e-3 * np.abs(jc).max())
    np.testing.assert_allclose(np.asarray(jworld), tworld.numpy(), atol=1e-4)
    # the map grew by the same voxels
    np.testing.assert_array_equal(np.asarray(jvm.table.keys),
                                  tvm.table.keys.numpy())
    np.testing.assert_array_equal(np.asarray(jvm.count), tvm.count.numpy())


def test_lio_stages_match_reference(ref):
    """propagate, deskew, downsample and one association on frame N_PRE."""
    cfg, tcfg = ref["cfg"], ref["tcfg"]
    o = _port(ref, "state", "vm")
    jb = JBundle.from_numpy(*ref["args"])
    tb = TBundle.from_numpy(*ref["args"], device="cpu")
    js, ts = ref["state"], o["state"]
    jp = jimu.const_velocity_propagate(js, jb.scan_duration, cfg.imu)
    tp = timu.const_velocity_propagate(ts, tb.scan_duration, tcfg.imu)
    for name in ("rot", "pos", "cov"):
        np.testing.assert_allclose(np.asarray(getattr(jp, name)),
                                   getattr(tp, name).numpy(),
                                   rtol=1e-6, atol=1e-7)
    T = jb.scan_duration
    jd = jimu.deskew_const_twist(jb.pts, jb.t_rel, T, js.bg * T, js.vel * T)
    td = timu.deskew_const_twist(tb.pts, tb.t_rel, tb.scan_duration,
                                 ts.bg * tb.scan_duration,
                                 ts.vel * tb.scan_duration)
    np.testing.assert_allclose(np.asarray(jd), td.numpy(), atol=2e-5)
    # downsample the SAME deskewed points: cells and masks exact
    leaf, k = cfg.lio.downsample_voxel, cfg.lio.map_update_points
    jdown, jm = j_downsample(jd, jb.mask, leaf, k)
    tdown, tm = t_downsample(_t(jd), tb.mask, leaf, k)
    np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
    np.testing.assert_allclose(np.asarray(jdown), tdown.numpy(), atol=1e-6)
    jcov = j_pcov(jdown, cfg.voxel_map.dept_err, cfg.voxel_map.beam_err)
    tcov = t_pcov(_t(jdown), tcfg.voxel_map.dept_err, tcfg.voxel_map.beam_err)
    np.testing.assert_allclose(np.asarray(jcov), tcov.numpy(), rtol=1e-6,
                               atol=1e-7)
    ja = j_associate(jp, ref["vm"], jdown, jcov, jm, cfg.voxel_map)
    ta = t_associate(tp, o["vm"], _t(jdown), _t(jcov), tm, tcfg.voxel_map)
    # gate decisions agree except where |z| sits on the χ bound to ulps
    agree = np.asarray(ja["valid"]) == ta["valid"].numpy()
    assert agree.mean() > 0.999
    both = np.asarray(ja["valid"]) & ta["valid"].numpy()
    np.testing.assert_array_equal(np.asarray(ja["slot"])[both],
                                  ta["slot"].numpy()[both])
    np.testing.assert_allclose(np.asarray(ja["z"])[both],
                               ta["z"].numpy()[both], atol=1e-4)


def test_mesh_step_matches_reference(ref):
    cfg = ref["cfg"]
    jb = JBundle.from_numpy(*ref["args"])
    # the reference's own world scan for this frame feeds both mesh steps
    state = ref["state"]
    world = np.asarray(state.transform_points(jb.pts))
    mask, sensor = np.asarray(jb.mask), np.asarray(state.pos)
    o = _port(ref, "gm", "store")
    jgm, jst, jn, jsl, jsm, jdiag = j_mesh_step(
        ref["gm"], ref["store"], jnp.asarray(world), jnp.asarray(mask),
        jnp.asarray(sensor), cfg.mesh.mesh_chunk)
    tgm, tst, tn, tsl, tsm, tdiag = t_mesh_step(
        o["gm"], o["store"], _t(world), _t(mask), _t(sensor),
        cfg.mesh.mesh_chunk)
    np.testing.assert_array_equal(np.asarray(jsl), tsl.numpy())
    np.testing.assert_array_equal(np.asarray(jsm), tsm.numpy())
    assert int(jn) == int(tn) > 0
    for k, v in jdiag.items():
        assert int(v) == int(tdiag[k]), k
    jt, tt = _tree(jgm), interop.to_numpy(tgm)
    for name in ("pts", "pt_count", "vox_pt_idx", "vox_pts", "vox_n",
                 "vox_new", "vox_meshed", "frame_no"):
        np.testing.assert_array_equal(jt[name], tt[name], name)
    for table in ("dedup", "vox"):
        for f in ("keys", "fp"):
            np.testing.assert_array_equal(jt[table][f], tt[table][f])
    for name in ("pts_smooth", "vox_pts_sm"):
        np.testing.assert_allclose(jt[name], tt[name], atol=1e-5)
    js, ts = _tree(jst), interop.to_numpy(tst)
    np.testing.assert_array_equal(js["tri_n"], ts["tri_n"])
    np.testing.assert_array_equal(js["tri_ids"], ts["tri_ids"])
    assert int(ts["tri_n"].sum()) > 100


def test_mesh_compaction_matches_reference(ref):
    mc = ref["cfg"].mesh
    o = _port(ref, "gm", "store")
    center = np.asarray(ref["state"].pos) + np.float32(3.0)
    low_p = int(0.3 * int(ref["gm"].pt_count))
    low_v = mc.voxel_capacity
    jr = j_keep_radius(ref["gm"], jnp.asarray(center), low_p, low_v,
                       mc.local_map_radius)
    tr = t_keep_radius(o["gm"], _t(center), low_p, low_v, mc.local_map_radius)
    assert float(jr) == float(tr) < mc.local_map_radius
    jgm, jst = _compact_mesh_jit(ref["gm"], ref["store"], jnp.asarray(center),
                                 jr)
    _compact_mesh(o["gm"], o["store"], _t(center), tr)
    assert 0 < int(o["gm"].pt_count) < int(ref["gm"].pt_count)
    jt, tt = _tree(jgm), interop.to_numpy(o["gm"])
    for name in ("pts", "pts_smooth", "pt_count", "vox_pt_idx", "vox_pts",
                 "vox_pts_sm", "vox_n", "vox_new", "vox_meshed"):
        np.testing.assert_array_equal(jt[name], tt[name], name)
    for table in ("dedup", "vox"):
        np.testing.assert_array_equal(jt[table]["keys"], tt[table]["keys"])
    js, ts = _tree(jst), interop.to_numpy(o["store"])
    for name in ("tri_ids", "tri_n", "dirty"):
        np.testing.assert_array_equal(js[name], ts[name], name)


def test_mesh_pipeline_matches_reference_over_frames(ref):
    """Both MeshPipelines fed the reference LIO's world scans: the whole
    meshing side — appends, smoothing, triangulation, occupancy-triggered
    compaction with its triangle-store remap, extraction — stays EXACT
    frame after frame."""
    jp, tp = JMeshPipe(ref["cfg"]), TMeshPipe(ref["tcfg"], device="cpu")
    for world, mask, sensor in ref["worlds"]:
        jn = jp.step(world, mask, sensor)
        tn, _ = tp.step(_t(world), _t(mask), _t(sensor))
        assert int(jn) == int(tn)
        assert jp.n_compactions == tp.n_compactions
        np.testing.assert_array_equal(np.asarray(jp.store.tri_ids),
                                      tp.store.tri_ids.numpy())
        np.testing.assert_array_equal(np.asarray(jp.gm.pts), tp.gm.pts.numpy())
    assert tp.n_compactions >= 1
    for j, t in zip(jp.extract(), tp.extract()):
        np.testing.assert_array_equal(j, t)
