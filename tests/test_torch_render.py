"""Port parity, render/ and its neighbours: the tile z-buffer, depth
unprojection and reinforcement (render/raster.py), the snapshot views
(render/viewer.py), the live viewer's region cache, plane overlay and HTTP
server (render/live.py), the plane-map PLY (runtime/export.py), the
console helpers (utils/console.py) and the scipy oracle mesh
(eval/mesh_quality.py) against the JAX reference, on the CPU; then the
runtime's viewer, reinforcement and pause hooks.

Tolerances, with their reasons:
  * depth: 1e-5 relative where both hit, and at most 0.1 % of the pixels
    hit on one side only — XLA:CPU fuses the edge functions' products
    into FMAs (ROADMAP queue 3 item 6), so a pixel centre exactly on an
    edge can fall either side: the tilted quad's shared diagonal runs
    through 36 pixel centres (0.047 %), which the reference leaves outside
    both triangles and the port's unfused edge functions put inside one;
    every other case measures 0;
  * unprojected points: 1e-5 m (the same depth through a 3×3 product);
  * region buffers, plane rows, PLY bytes, oracle faces, console: EXACT
    (numpy on the same host arrays)."""

import dataclasses
import http.client
import json
import struct
import threading
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from immesh_tpu.config import PRESETS as JPRESETS
from immesh_tpu.eval import mesh_quality as jmq
from immesh_tpu.frontend.sim import LidarImuSimulator
from immesh_tpu.frontend.types import ScanBundle as JBundle
from immesh_tpu.lio.pipeline import LioPipeline as JLio
from immesh_tpu.mesh.pipeline import MeshPipeline as JMeshPipe
from immesh_tpu.render import live as jlive
from immesh_tpu.render import raster as jraster
from immesh_tpu.render import viewer as jviewer
from immesh_tpu.runtime import export as jexport
from immesh_tpu.utils import console as jconsole
from immesh_tpu_torch import interop
from immesh_tpu_torch.config import ImMeshConfig as TConfig
from immesh_tpu_torch.eval import mesh_quality as tmq
from immesh_tpu_torch.frontend.types import ScanBundle as TBundle
from immesh_tpu_torch.render import live as tlive
from immesh_tpu_torch.render import raster as traster
from immesh_tpu_torch.render import viewer as tviewer
from immesh_tpu_torch.runtime import export as texport
from immesh_tpu_torch.runtime.app import ImMeshRuntime as TRuntime
from immesh_tpu_torch.utils import console as tconsole


def _tree(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if f.metadata.get("pytree_node", True)}
    return np.asarray(obj)


def _cams(**kw):
    """The same camera in both packages."""
    return (jraster.PinholeCam.looking(**kw),
            traster.PinholeCam.looking(device="cpu", **kw))


def _same_depth(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    fin_g, fin_w = np.isfinite(got), np.isfinite(want)
    assert (fin_g != fin_w).sum() <= 1e-3 * got.size
    both = fin_g & fin_w
    np.testing.assert_allclose(got[both], want[both], rtol=1e-5)
    return int(both.sum())


# ---------------------------------------------------------------------------
# rasterizer, on the analytic quads of tests/test_render.py
# ---------------------------------------------------------------------------
def _quad(z=2.0, half=1.0):
    verts = np.asarray([[-half, -half, z], [half, -half, z], [half, half, z],
                        [-half, half, z]], np.float32)
    return verts, np.asarray([[0, 1, 2], [0, 2, 3]], np.int32)


def _scene(name):
    if name == "flat":
        return _quad(2.0)
    if name == "occlusion":
        v1, f1 = _quad(2.0, 1.0)
        v2, f2 = _quad(1.0, 0.2)
        return np.concatenate([v1, v2]), np.concatenate([f1, f2 + 4])
    if name == "tilted":
        return (np.asarray([[-2, -2, 1.0], [2, -2, 3.0], [2, 2, 3.0],
                            [-2, 2, 1.0]], np.float32),
                np.asarray([[0, 1, 2], [0, 2, 3]], np.int32))
    # close-up: both triangles span > SPAN tiles (the shared large list),
    # beside a field of small ones
    rng = np.random.default_rng(0)
    c = rng.uniform(-1.5, 1.5, (300, 2)).astype(np.float32)
    z = np.full(300, 3.0, np.float32)
    small = np.concatenate([
        np.stack([c[:, 0], c[:, 1], z], -1),
        np.stack([c[:, 0] + 0.05, c[:, 1], z], -1),
        np.stack([c[:, 0], c[:, 1] + 0.05, z + 0.1], -1)])
    fs = np.stack([np.arange(300), np.arange(300) + 300,
                   np.arange(300) + 600], -1).astype(np.int32)
    v1, f1 = _quad(0.5, 0.3)
    return np.concatenate([small, v1]), np.concatenate([fs, f1 + 900])


@pytest.mark.parametrize("name", ["flat", "occlusion", "tilted", "large"])
def test_depth_rasterize_matches_reference(name):
    verts, faces = _scene(name)
    jc, tc = _cams(pos=(0, 0, 0), target=(0, 0, 1), up=(0, -1, 0), fx=100.0,
                   fy=100.0, cx=160.0, cy=120.0, width=320, height=240)
    mask = np.ones(len(faces), bool)
    mask[-1] = name != "large"     # a masked face must not draw
    want = jraster.depth_rasterize(jnp.asarray(verts), jnp.asarray(faces),
                                   jnp.asarray(mask), jc)
    got = traster.depth_rasterize(torch.from_numpy(verts),
                                  torch.from_numpy(faces),
                                  torch.from_numpy(mask), tc)
    assert _same_depth(got.numpy(), want) > 500
    pw, okw = jraster.unproject_depth(want, jc, stride=2)
    pg, okg = traster.unproject_depth(got, tc, stride=2)
    okw, okg = np.asarray(okw), okg.numpy()
    hit_w = np.isfinite(np.asarray(want))[::2, ::2].reshape(-1)
    hit_g = np.isfinite(got.numpy())[::2, ::2].reshape(-1)
    np.testing.assert_array_equal(okg != okw, hit_g != hit_w)
    both = okg & okw
    np.testing.assert_allclose(pg.numpy()[both], np.asarray(pw)[both],
                               atol=1e-5)


@pytest.fixture(scope="module")
def meshed():
    """A small meshed store (the reference's MeshPipeline over two noisy
    ground-plane frames, as tests/test_live.py builds it) carried into the
    port."""
    cfg = JPRESETS["sim"]()
    cfg = cfg.replace(mesh=cfg.mesh.__class__(
        points_capacity=2 ** 14, voxel_capacity=2 ** 10,
        active_voxels_per_frame=64, mesh_chunk=8))
    pipe = JMeshPipe(cfg)
    rng = np.random.default_rng(3)
    for _ in range(2):
        pts = rng.uniform(-3, 3, (2048, 3)).astype(np.float32)
        pts[:, 2] = 0.01 * rng.standard_normal(2048)
        pipe.step(jnp.asarray(pts), jnp.ones(2048, bool),
                  jnp.zeros(3, jnp.float32))
    tcfg = TConfig.from_dict(cfg.to_dict())
    o = interop.from_reference({"gm": _tree(pipe.gm),
                                "store": _tree(pipe.store)}, tcfg,
                               device="cpu")
    return dict(cfg=cfg, jpipe=pipe, gm=o["gm"], store=o["store"])


@pytest.mark.parametrize("stride,max_depth", [(1, 0.0), (2, 3.5)])
def test_reinforce_scan_matches_reference(meshed, stride, max_depth):
    jc, tc = _cams(pos=(0.3, -4.0, 2.5), target=(0, 0, 0), fx=120, fy=120)
    jp, jd = jraster.reinforce_scan(meshed["jpipe"].store, meshed["jpipe"].gm,
                                    jc, stride=stride, max_depth=max_depth)
    tp, td = traster.reinforce_scan(meshed["store"], meshed["gm"], tc,
                                    stride=stride, max_depth=max_depth)
    assert _same_depth(td, jd) > 1000
    assert len(tp) == len(jp) > 1000
    np.testing.assert_allclose(tp, jp, atol=1e-5)


def test_render_mesh_views_match_reference(meshed):
    pipe = meshed["jpipe"]
    verts, faces = pipe.extract()
    jc, tc = _cams(pos=(2.0, -3.0, 2.5), target=(0, 0, 0), fx=150, fy=150)
    jd, js = jviewer.render_mesh_views(np.asarray(verts), np.asarray(faces),
                                       jc)
    td, ts = tviewer.render_mesh_views(np.asarray(verts), np.asarray(faces),
                                       tc, device="cpu")
    assert _same_depth(td, jd) > 1000
    np.testing.assert_allclose(ts, js, atol=1e-4)


def test_save_snapshot_writes_a_png(meshed, tmp_path):
    pytest.importorskip("matplotlib")
    verts, faces = meshed["jpipe"].extract()
    path = str(tmp_path / "snap.png")
    tviewer.save_snapshot(np.asarray(verts), np.asarray(faces), path,
                          device="cpu")
    with open(path, "rb") as fh:
        assert fh.read(8) == b"\x89PNG\r\n\x1a\n"


# ---------------------------------------------------------------------------
# live viewer
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("smooth_lam", [0.0, 0.8])
def test_region_cache_sync_matches_reference(meshed, smooth_lam):
    cfg = meshed["cfg"]
    args = (cfg.mesh.region_size, cfg.mesh.voxel_resolution, smooth_lam)
    jcache, tcache = jlive.RegionCache(*args), tlive.RegionCache(*args)
    jstore = jcache.sync(meshed["jpipe"].gm, meshed["jpipe"].store)
    store = interop.from_reference(
        {"store": _tree(meshed["jpipe"].store)},
        TConfig.from_dict(cfg.to_dict()), device="cpu")["store"]
    tstore = tcache.sync(meshed["gm"], store)
    assert not tstore.dirty.any() and not np.asarray(jstore.dirty).any()
    assert tcache.stats() == jcache.stats() and tcache.seq == 1
    rids = tcache.changed_since(0)
    assert rids == jcache.changed_since(0) and rids
    for rid in rids:
        assert tcache.region_bytes(rid) == jcache.region_bytes(rid)
    tcache.sync(meshed["gm"], tstore)      # nothing dirty: a no-op
    assert tcache.seq == 1


@pytest.fixture(scope="module")
def lio_vm():
    """The reference LIO map after 3 IMU-on sim frames, and its port."""
    cfg = JPRESETS["sim"]()
    sim = LidarImuSimulator(n_rays=2048, seed=0)
    lio = JLio(cfg)
    lio.static_init(*sim.static_imu(50))
    for k in range(3):
        f = sim.frame(k)
        lio.step(JBundle.from_numpy(
            f.pts, f.t_rel, f.imu_stamps, f.imu_acc, f.imu_gyr,
            f.scan_duration, cfg.preprocess.max_points,
            cfg.imu.max_imu_per_scan))
    tvm = interop.from_reference({"vm": _tree(lio.vm)},
                                 TConfig.from_dict(cfg.to_dict()),
                                 device="cpu")["vm"]
    return lio.vm, tvm


def test_extract_planes_matches_reference(lio_vm):
    want = jlive.extract_planes(lio_vm[0])
    got = tlive.extract_planes(lio_vm[1])
    assert got.shape[0] > 0 and got.shape[1] == 8
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("max_planes", [None, 5])
def test_plane_map_ply_matches_reference(lio_vm, tmp_path, max_planes):
    paths = [str(tmp_path / f"{n}.ply") for n in ("jax", "port")]
    n_j = jexport.save_plane_map_ply(lio_vm[0], paths[0],
                                     max_planes=max_planes)
    n_t = texport.save_plane_map_ply(lio_vm[1], paths[1],
                                     max_planes=max_planes)
    assert n_t == n_j > 0
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    verts, faces, colors = texport.load_ply(paths[1])
    assert len(verts) == 4 * n_t and len(faces) == 2 * n_t


def _get(port, path, method="GET", body=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=10)
    conn.request(method, path, body=body)
    r = conn.getresponse()
    raw = r.read()
    conn.close()
    return r.status, raw


def test_live_server_endpoints(meshed, lio_vm):
    cfg = meshed["cfg"]
    cache = tlive.RegionCache(cfg.mesh.region_size, cfg.mesh.voxel_resolution)
    store = interop.from_reference(
        {"store": _tree(meshed["jpipe"].store)},
        TConfig.from_dict(cfg.to_dict()), device="cpu")["store"]
    cache.sync(meshed["gm"], store)
    srv = tlive.LiveMeshServer(cache).start()
    try:
        srv.record_pose(0.1, [1.0, 2.0, 3.0])
        planes = tlive.extract_planes(lio_vm[1])
        srv.record_planes(planes)
        code, html = _get(srv.port, "/")
        assert code == 200 and b"webgl2" in html and b"buildPlanes" in html
        code, body = _get(srv.port, "/state?since=0")
        st = json.loads(body)
        assert code == 200 and st["n_triangles"] > 0 and st["changed"]
        assert st["traj"][0][1:4] == [1.0, 2.0, 3.0]
        rid = st["changed"][0]
        code, raw = _get(srv.port, "/region/" + ",".join(map(str, rid)))
        magic, rx, ry, rz, n = struct.unpack_from("<Iiiii", raw)
        assert code == 200 and magic == tlive._MAGIC == jlive._MAGIC
        assert [rx, ry, rz] == rid and len(raw) == 20 + 36 * n
        code, raw = _get(srv.port, "/planes")
        (m,) = struct.unpack_from("<i", raw)
        assert code == 200 and m == planes.shape[0] > 0
        np.testing.assert_array_equal(
            np.frombuffer(raw[4:], np.float32).reshape(m, 8), planes)
        assert _get(srv.port, "/region/not,a,number")[0] == 400
        assert _get(srv.port, "/nope")[0] == 404
        code, body = _get(srv.port, "/controls")
        assert json.loads(body) == {
            "pause": False, "draw_mesh": True, "draw_traj": True,
            "draw_planes": False, "follow": True, "reinf_step": 2,
            "reinf_max_depth": 80.0}
        assert tlive.LiveMeshServer.CONTROL_TYPES == \
            jlive.LiveMeshServer.CONTROL_TYPES
        code, body = _get(srv.port, "/controls", "POST",
                          json.dumps({"pause": True, "bogus": 1}).encode())
        assert code == 200 and srv.paused and "bogus" not in json.loads(body)
        assert _get(srv.port, "/controls", "POST", b"{nope")[0] == 400
        with pytest.raises(KeyError):
            srv.set_control("nonexistent", 1)
    finally:
        srv.stop()


# ---------------------------------------------------------------------------
# console, oracle mesh
# ---------------------------------------------------------------------------
def test_console_matches_reference():
    import io

    class Tty(io.StringIO):
        def isatty(self):
            return True

    for stream in (io.StringIO(), Tty()):
        assert (tconsole.colorize("hi", "red", bold=True, stream=stream)
                == jconsole.colorize("hi", "red", bold=True, stream=stream))
    for hbm in (8 << 30, 80 << 30):
        assert (tconsole.recommend_capacities(hbm, 0.25)
                == jconsole.recommend_capacities(hbm, 0.25))
    assert tconsole.total_ram_mb() == jconsole.total_ram_mb() > 100.0
    assert tconsole.process_rss_mb() > 1.0


def test_oracle_mesh_matches_reference(meshed):
    pipe = meshed["jpipe"]
    want = jmq.oracle_mesh_from_map(pipe.gm, max_voxels=64, batch=16)
    got = tmq.oracle_mesh_from_map(meshed["gm"], max_voxels=64, batch=16)
    assert len(got) > 100
    np.testing.assert_array_equal(got, want)
    assert (tmq.oracle_boundary_stats(meshed["gm"], max_voxels=64, batch=16)
            == jmq.hole_stats(want))
    faces = tmq.store_faces(meshed["store"])
    np.testing.assert_array_equal(faces, jmq.store_faces(pipe.store))
    verts = meshed["gm"].pts.numpy()
    sim = LidarImuSimulator(n_rays=256, seed=0)
    assert (tmq.mesh_quality_report(verts, faces, sim.scene)
            == jmq.mesh_quality_report(verts, faces, sim.scene))


# ---------------------------------------------------------------------------
# the runtime's hooks
# ---------------------------------------------------------------------------
def test_runtime_viewer_reinforce_and_pause():
    """ImMeshRuntime on the port: the live viewer serves the mesh and the
    trajectory after two frames, `reinforce` follows the viewer's density
    and range controls, and `run` waits while the viewer pauses it."""
    cfg = JPRESETS["sim"]()
    cfg = cfg.replace(
        preprocess=dataclasses.replace(cfg.preprocess, max_points=2048),
        mesh=cfg.mesh.__class__(points_capacity=2 ** 14,
                                voxel_capacity=2 ** 10,
                                active_voxels_per_frame=64, mesh_chunk=8))
    rt = TRuntime(TConfig.from_dict(cfg.to_dict()), device="cpu")
    sim = LidarImuSimulator(n_rays=2048, seed=0)
    rt.static_init(*sim.static_imu(100))

    def bundle(k):
        f = sim.frame(k)
        return TBundle.from_numpy(f.pts, f.t_rel, f.imu_stamps, f.imu_acc,
                                  f.imu_gyr, f.scan_duration, 2048,
                                  cfg.imu.max_imu_per_scan, device="cpu")

    url = rt.start_live_viewer(sync_every=1)
    try:
        for k in range(2):
            rt.process_frame(bundle(k), t=0.1 * k)
        port = int(url.rsplit(":", 1)[1].rstrip("/"))
        code, body = _get(port, "/state?since=0")
        st = json.loads(body)
        assert code == 200 and st["n_triangles"] > 0 and len(st["traj"]) == 2
        code, raw = _get(port, "/planes")
        assert struct.unpack_from("<i", raw)[0] > 0
        assert not rt.mesh.store.dirty.any()
        dense, depth = rt.reinforce()
        assert depth.shape == (240, 320) and np.isfinite(depth).any()
        rt._live.set_control("reinf_step", 4)
        near = float(np.median(depth[np.isfinite(depth)]))
        rt._live.set_control("reinf_max_depth", near)
        sparse, _ = rt.reinforce()
        assert 0 < len(sparse) < len(dense) / 4
        assert np.isfinite(sparse).all()

        rt._live.set_control("pause", True)
        done = []
        th = threading.Thread(
            target=lambda: done.extend(rt.run([bundle(2)])))
        th.start()
        time.sleep(0.3)
        assert rt.paused and not done
        rt._live.set_control("pause", False)
        th.join(timeout=60)
        assert not th.is_alive() and len(done) == 1
    finally:
        rt.stop_live_viewer()


def test_new_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present; the default device is valid")
    verts, faces = _quad()
    with pytest.raises(RuntimeError, match="cuda"):
        traster.PinholeCam.looking((0, 0, 0), (1, 0, 0))
    _, cam = _cams(pos=(0, 0, 0), target=(0, 0, 1), up=(0, -1, 0))
    with pytest.raises(RuntimeError, match="cuda"):
        tviewer.render_mesh_views(verts, faces, cam)
    with pytest.raises(RuntimeError, match="cuda"):
        tviewer.save_snapshot(verts, faces, "unused.png", cam)
    cfg = TConfig.from_dict(JPRESETS["sim"]().to_dict())
    with pytest.raises(RuntimeError, match="cuda"):
        TRuntime(cfg.replace(ba=dataclasses.replace(cfg.ba, enabled=True)))
