"""Port parity of the host frontend: immesh_tpu_torch.frontend against
immesh_tpu.frontend on the same raw bytes, RawScans and files.

Everything here is host NumPy or the native scanpack library on both sides,
so every output is held BYTE-identical (dtype, shape and bits): decoded
points, times and rings of every LAYOUTS entry, Preprocessor outputs on
every gate, LOAM feature masks, dataset readers and the arrays of every
bundle the PacketSynchronizer emits.  The port's library is its own build
of csrc/scanpack.cpp (never native/libscanpack.so); it is held against its
NumPy oracle and against the JAX package's decode_filter.

The last test replays KITTI .bin files through each package's
synchronizer into its LioPipeline (IMU-less, 2,048 rays) and holds the
port's poses to the reference's at 1e-4 m and 1e-5 rad, the tolerance of
tests/test_torch_lio_mesh.py (f32 reduction order in the ESIKF).
"""

import os

import numpy as np
import pytest
import torch

from immesh_tpu.config import PRESETS as JPRESETS
from immesh_tpu.config import LidarType, PreprocessConfig
from immesh_tpu.frontend import features as jfeat
from immesh_tpu.frontend import native as jnative
from immesh_tpu.frontend import preprocess as jpre
from immesh_tpu.frontend.sim import LidarImuSimulator
from immesh_tpu.frontend.sync import PacketSynchronizer as JSync
from immesh_tpu.lio.pipeline import LioPipeline as JLio
from immesh_tpu_torch.config import ImMeshConfig as TConfig
from immesh_tpu_torch.config import PreprocessConfig as TPreprocessConfig
from immesh_tpu_torch.core import so3
from immesh_tpu_torch.frontend import features as tfeat
from immesh_tpu_torch.frontend import native as tnative
from immesh_tpu_torch.frontend import preprocess as tpre
from immesh_tpu_torch.frontend.sync import PacketSynchronizer as TSync
from immesh_tpu_torch.kernels import build
from immesh_tpu_torch.lio.pipeline import LioPipeline as TLio

_NP_OF = {jnative.DTYPE_F32: "<f4", jnative.DTYPE_F64: "<f8",
          jnative.DTYPE_U32: "<u4", jnative.DTYPE_U16: "<u2",
          jnative.DTYPE_U8: "u1", jnative.DTYPE_I32: "<i4"}


def _same(a, b):
    """Byte-identical arrays: dtype, shape and every bit."""
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype,
                                                        a.shape, b.shape)
    assert a.tobytes() == b.tobytes()


def _same_scan(j, t):
    for f in ("xyz", "time_off", "ring", "intensity", "tag"):
        x, y = getattr(j, f), getattr(t, f)
        assert (x is None) == (y is None), f
        if x is not None:
            _same(x, y)
    assert (j.stamp, j.duration) == (t.stamp, t.duration)


def _tcfg(jcfg):
    return TConfig.from_dict(jcfg.to_dict())


def _tpre(jpcfg):
    return TPreprocessConfig(**jpcfg.__dict__)


def _packet(layout, n, seed=0):
    """A strided buffer in `layout` (the construction of tests/
    test_packets.py::_build_packet) with planted rows: NaN, inside the
    blind radius, on the blind edge, beyond max range, on the max-range
    edge, and an infinite coordinate."""
    step, (ox, oy, oz), t_off, t_dt, t_sc, ring_off, ring_dt = \
        tnative.LAYOUTS[layout]
    rng = np.random.default_rng(seed)
    buf = np.zeros((n, step), np.uint8)
    xyz = rng.uniform(-40, 40, (n, 3)).astype(np.float32)
    xyz[3] = [np.nan, 1.0, 2.0]
    xyz[7] = [0.05, 0.0, 0.0]
    xyz[11] = [1.0, 0.0, 0.0]          # r² == blind² exactly: dropped
    xyz[13] = [200.0, 10.0, 0.0]
    xyz[17] = [100.0, 0.0, 0.0]        # r² == max_range² exactly: dropped
    xyz[19] = [np.inf, 0.0, 0.0]
    for off, col in ((ox, 0), (oy, 1), (oz, 2)):
        buf[:, off:off + 4] = xyz[:, col:col + 1].view(np.uint8).reshape(n, 4)
    t_np = np.dtype(_NP_OF[t_dt])
    t_raw = (rng.uniform(0, 0.1, n) / t_sc + 5.0).astype(t_np)
    buf[:, t_off:t_off + t_np.itemsize] = (
        t_raw[:, None].view(np.uint8).reshape(n, t_np.itemsize))
    if ring_off >= 0:
        r_np = np.dtype(_NP_OF[ring_dt])
        ring = rng.integers(0, 64, n).astype(r_np)
        buf[:, ring_off:ring_off + r_np.itemsize] = (
            ring[:, None].view(np.uint8).reshape(n, r_np.itemsize))
    return buf.tobytes()


LAYOUTS = sorted(tnative.LAYOUTS)


def test_layouts_and_dtype_codes_match_the_reference():
    assert tnative.LAYOUTS == jnative.LAYOUTS
    assert tnative._NP_DTYPES == jnative._NP_DTYPES


def test_port_builds_its_own_library():
    lib = tnative._load()
    assert os.path.dirname(lib._name) == build.BUILD_DIR
    assert os.path.basename(lib._name) == "libscanpack.so"
    assert build.source_path("scanpack").endswith(
        os.path.join("immesh_tpu_torch", "csrc", "scanpack.cpp"))


def test_a_failed_build_raises_with_the_compiler_output(tmp_path,
                                                        monkeypatch):
    (tmp_path / "broken.cpp").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(build, "CSRC_DIR", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", str(tmp_path / "_build"))
    with pytest.raises(RuntimeError, match="broken.cpp"):
        build.build(["broken"])
    assert not os.path.exists(build.library_path("broken"))


@pytest.mark.parametrize("filter_num", [1, 3])
@pytest.mark.parametrize("layout", LAYOUTS)
def test_native_decode_matches_oracle_and_reference(layout, filter_num):
    """The port's library == its NumPy oracle == the JAX package's
    decode_filter, byte for byte (xyz, t and ring), planted gate rows
    included."""
    n = 1000
    buf = _packet(layout, n, seed=filter_num)
    step, off_xyz, t_off, t_dt, t_sc, ring_off, ring_dt = \
        tnative.LAYOUTS[layout]
    kw = dict(point_step=step, off_xyz=off_xyz, t_off=t_off, t_dtype=t_dt,
              t_scale=t_sc, ring_off=ring_off, ring_dtype=ring_dt,
              blind=1.0, max_range=100.0, filter_num=filter_num,
              want_ring=True)
    got = tnative.decode_filter(buf, n, **kw)
    oracle = tnative._decode_filter_numpy(
        np.frombuffer(buf, np.uint8), n, step, off_xyz, t_off, t_dt, t_sc,
        ring_off, ring_dt, 1.0, 100.0, filter_num, True)
    ref = jnative.decode_filter(buf, n, **kw)
    for g, o, r in zip(got, oracle, ref):
        _same(g, o)
        _same(g, r)
    assert 0 < len(got[0]) < (n + filter_num - 1) // filter_num
    # without a time field: the same points, zero times
    xyz, t = tnative.decode_filter(buf, n, point_step=step, off_xyz=off_xyz,
                                   blind=1.0, max_range=100.0,
                                   filter_num=filter_num)
    _same(xyz, got[0])
    _same(t, np.zeros(len(xyz), np.float32))


def test_decode_rejects_a_short_buffer():
    with pytest.raises(ValueError, match="fewer than"):
        tnative.decode_filter(b"\0" * 100, 10, point_step=22,
                              off_xyz=(0, 4, 8))


@pytest.mark.parametrize("layout", LAYOUTS)
def test_decode_raw_buffer_matches_reference(layout):
    jcfg = PreprocessConfig(blind=1.0, max_range=100.0, point_filter_num=2,
                            timestamp_unit=1e-3)
    buf = _packet(layout, 512, seed=5)
    j = jpre.decode_raw_buffer(buf, 512, layout, jcfg, stamp=3.0,
                               duration=0.1)
    t = tpre.decode_raw_buffer(buf, 512, layout, _tpre(jcfg), stamp=3.0,
                               duration=0.1)
    _same_scan(j, t)
    # and through the preprocessor
    for a, b in zip(jpre.Preprocessor(jcfg).process(j),
                    tpre.Preprocessor(_tpre(jcfg)).process(t)):
        _same(a, b)


def test_imu_ring_matches_reference():
    """The same stream into both packages' rings (capacity 8, pushes of
    three and drains of at most four): the same accept/refuse answers,
    sizes and drained samples."""
    rng = np.random.default_rng(0)
    stamps = np.cumsum(rng.uniform(0.001, 0.01, 40))
    rings = (jnative.ImuRing(cap=8), tnative.ImuRing(cap=8))
    acc = rng.normal(size=(40, 3)).astype(np.float32)
    gyr = rng.normal(size=(40, 3)).astype(np.float32)
    k = 0
    for step in range(12):
        res = []
        for r in rings:
            pushed = [r.push(stamps[i], acc[i], gyr[i])
                      for i in range(k, min(k + 3, 40))]
            drained = r.drain_until(stamps[min(k, 39)] + 0.004, max_out=4)
            res.append((pushed, len(r), drained))
        (pj, nj, dj), (pt, nt, dt) = res
        assert pj == pt and nj == nt
        for a, b in zip(dj, dt):
            _same(np.asarray(a, b.dtype), b)
        k += 3
    # a full ring refuses, and accepts again once drained
    r = tnative.ImuRing(cap=4)
    assert all(r.push(float(i), acc[i], gyr[i]) for i in range(4))
    assert not r.push(9.0, acc[0], gyr[0])
    s, a, g = r.drain_until(10.0)
    _same(a, acc[:4])
    _same(g, gyr[:4])
    assert len(r) == 0 and r.push(11.0, acc[0], gyr[0]) and len(r) == 1


def _ring_scan(rng, n_rings=8, per_ring=300):
    """A rotating-sensor scan: rings of points on the walls of a square
    room (its corners are edges), a box in front of one wall (depth jumps,
    occlusion edges), in acquisition order."""
    az = np.tile(np.linspace(-np.pi, np.pi, per_ring, endpoint=False),
                 n_rings)
    ring = np.repeat(np.arange(n_rings), per_ring)
    el = np.deg2rad(-15 + 3 * ring)
    r = 8 / np.maximum(np.abs(np.cos(az)), np.abs(np.sin(az)))
    r = np.where((az > 0.2) & (az < 0.6), 5.0, r)
    r = r + rng.normal(0, 0.005, az.size)
    xyz = np.stack([r * np.cos(el) * np.cos(az), r * np.cos(el) * np.sin(az),
                    r * np.sin(el)], -1).astype(np.float32)
    t = ((az + np.pi) / (2 * np.pi) * 0.1).astype(np.float32)
    return xyz, ring.astype(np.int32), t


def test_extract_features_masks_match_reference():
    xyz, ring, t = _ring_scan(np.random.default_rng(0))
    j = jfeat.extract_features(xyz, ring, t)
    p = tfeat.extract_features(xyz, ring, t)
    for a, b in zip(j, p):
        _same(a, b)
    assert j[0].sum() > 100 and j[1].sum() > 0
    cfg = jfeat.FeatureConfig(window=3, n_sectors=4)
    for a, b in zip(jfeat.extract_features(xyz, ring, t, cfg),
                    tfeat.extract_features(
                        xyz, ring, t, tfeat.FeatureConfig(window=3,
                                                          n_sectors=4))):
        _same(a, b)


def _scan_cases():
    rng = np.random.default_rng(1)
    n = 400
    xyz = rng.uniform(-60, 60, (n, 3)).astype(np.float32)
    xyz[::37] = [0.05, 0.0, 0.0]
    xyz[5::41] = np.nan
    xyz[7::43] = [80.0, 80.0, 0.0]
    time_off = np.sort(rng.uniform(0, 100, n)) + 1e3
    tag = rng.integers(0, 256, n).astype(np.uint8)
    az = np.linspace(0, -2 * np.pi * 0.95, n)
    spin = np.stack([20 * np.cos(az), 20 * np.sin(az),
                     rng.uniform(-2, 2, n)], -1).astype(np.float32)
    ring_xyz, ring, ring_t = _ring_scan(rng)
    R = jpre.RawScan
    return {
        "gates": (PreprocessConfig(blind=1.0, max_range=100.0),
                  R(xyz=xyz, time_off=time_off)),
        "decimation": (PreprocessConfig(blind=0.5, point_filter_num=3),
                       R(xyz=xyz, time_off=time_off)),
        "livox_tag": (PreprocessConfig(lidar_type=LidarType.AVIA, blind=0.5),
                      R(xyz=xyz, time_off=time_off, tag=tag)),
        "tag_ignored_off_avia": (
            PreprocessConfig(lidar_type=LidarType.OUST64, blind=0.5),
            R(xyz=xyz, time_off=time_off, tag=tag)),
        "time_ms": (PreprocessConfig(timestamp_unit=1e-3, blind=0.5),
                    R(xyz=xyz, time_off=time_off)),
        "time_ns": (PreprocessConfig(timestamp_unit=1e-9, blind=0.5),
                    R(xyz=xyz, time_off=time_off * 1e6)),
        "time_s": (PreprocessConfig(timestamp_unit=1.0, blind=0.5),
                   R(xyz=xyz, time_off=time_off * 1e-3)),
        "azimuth_time": (PreprocessConfig(blind=0.5),
                         R(xyz=spin, duration=0.1)),
        "azimuth_time_f64_input": (PreprocessConfig(blind=0.5),
                                   R(xyz=spin.astype(np.float64),
                                     duration=0.05)),
        "calib_laser": (PreprocessConfig(lidar_type=LidarType.KITTI64,
                                         calib_laser=True, blind=0.5),
                        R(xyz=spin)),
        "calib_off_other_sensor": (PreprocessConfig(calib_laser=True,
                                                    blind=0.5),
                                   R(xyz=spin)),
        "features_ring": (PreprocessConfig(feature_extract_en=True,
                                           blind=0.5),
                          R(xyz=ring_xyz, time_off=ring_t * 1e3, ring=ring)),
        "features_elevation_ring": (
            PreprocessConfig(feature_extract_en=True, n_scans=8, blind=0.5),
            R(xyz=ring_xyz, time_off=ring_t * 1e3)),
        "features_degenerate": (PreprocessConfig(feature_extract_en=True,
                                                 blind=0.5),
                                R(xyz=spin[:30])),
        "empty": (PreprocessConfig(), R(xyz=np.zeros((0, 3), np.float32))),
    }


@pytest.mark.parametrize("case", sorted(_scan_cases()))
def test_preprocessor_matches_reference(case):
    jcfg, scan = _scan_cases()[case]
    j = jpre.Preprocessor(jcfg).process(scan)
    t = tpre.Preprocessor(_tpre(jcfg)).process(scan)
    for a, b in zip(j, t):
        _same(a, b)
    if case != "empty":
        assert len(j[0]) > 0


def test_kitti_calib_matches_reference():
    xyz = np.random.default_rng(2).uniform(-20, 20, (300, 3)).astype(
        np.float32)
    _same(jpre.kitti_vertical_angle_calib(xyz),
          tpre.kitti_vertical_angle_calib(xyz))


def test_dataset_readers_match_reference(tmp_path):
    rng = np.random.default_rng(3)
    vdir = tmp_path / "velodyne"
    vdir.mkdir()
    for k in range(3):
        rng.uniform(-30, 30, (100 + k, 4)).astype(np.float32).tofile(
            vdir / f"{k:06d}.bin")
    (vdir / "notes.txt").write_text("not a scan")
    _same_scan(jpre.read_kitti_bin(str(vdir / "000001.bin"), 0.05),
               tpre.read_kitti_bin(str(vdir / "000001.bin"), 0.05))
    js = list(jpre.kitti_sequence(str(vdir)))
    ts = list(tpre.kitti_sequence(str(vdir)))
    assert len(js) == len(ts) == 3
    for a, b in zip(js, ts):
        _same_scan(a, b)

    arrays = {"imu_stamps": np.arange(0, 0.35, 0.01),
              "imu_acc": rng.normal(size=(35, 3)).astype(np.float32),
              "imu_gyr": rng.normal(size=(35, 3)).astype(np.float32)}
    for k in range(3):
        arrays[f"scan{k}_xyz"] = rng.normal(size=(50, 3)).astype(np.float32)
        arrays[f"scan{k}_stamp"] = np.float64(0.1 * k + 0.003 * k * k)
        if k != 1:
            arrays[f"scan{k}_time"] = rng.uniform(0, 100, 50)
    path = str(tmp_path / "seq.npz")
    np.savez(path, **arrays)
    jn = list(jpre.read_npz_sequence(path))
    tn = list(tpre.read_npz_sequence(path))
    assert len(jn) == len(tn) == 3
    for (a, ia), (b, ib) in zip(jn, tn):
        _same_scan(a, b)
        assert ia.keys() == ib.keys()
        for key in ia:
            _same(ia[key], ib[key])


def _bundle_arrays(b):
    return [np.asarray(x) if not isinstance(x, torch.Tensor)
            else x.cpu().numpy()
            for x in (b.pts, b.t_rel, b.mask, b.imu_stamps, b.imu_acc,
                      b.imu_gyr, b.imu_mask, b.scan_duration)]


def _same_bundle(jb, tb):
    assert (jb is None) == (tb is None)
    if jb is not None:
        for a, b in zip(_bundle_arrays(jb), _bundle_arrays(tb)):
            _same(a, b)


def _sync_scan(stamp, n=100):
    rng = np.random.default_rng(int(stamp * 1000) % 2 ** 31)
    return jpre.RawScan(xyz=rng.uniform(2, 10, (n, 3)).astype(np.float32),
                        time_off=np.linspace(0, 100, n), stamp=stamp,
                        duration=0.1)


def _imu_less():
    cfg = JPRESETS["kitti"]()
    return cfg.replace(preprocess=PreprocessConfig(
        lidar_type=LidarType.KITTI64, blind=1.0, max_points=1024))


# (config, a script of calls); every call's result is compared
SYNC_CASES = {
    "bundle_window": (JPRESETS["sim"], [
        *[("imu", k * 0.01) for k in range(30)], ("scan", 0.0), ("next",),
        ("scan", 0.1), ("next",), ("next",)]),
    "waits_for_imu": (JPRESETS["sim"], [
        ("scan", 0.0), ("imu", 0.02), ("next",), ("imu", 0.12), ("next",)]),
    "backwards_imu_dropped": (JPRESETS["sim"], [
        ("imu", 0.05), ("imu", 0.01), ("imu", 0.05), ("imu", 0.11),
        ("scan", 0.0), ("next",)]),
    "imu_gap": (JPRESETS["sim"], [
        ("imu", 0.0), ("gap",), ("imu", 0.5), ("gap",), ("gap",),
        ("imu", 0.6), ("gap",)]),
    "loopback_clears": (JPRESETS["sim"], [
        ("scan", 5.0), ("imu", 5.0), ("scan", 0.0), ("imu", 0.05),
        ("imu", 0.1), ("next",), ("next",)]),
    "imu_less": (_imu_less, [("scan", 0.0), ("scan", 0.1), ("next",),
                             ("next",), ("next",)]),
}


@pytest.mark.parametrize("case", sorted(SYNC_CASES))
def test_packet_synchronizer_matches_reference(case):
    make_cfg, script = SYNC_CASES[case]
    jcfg = make_cfg()
    js, ts = JSync(jcfg), TSync(_tcfg(jcfg), device="cpu")
    rng = np.random.default_rng(4)
    for call in script:
        if call[0] == "imu":
            acc, gyr = rng.normal(size=3), rng.normal(size=3)
            js.push_imu(call[1], acc, gyr)
            ts.push_imu(call[1], acc, gyr)
        elif call[0] == "scan":
            js.push_scan(_sync_scan(call[1]))
            ts.push_scan(_sync_scan(call[1]))
        elif call[0] == "gap":
            assert js.consume_gap() == ts.consume_gap()
        else:
            _same_bundle(js.next_bundle(), ts.next_bundle())
        assert len(js.scans) == len(ts.scans)
        assert js.imu_t == ts.imu_t
        for a, b in zip(js.imu_acc + js.imu_gyr, ts.imu_acc + ts.imu_gyr):
            _same(a, b)
        assert js.last_imu_t == ts.last_imu_t
        assert js.imu_gap_detected == ts.imu_gap_detected


def test_synchronizer_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present; the default device is usable")
    with pytest.raises(RuntimeError, match="cuda"):
        TSync(_tcfg(JPRESETS["sim"]()))


def test_kitti_bin_replay_through_both_synchronizers(tmp_path):
    """KITTI .bin files (2,048 rays from the clockwise simulator) read back
    through kitti_sequence → PacketSynchronizer (IMU-less) → LioPipeline in
    each package: the same bundles byte for byte, and poses within 1e-4 m
    and 1e-5 rad of the reference's on every frame."""
    sim = LidarImuSimulator(n_rays=2048, seed=7, clockwise=True)
    vdir = tmp_path / "velodyne"
    vdir.mkdir()
    for k in range(5):
        f = sim.frame(k)
        np.concatenate([f.pts, np.ones((len(f.pts), 1), np.float32)],
                       axis=1).astype(np.float32).tofile(
                           vdir / f"{k:06d}.bin")
    base = JPRESETS["kitti"]()
    jcfg = base.replace(
        preprocess=base.preprocess.__class__(
            lidar_type=LidarType.KITTI64, n_scans=16, blind=1.0,
            calib_laser=False, max_points=4096),
        voxel_map=base.voxel_map.__class__(
            voxel_size=3.0, max_points_per_voxel=1000, capacity=2 ** 14))
    js, ts = JSync(jcfg), TSync(_tcfg(jcfg), device="cpu")
    jl, tl = JLio(jcfg), TLio(_tcfg(jcfg), device="cpu")
    for k, (a, b) in enumerate(zip(jpre.kitti_sequence(str(vdir)),
                                   tpre.kitti_sequence(str(vdir)))):
        _same_scan(a, b)
        js.push_scan(a)
        ts.push_scan(b)
        jb, tb = js.next_bundle(), ts.next_bundle()
        _same_bundle(jb, tb)
        jl.step(jb)
        tl.step(tb)
        np.testing.assert_allclose(tl.state.pos.numpy(),
                                   np.asarray(jl.state.pos), atol=1e-4)
        dR = np.asarray(jl.state.rot).T @ tl.state.rot.numpy()
        ang = so3.log(torch.from_numpy(dR.astype(np.float32))).norm()
        assert float(ang) < 1e-5, (k, float(ang))
    assert np.linalg.norm(np.asarray(jl.state.pos)) > 0.1
