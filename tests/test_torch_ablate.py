"""Port parity of MeshConfig.ablate, the reference's profiling cuts: nine
of the triangulation (mesh/triangles.py) and five of the append
(mesh/global_map.py), each returning what the reference returns at that
point; and tools/torch_ablate_e2e.py, the port's counterpart of
tools/ablate_e2e.py, which chains them on the card.

MeshPipeline runs PRESETS["sim"]'s mesh config cut to 2^12 points, 2^9
voxels, 64 active voxels and chunks of 16 on three frames of 500 points of
a gently curved surface, the later frames shifted so the map re-meshes
voxels it already holds.  The mesh step is compared EXACTLY (the same ops
on the same inputs), cut by cut.  The reference's "argmin0" cannot run on
the CPU (it launches the Pallas kernel without interpret mode), so the
port's is held to the reference's "pull0" state — the same empty output
by the reference's construction — and must have reached the argmin.
JointPipeline runs under one cut of each family at PRESETS["sim"] with
2,048-ray bundles, pose within 1e-3 m of the reference's per frame (as
tests/test_torch_port_gaps.py holds the same pipeline)."""

import dataclasses
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import immesh_tpu.runtime.joint as jjoint
import immesh_tpu_torch.mesh.triangles as ttri
import immesh_tpu_torch.runtime.joint as tjoint
from immesh_tpu.config import ImMeshConfig as JConfig
from immesh_tpu.config import PRESETS as JPRESETS
from immesh_tpu.frontend.sim import LidarImuSimulator
from immesh_tpu.frontend.types import ScanBundle as JBundle
from immesh_tpu.mesh.pipeline import MeshPipeline as JMeshPipe
from immesh_tpu_torch.config import ImMeshConfig as TConfig
from immesh_tpu_torch.frontend.types import ScanBundle as TBundle
from immesh_tpu_torch.mesh.global_map import GlobalPointMap
from immesh_tpu_torch.mesh.pipeline import MeshPipeline as TMeshPipe

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TRI_CUTS = ("skip_tri", "pull0", "pairs0", "compact0", "fake_tri3", "tri30",
            "gather0", "sort30")
APP_CUTS = ("app_cell0", "app_insert0", "app_alloc0", "app_file0",
            "app_active0")
N_PTS, N_FRAMES = 500, 3
N_RAYS, N_STEPS = 2048, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores; eager torch ops on small
    tensors gain nothing from threads, and oversubscribed threads slow
    every worker, so this module runs torch on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh_config(cut: str):
    cfg = JPRESETS["sim"]()
    return cfg.replace(mesh=dataclasses.replace(
        cfg.mesh, points_capacity=2 ** 12, voxel_capacity=2 ** 9,
        active_voxels_per_frame=64, mesh_chunk=16, ablate=cut))


def _scans():
    rng = np.random.default_rng(11)
    xy = rng.uniform(-1.0, 1.0, (N_PTS, 2))
    z = 0.15 * np.sin(1.5 * xy[:, 0]) * np.cos(xy[:, 1])
    base = np.concatenate([xy, z[:, None]], -1)
    out = []
    for k in range(N_FRAMES):
        p = base + [0.35 * k, 0.2 * k, 0.0] + rng.normal(0, 0.003, base.shape)
        out.append(p.astype(np.float32))
    return out


SENSOR = np.array([0.0, 0.0, 2.0], np.float32)
_REF = {}


def _reference(cut: str) -> dict:
    """The JAX MeshPipeline's per-frame returns and final state under `cut`
    (each configuration compiled once per module)."""
    if cut not in _REF:
        jm = JMeshPipe(_mesh_config(cut))
        ns = [int(jm.step(p, np.ones(N_PTS, bool), SENSOR)) for p in _scans()]
        gm, st = jm.gm, jm.store
        _REF[cut] = {"n_active": ns, "pt_count": int(gm.pt_count),
                     "frame_no": int(gm.frame_no), "pts": np.asarray(gm.pts),
                     "vox_n": np.asarray(gm.vox_n),
                     "vox_new": np.asarray(gm.vox_new),
                     "tri_ids": np.asarray(st.tri_ids),
                     "tri_n": np.asarray(st.tri_n)}
    return _REF[cut]


def _port(cut: str):
    tm = TMeshPipe(TConfig.from_dict(_mesh_config(cut).to_dict()),
                   device="cpu")
    ns = [int(tm.step(p, np.ones(N_PTS, bool), SENSOR)[0]) for p in _scans()]
    return tm, ns


def _assert_state_equal(tm, ns, ref):
    assert ns == ref["n_active"]
    assert int(tm.gm.pt_count) == ref["pt_count"]
    assert int(tm.gm.frame_no) == ref["frame_no"] == N_FRAMES
    for name in ("pts", "vox_n", "vox_new"):
        np.testing.assert_array_equal(getattr(tm.gm, name).numpy(),
                                      ref[name], err_msg=name)
    np.testing.assert_array_equal(tm.store.tri_ids.numpy(), ref["tri_ids"])
    np.testing.assert_array_equal(tm.store.tri_n.numpy(), ref["tri_n"])


@pytest.mark.parametrize("cut", ("",) + TRI_CUTS + APP_CUTS)
def test_cut_matches_reference(cut):
    tm, ns = _port(cut)
    ref = _reference(cut)
    _assert_state_equal(tm, ns, ref)
    n_tri = int(tm.store.n_triangles())
    if cut in ("", "fake_tri3"):
        assert n_tri > 0
    else:
        assert n_tri == 0
    if cut == "fake_tri3":  # real triangles, not the full run's
        assert not np.array_equal(ref["tri_ids"], _reference("")["tri_ids"])
    if cut.startswith("app_"):
        # the in-place append must leave nothing behind: the map equals a
        # fresh one but for its frame counter
        fresh = GlobalPointMap.create(tm.gm.cfg, device="cpu")
        for f in dataclasses.fields(fresh):
            a, b = getattr(tm.gm, f.name), getattr(fresh, f.name)
            if f.name == "frame_no":
                assert int(a) == N_FRAMES
            elif f.name in ("dedup", "vox"):
                assert torch.equal(a.keys, b.keys), f.name
                assert torch.equal(a.fp, b.fp), f.name
            elif isinstance(a, torch.Tensor):
                assert torch.equal(a, b), f.name
    else:
        assert int(tm.gm.pt_count) > 0


def test_argmin0_reaches_the_argmin_and_leaves_the_pull0_state(monkeypatch):
    calls = []
    pairs_argmin = ttri.pairs_argmin

    def counted(u, v, lift, valid, d_eps):
        calls.append((tuple(u.shape), float(d_eps.max())))
        assert torch.equal(lift, u * u + v * v)  # the unperturbed lift
        return pairs_argmin(u, v, lift, valid, d_eps)

    monkeypatch.setattr(ttri, "pairs_argmin", counted)
    tm, ns = _port("argmin0")
    assert calls and all(c == ((16, 48), pytest.approx(1e-6)) for c in calls)
    _assert_state_equal(tm, ns, _reference("pull0"))
    assert int(tm.store.n_triangles()) == 0 and int(tm.gm.pt_count) > 0


def _joint_config(cut: str):
    base = JPRESETS["sim"]()
    return base.replace(
        preprocess=dataclasses.replace(base.preprocess, max_points=N_RAYS),
        mesh=dataclasses.replace(base.mesh, ablate=cut))


@pytest.mark.parametrize("cut", ["gather0", "app_alloc0"])
def test_joint_pipeline_under_a_cut_matches_reference(cut):
    cfg = _joint_config(cut)
    sim = LidarImuSimulator(n_rays=N_RAYS, seed=3)
    acc, gyr = sim.static_imu(100)
    jp = jjoint.JointPipeline(cfg)
    tp = tjoint.JointPipeline(TConfig.from_dict(cfg.to_dict()), device="cpu")
    jp.static_init(acc, gyr)
    tp.static_init(acc, gyr)
    for k in range(N_STEPS):
        f = sim.frame(k)
        args = (f.pts, f.t_rel, f.imu_stamps, f.imu_acc, f.imu_gyr,
                f.scan_duration, cfg.preprocess.max_points,
                cfg.imu.max_imu_per_scan)
        jp.step(JBundle.from_numpy(*args))
        tp.step(TBundle.from_numpy(*args, device="cpu"))
        np.testing.assert_allclose(tp.state.pos.numpy(),
                                   np.asarray(jp.state.pos), atol=1e-3,
                                   err_msg=f"frame {k}")
    assert int(tp.store.n_triangles()) == int(jp.store.n_triangles()) == 0
    assert int(tp.mesh.gm.frame_no) == int(jp.mesh.gm.frame_no) == N_STEPS
    n_t, n_j = int(tp.mesh.gm.pt_count), int(jp.mesh.gm.pt_count)
    if cut.startswith("app_"):
        assert n_t == n_j == 0
    else:
        assert n_j > 0 and abs(n_t - n_j) <= 0.01 * n_j


# ---------------------------------------------------------------------------
# tools/torch_ablate_e2e.py against tools/ablate_e2e.py
# ---------------------------------------------------------------------------
def _load(rel: str, name: str):
    spec = importlib.util.spec_from_file_location(name,
                                                  os.path.join(ROOT, rel))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def tools():
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
        yield (_load("tools/ablate_e2e.py", "jax_ablate_e2e"),
               _load("tools/torch_ablate_e2e.py", "torch_ablate_e2e"),
               chip_smoke)
    finally:
        sys.path.remove(ROOT)


def test_tool_variants_are_the_references(tools):
    jtool, ttool, _ = tools
    assert list(ttool.VARIANTS) == list(jtool.VARIANTS)
    assert ttool.VARIANTS == jtool.VARIANTS


@pytest.mark.parametrize("name", list(_load("tools/ablate_e2e.py",
                                            "jax_ablate_e2e").VARIANTS))
def test_tool_apply_variant_matches_reference(tools, name):
    jtool, ttool, chip_smoke = tools
    tcfg = chip_smoke.kitti_config()
    jcfg = JConfig.from_dict(tcfg.to_dict())
    got = ttool.apply_variant(tcfg, ttool.VARIANTS[name])
    want = jtool.apply_variant(jcfg, jtool.VARIANTS[name])
    assert got.to_dict() == want.to_dict()


def test_tool_runs_a_cut_on_the_cpu(tools, monkeypatch):
    _, ttool, chip_smoke = tools
    monkeypatch.setattr(chip_smoke, "kitti_config", chip_smoke.small_config)
    out = ttool.run_variant("gather0", ttool.VARIANTS["gather0"], frames=1,
                            warmup=1, device="cpu")
    assert out["variant"] == "gather0"
    assert out["triangles"] == 0 and out["map_points"] > 0
    assert out["pairs_launches_per_frame"] == 0  # the CPU launches no kernel
    assert np.isfinite(out["ms_median"]) and out["ms_p90"] >= out["ms_median"]
    assert 0 < out["mesh_ms_median"] < out["ms_median"]
