"""The two stage profilers of the port, tools/torch_profile_lio.py and
tools/torch_profile_stages.py, on the CPU at chip_smoke.small_config()
(8,192 rays) and small_avia_config() (4,096 rays, IMU on, extrinsics).

  * the LIO stages composed in order reproduce lio_step bit for bit
    (state, world scan, every field of the plane map): the same ops on the
    same inputs;
  * map_update runs on copies and the read-only stages (associate_x1,
    esikf_update_x3) leave the pipeline's map bit-identical;
  * the profile_stages sequence over three frames leaves the same store,
    point map and filter state as lio_step + MeshPipeline.step without
    compaction, EXACTLY;
  * lio_update alone, the one LIO stage no other test holds alone, against
    immesh_tpu.lio.esikf.lio_update on the same frame and inputs, with the
    tolerances of tests/test_torch_lio_mesh.py::
    test_lio_step_matches_reference (pose 1e-4 m and 1e-5 rad, vel and bg
    1e-3, covariance 1e-3 of its largest entry);
  * each tool's output keys include its JAX counterpart's, read from
    tools/profile_lio.py and tools/profile_stages.py by AST (not run)."""

import ast
import dataclasses
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp
from immesh_tpu.config import ImMeshConfig as JConfig
from immesh_tpu.core.state import EsikfState as JEsikfState
from immesh_tpu.lio.esikf import lio_update as j_lio_update
from immesh_tpu.map.voxel_map import VoxelMap as JVoxelMap
from immesh_tpu_torch.core import so3
from immesh_tpu_torch.lio.esikf import lio_update as t_lio_update
from immesh_tpu_torch.lio.pipeline import LioPipeline, lio_step
from immesh_tpu_torch.mesh.pipeline import MeshPipeline

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WARM = 2  # frames before the profiled one


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores; eager torch ops on small
    tensors gain nothing from threads, and oversubscribed threads slow
    every worker, so this module runs torch on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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
        yield (_load("tools/torch_profile_lio.py", "torch_profile_lio"),
               _load("tools/torch_profile_stages.py", "torch_profile_stages"),
               chip_smoke)
    finally:
        sys.path.remove(ROOT)


def _path(chip_smoke, path: str, n: int):
    """(cfg, n simulator frames, static IMU samples or None) at the CPU's
    cut of a chip_smoke path."""
    if path == "kitti":
        cfg = chip_smoke.small_config()
        sim = chip_smoke.make_sim(cfg.preprocess.max_points, 16)
        return cfg, [sim.frame(k) for k in range(n)], None
    cfg = chip_smoke.small_avia_config()
    sim = chip_smoke.make_avia_sim(cfg)
    static = sim.static_imu(100)
    return cfg, [sim.frame(k) for k in range(n)], static


def _warm(chip_smoke, path):
    cfg, scans, static = _path(chip_smoke, path, WARM + 1)
    pipe = LioPipeline(cfg, device="cpu")
    if static is not None:
        pipe.static_init(*static)
    bundles = [chip_smoke.bundle(f, cfg, "cpu") for f in scans]
    for b in bundles[:WARM]:
        pipe.step(b)
    return cfg, pipe, bundles[WARM]


def _map_arrays(vm) -> dict:
    out = {"keys": vm.table.keys.numpy().copy(),
           "fp": vm.table.fp.numpy().copy()}
    out.update({n: getattr(vm, n).numpy().copy() for n in vm._FIELDS})
    return out


def _assert_same_arrays(a: dict, b: dict):
    assert a.keys() == b.keys()
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


@pytest.mark.parametrize("path", ["kitti", "avia"])
def test_lio_stages_compose_to_lio_step(tools, path):
    tlio, _, chip_smoke = tools
    cfg, pipe, b = _warm(chip_smoke, path)
    vm_ref, vm_comp = pipe.vm.clone(), pipe.vm.clone()
    st, _, world, diag = lio_step(pipe.state, vm_ref, b, cfg, pipe.ext)
    x = tlio.compose(pipe.state, vm_comp, b, cfg)
    assert set(tlio.stage_names(cfg)) >= {"downsample", "pcov",
                                          "esikf_update_x3", "map_update"}
    for f in dataclasses.fields(st):
        np.testing.assert_array_equal(getattr(st, f.name).numpy(),
                                      getattr(x["state_new"], f.name).numpy(),
                                      err_msg=f.name)
    np.testing.assert_array_equal(world.numpy(), x["world"].numpy())
    assert int(diag["n_effective"]) == int(x["diag"]["n_effective"]) > 100
    _assert_same_arrays(_map_arrays(vm_ref), _map_arrays(vm_comp))
    # the step grew the map: the comparison above has something to hold
    assert int(vm_comp.n_voxels()) > int(pipe.vm.n_voxels())


@pytest.mark.parametrize("path", ["kitti", "avia"])
def test_stages_leave_the_pipeline_map(tools, path):
    """map_update repeated on copies, and the read-only stages on the map
    itself, leave the pipeline's map bit-identical; the same map_update on
    the map itself changes it."""
    tlio, _, chip_smoke = tools
    cfg, pipe, b = _warm(chip_smoke, path)
    before = _map_arrays(pipe.vm)
    x = tlio.compose(pipe.state, pipe.vm.clone(), b, cfg)
    stages = tlio.lio_stages(x, b, cfg)
    for _ in range(3):
        stages["map_update"](pipe.vm.clone())
    stages["associate_x1"](pipe.vm)
    n_it = tlio.esikf_iterations(lambda: stages["esikf_update_x3"](pipe.vm))
    assert 1 <= n_it <= cfg.lio.max_iterations
    _assert_same_arrays(before, _map_arrays(pipe.vm))
    stages["map_update"](pipe.vm)
    assert not np.array_equal(before["count"], pipe.vm.count.numpy())


@pytest.fixture(scope="module", params=["kitti", "avia"])
def lio_run(request, tools):
    """(path, cfg, profile_lio's output) at 2 warm frames and 2 repeats."""
    tlio, _, chip_smoke = tools
    cfg, scans, static = _path(chip_smoke, request.param, WARM + 1)
    return request.param, cfg, tlio.profile_lio(cfg, scans, "cpu", WARM, 2,
                                                static)


@pytest.fixture(scope="module")
def stages_run(tools):
    """(cfg, run_stages' output): 1 warm-up + 2 frames, no compaction."""
    _, tstages, chip_smoke = tools
    base = chip_smoke.small_config()
    cfg = base.replace(mesh=dataclasses.replace(base.mesh,
                                                compact_check_every=0))
    sim = chip_smoke.make_sim(cfg.preprocess.max_points, 16)
    scans = [sim.frame(k) for k in range(3)]
    return cfg, scans, tstages.run_stages(cfg, scans, "cpu", warmup=1)


def test_profile_lio_on_the_cpu(tools, lio_run):
    tlio = tools[0]
    _, cfg, out = lio_run
    assert all(out["compose_matches"].values())
    assert out["map_unchanged"] == {n: True for n in tlio.stage_names(cfg)}
    assert list(out["profiled"]) == list(tlio.stage_names(cfg))
    for name, counts in out["profiled"].items():
        assert np.isfinite(out[name]) and out[name] > 0
        assert counts == {"launches": 0, "syncs": 0, "copies": 0,
                          "busy_ms": 0.0}, name  # no device on the CPU
    assert "CPU run" in out["note"]
    assert 1 <= out["esikf_iterations"] <= cfg.lio.max_iterations
    summed = [n for n in tlio.stage_names(cfg) if n != "associate_x1"]
    assert list(out["in_sequence"]) == summed
    np.testing.assert_allclose(out["stages_sum_ms"],
                               sum(out[n] for n in summed))
    np.testing.assert_allclose(out["in_sequence_sum_ms"],
                               sum(out["in_sequence"].values()))
    for name, ms in out["rounds"].items():  # each figure the least round
        assert len(ms) == tlio.ROUNDS
        if name not in ("lio_step", "in_sequence"):
            assert out[name] == min(ms)
    assert out["lio_step_ms"] == min(out["rounds"]["lio_step"])
    assert any("ESIKF iterations" in r for r in tlio.table(out))


def test_profile_stages_matches_mesh_pipeline(tools, stages_run):
    _, tstages, chip_smoke = tools
    cfg, scans, out = stages_run
    lio, mesh = out["pipes"]

    ref_lio = LioPipeline(cfg, device="cpu")
    ref_mesh = MeshPipeline(cfg, device="cpu")
    for f in scans:
        b = chip_smoke.bundle(f, cfg, "cpu")
        ref_lio.state, ref_lio.vm, world, _ = lio_step(
            ref_lio.state, ref_lio.vm, b, cfg, ref_lio.ext)
        ref_mesh.step(world, b.mask, ref_lio.state.pos)
    assert int(ref_mesh.store.n_triangles()) > 0
    for got, want in ((mesh.gm, ref_mesh.gm), (mesh.store, ref_mesh.store),
                      (lio.state, ref_lio.state), (lio.vm, ref_lio.vm)):
        for f in dataclasses.fields(want):
            a, w = getattr(got, f.name), getattr(want, f.name)
            if hasattr(w, "keys") and hasattr(w, "fp"):  # a HashTable
                a, w = torch.cat([a.keys, a.fp[:, None]], 1), \
                    torch.cat([w.keys, w.fp[:, None]], 1)
            if torch.is_tensor(w):
                np.testing.assert_array_equal(a.numpy(), w.numpy(),
                                              err_msg=f.name)


def test_profile_stages_on_the_cpu(tools, stages_run):
    tstages = tools[1]
    _, _, out = stages_run
    assert out["n_frames"] == 2
    assert [len(r["ms"]) for r in out["frames"]] == [0, 6, 6]
    assert set(out["profiled"]) == set(tstages.STAGES)
    assert all(c["launches"] == 0 for c in out["profiled"].values())
    assert "CPU run" in out["note"]
    # the CPU runs pairs_argmin's plain version, which counts no launch
    assert out["pairs_launches_per_frame"] == dict.fromkeys(tstages.STAGES,
                                                            0.0)
    np.testing.assert_allclose(
        out["total_ms"], sum(out[s] for s in tstages.STAGES))
    assert any("pull counted twice" in r for r in tstages.table(out))


# ---------------------------------------------------------------------------
# the JAX tools' keys, by AST
# ---------------------------------------------------------------------------
def _jax_lio_keys() -> list:
    tree = ast.parse(open(os.path.join(ROOT, "tools/profile_lio.py")).read())
    for node in ast.walk(tree):
        if (isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict)
                and [t.id for t in node.targets] == ["stages"]):
            return [k.value for k in node.value.keys]
    raise AssertionError("no `stages` dict in tools/profile_lio.py")


def _jax_stages_keys() -> list:
    tree = ast.parse(open(os.path.join(ROOT,
                                       "tools/profile_stages.py")).read())
    keys = []
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and node.args
                and isinstance(node.args[0], ast.Constant)
                and isinstance(node.args[0].value, str)
                and (getattr(node.func, "id", None) == "timed"
                     or getattr(node.func, "attr", None) == "setdefault")):
            keys.append(node.args[0].value)
        elif (isinstance(node, ast.Subscript)
              and isinstance(node.ctx, ast.Store)
              and getattr(node.value, "id", None) == "out"):
            keys.append(node.slice.value)
    return keys


def test_jax_tool_keys_are_read():
    assert _jax_lio_keys() == ["deskew_const", "downsample", "pcov",
                               "associate_x1", "esikf_update_x3",
                               "map_update", "world_transform"]
    assert set(_jax_stages_keys()) == {"lio", "append", "smooth", "pull",
                                       "delaunay", "apply", "n_frames",
                                       "total_ms"}


def test_profile_lio_output_has_the_jax_keys(tools, lio_run):
    path, cfg, out = lio_run
    jax_keys = _jax_lio_keys()
    if path == "avia":  # the IMU path deskews through imu_propagate + deskew
        jax_keys.remove("deskew_const")
    assert set(jax_keys) <= set(tools[0].stage_names(cfg))
    assert set(jax_keys) <= set(out)
    for k in jax_keys:
        assert isinstance(out[k], float)


def test_profile_stages_output_has_the_jax_keys(stages_run):
    _, _, out = stages_run
    assert set(_jax_stages_keys()) <= set(out)
    for k in _jax_stages_keys():
        assert isinstance(out[k], (int, float))


@pytest.mark.parametrize("tool", ["torch_profile_lio", "torch_profile_stages"])
def test_tools_raise_without_a_card(tools, tool, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "argv", [tool])
    mod = tools[0] if tool == "torch_profile_lio" else tools[1]
    with pytest.raises(RuntimeError, match="cuda"):
        mod.main()


# ---------------------------------------------------------------------------
# lio_update alone against the JAX package
# ---------------------------------------------------------------------------
def _state_to_jax(st) -> JEsikfState:
    return JEsikfState(**{f.name: jnp.asarray(getattr(st, f.name).numpy())
                          for f in dataclasses.fields(st)})


def _map_to_jax(vm, jmap_cfg) -> JVoxelMap:
    """The port's plane map as the reference's, field for field."""
    base = JVoxelMap.create(jmap_cfg)
    return base.replace(
        table=base.table.replace(keys=jnp.asarray(vm.table.keys.numpy()),
                                 fp=jnp.asarray(vm.table.fp.numpy())),
        **{n: jnp.asarray(getattr(vm, n).numpy()) for n in vm._FIELDS})


def test_lio_update_matches_reference(tools):
    """The port's pipeline warms up on WARM frames at small_config; its
    filter and map go to the reference as they are, and both lio_update
    take frame WARM's propagated state, downsampled points, covariances
    and mask as compose() made them."""
    tlio, _, chip_smoke = tools
    cfg, pipe, b = _warm(chip_smoke, "kitti")
    x = tlio.compose(pipe.state, pipe.vm.clone(), b, cfg)
    ts, tdiag = t_lio_update(x["state_prop"], pipe.vm, x["down_pts"],
                             x["pcov"], x["down_mask"], cfg.lio,
                             cfg.voxel_map)
    jcfg = JConfig.from_dict(cfg.to_dict())
    js, jdiag = j_lio_update(
        _state_to_jax(x["state_prop"]), _map_to_jax(pipe.vm, jcfg.voxel_map),
        *(jnp.asarray(x[k].numpy()) for k in ("down_pts", "pcov",
                                              "down_mask")),
        jcfg.lio, jcfg.voxel_map)

    assert int(tdiag["n_effective"]) > 1000
    assert abs(int(jdiag["n_effective"]) - int(tdiag["n_effective"])) <= 2
    assert bool(jdiag["converged"]) == bool(tdiag["converged"])
    np.testing.assert_allclose(np.asarray(js.pos), ts.pos.numpy(), atol=1e-4)
    dR = so3.log(torch.from_numpy(np.array(js.rot)).T @ ts.rot)
    assert float(dR.norm()) < 1e-5
    for name in ("vel", "bg"):
        np.testing.assert_allclose(np.asarray(getattr(js, name)),
                                   getattr(ts, name).numpy(), atol=1e-3)
    jc, tc = np.asarray(js.cov), ts.cov.numpy()
    np.testing.assert_allclose(jc, tc, atol=1e-3 * np.abs(jc).max())
    # the update moved the state: the comparison above has something to hold
    assert float(torch.linalg.norm(ts.pos - x["state_prop"].pos)) > 1e-4
