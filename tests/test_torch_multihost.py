"""Port parity, multi-host scaffolding: immesh_tpu_torch/dist/multihost.py
against immesh_tpu/dist/multihost.py on the CPU — the no-op initialize of
a single-process run, the DeviceMesh builders in a spawned world of two
gloo ranks, and the scaling harness at worlds [1, 2], which must report
the JAX harness's keys (with `shared_device` in place of its
`cpu_virtual_mesh`)."""

import ast
import inspect
import json

import numpy as np
import pytest
import torch

import torch_dist_worker as worker
from immesh_tpu.dist import multihost as jmh
from immesh_tpu_torch.config import PRESETS
from immesh_tpu_torch.dist import multihost


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores; eager torch ops on small
    tensors gain nothing from threads, and oversubscribed threads slow
    every worker, so this module runs torch on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_single_process_noop(monkeypatch):
    monkeypatch.delenv(multihost.ENV_COORDINATOR, raising=False)
    assert multihost.initialize() is False


def test_env_single_process_noop(monkeypatch):
    assert (multihost.ENV_COORDINATOR, multihost.ENV_NUM_PROCESSES,
            multihost.ENV_PROCESS_ID) == (
        jmh.ENV_COORDINATOR, jmh.ENV_NUM_PROCESSES, jmh.ENV_PROCESS_ID)
    monkeypatch.setenv(multihost.ENV_COORDINATOR, "127.0.0.1:1")
    monkeypatch.setenv(multihost.ENV_NUM_PROCESSES, "1")
    assert multihost.initialize() is False


def test_mesh_builders_in_a_world_of_two():
    out = multihost.run_world(worker.run_all, 2, ([("mesh_builders", {})],))
    for rank, (r,) in enumerate(out):
        assert r["shape"] == (2,) and r["names"] == ("dp",)
        assert r["host_shape"] == (1, 2)
        assert r["host_names"] == ("host", "dp")
        assert r["group_size"] == 2
        np.testing.assert_array_equal(r["block"], np.arange(4) + 10 * rank)
        np.testing.assert_array_equal(r["sum"], 2 * np.arange(4) + 10)


def _jax_curve_keys():
    """The keys of one entry of the JAX scaling_curve's result list."""
    tree = ast.parse(inspect.getsource(jmh.scaling_curve))
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "append"
                and isinstance(node.args[0], ast.Dict)):
            return {k.value for k in node.args[0].keys}
    raise AssertionError("no results.append({...}) in the JAX harness")


def test_scaling_curve_reports_the_jax_keys(tmp_path):
    cfg = PRESETS["sim"]()
    cfg = cfg.replace(
        preprocess=cfg.preprocess.__class__(
            lidar_type=cfg.preprocess.lidar_type, max_points=1024),
        voxel_map=cfg.voxel_map.__class__(
            voxel_size=0.8, capacity=2 ** 12, max_probe=16),
        lio=cfg.lio.__class__(max_iterations=2, map_update_points=512),
        mesh=cfg.mesh.__class__(
            points_capacity=2 ** 14, voxel_capacity=2 ** 10,
            active_voxels_per_frame=64, mesh_chunk=8),
    )
    out = tmp_path / "scaling.json"
    res = multihost.scaling_curve(cfg, [1, 2], frames=2, warmup=1,
                                  out_path=str(out), device="cpu")
    keys = _jax_curve_keys() - {"cpu_virtual_mesh"} | {"shared_device"}
    assert [r["n_devices"] for r in res] == [1, 2]
    for r in res:
        assert keys <= set(r)
        assert r["frames_per_s"] > 0 and r["t_lio_ms"] > 0
        assert r["backend"] == "gloo" and r["device"] == "cpu"
    assert res[0]["speedup"] == 1.0
    assert [r["shared_device"] for r in res] == [False, True]
    assert json.loads(out.read_text()) == res
