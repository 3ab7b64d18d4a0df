"""Port parity, multi-rank meshing: immesh_tpu_torch/dist/mesh.py run as two
gloo ranks (one spawned world for the module, tests/torch_dist_worker.py)
against the JAX dist/mesh.py steps on a 2-device CPU mesh and against the
port's single-device MeshPipeline.

Held EXACTLY: the triangle set, keyed by the exact f32 vertex positions
(store ids are shard-local), of
  * the capacity-sharded step at slab_voxels=1 (every 0.4 m column changes
    owner: the most boundaries) over two frames, the second an
    incremental re-mesh, as tests/test_dist.py:156-186;
  * the same at slab_voxels=16, where keep fraction × margin =
    (16 + 4)/(16·2)·1.5 < 1, so the pre-partitioned append (compacted
    buffer, scaled budgets) is the path under test, as
    tests/test_dist.py:219-254;
  * the compute-parallel step (replicated store: triangle ids too);
and the summed counters (active voxels, triangles, pre-partition drops);
a frame concentrated in one rank's slab overflows its buffer and the
excess is counted, row for row (tests/test_dist.py:256-278 asks > 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
import pytest
from jax.sharding import Mesh

import torch_dist_worker as worker
from immesh_tpu.config import PRESETS as JPRESETS
from immesh_tpu.dist import mesh as jdmesh
from immesh_tpu.mesh.global_map import GlobalPointMap as JGM
from immesh_tpu.mesh.triangles import TriangleStore as JStore
from immesh_tpu_torch.config import PRESETS
from immesh_tpu_torch.dist.mesh import shard_keep_fraction
from immesh_tpu_torch.dist.multihost import run_world
from immesh_tpu_torch.mesh.pipeline import MeshPipeline as TMeshPipe

WORLD = 2
SENSOR_GRID = (0.0, 0.0, 2.0)
SENSOR_STRIP = (12.0, 0.5, 2.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores; eager torch ops on small
    tensors gain nothing from threads, and oversubscribed threads slow
    every worker, so this module runs torch on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pad(pts):
    n = len(pts)
    pad = (-n) % WORLD
    return (np.concatenate([pts, np.zeros((pad, 3), np.float32)]),
            np.concatenate([np.ones(n, bool), np.zeros(pad, bool)]))


def _cloud(seed, shift=0.0):
    """tests/test_dist.py TestShardedMesh._cloud: a jittered 0.12 m grid."""
    rng = np.random.default_rng(seed)
    g = np.arange(-1.5, 1.5, 0.12, dtype=np.float32)
    X, Y = np.meshgrid(g, g)
    jit2 = 0.01 * rng.standard_normal((X.size, 2)).astype(np.float32)
    return _pad(np.stack([
        X.ravel() + jit2[:, 0] + shift, Y.ravel() + jit2[:, 1],
        0.005 * rng.standard_normal(X.size).astype(np.float32)], -1))


def _strip(seed, x_len=25.6, n_y=10):
    """A long strip over both ranks' 6.4 m slabs (slab_voxels=16)."""
    rng = np.random.default_rng(seed)
    gx = np.arange(0.06, x_len, 0.12, dtype=np.float32)
    gy = np.arange(0.06, n_y * 0.12, 0.12, dtype=np.float32)
    X, Y = np.meshgrid(gx, gy)
    jit2 = 0.01 * rng.standard_normal((X.size, 2)).astype(np.float32)
    return _pad(np.stack([
        X.ravel() + jit2[:, 0], Y.ravel() + jit2[:, 1],
        0.005 * rng.standard_normal(X.size).astype(np.float32)], -1))


def _concentrated():
    """4096 points inside rank 0's first slab (+ halo)."""
    rng = np.random.default_rng(0)
    pts = np.stack([rng.uniform(0.0, 3.1, 4096), rng.uniform(0.0, 2.0, 4096),
                    rng.normal(0, 0.005, 4096)], -1).astype(np.float32)
    return pts, np.ones(4096, bool)


CASES = {
    "slab1": ([_cloud(0), _cloud(1, 0.25)], SENSOR_GRID, 1),
    "slab16": ([_strip(0), _strip(1)], SENSOR_STRIP, 16),
}


@pytest.fixture(scope="module")
def ranks():
    """Per rank: the CASES in order, then the overflow frame, then the
    compute-parallel step."""
    jobs = [("sharded_mesh", {"frames": fr, "sensor": s, "slab_voxels": sv})
            for fr, s, sv in CASES.values()]
    jobs += [("sharded_mesh", {"frames": [_concentrated()],
                               "sensor": (1.6, 0.5, 2.0), "slab_voxels": 16}),
             ("mp_mesh", {"frames": CASES["slab1"][0],
                          "sensor": SENSOR_GRID})]
    return run_world(worker.run_all, WORLD, (jobs,))


def _tri_set(pts, tris):
    """Triangles keyed by their sorted exact vertex positions."""
    v = np.ascontiguousarray(pts[tris]).view(np.uint32)      # (T, 3, 3)
    return {tuple(sorted(map(tuple, t.tolist()))) for t in v}


def _single_device(frames, sensor):
    ref = TMeshPipe(PRESETS["sim"](), device="cpu")
    for pts, mask in frames:
        ref.step(pts, mask, np.asarray(sensor, np.float32))
    t = ref.store.tri_ids.reshape(-1, 3).numpy()
    t = t[np.all(t >= 0, axis=1)]
    return ref, _tri_set(ref.gm.pts.numpy(), t)


@pytest.mark.parametrize("case", list(CASES))
def test_sharded_mesh_matches_jax_and_single_device(ranks, case):
    frames, sensor, slab = CASES[case]
    idx = list(CASES).index(case)
    a, b = (r[idx] for r in ranks)
    if slab == 16:
        assert shard_keep_fraction(slab, WORLD) * 1.5 < 1.0
    # the gathered mesh and the summed counters are the same on both ranks
    for key in ("pts", "tris", "n_active", "n_tris", "n_part_drop"):
        np.testing.assert_array_equal(a[key], b[key], key)
    assert a["n_part_drop"] == 0

    cfg = JPRESETS["sim"]()
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))
    smm = jdmesh.create_sharded_mesh(mesh, cfg, slab_voxels=slab)
    step = jdmesh.make_sharded_mesh_step(mesh, cfg)
    for pts, mask in frames:
        smm, n_act, n_tris, n_drop = step(
            smm, jnp.asarray(pts), jnp.asarray(mask),
            jnp.asarray(sensor, jnp.float32))
    g = jdmesh.gather_mesh(smm)
    assert (a["n_active"], a["n_tris"], a["n_part_drop"]) == (
        int(n_act), int(n_tris), int(n_drop))
    np.testing.assert_array_equal(a["n_pts_per_shard"],
                                  np.asarray(smm.gm.pt_count))
    s_port = _tri_set(a["pts"], a["tris"])
    assert s_port == _tri_set(g["pts"], g["tris"])

    ref, s_ref = _single_device(frames, sensor)
    assert a["n_tris"] == int(ref.store.n_triangles()) == len(s_port)
    assert s_port == s_ref
    if slab == 16:  # each rank stores ≈ its owned+halo share
        assert a["n_pts_per_shard"].max() < 0.8 * int(ref.gm.pt_count)


def test_sharded_mesh_overflow_is_counted(ranks):
    """All 4,096 points lie in rank 0's slab, whose buffer holds M =
    round_up(⌊4096 · keep fraction · 1.5⌋, 256) = 3,840 rows; rank 1 keeps
    only its halo columns (x < 0.8 m), well inside its buffer."""
    a, b = (r[len(CASES)] for r in ranks)
    f = shard_keep_fraction(16, WORLD) * 1.5
    M = -(-int(4096 * f) // 256) * 256
    assert a["n_part_drop"] == b["n_part_drop"] == 4096 - M == 256


def test_mp_mesh_matches_jax_and_single_device(ranks):
    a, b = (r[len(CASES) + 1] for r in ranks)
    np.testing.assert_array_equal(a["tri_ids"], b["tri_ids"])
    np.testing.assert_array_equal(a["pts"], b["pts"])
    frames, sensor, _ = CASES["slab1"]
    cfg = JPRESETS["sim"]()
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))
    gm, store = JGM.create(cfg.mesh), JStore.create(cfg.mesh)
    step = jdmesh.make_mp_mesh_step(mesh, cfg)
    for pts, mask in frames:
        gm, store, n_act = step(gm, store, jnp.asarray(pts),
                                jnp.asarray(mask),
                                jnp.asarray(sensor, jnp.float32))
    assert a["n_active"] == int(n_act)
    np.testing.assert_array_equal(a["pts"], np.asarray(gm.pts))
    np.testing.assert_array_equal(a["tri_ids"], np.asarray(store.tri_ids))
    ref, s_ref = _single_device(frames, sensor)
    t = a["tri_ids"].reshape(-1, 3)
    assert _tri_set(a["pts"], t[np.all(t >= 0, axis=1)]) == s_ref
