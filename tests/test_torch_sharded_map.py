"""Port parity, spatially sharded voxel map: immesh_tpu_torch/dist/
sharded_map.py against immesh_tpu/dist/sharded_map.py on the CPU.

One world of 4 gloo ranks is spawned for the module
(tests/torch_dist_worker.py); sub-groups of its first 1, 2 and 4 ranks
stand in for worlds of those sizes.  Held:
  * owner_of_coords EXACT against JAX's, and level-consistent;
  * the owner partition disjoint and complete (the union of the shards'
    owned keys is the single-device map's key set), owned planes within
    1e-5 (normal) and 1e-4 (d) of the single-device map, the bounds of
    tests/test_sharded_map.py:98-103;
  * halo_exchange at worlds 1, 2 and 4 record for record: both sides start
    from the same shards (grown by the port, carried into JAX's
    ShardedVoxelMap), and every table slot, plane field and halo flag after
    the exchange is EXACTLY JAX's;
  * the sharded-map LIO step at world 2 (PRESETS["sim"], 2,048 rays, 5
    frames after static_init): pose within 1e-4 m of JAX's
    make_sharded_lio_step over the 5 chained frames (the dp LIO bound of
    tests/test_torch_dist.py), within 0.05 m of the single-device
    pipeline, and the map partitioned (tests/test_sharded_map.py:151-159)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import shard_map
from jax.sharding import Mesh, PartitionSpec as P

import torch_dist_worker as worker
from immesh_tpu.config import PRESETS as JPRESETS
from immesh_tpu.core.state import EsikfState as JState
from immesh_tpu.dist import sharded_map as jsm
from immesh_tpu.frontend.sim import LidarImuSimulator as JSim
from immesh_tpu.frontend.types import ScanBundle as JBundle
from immesh_tpu.lio import imu as jimu
from immesh_tpu.map.hash import voxel_coords as j_voxel_coords
from immesh_tpu_torch import interop
from immesh_tpu_torch.config import PRESETS
from immesh_tpu_torch.dist import sharded_map as tsm
from immesh_tpu_torch.dist.multihost import run_world
from immesh_tpu_torch.frontend.types import ScanBundle as TBundle
from immesh_tpu_torch.lio.pipeline import LioPipeline as TLio
from immesh_tpu_torch.map.hash import EMPTY, voxel_coords
from immesh_tpu_torch.map.voxel_map import VoxelMap

WORLD = 4
SLAB, HALO_CAP = 4, 1024
N_RAYS, SEED, FRAMES = 2048, 7, 5


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The test workers share the host's cores; eager torch ops on small
    tensors gain nothing from threads, and oversubscribed threads slow
    every worker, so this module runs torch on one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _planar_points(n=4096, half=15.0, seed=0):
    rng = np.random.default_rng(seed)
    pts = rng.uniform(-half, half, size=(n, 3)).astype(np.float32)
    pts[:, 2] = 0.02 * rng.standard_normal(n)
    return pts, np.full(n, 1e-4, np.float32), np.ones(n, bool)


def _tree(obj):
    """A JAX struct dataclass as nested dicts of numpy arrays (data fields
    only), the form interop.from_reference takes."""
    import dataclasses
    if dataclasses.is_dataclass(obj):
        return {f.name: _tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if f.metadata.get("pytree_node", True)}
    return np.array(obj)


def _port_shards(n):
    """n port shards grown from the planar points (owner-computes)."""
    cfg = PRESETS["sim"]()
    pts, sig, mask = (torch.from_numpy(x) for x in _planar_points())
    out = []
    for i in range(n):
        svm = tsm.ShardedVoxelMap.create(cfg.voxel_map, i, n, slab_voxels=SLAB,
                                         halo_capacity=HALO_CAP, device="cpu")
        svm.update_owned(pts, sig, mask)
        out.append({"vm": interop.to_numpy(svm.vm),
                    "is_halo": svm.is_halo.numpy().copy()})
    return out


def _jax_exchange(states):
    """The same shards as JAX ShardedVoxelMaps, after JAX's halo_exchange
    inside shard_map on an n-device mesh."""
    cfg = JPRESETS["sim"]()
    n = len(states)
    shards = []
    for i, st in enumerate(states):
        s = jsm.ShardedVoxelMap.create(cfg.voxel_map, i, n, slab_voxels=SLAB,
                                       halo_capacity=HALO_CAP)
        v = st["vm"]
        vm = s.vm.replace(
            table=s.vm.table.replace(keys=jnp.asarray(v["table"]["keys"]),
                                     fp=jnp.asarray(v["table"]["fp"])),
            **{f: jnp.asarray(v[f]) for f in VoxelMap._FIELDS})
        shards.append(s.replace(vm=vm, is_halo=jnp.asarray(st["is_halo"])))
    stacked = jax.tree_util.tree_map(lambda *xs: jnp.stack(xs), *shards)

    def body(st):
        svm = jax.tree_util.tree_map(lambda x: x[0], st)
        return jax.tree_util.tree_map(lambda x: x[None],
                                      svm.halo_exchange("dp"))

    mesh = Mesh(np.array(jax.devices()[:n]), ("dp",))
    return jax.jit(shard_map(body, mesh=mesh, in_specs=(P("dp"),),
                             out_specs=P("dp"), check_vma=False))(stacked)


@pytest.fixture(scope="module")
def shards():
    return {n: _port_shards(n) for n in (1, 2, 4)}


@pytest.fixture(scope="module")
def ranks(shards):
    jobs = [("halo_exchange", {"shards": shards,
                "slab_voxels": SLAB, "halo_capacity": HALO_CAP}),
            ("sharded_lio", {"size": 2, "n_rays": N_RAYS, "seed": SEED,
                             "frames": FRAMES, "slab_voxels": SLAB})]
    return run_world(worker.run_all, WORLD, (jobs,))


# ---------------------------------------------------------------------------
def test_owner_matches_jax_and_is_level_consistent(rng):
    pts = rng.uniform(-50, 50, size=(512, 3)).astype(np.float32)
    for lvl in (0, 1, 2):
        c = voxel_coords(torch.from_numpy(pts), 0.8, lvl)
        jc = j_voxel_coords(jnp.asarray(pts), 0.8, lvl)
        np.testing.assert_array_equal(
            tsm.owner_of_coords(c, 4, 8).numpy(),
            np.asarray(jsm.owner_of_coords(jc, 4, 8)))
        np.testing.assert_array_equal(
            tsm.owner_of_coords(c, 4, 8).numpy(),
            tsm.owner_of_coords(voxel_coords(torch.from_numpy(pts), 0.8, 0),
                                4, 8).numpy())


def test_partition_disjoint_complete_and_planes_match():
    cfg = PRESETS["sim"]()
    pts, sig, mask = (torch.from_numpy(x) for x in _planar_points())
    ref = VoxelMap.create(cfg.voxel_map, device="cpu").update(pts, sig, mask)
    ref_keys = ref.table.keys.numpy()
    ref_set = {tuple(k) for k in ref_keys[ref_keys[:, 0] != EMPTY]}
    sets = []
    for i in range(WORLD):
        svm = tsm.ShardedVoxelMap.create(cfg.voxel_map, i, WORLD,
                                         slab_voxels=SLAB, device="cpu")
        svm.update_owned(pts, sig, mask)
        keys = svm.vm.table.keys.numpy()
        occ = (keys[:, 0] != EMPTY) & ~svm.is_halo.numpy()
        sets.append({tuple(k) for k in keys[occ]})
        slots = ref.table.lookup(torch.from_numpy(keys[occ])).numpy()
        assert np.all(slots >= 0)
        np.testing.assert_allclose(svm.vm.normal.numpy()[occ],
                                   ref.normal.numpy()[slots], atol=1e-5)
        np.testing.assert_allclose(svm.vm.d.numpy()[occ],
                                   ref.d.numpy()[slots], atol=1e-4)
    assert set().union(*sets) == ref_set
    for a in range(WORLD):
        for b in range(a + 1, WORLD):
            assert not sets[a] & sets[b]


@pytest.mark.parametrize("n", [1, 2, 4])
def test_halo_exchange_matches_jax_record_for_record(ranks, shards, n):
    after = _jax_exchange(shards[n])
    n_halo = 0
    for i in range(n):
        got = ranks[i][0][n]
        want = _tree(jax.tree_util.tree_map(lambda x: x[i], after))
        np.testing.assert_array_equal(got["is_halo"], want["is_halo"])
        np.testing.assert_array_equal(got["vm"]["table"]["keys"],
                                      want["vm"]["table"]["keys"])
        np.testing.assert_array_equal(got["vm"]["table"]["fp"],
                                      want["vm"]["table"]["fp"])
        for f in VoxelMap._FIELDS:
            np.testing.assert_array_equal(got["vm"][f], want["vm"][f], f)
        n_halo += int(got["is_halo"].sum())
    assert n_halo > 0


def test_sharded_lio_world2_matches_jax_and_tracks_single_device(ranks):
    a, b = ranks[0][1], ranks[1][1]
    np.testing.assert_array_equal(a["pos"], b["pos"])
    np.testing.assert_array_equal(a["n_eff"], b["n_eff"])
    assert ranks[2][1] is None

    cfg = JPRESETS["sim"]()
    sim = JSim(n_rays=N_RAYS, seed=SEED)
    acc, gyr = sim.static_imu(100)
    mesh = Mesh(np.array(jax.devices()[:2]), ("dp",))
    step = jsm.make_sharded_lio_step(mesh, cfg)
    state = jimu.static_init(jnp.asarray(acc), jnp.asarray(gyr), cfg.imu,
                             JState.identity())
    svm = jsm.create_sharded_map(mesh, cfg, slab_voxels=SLAB)
    tcfg = PRESETS["sim"]()
    ref = TLio(tcfg, device="cpu")
    ref.static_init(acc, gyr)
    jpos = []
    for k in range(FRAMES):
        f = sim.frame(k)
        args = (f.pts, f.t_rel, f.imu_stamps, f.imu_acc, f.imu_gyr,
                f.scan_duration, cfg.preprocess.max_points,
                cfg.imu.max_imu_per_scan)
        state, svm, _, _ = step(state, svm, JBundle.from_numpy(*args))
        ref.step(TBundle.from_numpy(*args, device="cpu"))
        jpos.append(np.asarray(state.pos))
    np.testing.assert_allclose(a["pos"], np.stack(jpos), atol=1e-4)
    p_ref = ref.state.pos.numpy()
    assert np.linalg.norm(a["pos"][-1] - p_ref) < 0.05
    assert a["n_eff"][-1] > 500

    # the map really is partitioned: disjoint owned sets, each a strict
    # subset of the single-device map, halos on both shards
    owned = [{tuple(k) for k in r[1]["owned_keys"]} for r in ranks[:2]]
    assert not owned[0] & owned[1]
    total_ref = int(ref.vm.n_voxels())
    assert len(owned[0]) + len(owned[1]) >= 0.8 * total_ref
    assert max(a["n_owned"], b["n_owned"]) < total_ref
    assert a["n_halo"] > 0 and b["n_halo"] > 0
