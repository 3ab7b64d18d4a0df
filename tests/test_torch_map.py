"""Port parity, map layer: the open-addressing hash table, the exact frame
dedup, voxel quantization, the plane voxel map and its compaction, and the
scatter/segment helpers — each against the JAX reference on seeded inputs.

Slots, keys, fingerprints, counts and flags must match EXACTLY: every one
of them is integer arithmetic or a comparison, and the probe sequences,
claim tournaments and dedup order are the reference's.  Moments are f32
segment sums: the port sums each segment in input order, as XLA:CPU's
scatter-add does, so they match to rtol 1e-6 (a different sum order would
still sit well inside it at these sizes)."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from immesh_tpu.config import VoxelMapConfig as JVC
from immesh_tpu.map import hash as jhash
from immesh_tpu.map.voxel_map import VoxelMap as JVM
from immesh_tpu.mesh.global_map import _compact_indices as j_compact_indices
from immesh_tpu_torch.config import VoxelMapConfig as TVC
from immesh_tpu_torch.core import ops
from immesh_tpu_torch.map import hash as thash
from immesh_tpu_torch.map.voxel_map import VoxelMap as TVM


def _t(x):
    return torch.from_numpy(np.array(x))


def _eq(j, t, what=""):
    np.testing.assert_array_equal(np.asarray(j), t.numpy(), what)


def _unique_keys(rng, n, span=40):
    keys = set()
    while len(keys) < n:
        keys.add(tuple(rng.integers(-span, span, 3)) + (int(rng.integers(0, 3)),))
    return np.array(sorted(keys), np.int32)[rng.permutation(n)]


# ---------------------------------------------------------------------------
# hash table
# ---------------------------------------------------------------------------
def test_hash_and_fingerprint_wrap_like_the_reference():
    rng = np.random.default_rng(0)
    c = rng.integers(-2 ** 31, 2 ** 31 - 1, (4096, 4), dtype=np.int32)
    c[0] = [2 ** 31 - 1, -2 ** 31, -1, 0]
    c[1] = [-2 ** 31, 2 ** 31 - 1, 2 ** 31 - 1, -2 ** 31]
    for mask in (255, 2 ** 18 - 1):
        _eq(jhash._hash(jnp.asarray(c), mask), thash._hash(_t(c), mask))
    fp = thash._fingerprint(_t(c))
    _eq(jhash._fingerprint(jnp.asarray(c)), fp)
    assert bool((fp & 1).all())


@pytest.mark.parametrize("max_probe", [32, 2])
def test_insert_and_lookup_slots_exact_at_high_load(max_probe):
    """Three batches fill a 256-slot table to ~70 %; with max_probe=2 some
    keys exhaust their probe sequence and both sides report -1."""
    rng = np.random.default_rng(1)
    keys = _unique_keys(rng, 260)
    jt = jhash.HashTable.create(256, max_probe)
    tt = thash.HashTable.create(256, max_probe, device="cpu")
    batches = [keys[:64], np.concatenate([keys[32:96], keys[200:220]]),
               keys[96:180]]
    for b in batches:
        valid = rng.random(len(b)) < 0.9
        old_empty = np.asarray(jt.keys[:, 0] == jhash.EMPTY)
        jt, js = jt.insert(jnp.asarray(b), jnp.asarray(valid))
        ts, new = tt.insert(_t(b), _t(valid))
        _eq(js, ts, "slots")
        _eq(jt.keys, tt.keys, "keys")
        _eq(jt.fp, tt.fp, "fp")
        js = np.asarray(js)
        want_new = (js >= 0) & old_empty[np.maximum(js, 0)]
        np.testing.assert_array_equal(want_new, new.numpy())
    if max_probe == 2:
        assert (np.asarray(js) < 0).any() and (np.asarray(js) >= 0).any()
    # lookups of present, absent and never-inserted keys
    q = np.concatenate([keys, _unique_keys(rng, 64, span=200)])
    _eq(jt.lookup(jnp.asarray(q)), tt.lookup(_t(q)), "lookup")
    _eq(jt.occupancy(), tt.occupancy())


def test_lookup_compares_fingerprints_only():
    """A key whose fingerprint collides with a stored key on its probe chain
    resolves to that slot on both sides (the reference's sticky aliasing)."""
    tt = thash.HashTable.create(64, 8, device="cpu")
    jt = jhash.HashTable.create(64, 8)
    a = np.array([[1, 2, 3, 0]], np.int32)
    jt, _ = jt.insert(jnp.asarray(a), jnp.ones(1, bool))
    tt.insert(_t(a), torch.ones(1, dtype=torch.bool))
    # forge a colliding fingerprint at the probed slot of another key
    b = np.array([[7, -5, 9, 1]], np.int32)
    slot_b = int(thash._hash(_t(b), 63))
    fp_b = int(thash._fingerprint(_t(b)))
    tt.fp[slot_b] = fp_b
    tt.keys[slot_b] = torch.tensor([100, 100, 100, 0], dtype=torch.int32)
    jt = jt.replace(fp=jt.fp.at[slot_b].set(fp_b),
                    keys=jt.keys.at[slot_b].set(jnp.asarray([100, 100, 100, 0])))
    assert int(tt.lookup(_t(b))[0]) == slot_b
    _eq(jt.lookup(jnp.asarray(b)), tt.lookup(_t(b)))


def test_frame_unique_coords_exact():
    rng = np.random.default_rng(2)
    c = rng.integers(-4, 4, (600, 3), dtype=np.int32)
    c[:5] = [2 ** 31 - 2, -2 ** 31, 0]
    mask = rng.random(600) < 0.8
    for k in (1000, 100):   # all uniques fit / uniques overflow k
        for j, t in zip(jhash.frame_unique_coords(jnp.asarray(c),
                                                  jnp.asarray(mask), k),
                        thash.frame_unique_coords(_t(c), _t(mask), k)):
            _eq(j, t)


def test_voxel_coords_exact():
    rng = np.random.default_rng(3)
    p = (rng.normal(size=(2000, 3)) * 50).astype(np.float32)
    p[:6] = [[0.0, -0.0, 3.0], [-3.0, 2.9999998, 3.0000002],
             [1.5, -1.5, 0.75], [299.99998, -0.75, 6.0],
             [-1e-8, 1e-8, 2.25], [4.5, 5.25, -5.25]]
    for size, lvl in ((3.0, 0), (3.0, 1), (0.75, 2), (0.6, 0)):
        _eq(jhash.voxel_coords(jnp.asarray(p), size, lvl),
            thash.voxel_coords(_t(p), size, lvl), (size, lvl))


# ---------------------------------------------------------------------------
# plane voxel map
# ---------------------------------------------------------------------------
_VM_CFG = dict(voxel_size=1.0, capacity=2 ** 10, max_layers=3,
               touched_voxels_per_scan=128, max_points_per_voxel=60)


def _scans(rng, n_scans=3, n=1500):
    """Planar patches (ground + two walls) with noise, plus a noisy blob
    that spills voxels into the finer levels."""
    out = []
    for _ in range(n_scans):
        g = np.c_[rng.uniform(-4, 4, (n, 2)), rng.normal(0, 0.01, n)]
        w = np.c_[rng.uniform(-4, 4, n // 2), rng.normal(2.3, 0.01, n // 2),
                  rng.uniform(0, 3, n // 2)]
        blob = rng.normal([1.5, -1.5, 1.5], 0.6, (n // 4, 3))
        p = np.concatenate([g, w, blob]).astype(np.float32)
        s2 = rng.uniform(1e-4, 1e-3, len(p)).astype(np.float32)
        m = rng.random(len(p)) < 0.95
        out.append((p, s2, m))
    return out


@pytest.fixture(scope="module")
def vm_runs():
    """Both maps after each of three scans: (reference maps, port snapshots
    as numpy dicts, final port map).  The reference update runs jitted so
    it compiles once for the three same-shaped scans."""
    jvm = JVM.create(JVC(**_VM_CFG))
    tvm = TVM.create(TVC(**_VM_CFG), device="cpu")
    jupdate = jax.jit(lambda vm, p, s2, m: vm.update(p, s2, m))
    jmaps, tmaps = [], []
    for p, s2, m in _scans(np.random.default_rng(4)):
        jvm = jupdate(jvm, jnp.asarray(p), jnp.asarray(s2), jnp.asarray(m))
        tvm.update(_t(p), _t(s2), _t(m))
        jmaps.append(jvm)
        tmaps.append(copy.deepcopy(tvm))
    return jmaps, tmaps


def _check_vm(jvm, tvm):
    _eq(jvm.table.keys, tvm.table.keys, "keys")
    _eq(jvm.table.fp, tvm.table.fp, "fp")
    for name in ("count", "plane_valid", "subdivided"):
        _eq(getattr(jvm, name), getattr(tvm, name), name)
    for name in ("sum_p", "sum_ppT", "sigma2_sum"):
        np.testing.assert_allclose(np.asarray(getattr(jvm, name)),
                                   getattr(tvm, name).numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    # fit outputs: eigenvalues come from a cancelling covariance and the
    # arccos/cos closed form, so their error scales with the voxel's
    # largest eigenvalue (≲ 1 m² here), not with each value
    for name in ("center", "lam", "var_c"):
        np.testing.assert_allclose(np.asarray(getattr(jvm, name)),
                                   getattr(tvm, name).numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    # normals of fitted planes, up to sign
    pv = np.asarray(jvm.plane_valid)
    jn, tn = np.asarray(jvm.normal)[pv], tvm.normal.numpy()[pv]
    np.testing.assert_allclose(np.abs(np.sum(jn * tn, -1)), 1.0, atol=1e-4)


@pytest.mark.parametrize("scan", [0, 1, 2])
def test_voxel_map_update_matches_reference(vm_runs, scan):
    jmaps, tmaps = vm_runs
    _check_vm(jmaps[scan], tmaps[scan])


def test_voxel_map_levels_and_queries(vm_runs):
    jvm, tvm = vm_runs[0][-1], vm_runs[1][-1]
    assert int(tvm.subdivided.sum()) > 0 and int(tvm.n_planes()) > 0
    live = tvm.table.keys[:, 0] != thash.EMPTY
    assert int(tvm.table.keys[live, 3].max()) == 2   # the finest level is used
    rng = np.random.default_rng(5)
    q = np.concatenate([_scans(rng, 1, 400)[0][0],
                        rng.uniform(-9, 9, (200, 3)).astype(np.float32)])
    # the voxel size is 1: points exactly on voxel boundaries, on the
    # quarter marks, in the outer quarter, at negative coordinates, and the
    # masked rows' 0 (what voxel_downsample leaves there)
    k = rng.integers(-6, 6, (64, 3)).astype(np.float32)
    q = np.concatenate([q, k, k + 0.25, k + 0.75, k + 0.1, k + 0.9,
                        -np.abs(q[:64]), np.zeros((4, 3)),
                        [[-0.0, 0.0, -0.0]]]).astype(np.float32)
    jq, tq = jvm.query_planes(jnp.asarray(q)), tvm.query_planes(_t(q))
    _eq(jq["found"], tq["found"])
    _eq(jq["slot"], tq["slot"])
    stack = np.stack([q, q + 0.5, q - 0.25]).astype(np.float32)
    for j, t in zip(jvm.lookup_planes_stack(jnp.asarray(stack)),
                    tvm.lookup_planes_stack(_t(stack))):
        _eq(j, t)


def test_voxel_map_compact_matches_reference(vm_runs):
    jvm, tvm = vm_runs[0][-1], copy.deepcopy(vm_runs[1][-1])
    center = np.array([1.0, -0.5, 0.0], np.float32)
    jvm = jvm.compact(jnp.asarray(center), 2.5)
    tvm.compact(_t(center), 2.5)
    assert 0 < int(tvm.n_voxels()) < int(vm_runs[1][-1].n_voxels())
    _check_vm(jvm, tvm)


# ---------------------------------------------------------------------------
# scatter / segment helpers
# ---------------------------------------------------------------------------
def test_scatter_and_segment_helpers():
    rng = np.random.default_rng(7)
    # set_drop over 2-D lanes: only selected lanes write
    dst = torch.zeros(10, 2)
    idx = torch.tensor([[1, 2], [3, -1]])
    ok = torch.tensor([[True, False], [True, False]])
    ops.set_drop(dst, idx, torch.arange(8.0).reshape(2, 2, 2), ok)
    want = torch.zeros(10, 2)
    want[1], want[3] = torch.tensor([0.0, 1.0]), torch.tensor([4.0, 5.0])
    assert torch.equal(dst, want)
    # segment sums in input order equal a sequential scatter-add
    vals = rng.normal(size=(500, 4)).astype(np.float32) * 1e3
    seg = rng.integers(0, 37, 500)
    ref = np.zeros((37, 4), np.float32)
    np.add.at(ref, seg, vals)
    np.testing.assert_array_equal(ops.segment_sum(_t(vals), _t(seg), 37).numpy(),
                                  ref)
    keep = rng.random(300) < 0.3
    for k in (200, 50):
        _eq(j_compact_indices(jnp.asarray(keep), k),
            ops.compact_indices(_t(keep), k))
