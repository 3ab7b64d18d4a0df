"""Grouped drop-mode scatters (kernels/scatter_drop.py's set_group_* and
add_group_*, reached through core/ops.py's set_drop_group and
add_drop_group): several fields that share one (idx, ok), written in one
kernel launch on the card.

On the CPU:
  * the plain group versions equal the fields' single plain calls one after
    the other, bit for bit, on seeded numpy inputs: the LIO refit's eight
    plane fields, the four moments added from column slices of one
    aggregate, mixed f32 / int32 / bool / int64 fields with scalar and
    strided srcs, 2-D lanes, no lane and every lane selected, targets from
    the end and out of range, the mesh store's 768-byte slot rows;
  * the group contract (1 to 8 fields, one row count, f32 for an add, no src
    sharing memory with a dst) holds in both versions; a CPU group never
    loads the CUDA library and a group off the CPU never takes the plain
    version;
  * VoxelMap.update makes exactly two grouped calls a level (the moments'
    add, the plane fields' set) and no single call, and still equals the
    JAX reference's update; a mesh step makes its five grouped calls
    (append's three, the triangle store's, mark_meshed's).

The `cuda` tests hold the grouped kernel to its plain version on the card
and count one launch a group; they skip without a card.  The reference is
imported inside a fixture, so on the GPU machine (no JAX)

    python -m pytest --noconftest -m cuda tests/test_torch_scatter_group.py
"""

import numpy as np
import pytest
import torch

from immesh_tpu_torch.core import ops
from immesh_tpu_torch.kernels import build
from immesh_tpu_torch.kernels import scatter_drop as sd

_ROWS, _LANES = 97, 60


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _rand(g, dtype, shape):
    """Seeded values of dtype (g: a torch.Generator on the tensors' device)."""
    dev = g.device
    if dtype == torch.bool:
        return torch.rand(shape, generator=g, device=dev) < 0.5
    if dtype.is_floating_point:
        return torch.randn(shape, generator=g, device=dev)
    return torch.randint(-2 ** 30, 2 ** 30, shape, generator=g,
                         device=dev).to(dtype)


def _out_of_range(idx, rows):
    """Every third lane's target written from the end, every fifth moved
    outside [-rows, rows): the targets that remain stay distinct."""
    lane = torch.arange(idx.numel(), device=idx.device)
    far = torch.where(lane % 2 == 0, rows + lane, -rows - 1 - lane)
    idx = torch.where(lane % 3 == 0, idx - rows, idx)
    return torch.where(lane % 5 == 0, far, idx).to(idx.dtype)


f32, i32, i64, b8 = torch.float32, torch.int32, torch.int64, torch.bool
# name: (kind, idx dtype, [(dst dtype, row, src)]) with src "tensor",
# "strided" (a column block of a wider tensor) or a Python scalar
GROUPS = {
    "refit": ("set", i32, [(f32, (3,), "tensor"), (f32, (), "tensor"),
                           (f32, (3,), "tensor"), (f32, (6,), "tensor"),
                           (f32, (), "tensor"), (f32, (3,), "tensor"),
                           (b8, (), "tensor"), (b8, (), "tensor")]),
    "moments": ("add", i32, [(f32, (3,), "agg"), (f32, (6,), "agg"),
                             (f32, (), "agg"), (f32, (), "agg")]),
    "mixed": ("set", i64, [(f32, (3,), "strided"), (i32, (), 0),
                           (b8, (), True), (i64, (2,), "tensor"),
                           (i32, (3,), "strided")]),
    "lanes2d": ("set", i32, [(f32, (3,), "tensor"), (i32, (), "tensor")]),
    "no_lane": ("set", i32, [(f32, (3,), "tensor"), (b8, (), True)]),
    "every_lane": ("add", i64, [(f32, (6,), "tensor"), (f32, (), "strided")]),
    "out_of_range": ("set", i64, [(i32, (3,), "tensor"), (f32, (), "tensor"),
                                  (b8, (), False)]),
    "add_out_of_range": ("add", i32, [(f32, (3,), "tensor"),
                                      (f32, (4,), "tensor")]),
    "slot_rows": ("set", i32, [(i32, (64, 3), "tensor"), (i32, (), "tensor"),
                               (b8, (), True)]),
    "pieces": ("set", i32, [(f32, (4,), "tensor"), (f32, (8,), "strided"),
                            (i64, (2,), "tensor"), (f32, (48, 4), "tensor")]),
}


def make_group(name, g, lanes, rows=None):
    """(kind, dsts, idx, srcs, ok) of GROUPS[name], made with g on its
    device: `lanes` lanes with distinct targets into `rows` rows (2 × lanes
    by default)."""
    kind, idx_dtype, fields = GROUPS[name]
    rows = rows or 2 * lanes
    dev = g.device
    idx = torch.randperm(rows, generator=g, device=dev)[:lanes].to(idx_dtype)
    ok = torch.rand(lanes, generator=g, device=dev) < 0.7
    if name == "no_lane":
        ok = torch.zeros_like(ok)
    if name == "every_lane":
        ok = torch.ones_like(ok)
    if "out_of_range" in name:
        idx = _out_of_range(idx, rows)
    agg = _rand(g, f32, (lanes, 11))
    agg_cols = iter([agg[:, 0:3], agg[:, 3:9], agg[:, 9], agg[:, 10]])
    dsts, srcs = [], []
    for dtype, row, src in fields:
        dsts.append(_rand(g, dtype, (rows,) + row))
        if src == "agg":
            srcs.append(next(agg_cols))
        elif src == "strided":
            w = int(np.prod(row)) if row else 1
            srcs.append(_rand(g, dtype, (lanes, w + 5))[:, 2:2 + w]
                        .reshape((lanes,) + row))
        elif src == "tensor":
            srcs.append(_rand(g, dtype, (lanes,) + row))
        else:
            srcs.append(src)
    if name == "lanes2d":
        shape = (lanes // 4, 4)
        idx, ok = idx.reshape(shape), ok.reshape(shape)
        srcs = [s.reshape(shape + s.shape[1:]) for s in srcs]
    return kind, dsts, idx, srcs, ok


def _same_bits(a, b):
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


@pytest.mark.parametrize("name", sorted(GROUPS))
def test_plain_group_equals_the_single_calls(name):
    g = torch.Generator().manual_seed(sorted(GROUPS).index(name))
    kind, dsts, idx, srcs, ok = make_group(name, g, _LANES, _ROWS)
    single = sd.set_plain if kind == "set" else sd.add_plain
    group = (ops.set_drop_group if kind == "set" else ops.add_drop_group)
    before = [d.clone() for d in dsts]
    want = [d.clone() for d in dsts]
    for d, s in zip(want, srcs):
        single(d, idx, s, ok)
    group(dsts, idx, srcs, ok)
    assert all(_same_bits(a, b) for a, b in zip(dsts, want))
    changed = [not _same_bits(a, b) for a, b in zip(dsts, before)]
    assert not any(changed) if name == "no_lane" else any(changed)


def test_both_versions_take_one_group_contract():
    dst = torch.zeros(8, 3)
    idx = torch.arange(4, dtype=torch.int32)
    ok = torch.ones(4, dtype=torch.bool)
    src = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="1 to 8"):
        ops.set_drop_group([], idx, [], ok)
    with pytest.raises(ValueError, match="1 to 8"):
        ops.set_drop_group([torch.zeros(8) for _ in range(9)], idx,
                           [1.0] * 9, ok)
    with pytest.raises(ValueError, match="1 to 8"):
        ops.set_drop_group([dst], idx, [src, src], ok)
    with pytest.raises(ValueError, match="one row count"):
        ops.set_drop_group([dst, torch.zeros(9)], idx, [src, 1.0], ok)
    with pytest.raises(ValueError, match="shares memory"):
        ops.set_drop_group([dst], idx, [dst[:4]], ok)
    with pytest.raises(ValueError, match="share memory"):
        ops.set_drop_group([dst, dst[:, 0]], idx, [src, 1.0], ok)
    with pytest.raises(TypeError, match="f32"):
        ops.add_drop_group([dst, torch.zeros(8, dtype=torch.int32)], idx,
                           [src, torch.zeros(4, dtype=torch.int32)], ok)
    with pytest.raises(TypeError, match="f32"):
        ops.add_drop_group([dst], idx, [1.0], ok)
    with pytest.raises(ValueError, match="expected"):
        ops.set_drop_group([dst], idx, [torch.zeros(4, 2)], ok)


def test_a_cpu_group_never_loads_the_cuda_library(monkeypatch):
    def no_build(name):
        raise AssertionError(f"the CPU path loaded lib{name}")

    monkeypatch.setattr(build, "load", no_build)
    monkeypatch.setattr(sd, "_lib", None)
    monkeypatch.setattr(sd, "launches", 0)
    a, b = torch.zeros(8), torch.zeros(8, dtype=torch.int32)
    ops.set_drop_group([a, b], torch.tensor([1, 5]),
                       [torch.tensor([2.0, 3.0]), 7], torch.tensor([True, True]))
    ops.add_drop_group([a], torch.tensor([5]), [torch.tensor([1.0])],
                       torch.tensor([True]))
    assert a.tolist() == [0, 2, 0, 0, 0, 4, 0, 0] and sd.launches == 0
    assert b.tolist() == [0, 7, 0, 0, 0, 7, 0, 0] and sd.runs() == 0


def test_a_group_off_the_cpu_never_takes_the_plain_version(monkeypatch):
    def plain(*args):
        raise AssertionError("the plain version ran on a tensor off the CPU")

    monkeypatch.setattr(sd, "set_group_plain", plain)
    monkeypatch.setattr(sd, "add_group_plain", plain)
    meta = dict(device="meta")
    dsts = [torch.empty((16, 3), **meta), torch.empty(16, **meta)]
    idx = torch.empty(4, dtype=torch.int32, **meta)
    ok = torch.empty(4, dtype=torch.bool, **meta)
    srcs = [torch.empty((4, 3), **meta), torch.empty(4, **meta)]
    with pytest.raises(ValueError, match="CUDA device"):
        ops.set_drop_group(dsts, idx, srcs, ok)
    with pytest.raises(ValueError, match="CUDA device"):
        ops.add_drop_group(dsts, idx, srcs, ok)


# ---------------------------------------------------------------------------
# the call sites: how many launches a step makes
# ---------------------------------------------------------------------------
@pytest.fixture
def scatter_calls(monkeypatch):
    """Record every plain scatter outside the hash table's plain insert
    (which stands for the insert kernel on the card): ("single", dst) or
    ("group", dsts)."""
    from immesh_tpu_torch.kernels import hash_probe
    calls, inside = [], [False]

    def wrap(kind, fn):
        def f(dsts, *args):
            if not inside[0]:
                calls.append((kind, dsts if kind == "group" else [dsts]))
            return fn(dsts, *args)
        return f

    def insert(*args):
        inside[0] = True
        try:
            return insert_plain(*args)
        finally:
            inside[0] = False

    insert_plain = hash_probe.insert_plain
    monkeypatch.setattr(hash_probe, "insert_plain", insert)
    for name in ("set_plain", "add_plain"):
        monkeypatch.setattr(sd, name, wrap("single", getattr(sd, name)))
    for name in ("set_group_plain", "add_group_plain"):
        monkeypatch.setattr(sd, name, wrap("group", getattr(sd, name)))
    return calls


def _scan(rng, n=1500):
    """Ground and wall patches with a blob that spills into finer levels."""
    g = np.c_[rng.uniform(-4, 4, (n, 2)), rng.normal(0, 0.01, n)]
    w = np.c_[rng.uniform(-4, 4, n // 2), rng.normal(2.3, 0.01, n // 2),
              rng.uniform(0, 3, n // 2)]
    blob = rng.normal([1.5, -1.5, 1.5], 0.6, (n // 4, 3))
    p = np.concatenate([g, w, blob]).astype(np.float32)
    return (p, rng.uniform(1e-4, 1e-3, len(p)).astype(np.float32),
            rng.random(len(p)) < 0.95)


def test_voxel_map_update_groups_its_scatters_and_matches_the_reference(
        scatter_calls):
    import jax
    import jax.numpy as jnp
    from immesh_tpu.config import VoxelMapConfig as JVC
    from immesh_tpu.map.voxel_map import VoxelMap as JVM
    from immesh_tpu_torch.config import VoxelMapConfig as TVC
    from immesh_tpu_torch.map.voxel_map import VoxelMap as TVM

    cfg = dict(voxel_size=1.0, capacity=2 ** 10, max_layers=3,
               touched_voxels_per_scan=128, max_points_per_voxel=60)
    jvm = JVM.create(JVC(**cfg))
    tvm = TVM.create(TVC(**cfg), device="cpu")
    jupdate = jax.jit(lambda vm, p, s2, m: vm.update(p, s2, m))
    rng = np.random.default_rng(5)
    for _ in range(2):
        p, s2, m = _scan(rng)
        del scatter_calls[:]
        jvm = jupdate(jvm, jnp.asarray(p), jnp.asarray(s2), jnp.asarray(m))
        tvm.update(*(torch.from_numpy(x) for x in (p, s2, m)))
        # per level: the four moments, then the plane fields (the finest
        # level has no `subdivided`)
        fields = [[n for n in TVM._FIELDS if n != "subdivided" or lvl < 2]
                  for lvl in range(3)]
        want = [g for lvl in range(3) for g in (
            fields[lvl][:4], fields[lvl][4:])]
        got = [[n for n in TVM._FIELDS
                if any(getattr(tvm, n) is d for d in dsts)]
               for kind, dsts in scatter_calls]
        assert [k for k, _ in scatter_calls] == ["group"] * 6
        assert got == want
        for name in ("count", "plane_valid", "subdivided"):
            np.testing.assert_array_equal(np.asarray(getattr(jvm, name)),
                                          getattr(tvm, name).numpy(), name)
        np.testing.assert_array_equal(np.asarray(jvm.table.keys),
                                      tvm.table.keys.numpy())
        for name in ("sum_p", "sum_ppT", "sigma2_sum"):
            np.testing.assert_allclose(np.asarray(getattr(jvm, name)),
                                       getattr(tvm, name).numpy(), rtol=1e-6,
                                       atol=1e-6, err_msg=name)


def test_mesh_step_groups_its_scatters(scatter_calls):
    import chip_smoke
    from immesh_tpu_torch.mesh.pipeline import MeshPipeline
    from immesh_tpu_torch.utils.graphs import named_tensors

    cfg = chip_smoke.small_config()
    mesh = MeshPipeline(cfg, device="cpu")
    rng = np.random.default_rng(6)
    n = 4000
    pts = np.c_[rng.uniform(-6, 6, (n, 2)), rng.normal(0, 0.02, n)]
    pos = torch.zeros(3)
    del scatter_calls[:]
    mesh.step(torch.from_numpy(pts.astype(np.float32)),
              torch.ones(n, dtype=torch.bool), pos)
    names = {x.data_ptr(): n for n, x in named_tensors(
        {"gm": mesh.gm, "store": mesh.store})}
    groups = [[names.get(d.data_ptr(), "?") for d in dsts]
              for kind, dsts in scatter_calls if kind == "group"]
    assert groups == [
        ["gm.pts", "gm.pts_smooth"],
        ["gm.vox_pt_idx", "gm.vox_pts", "gm.vox_pts_sm"],
        ["gm.vox_n", "gm.vox_new"],
        ["store.tri_ids", "store.tri_n", "store.dirty"],
        ["gm.vox_new", "gm.vox_meshed"]]
    # the singles left: compact_indices' work lists and smooth's two writes
    singles = [names.get(d[0].data_ptr(), "scratch")
               for kind, d in scatter_calls if kind == "single"]
    assert set(singles) <= {"scratch", "gm.pts_smooth", "gm.vox_pts_sm"}
    assert int(mesh.store.n_triangles()) > 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(GROUPS))
def test_group_kernel_equals_the_plain_version_on_the_card(dev, name):
    """More lanes than the card holds threads (the kernel strides), and
    the path's 1,024."""
    props = torch.cuda.get_device_properties(dev)
    resident = props.multi_processor_count * \
        props.max_threads_per_multi_processor
    for lanes in (1024, 2 * resident):
        g = torch.Generator(device=dev).manual_seed(lanes)
        kind, dsts, idx, srcs, ok = make_group(name, g, lanes)
        want = [d.clone() for d in dsts]
        before = sd.launches
        if kind == "set":
            sd.set_group_cuda(dsts, idx, srcs, ok)
            sd.set_group_plain(want, idx, srcs, ok)
        else:
            sd.add_group_cuda(dsts, idx, srcs, ok)
            sd.add_group_plain(want, idx, srcs, ok)
        torch.cuda.synchronize()
        assert sd.launches == before + 1
        assert all(_same_bits(a, b) for a, b in zip(dsts, want))


@pytest.mark.cuda
def test_a_refused_group_launch_raises(dev, monkeypatch):
    dsts = [torch.zeros(8, device=dev), torch.zeros(8, 3, device=dev)]
    idx = torch.arange(4, dtype=torch.int32, device=dev)
    ok = torch.ones(4, dtype=torch.bool, device=dev)
    ops.set_drop_group(dsts, idx, [1.0, torch.ones(4, 3, device=dev)], ok)
    assert dsts[0][:4].tolist() == [1.0] * 4
    monkeypatch.setattr(sd, "max_blocks", lambda index: 0)  # refused
    with pytest.raises(RuntimeError, match="launch failed"):
        ops.set_drop_group(dsts, idx, [1.0, torch.ones(4, 3, device=dev)], ok)
