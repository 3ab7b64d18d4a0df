"""The hash lookup's launch forms (kernels/hash_probe.py): each plain form
against the JAX reference code it replaces, the kernels' schedule emulated
on the CPU, and the kernels against the plain forms on the card.

  * lookup_planes_plain(near=True) is immesh_tpu.lio.association.
    _lookup_with_neighbors; lookup_parent_plain is VoxelMap.update's parent
    probe; lookup_neighbors_plain is GlobalPointMap's 3×3×3 neighbourhood
    lookup.  (near=False is VoxelMap.lookup_planes_stack and query_planes,
    held to the reference with the same edge cases in
    tests/test_torch_map.py::test_voxel_map_levels_and_queries.)  Each is
    held to the reference on a plane map the reference built from
    seeded points and that interop carried across, at max_layers 2 and 4:
    found and slots EQUAL (integer arithmetic and comparisons after one
    IEEE division and a floor), with points exactly on voxel boundaries and
    on the quarter marks, in the outer quarter, at negative coordinates, in
    masked rows (zeros in the body frame, so the pose's position in the
    world: what voxel_downsample leaves there), with an absent own voxel
    and a present near one (reference behaviour 4) and with a planted
    fingerprint collision (reference behaviour 2).
  * The kernels' order (every key first, then each chain, then the
    descent) is emulated lane by lane in numpy f32 and must give the plain
    forms' bits; numpy's f32 division is the kernel's __fdiv_rn, so
    floor(x / s) at the presets' level sizes must equal the plain
    version's div + floor.
  * The `cuda` tests compare each kernel with its plain form on the card
    (also at NaN, ±inf and out-of-range points, where the cast saturates
    as torch's does on the card) and skip without one:

    python -m pytest --noconftest -m cuda tests/test_torch_lookup_forms.py
"""

import types

import numpy as np
import pytest
import torch

from immesh_tpu_torch import interop
from immesh_tpu_torch.config import VoxelMapConfig as TVC
from immesh_tpu_torch.core.ops import div
from immesh_tpu_torch.kernels import build
from immesh_tpu_torch.kernels import hash_probe as hp
from immesh_tpu_torch.lio.downsample import voxel_downsample
from immesh_tpu_torch.map.hash import HashTable
from immesh_tpu_torch.map.voxel_map import VoxelMap as TVM

# (voxel_size, max_layers): the avia preset's map and the KITTI preset's
_MAPS = [(0.5, 2), (3.0, 4)]


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def J():
    """The reference's modules (JAX on the CPU, as conftest sets it)."""
    import jax
    import jax.numpy as jnp
    from immesh_tpu.config import VoxelMapConfig as JVC
    from immesh_tpu.lio import association
    from immesh_tpu.map import hash as jhash
    from immesh_tpu.map.voxel_map import VoxelMap as JVM
    # the reference's lookups, each compiled once (eager, each of their
    # ops would compile on its own)
    near = jax.jit(association._lookup_with_neighbors)
    # VoxelMap.update's parent probe, one level
    parent = jax.jit(lambda vm, p, m, size, lvl: m & jnp.where(
        (s := vm.table.lookup(jhash.voxel_coords(p, size, lvl))) >= 0,
        vm.subdivided[s], False), static_argnums=(3, 4))
    return types.SimpleNamespace(jax=jax, jnp=jnp, JVC=JVC, JVM=JVM,
                                 jhash=jhash, near=near, parent=parent)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _scene(rng, size: float, n: int = 1200):
    """A ground plane, a wall and a noisy blob (which spills voxels into the
    finer levels), in units of the voxel edge."""
    g = np.c_[rng.uniform(-4, 4, (n, 2)), rng.normal(0, 0.004, n)]
    w = np.c_[rng.uniform(-4, 4, n // 2), rng.normal(2.3, 0.004, n // 2),
              rng.uniform(0, 3, n // 2)]
    blob = rng.normal([1.5, -1.5, 1.5], 0.6, (n // 3, 3))
    p = (np.concatenate([g, w, blob]) * size).astype(np.float32)
    s2 = rng.uniform(1e-5, 1e-4, len(p)).astype(np.float32) * size ** 2
    return p, s2, rng.random(len(p)) < 0.95


def _map_cfg(size: float, levels: int) -> dict:
    return dict(voxel_size=size, capacity=2 ** 11, max_layers=levels,
                touched_voxels_per_scan=512, max_points_per_voxel=60,
                planer_threshold=0.01 * size ** 2)


@pytest.fixture(scope="module", params=_MAPS, ids=lambda m: f"L{m[1]}")
def maps(request, J):
    """The reference's plane map after two scans, and the port's copy of it
    carried across with interop (with the seed's scene)."""
    size, levels = request.param
    cfg = _map_cfg(size, levels)
    rng = np.random.default_rng(levels)
    jvm = J.JVM.create(J.JVC(**cfg))
    update = J.jax.jit(lambda vm, *a: vm.update(*a))
    for _ in range(2):
        p, s2, m = _scene(rng, size)
        jvm = update(jvm, *map(J.jnp.asarray, (p, s2, m)))
    tree = {"table": {"keys": np.asarray(jvm.table.keys),
                      "fp": np.asarray(jvm.table.fp)},
            **{n: np.asarray(getattr(jvm, n)) for n in TVM._FIELDS}}
    tvm = interop.from_reference(
        {"vm": tree}, types.SimpleNamespace(voxel_map=TVC(**cfg)),
        device="cpu")["vm"]
    assert int(tvm.subdivided.sum()) > 0 and int(tvm.n_planes()) > 0
    return types.SimpleNamespace(j=jvm, t=tvm, size=size, levels=levels,
                                 rng=rng)


def _absent_own_present_near(vm, size: float, n: int = 16) -> np.ndarray:
    """Points in the outer quarter of an absent level-0 voxel, toward a
    present planar one along x, centred on the other axes: the own descent
    finds nothing and the near probe does (reference behaviour 4)."""
    keys = vm.table.keys
    live = keys[:, 0] != hp.EMPTY
    planar = live & (keys[:, 3] == 0) & vm.plane_valid
    present = {tuple(k) for k in keys[live].tolist()}
    out = []
    for k in keys[planar].tolist():
        for dx, fx in ((1, 0.1), (-1, 0.9)):
            if (k[0] + dx, k[1], k[2], 0) not in present:
                out.append([(k[0] + dx + fx) * size, (k[1] + 0.5) * size,
                            (k[2] + 0.5) * size])
        if len(out) >= n:
            break
    assert out, "no planar voxel with an absent x-neighbour"
    return np.array(out, np.float32)


def _queries(m) -> np.ndarray:
    """The scene's points and the edge cases of the module docstring."""
    s = m.size
    p, _, _ = _scene(m.rng, s, 300)
    k = m.rng.integers(-6, 6, (64, 3)).astype(np.float32)
    edges = np.concatenate([
        k * s,                          # exactly on voxel boundaries
        (k + 0.25) * s, (k + 0.75) * s,  # the quarter marks (no shift)
        (k + 0.1) * s, (k + 0.9) * s,    # the outer quarter (shifted)
        -np.abs(p[:64]),                 # negative coordinates
        np.zeros((4, 3)), [[-0.0, 0.0, -0.0]],  # masked rows: the body's 0
        m.rng.uniform(-40, 40, (64, 3)) * s,    # mostly absent
    ]).astype(np.float32)
    return np.concatenate([p, edges, _absent_own_present_near(m.t, s)])


def _plant_collision(m, q: np.ndarray):
    """Copies of both maps in which the level-0 key k2 of one query point
    that misses the map (its home slot empty) meets a colliding stored key
    k1 at that slot (same fingerprint, other key, plane_valid): both sides
    must alias the lookup to that slot (reference behaviour 2).  Returns
    the copies, the point's row in q and the slot."""
    c = np.floor(q / np.float32(m.size)).astype(np.int32)
    keys = torch.from_numpy(np.c_[c, np.zeros(len(c), np.int32)])
    h0 = hp._hash(keys, m.t.table.capacity - 1)
    free = (m.t.table.fp[h0.long()] == 0).numpy()
    i = int(np.flatnonzero(free)[0])
    k2 = keys[i].numpy().astype(np.int64)
    weyl = [x % 2 ** 32 for x in (-1640531527, -1274297907, -1981354251,
                                  1183186591)]
    inv = pow(weyl[1], -1, 2 ** 32)
    step = inv if sum(int(x) % 2 ** 32 * w for x, w in
                      zip(k2, weyl)) % 2 ** 32 % 2 == 0 else -inv
    k1 = k2.copy()
    k1[1] = (k2[1] + step) % 2 ** 32
    k1 = (k1 - (k1 >= 2 ** 31) * 2 ** 32).astype(np.int32)
    fp1 = hp._fingerprint(torch.from_numpy(k1))
    assert int(fp1) == int(hp._fingerprint(keys[i])) and (k1 != k2).any()
    slot = int(h0[i])
    tvm = m.t.clone()
    tvm.table.keys[slot] = torch.from_numpy(k1)
    tvm.table.fp[slot] = fp1
    tvm.plane_valid[slot] = True
    j = m.j
    jvm = j.replace(
        table=j.table.replace(keys=j.table.keys.at[slot].set(k1),
                              fp=j.table.fp.at[slot].set(int(fp1))),
        plane_valid=j.plane_valid.at[slot].set(True))
    return jvm, tvm, i, slot


def _planes(vm, q, near, max_probe=None):
    return hp.lookup_planes_plain(
        q, vm.cfg.voxel_size, vm.cfg.max_layers, vm.table.fp, vm.plane_valid,
        vm.subdivided, vm.table.max_probe if max_probe is None else max_probe,
        near)


def _eq(j, t, what=""):
    np.testing.assert_array_equal(np.asarray(j), t.numpy(), what)


# ---------------------------------------------------------------------------
# the plain forms against the reference
# ---------------------------------------------------------------------------
def test_planes_near_form_equals_the_reference(J, maps):
    """On copies of both maps with a planted collision (which only turns
    one empty slot into a planar one)."""
    q = _queries(maps)
    n4 = len(_absent_own_present_near(maps.t, maps.size))
    jvm, tvm, row, slot = _plant_collision(maps, q[:-n4])
    jf, js = J.near(jvm, J.jnp.asarray(q))
    tf, ts = _planes(tvm, _t(q), near=True)
    _eq(jf, tf, "found")
    _eq(js, ts, "slot")
    assert bool(tf[row]) and int(ts[row]) == slot  # behaviour 2: the alias
    # behaviour 4: the last rows' own voxels are absent, their near ones not
    own_f, _ = _planes(maps.t, _t(q[-n4:]), near=False)
    assert not bool(own_f.any()) and bool(tf[-n4:].all())
    # the map's own entry point is the dispatcher: the plain form here
    vf, vs = tvm.lookup_planes(_t(q), near=True)
    assert torch.equal(vf, tf) and torch.equal(vs, ts)


def test_parent_form_equals_the_reference(J, maps):
    """Every refinement level's mask, chained as VoxelMap.update chains it,
    from the scene's points with a random mask."""
    p, _, m = _scene(maps.rng, maps.size, 600)
    p = np.concatenate([p, _queries(maps)[-200:]])
    m = np.concatenate([m, maps.rng.random(200) < 0.9])
    jm, tm = J.jnp.asarray(m), _t(m)
    for lvl in range(1, maps.levels):
        jm = J.parent(maps.j, J.jnp.asarray(p), jm, maps.size, lvl - 1)
        prev = tm
        tm = hp.lookup_parent_plain(_t(p), maps.size, lvl - 1,
                                    maps.t.table.fp, maps.t.subdivided, prev,
                                    maps.t.table.max_probe)
        _eq(jm, tm, f"level {lvl}")
        assert torch.equal(maps.t.parent_mask(_t(p), prev, lvl), tm)
        if lvl == 1:  # the blob's points feed level 1
            assert 0 < int(tm.sum()) < int(prev.sum())


def _neighbor_table(rng, n_keys=600, capacity=2 ** 10):
    """A mesh voxel table of clustered keys (tag 0), and slots into it:
    occupied ones, empty ones (whose EMPTY key wraps when offset) and
    negative ones (torch's indexing counts them from the end)."""
    keys = np.unique(rng.integers(-6, 6, (n_keys, 3)), axis=0)
    keys = np.c_[keys, np.zeros(len(keys), np.int64)].astype(np.int32)
    table = HashTable.create(capacity, 32, device="cpu")
    slots, _ = table.insert(_t(keys), torch.ones(len(keys), dtype=torch.bool))
    empty = torch.nonzero(table.fp == 0)[:8, 0].to(torch.int32)
    s = torch.cat([slots[:200], empty, torch.tensor([-1, -capacity],
                                                    dtype=torch.int32)])
    return table, s


def test_neighbors_form_equals_the_reference(J):
    rng = np.random.default_rng(11)
    table, s = _neighbor_table(rng)
    jt = J.jhash.HashTable(keys=J.jnp.asarray(table.keys.numpy()),
                           fp=J.jnp.asarray(table.fp.numpy()),
                           capacity=table.capacity,
                           max_probe=table.max_probe)
    from immesh_tpu.mesh.global_map import _neighbor_offsets

    @J.jax.jit
    def neighbors(jt, s):  # GlobalPointMap's, on the slots s
        nb = jt.keys[s][:, None, :3] + _neighbor_offsets()[None]
        return jt.lookup(J.jnp.concatenate(
            [nb, J.jnp.zeros((len(s), 27, 1), J.jnp.int32)],
            -1).reshape(-1, 4))

    want = neighbors(jt, J.jnp.asarray(s.numpy()))
    got = hp.lookup_neighbors_plain(s, table.keys, table.fp, table.max_probe)
    _eq(want, got)
    assert 0 < int((got >= 0).sum()) < got.numel()


def test_masked_rows_hold_the_pose_position(J, maps):
    """voxel_downsample leaves 0 in its masked rows, so the world points the
    LIO looks up there are the pose's position; those rows look up like
    any other point."""
    rng = np.random.default_rng(5)
    pts = _t(rng.normal(0, 3, (500, 3)).astype(np.float32))
    mask = _t(rng.random(500) < 0.3)
    down, dmask = voxel_downsample(pts, mask, 0.5, 400)
    assert int((~dmask).sum()) > 0
    assert bool((down[~dmask] == 0).all())
    rot = torch.linalg.qr(_t(rng.normal(size=(3, 3)).astype(np.float32)))[0]
    pos = _t(np.float32([1.25, -2.5, 0.75]) * maps.size)
    world = down @ rot.T + pos
    assert bool((world[~dmask] == pos).all())
    jf, js = J.near(maps.j, J.jnp.asarray(world.numpy()))
    tf, ts = _planes(maps.t, world, near=True)
    _eq(jf, tf)
    _eq(js, ts)


# ---------------------------------------------------------------------------
# the kernels' schedule, emulated on the CPU
# ---------------------------------------------------------------------------
def _chain(h0, fq, first, fp, max_probe):
    """Each key's chain after its first round (`first`, already loaded):
    its slot, or −1 at an empty slot or at max_probe."""
    mask = fp.shape[0] - 1
    out = torch.full_like(h0, -1)
    if max_probe == 0:
        return out
    cand, f = h0.clone(), first.clone()
    live = torch.ones_like(h0, dtype=torch.bool)
    for r in range(max_probe):
        if r:
            cand = torch.where(live, (h0 + r * fq) & mask, cand)
            f = torch.where(live, fp[cand.long()], f)
        hit = live & (f == fq)
        out = torch.where(hit, cand, out)
        live = live & ~hit & (f != 0)
    return out


def _home(keys, fp):
    return hp._hash(keys, fp.shape[0] - 1), hp._fingerprint(keys)


def _planes_as_the_kernel_runs(q, voxel_size, levels, fp, pv, sub,
                               max_probe, near):
    """csrc/hash_probe.cu's hash_lookup_planes_kernel lane by lane: the near
    shift in f32 op by op, all kP·L keys and their first-round loads, each
    chain's further rounds, the flags of the found slots, then the descent
    and the take merge in registers."""
    x = q.numpy()
    sizes = hp.level_sizes(voxel_size, levels)
    pts = [x]
    if near:
        qs = x / sizes[0]
        frac = (qs - np.floor(qs)) - np.float32(0.5)
        shift = np.where(np.abs(frac) > np.float32(0.25), np.sign(frac),
                         np.float32(0)).astype(np.float32) * sizes[0]
        pts.append(x + shift)
    keys = [torch.from_numpy(np.c_[np.floor(p / sizes[lvl]).astype(np.int32),
                                   np.full(len(p), lvl, np.int32)])
            for p in pts for lvl in range(levels)]
    homes = [_home(k, fp) for k in keys]
    firsts = [fp[h.long()] if max_probe else h for h, _ in homes]
    slots = [_chain(h, f, first, fp, max_probe)
             for (h, f), first in zip(homes, firsts)]
    flags = [(s >= 0) & pv[s.clamp(min=0).long()] for s in slots]
    subs = [(s >= 0) & sub[s.clamp(min=0).long()] for s in slots]
    found, slot = [], []
    for k in range(len(pts)):
        fnd = torch.zeros(len(x), dtype=torch.bool)
        desc = torch.ones(len(x), dtype=torch.bool)
        sl = torch.zeros(len(x), dtype=torch.int32)
        for lvl in range(levels):
            j = k * levels + lvl
            present = desc & (slots[j] >= 0)
            use = present & flags[j] & ~fnd
            sl = torch.where(use, slots[j], sl)
            fnd = fnd | use
            desc = present & subs[j]
        found.append(fnd)
        slot.append(sl)
    if not near:
        return found[0], slot[0]
    take = ~found[0] & found[1]
    return found[0] | take, torch.where(take, slot[1], slot[0])


@pytest.mark.parametrize("near", [True, False])
@pytest.mark.parametrize("max_probe", [32, 2, 1, 0])
def test_planes_kernel_schedule_gives_the_plain_result(maps, near,
                                                        max_probe):
    q = _t(_queries(maps))
    vm = maps.t
    want = _planes(vm, q, near, max_probe)
    got = _planes_as_the_kernel_runs(
        q, maps.size, maps.levels, vm.table.fp, vm.plane_valid,
        vm.subdivided, max_probe, near)
    assert torch.equal(want[0], got[0]) and torch.equal(want[1], got[1])


def test_parent_and_neighbor_kernel_schedules_give_the_plain_result(maps):
    """The parent kernel: a masked lane loads nothing and is false; else its
    key, its chain and the flag.  The neighbours kernel: the slot's key row
    (a negative slot from the end), 27 keys in _OFFS order with the 4th
    column 0 (int32 sums wrap, as EMPTY + 1 does), first loads, chains."""
    vm, rng = maps.t, np.random.default_rng(12)
    p = _t(_queries(maps))
    mask = _t(rng.random(len(p)) < 0.7)
    fp = vm.table.fp
    for lvl in range(maps.levels):
        for mp in (32, 1):
            size = hp.level_sizes(maps.size, lvl + 1)[lvl]
            c = torch.from_numpy(np.floor(p.numpy() / size).astype(np.int32))
            keys = torch.cat([c, torch.full((len(p), 1), lvl,
                                            dtype=torch.int32)], 1)
            h, f = _home(keys, fp)
            s = _chain(h, f, fp[h.long()], fp, mp)
            got = mask & (s >= 0) & vm.subdivided[s.clamp(min=0).long()]
            want = hp.lookup_parent_plain(p, maps.size, lvl, fp,
                                          vm.subdivided, mask, mp)
            assert torch.equal(got, want)
    table, slots = _neighbor_table(rng)
    cap = table.capacity
    rows = table.keys[torch.where(slots < 0, slots + cap, slots).long()]
    offs = [(j // 9 - 1, j // 3 % 3 - 1, j % 3 - 1) for j in range(27)]
    assert np.array_equal(np.array(offs), hp._OFFS)
    keys = torch.stack([torch.stack([rows[:, 0] + o[0], rows[:, 1] + o[1],
                                     rows[:, 2] + o[2],
                                     torch.zeros_like(rows[:, 0])], -1)
                        for o in offs], 1).reshape(-1, 4)
    for mp in (32, 2):
        h, f = _home(keys, table.fp)
        got = _chain(h, f, table.fp[h.long()], table.fp, mp)
        want = hp.lookup_neighbors_plain(slots, table.keys, table.fp, mp)
        assert torch.equal(got, want)


def test_level_divisions_in_f32_equal_the_plain_version():
    """The kernel divides by each level's f32 edge once (__fdiv_rn) and
    floors: numpy's f32 division at the presets' sizes (3.0, 0.5, 2.0, 1.0,
    0.8 and their halves) gives the plain version's div + floor, and
    level_sizes holds the f32 that torch.full((), size) holds."""
    rng = np.random.default_rng(13)
    x = np.concatenate([rng.normal(0, 200, 20000),
                        rng.uniform(-3, 3, 20000),
                        np.arange(-64, 64) * 0.375,
                        np.nextafter(np.arange(-64, 64) * 0.75, 1e9)]
                       ).astype(np.float32)
    for voxel_size in (3.0, 0.5, 2.0, 1.0, 0.8):
        sizes = hp.level_sizes(voxel_size, 4)
        for lvl, s in enumerate(sizes):
            held = torch.full((), voxel_size / 2 ** lvl, dtype=torch.float32)
            assert s == held.numpy()
            want = torch.floor(div(_t(x), voxel_size / 2 ** lvl)).numpy()
            np.testing.assert_array_equal(np.floor(x / s), want)


# ---------------------------------------------------------------------------
# dispatch: the CPU never loads the library, nothing else takes the plain
# ---------------------------------------------------------------------------
def test_the_forms_never_load_the_library_on_the_cpu(maps, monkeypatch):
    def no_build(name):
        raise AssertionError(f"the CPU path loaded lib{name}")

    monkeypatch.setattr(build, "load", no_build)
    monkeypatch.setattr(hp, "_lib", None)
    hp.reset_launches()
    q = _t(_queries(maps))
    maps.t.lookup_planes(q, near=True)
    maps.t.parent_mask(q, torch.ones(len(q), dtype=torch.bool), 1)
    table, s = _neighbor_table(np.random.default_rng(3))
    hp.lookup_neighbors(s, table.keys, table.fp, 32)
    assert hp.launches == dict.fromkeys(hp.KERNELS, 0)


def test_a_tensor_off_the_cpu_never_takes_a_plain_form(monkeypatch):
    def plain(*args):
        raise AssertionError("a plain form ran on a tensor off the CPU")

    for name in ("lookup_plain", "lookup_planes_plain", "lookup_parent_plain",
                 "lookup_neighbors_plain"):
        monkeypatch.setattr(hp, name, plain)
    meta = dict(device="meta")
    fp = torch.empty(16, dtype=torch.int32, **meta)
    flags = torch.empty(16, dtype=torch.bool, **meta)
    q = torch.empty((4, 3), **meta)
    with pytest.raises(ValueError, match="CUDA device"):
        hp.lookup_planes(q, 1.0, 2, fp, flags, flags, 32, True)
    with pytest.raises(ValueError, match="CUDA device"):
        hp.lookup_parent(q, 1.0, 0, fp, flags,
                         torch.empty(4, dtype=torch.bool, **meta), 32)
    with pytest.raises(ValueError, match="CUDA device"):
        hp.lookup_neighbors(torch.empty(4, dtype=torch.int32, **meta),
                            torch.empty((16, 4), dtype=torch.int32, **meta),
                            fp, 32)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _card_map(dev, seed: int, load: float, levels: int, size: float = 3.0):
    """A plane map on the card whose table holds the level keys of random
    clustered points at about `load` of its 2^14 slots, with random
    plane_valid and subdivided flags, and the points."""
    rng = np.random.default_rng(seed)
    cap = 2 ** 14
    vm = TVM.create(TVC(voxel_size=size, capacity=cap, max_layers=levels),
                    device=dev)
    pts = (rng.normal(0, 12, (40000, 3)) * size).astype(np.float32)
    for lvl in range(levels):
        c = hp.voxel_coords(_t(pts).to(dev), size, lvl)
        u = torch.unique(c, dim=0)
        n = min(u.shape[0], int(load * cap / levels))
        vm.table.insert(u[:n].contiguous(),
                        torch.ones(n, dtype=torch.bool, device=dev))
    g = torch.Generator(device=dev).manual_seed(seed)
    vm.plane_valid.copy_(torch.rand(cap, generator=g, device=dev) < 0.5)
    vm.subdivided.copy_(torch.rand(cap, generator=g, device=dev) < 0.6)
    q = np.concatenate([pts[:8192], (rng.uniform(-60, 60, (2048, 3))
                                     * size).astype(np.float32),
                        [[np.nan, 0, 0], [np.inf, -np.inf, 1.0],
                         [3e38, -3e38, 1e10], [-0.0, 0.0, 1e-30]]])
    return vm, _t(q.astype(np.float32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("levels", [1, 2, 3, 4])
@pytest.mark.parametrize("load", [0.1, 0.9])
def test_planes_kernel_equals_the_plain_form_on_the_card(dev, levels, load):
    vm, q = _card_map(dev, levels, load, levels)
    hp.reset_launches()
    n = 0
    for near in (True, False):
        for mp in (32, 4, 1, 0):
            args = (q, vm.cfg.voxel_size, levels, vm.table.fp,
                    vm.plane_valid, vm.subdivided, mp, near)
            kf, ks = hp.lookup_planes_cuda(*args)
            pf, ps = hp.lookup_planes_plain(*args)
            torch.cuda.synchronize()
            assert torch.equal(kf, pf) and torch.equal(ks, ps), (near, mp)
            n += 1
    assert hp.launches["hash_lookup_planes"] == n
    assert hp.runs()["hash_lookup_planes"] == n


@pytest.mark.cuda
@pytest.mark.parametrize("load", [0.1, 0.9])
def test_parent_kernel_equals_the_plain_form_on_the_card(dev, load):
    vm, q = _card_map(dev, 7, load, 4)
    g = torch.Generator(device=dev).manual_seed(1)
    mask = torch.rand(q.shape[0], generator=g, device=dev) < 0.8
    for lvl in range(4):
        for mp in (32, 1, 0):
            args = (q, vm.cfg.voxel_size, lvl, vm.table.fp, vm.subdivided,
                    mask, mp)
            assert torch.equal(hp.lookup_parent_cuda(*args),
                               hp.lookup_parent_plain(*args)), (lvl, mp)


@pytest.mark.cuda
def test_neighbors_kernel_equals_the_plain_form_on_the_card(dev):
    rng = np.random.default_rng(14)
    table, s = _neighbor_table(rng, 3000, 2 ** 12)
    keys, fp, s = table.keys.to(dev), table.fp.to(dev), s.to(dev)
    for a in (s, s[:1], s[:65], torch.arange(-4096, 4096, 3, device=dev,
                                              dtype=torch.int32)):
        for mp in (32, 2, 0):
            assert torch.equal(hp.lookup_neighbors_cuda(a, keys, fp, mp),
                               hp.lookup_neighbors_plain(a, keys, fp, mp))


@pytest.mark.cuda
def test_lookup_forms_reject_bad_inputs(dev):
    fp = torch.zeros(16, dtype=torch.int32, device=dev)
    flags = torch.zeros(16, dtype=torch.bool, device=dev)
    q = torch.zeros((4, 3), device=dev)
    with pytest.raises(ValueError, match="levels"):
        hp.lookup_planes_cuda(q, 1.0, 5, fp, flags, flags, 32, True)
    with pytest.raises(TypeError):
        hp.lookup_planes_cuda(q.double(), 1.0, 2, fp, flags, flags, 32, True)
    with pytest.raises(ValueError, match="contiguous"):
        hp.lookup_parent_cuda(torch.zeros((4, 6), device=dev)[:, ::2], 1.0,
                              0, fp, flags, flags[:4], 32)
    keys = torch.zeros(16 * 4 + 1, dtype=torch.int32, device=dev)[1:]
    with pytest.raises(ValueError, match="aligned"):
        hp.lookup_neighbors_cuda(torch.zeros(2, dtype=torch.int32,
                                             device=dev),
                                 keys.reshape(16, 4), fp, 32)
