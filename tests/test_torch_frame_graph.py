"""The frame as one captured CUDA graph and its IF sites' predicates, one
set launch a site (kernels/graph_cond.py, utils/graphs.py::device_if,
runtime/captured.py).

On the CPU:

  * each site's predicate description (graph_cond.Pred), whose plain
    version (Pred.value) the eager step reads and whose form the set
    kernel computes on the card, against the torch expression the site
    used before: the ESIKF's `~converged`, a refinement level's `m.any()`
    with its count `levels + taken.to(int32)`, a mesh chunk's
    `pmask[sl].any()` over every chunk at 512 and 64 rows; masks empty,
    all true, a single true at the last row and random at a seed, EXACT;
  * the level count: VoxelMap.update_levels returns the int32 the old
    composition gave;
  * the ESIKF with its first body unconditional (no predicate, no host
    read) against the JAX reference's while_loop (jitted), on the cases
    tests/test_torch_conditional.py uses (converge at 1, 2, never): the
    iteration count EQUAL, the pose within that file's tolerances, and one
    host read a later body (its two device_if calls share one predicate);
  * the frame pipeline on the CPU composes the two eager steps, its mesh
    half serial (no CUDA stream or event, no counter in the frame trace,
    the map and store read and assigned as before), and the frame's
    captured steps' moved-tensor errors name the part that moved.

On the card (`cuda`, skips here; the JAX reference is imported inside the
CPU tests only, so on the GPU machine

    python -m pytest --noconftest -m cuda tests/test_torch_frame_graph.py

runs them): the frame's two graphs (the mesh half on its own stream)
against the eager frame bit for bit over small_config frames; the two
graphs' IF nodes and set launches by site; one set launch a predicate;
every kernel's device runs equal the outer launches x replays plus each
body's launches x its runs; and the pipelined frame against the eager one
over 26 frames of a compacting mesh map and 10 pose-only frames, the state
read as the benchmark's check reads it, the mesh half's scalars read after
a join, with the mesh half's counters in the frame trace.
"""

import contextlib
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from immesh_tpu_torch import interop
from immesh_tpu_torch.config import LioConfig as TLC
from immesh_tpu_torch.config import VoxelMapConfig as TVC
from immesh_tpu_torch.core import so3
from immesh_tpu_torch.kernels import graph_cond as gc
from immesh_tpu_torch.lio import esikf as tesikf
from immesh_tpu_torch.map.voxel_map import VoxelMap
from immesh_tpu_torch.utils import graphs
from immesh_tpu_torch.utils.timers import trace

# the level mask's points (KITTI's map_update_points) and the pull mask's
# rows a voxel; chunks of the KITTI and Avia presets
LEVEL_POINTS, K = 8192, 48
CHUNKS = (512, 64)
MASKS = ("empty", "all", "last", "random")
_VM = dict(voxel_size=1.0, capacity=2 ** 10, max_layers=3,
           touched_voxels_per_scan=128, max_points_per_voxel=60)
_CONVERGE = {1: (1e6, 1e6), 2: (0.5, 0.005), 4: (0.0, 0.0)}


def _mask(kind: str, shape, seed: int) -> torch.Tensor:
    m = torch.zeros(shape, dtype=torch.bool)
    if kind == "all":
        m.fill_(True)
    elif kind == "last":
        m.view(-1)[-1] = True
    elif kind == "random":
        rng = np.random.default_rng(seed)
        m = torch.from_numpy(rng.random(shape) < 1e-3)
    return m


# ---------------------------------------------------------------------------
# the predicates, plain version against the expressions they replace
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("converged", [False, True])
def test_esikf_predicate_is_not_converged(converged):
    c = torch.tensor(converged)
    p = gc.negation(c, uses=2)
    assert p.value().dtype == torch.bool and p.value().shape == ()
    assert torch.equal(p.value(), ~c)
    assert gc.taken_plain(p) == (not converged)


@pytest.mark.parametrize("kind", MASKS)
def test_level_predicate_and_count(kind):
    """Three levels' masks: the set launch's "any" with the count set by
    the first and added by the others, against m.any() and
    levels + taken.to(int32) from zero."""
    masks = [_mask(kind, LEVEL_POINTS, 40 + k) for k in range(3)]
    if kind == "random":
        masks[1].zero_()  # a skipped level between taken ones
    old = torch.zeros((), dtype=torch.int32)
    new = torch.empty((), dtype=torch.int32)
    for k, m in enumerate(masks):
        taken = m.any()
        old = old + taken.to(torch.int32)
        p = gc.any_of(m, new, "set" if k == 0 else "add")
        assert torch.equal(p.value(), taken)
    assert new.dtype == old.dtype and torch.equal(new, old)


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("chunk", CHUNKS)
def test_chunk_predicate_over_row_ranges(kind, chunk):
    """Every chunk of a (4 chunks + a part, K) pull mask: any of its rows
    read in place (a contiguous view, no copy) against pmask[sl].any()."""
    A = 4 * chunk + chunk // 2
    pmask = _mask(kind, (A, K), 50 + chunk)
    for c0 in range(0, A, chunk):
        rows = pmask[c0:c0 + chunk]
        p = gc.any_of(rows)
        assert rows.is_contiguous() and p.x.data_ptr() == rows.data_ptr()
        assert torch.equal(p.value(), rows.any())


def test_read_form_is_the_bool_and_preds_are_checked():
    for v in (False, True):
        assert gc.taken_plain(torch.tensor(v)) == v
        assert gc.as_pred(torch.tensor([v])).form == "read"
    with pytest.raises(ValueError):
        gc.Pred("not", torch.zeros(2, dtype=torch.bool))
    with pytest.raises(ValueError):
        gc.any_of(torch.zeros(3, dtype=torch.bool),
                  torch.zeros((), dtype=torch.int64), "add")
    with pytest.raises(ValueError):
        gc.Pred("read", torch.zeros((), dtype=torch.bool),
                uses=gc.MAX_USES + 1)


def test_shared_predicate_reads_once_on_the_host(monkeypatch):
    """Two device_if calls on one predicate read it once on the CPU, and
    both take that value, as one set launch sets both nodes on the card."""
    reads = []
    inner = gc.taken_plain
    monkeypatch.setattr(gc, "taken_plain",
                        lambda p: reads.append(1) or inner(p))
    c = torch.tensor(False)
    p = gc.negation(c, uses=2)
    ran = []
    graphs.device_if(p, lambda: ran.append(0) or c.fill_(True), "esikf")
    graphs.device_if(p, lambda: ran.append(1), "esikf_step")
    assert ran == [0, 1] and reads == [1]


# ---------------------------------------------------------------------------
# the level count, and the ESIKF's first body, against the reference
# ---------------------------------------------------------------------------
def _planes(rng, n=1500, blob=True):
    g = np.c_[rng.uniform(-4, 4, (n, 2)), rng.normal(0, 0.01, n)]
    w = np.c_[rng.uniform(-4, 4, n // 2), rng.normal(2.3, 0.01, n // 2),
              rng.uniform(0, 3, n // 2)]
    parts = [g, w] + ([rng.normal([1.5, -1.5, 1.5], 0.6, (n // 4, 3))]
                      if blob else [])
    p = np.concatenate(parts).astype(np.float32)
    s2 = rng.uniform(1e-4, 1e-3, len(p)).astype(np.float32)
    return p, s2, np.ones(len(p), bool)


@pytest.fixture(scope="module")
def port_map():
    """A port plane map of three levels after two scans of the planes and
    a blob (the scene test_torch_conditional.py uses), on the CPU."""
    vm = VoxelMap.create(TVC(**_VM), device="cpu")
    rng = np.random.default_rng(31)
    for _ in range(2):
        vm.update(*(torch.from_numpy(a) for a in _planes(rng)))
    return vm


@pytest.mark.parametrize("blob", [False, True], ids=["skipped", "taken"])
def test_update_levels_count(port_map, blob):
    """update_levels' int32 equals the old composition's
    (levels + m.any().to(int32) over the parent masks)."""
    p, s2, m = (torch.from_numpy(a) for a in _planes(
        np.random.default_rng(33), blob=blob))
    if not blob:  # ground away from the blob and the wall: no level taken
        keep = (p[:, 0] < 0) & (p[:, 1] < 1.5) & (p[:, 2].abs() < 0.1)
        keep &= ~port_map.parent_mask(p, m, 1)
        p, s2, m = p[keep], s2[keep], m[keep]
    vm, ref = port_map.clone(), port_map.clone()
    want = torch.zeros((), dtype=torch.int32)
    ref._update_level(p, s2, m, 0, _VM["touched_voxels_per_scan"])
    lm = m
    for lvl in range(1, _VM["max_layers"]):
        lm = ref.parent_mask(p, lm, lvl)
        want = want + lm.any().to(torch.int32)
        ref._update_level(p, s2, lm, lvl, _VM["touched_voxels_per_scan"])
    got = vm.update_levels(p, s2, m)
    assert got.dtype == torch.int32 and got.shape == ()
    assert torch.equal(got, want) and (int(got) > 0) == blob
    assert torch.equal(vm.count, ref.count)


@pytest.fixture(scope="module")
def J():
    import jax
    import jax.numpy as jnp
    from immesh_tpu.config import LioConfig, VoxelMapConfig
    from immesh_tpu.core.geometry import lidar_point_cov_body
    from immesh_tpu.core.state import EsikfState
    from immesh_tpu.lio import esikf
    from immesh_tpu.map.voxel_map import VoxelMap as JVM
    jvm = JVM.create(VoxelMapConfig(**_VM))
    update = jax.jit(lambda vm, p, s2, m: vm.update(p, s2, m))
    rng = np.random.default_rng(31)
    for _ in range(2):
        jvm = update(jvm, *map(jnp.asarray, _planes(rng)))
    return SimpleNamespace(jax=jax, jnp=jnp, LC=LioConfig, VC=VoxelMapConfig,
                           pcov=lidar_point_cov_body, State=EsikfState,
                           esikf=esikf, vm=jvm)


def _tree(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if f.metadata.get("pytree_node", True)}
    return np.asarray(obj)


@pytest.mark.parametrize("iterations", sorted(_CONVERGE))
def test_first_esikf_body_runs_unconditionally(J, monkeypatch, iterations):
    rot_deg, trans_m = _CONVERGE[iterations]
    kw = dict(max_iterations=4, converge_rot_deg=rot_deg,
              converge_trans_m=trans_m)
    rng = np.random.default_rng(32)
    p, _, _ = _planes(rng, 900, blob=False)
    ang = np.deg2rad(0.6) * np.array([0.3, -0.5, 0.8])
    R = np.asarray(so3.exp(torch.tensor(ang, dtype=torch.float64)))
    t = np.array([0.04, -0.03, 0.01])
    body = ((p - t) @ R).astype(np.float32)
    pcov = np.asarray(J.pcov(J.jnp.asarray(body), 0.02, 0.05))
    mask = rng.random(len(body)) < 0.97
    prior = J.State.identity()
    jlio, jvc = J.LC(**kw), J.VC(**_VM)
    calls = [0]  # the reference's bodies, counted in its association
    assoc = J.esikf.associate

    def counted(*args, **kwargs):
        J.jax.debug.callback(lambda: calls.__setitem__(0, calls[0] + 1))
        return assoc(*args, **kwargs)

    monkeypatch.setattr(J.esikf, "associate", counted)
    js, jdiag = J.jax.jit(lambda st, vm, *a: J.esikf.lio_update(
        st, vm, *a, jlio, jvc))(prior, J.vm,
                                *map(J.jnp.asarray, (body, pcov, mask)))
    J.jax.block_until_ready(js)

    cfg = SimpleNamespace(voxel_map=TVC(**_VM))
    tvm = interop.from_reference({"vm": _tree(J.vm)}, cfg, device="cpu")["vm"]
    tprior = interop.from_reference({"state": _tree(prior)}, cfg,
                                    device="cpu")["state"]
    reads = []
    inner = gc.taken_plain
    monkeypatch.setattr(gc, "taken_plain",
                        lambda p: reads.append(p.form) or inner(p))
    ts, tdiag = tesikf.lio_update(
        tprior, tvm, *(torch.from_numpy(np.asarray(a))
                       for a in (body, pcov, mask)), TLC(**kw), TVC(**_VM))
    assert int(tdiag["iterations"]) == calls[0] == iterations
    assert bool(tdiag["converged"]) == bool(jdiag["converged"])
    np.testing.assert_allclose(np.asarray(js.pos), ts.pos.numpy(), atol=1e-4)
    dR = so3.log(torch.from_numpy(np.asarray(js.rot)).T @ ts.rot)
    assert float(dR.norm()) < 1e-5
    # bodies 2-4 read their shared predicate once each, the first none
    assert reads == ["not"] * (kw["max_iterations"] - 1)


# ---------------------------------------------------------------------------
# the frame pipeline
# ---------------------------------------------------------------------------
def test_cpu_frame_composes_the_eager_steps(monkeypatch):
    """On the CPU JointPipeline has no frame graph and its inner pipelines
    none of their own; each step is the LioPipeline's step without its
    compaction trigger (advance), the mesh half (MeshPipeline.step), once
    each, then the plane map's poll."""
    import chip_smoke
    from immesh_tpu_torch.lio.pipeline import LioPipeline
    from immesh_tpu_torch.mesh.pipeline import MeshPipeline
    from immesh_tpu_torch.runtime.joint import JointPipeline
    cfg = chip_smoke.small_config()
    cfg = cfg.replace(preprocess=dataclasses.replace(cfg.preprocess,
                                                     max_points=1024))
    pipe = JointPipeline(cfg, adaptive_mesh_budget=256, device="cpu")
    assert pipe.captured is None
    assert pipe.lio.captured is None and pipe.mesh.captured is None
    calls = []
    for cls, name in ((LioPipeline, "advance"), (MeshPipeline, "step"),
                      (LioPipeline, "maybe_compact")):
        inner = getattr(cls, name)

        def hooked(*args, _name=f"{cls.__name__}.{name}", _inner=inner):
            calls.append(_name)
            return _inner(*args)
        monkeypatch.setattr(cls, name, hooked)
    sim = chip_smoke.make_sim(1024, 16)
    world, diag = pipe.step(chip_smoke.bundle(sim.frame(0), cfg, "cpu"))
    assert calls == ["LioPipeline.advance", "MeshPipeline.step",
                     "LioPipeline.maybe_compact"]
    assert world.shape == (1024, 3) and "n_active_voxels" in diag
    assert set(pipe.mesh.last_drops) <= set(diag)
    assert pipe.mesh.last_active is not None and pipe.frame_idx == 1


def test_cpu_mesh_half_is_serial(monkeypatch):
    """On the CPU the mesh half stays on the caller's stream: a
    JointPipeline and an ImMeshRuntime make no CUDA stream or event, the
    frame trace counts none of the mesh half's counters, and the point map
    and store read and assign as before, through extract() and the live
    viewer's sync."""
    import chip_smoke
    from immesh_tpu_torch.render.live import RegionCache
    from immesh_tpu_torch.runtime.app import ImMeshRuntime
    from immesh_tpu_torch.runtime.joint import JointPipeline

    def refused(*args, **kwargs):
        raise AssertionError("a CUDA stream or event on the CPU path")

    monkeypatch.setattr(torch.cuda, "Stream", refused)
    monkeypatch.setattr(torch.cuda, "Event", refused)
    cfg = chip_smoke.small_config()
    cfg = cfg.replace(preprocess=dataclasses.replace(cfg.preprocess,
                                                     max_points=1024))
    sim = chip_smoke.make_sim(1024, 16)
    bundles = [chip_smoke.bundle(sim.frame(k), cfg, "cpu") for k in (0, 1)]
    pipe = JointPipeline(cfg, device="cpu")
    rt = ImMeshRuntime(cfg, device="cpu")
    with _traced():
        for b in bundles:
            pipe.step(b)
            rt.process_frame(b)
        for mesh in (pipe.mesh, rt.mesh):
            mesh.count_pending("pose_before_mesh")
            mesh.join()
        assert trace.frame_counts() == [{}] * 4
    for mesh in (pipe.mesh, rt.mesh):
        assert mesh.stream is None and mesh.done is None
        gm, store = mesh.gm, mesh.store
        assert gm is mesh._gm and store is mesh._store
        verts, faces = mesh.extract()
        assert len(faces) > 0
        np.testing.assert_array_equal(verts[faces], gm.pts.numpy()[
            store.tri_ids.reshape(-1, 3)[
                (store.tri_ids.reshape(-1, 3) >= 0).all(-1)].numpy()])
        cache = RegionCache(cfg.mesh.region_size, cfg.mesh.voxel_resolution,
                            cfg.mesh.display_smooth_lam)
        mesh.store = cache.sync(mesh.gm, mesh.store)
        assert mesh.store is store and not bool(store.dirty.any())
    assert pipe.store is pipe.mesh.store
    assert len(rt._pending_cost) == 1 and rt._pending_cost[0][2] is None
    rt.close()


def test_moved_tensor_names_the_part():
    """The frame's two captured steps check, at each replay, every tensor
    of the plane map (the LIO step), the point map and the store (the mesh
    step) and name the one that moved (no replay)."""
    import chip_smoke
    from immesh_tpu_torch.lio.captured import CapturedLioStep
    from immesh_tpu_torch.mesh.captured import CapturedMeshStep
    from immesh_tpu_torch.mesh.global_map import GlobalPointMap
    from immesh_tpu_torch.mesh.triangles import TriangleStore
    cfg = chip_smoke.small_config()
    vm = VoxelMap.create(cfg.voxel_map, device="cpu")
    gm = GlobalPointMap.create(cfg.mesh, device="cpu")
    store = TriangleStore.create(cfg.mesh, device="cpu")
    lio = CapturedLioStep.__new__(CapturedLioStep)
    mesh = CapturedMeshStep.__new__(CapturedMeshStep)
    for step, parts, moves in (
            (lio, (vm,), ((vm, "count", "the plane map"),)),
            (mesh, (gm, store), ((gm, "pts", "the point map"),
                                 (store, "tri_ids", "the triangle store")))):
        g = graphs.Graph(graph=None, inputs=(), out=None,
                         ptrs=step._pointers(*parts), captured={})
        for obj, name, what in moves:
            old = getattr(obj, name)
            setattr(obj, name, old.clone())
            with pytest.raises(RuntimeError,
                               match=f"a tensor of {what} moved"):
                step._replay(g, parts, ())
            setattr(obj, name, old)


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _read_as_checked(state, vm, mesh) -> list:
    """The state as the benchmark's check reads it straight after a step
    (perfbench/harness/window.py::flat_parts): every tensor of the filter
    state, the plane map, the point map and the store cloned on the
    current stream, with no synchronize."""
    return [(n, t.clone()) for n, t in graphs.named_tensors(
        {"state": state, "vm": vm, "gm": mesh.gm, "store": mesh.store})]


@contextlib.contextmanager
def _traced():
    """The frame trace on, then off and empty again."""
    trace.disable()
    trace.clear()
    trace.enable()
    try:
        yield
    finally:
        trace.disable()
        trace.clear()


COUNTERS = ("pose_before_mesh", "lio_over_mesh", "mesh_joins")


def _counted() -> tuple:
    """The mesh half's counters of the frame trace's newest frame."""
    counts = trace.frame_counts()[-1]
    return tuple(counts.get(c, 0) for c in COUNTERS)


def _mesh_scalars(mesh, diag) -> dict:
    """The mesh half's device scalars as a caller reads them: after a join
    of the half (no synchronize), diag's mesh entries and last_drops."""
    mesh.join()
    return {**{k: int(v) for k, v in diag.items()
               if k == "n_active_voxels" or k.startswith("drop_")},
            **{f"last.{k}": int(v) for k, v in mesh.last_drops.items()}}


@pytest.mark.cuda
def test_one_graph_frame_on_the_card():
    """small_config on the card two ways from the same start: the frame's
    two graphs (the LIO's, then the mesh half's on its own stream) and
    eager, bit for bit every frame (a forced compaction of both maps
    included); the two graphs' IF nodes and set launches by site, one set
    launch a predicate, and every kernel's device runs as the graphs'
    replays and bodies say."""
    dev = _card()
    import chip_smoke
    from immesh_tpu_torch.kernels import hash_probe as hp
    from immesh_tpu_torch.kernels import pairs_argmin as pk
    from immesh_tpu_torch.kernels import scatter_drop as sd
    from immesh_tpu_torch.runtime.joint import JointPipeline
    cfg = chip_smoke.small_config()
    sim = chip_smoke.make_sim(cfg.preprocess.max_points, 16)
    two = JointPipeline(cfg, adaptive_mesh_budget=256, device=dev)
    eager = JointPipeline(cfg, adaptive_mesh_budget=256, device=dev,
                          graph=False)
    assert eager.captured is None and two.mesh.stream is not None
    pipes = (eager, two)
    for mod in (hp, sd, pk, gc):
        mod.reset_launches()
    n = 8
    rows = []
    for k in range(n):
        b = chip_smoke.bundle(sim.frame(k), cfg, dev)
        outs = [p.step(b) for p in pipes]
        if k == 4:
            for p in pipes:
                chip_smoke.compact_half(p.lio.vm, p.state.pos)
                chip_smoke.compact_mesh_half(p.mesh, p.state.pos)
        (we, de), (w, d) = outs
        assert chip_smoke.mesh_differs(eager.mesh, two.mesh, [
            ("world", we, w), *[(x, de[x], d[x]) for x in de],
            *zip(("slots", "smask"), eager.mesh.last_active,
                 two.mesh.last_active)]) == []
        assert chip_smoke.lio_differs(eager.lio.state, two.lio.state,
                                      eager.lio.vm, two.lio.vm) == []
        rows.append({"iterations": int(d["iterations"]),
                     "levels": int(d["levels"]),
                     "chunks": chip_smoke.active_chunks(
                         two.mesh.last_active[1], cfg.mesh.mesh_chunk)})
    torch.cuda.synchronize()
    graphs_ = two.captured.graphs
    lg, mg = graphs_
    assert (lg.replays, mg.replays, two.captured.replays) == (n - 1,) * 3
    n_chunks = -(-cfg.mesh.active_voxels_per_frame // cfg.mesh.mesh_chunk)
    sites = chip_smoke.check_sites("two graphs", graphs_, rows, cfg)
    assert sites["if_nodes"]["nodes"] == {**chip_smoke.lio_sites(cfg),
                                          "chunk": n_chunks}
    assert sites["set_launches"] == {**chip_smoke.lio_launches(cfg),
                                     "chunk": n_chunks}
    # one launch a predicate: the ESIKF body's two nodes share one
    assert sum(g.captured["graph_cond"] for g in graphs_) == sum(
        sites["set_launches"].values())
    bodies = [bd for gr in graphs_ for bd in gr.bodies]
    assert len(bodies) == sum(sites["if_nodes"]["nodes"].values())
    assert sum(bd.captured.get("graph_cond", 0) for bd in bodies) == 0
    # every kernel's device runs: the two graphs' and the eager frames'
    taken = gc.taken([bd.slot for bd in bodies])
    launches = {**hp.launches, "scatter_drop": sd.launches,
                "pairs_argmin": pk.launches, "graph_cond": 0}
    runs = {**hp.runs(), "scatter_drop": sd.runs(),
            "pairs_argmin": pk.runs(), "graph_cond": gc.runs()}
    for k in runs:
        want = launches[k] + sum(gr.replays * gr.captured.get(k, 0)
                                 for gr in graphs_) + sum(
            t * bd.captured.get(k, 0) for t, bd in zip(taken, bodies))
        assert runs[k] == want, k


@pytest.mark.cuda
def test_pipelined_frame_equals_eager_on_the_card():
    """The JointPipeline on the card, its mesh half on its own stream,
    against graph=False (eager, serial) from the same start, over 26
    small_config frames whose mesh map compacts every 2-3 frames on its
    own (its 8,192-point capacity), the frame trace on: the pose, the world
    scan, diag's LIO entries, the compaction counts and the state as the
    benchmark's check reads it straight after the step bit for bit every
    frame, and the mesh half's scalars (diag's n_active_voxels and drop_*,
    last_drops) read as ints after a join, with no synchronize, equal;
    then 10 frames each with the pose read alone, and the state bit for
    bit after them.  The trace's counters: pose_before_mesh on every
    replayed frame without a mesh compaction (its host reads end the half
    before the step returns), mesh_joins on the joins, lio_over_mesh in
    the pose-only frames; none on the eager pipeline."""
    dev = _card()
    import chip_smoke
    from immesh_tpu_torch.runtime.joint import JointPipeline
    cfg = chip_smoke.small_config()
    sim = chip_smoke.make_sim(cfg.preprocess.max_points, 16)
    bundles = [chip_smoke.bundle(sim.frame(k), cfg, dev) for k in range(36)]
    with _traced():
        eager = JointPipeline(cfg, adaptive_mesh_budget=256, device=dev,
                              graph=False)
        piped = JointPipeline(cfg, adaptive_mesh_budget=256, device=dev)
        pipes = (eager, piped)
        totals = {id(p): np.zeros(3, np.int64) for p in pipes}
        steady, compacted = [], 0
        for k in range(26):
            got = []
            for p in pipes:
                before = p.mesh.n_compactions
                world, diag = p.step(bundles[k])
                pose = p.state.pos.cpu()
                scalars = _mesh_scalars(p.mesh, diag)
                got.append((pose, world, diag, scalars,
                            _read_as_checked(p.state, p.lio.vm, p.mesh),
                            _counted(), p.mesh.n_compactions - before))
                totals[id(p)] += got[-1][5]
            ((pe, we, de, me, se, _, ce),
             (pp, wp, dp, mp, sp, counted, cp)) = got
            bad = [n for (n, x), (_, y) in zip(se, sp)
                   if not chip_smoke.same_bits(x, y)]
            bad += [x for x in de if not chip_smoke.same_bits(de[x], dp[x])]
            bad += [n for n, x, y in (("pose", pe, pp), ("world", we, wp))
                    if not chip_smoke.same_bits(x, y)]
            assert bad == [] and me == mp and ce == cp, (k, bad, me, mp)
            compacted += cp
            if k >= 2 and not cp:
                steady.append(counted[0])
        assert compacted >= 5 and len(steady) >= 8
        assert steady == [1] * len(steady)
        assert totals[id(piped)][2] >= len(steady)
        over = totals[id(piped)][1]
        for p in pipes:   # the pose alone, each pipeline on its own
            for b in bundles[26:]:
                p.step(b)
                p.state.pos.cpu()
                totals[id(p)] += _counted()
        assert totals[id(piped)][1] - over >= 3
        assert totals[id(eager)].tolist() == [0, 0, 0]
        se, sp = (_read_as_checked(p.state, p.lio.vm, p.mesh) for p in pipes)
        assert [n for (n, x), (_, y) in zip(se, sp)
                if not chip_smoke.same_bits(x, y)] == []
        assert eager.mesh.n_compactions == piped.mesh.n_compactions


@pytest.mark.cuda
def test_one_set_launch_sets_nodes_across_a_solve_on_the_card():
    """chip_smoke's forms probe: every form of the set kernel (read, not,
    any over unaligned spans, a level's and a chunk's bytes, the count set
    and added) and one launch setting 3 and MAX_USES IF nodes with a
    cholesky_solve between them, captured and replayed on random inputs,
    against the same step on the CPU (the plain versions)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    import chip_smoke
    dev = torch.device("cuda")
    rng = np.random.default_rng(36)
    gen = torch.Generator().manual_seed(37)
    M = torch.randn(18, 18, generator=gen)
    A = torch.linalg.cholesky(M @ M.T + 18 * torch.eye(18))
    B = torch.randn(18, 1, generator=gen)
    n = 8 + len(chip_smoke.COND_SPANS) + 3 + gc.MAX_USES
    acc = torch.zeros(n + len(chip_smoke.COND_SPANS), dtype=torch.int32,
                      device=dev)
    ref = acc.cpu()
    gc.reset_launches()
    step = chip_smoke.probe_step(dev, chip_smoke.forms_step)
    for _ in range(12):
        flags, buf = chip_smoke.forms_inputs(rng, dev)
        step(acc, flags, buf, A.to(dev), B.to(dev))
        chip_smoke.forms_step(ref, flags.cpu(), buf.cpu(), A, B)
        assert torch.equal(acc.cpu(), ref)
    (g,) = step.graphs
    n_preds = 8 + len(chip_smoke.COND_SPANS) + 2
    assert g.captured["graph_cond"] == n_preds and len(g.bodies) == n
    assert gc.runs() == n_preds * g.replays
