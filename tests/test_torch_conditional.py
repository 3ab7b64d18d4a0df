"""The reference's on-device exits as the port runs them
(utils/graphs.py::device_if): the ESIKF while_loop, the refinement
levels' lax.cond and the mesh chunks' lax.cond, against the JAX reference
on seeded numpy inputs.

In the captured steps each is the body of a CUDA-graph IF node: a skipped
body runs nothing, so a tensor it makes holds the previous replay's bits,
and nothing after the node may read one.  On the CPU device_if is a host
`if`; here every call of it goes through a spy that, after each body that
ran, overwrites the bits of every tensor the body made (its fresh storage,
found with a TorchDispatchMode) and records every tensor reachable from the
body (the carry) before and after each call.  Then:

  * the early-exit ESIKF (lio_update) against the reference's while_loop
    (jitted, its iterations counted by a debug callback in its association) at
    converge-at-1, converge-at-2 and never (_CONVERGE): the iteration count
    EQUAL, the state within tests/test_torch_lio_graph.py's tolerances (pose
    1e-4 m and 1e-5 rad, covariance 1e-3 of its largest entry: another
    summation order and another 18×18 Cholesky), n_effective within 2; and
    bit for bit the masked form the multi-rank step runs (iterated_update
    with an identity `reduce`);
  * VoxelMap.update_levels against the reference's lax.cond on a scan whose
    refinement levels are skipped and on one whose levels are taken (keys,
    fp, counts and flags EXACT, the rest as tests/test_torch_lio_graph.py
    holds them), and bit for bit the form that runs every level;
  * triangulate_voxels against the reference's lax.map / lax.cond chunks
    on a work list with taken and skipped chunks: ids,
    counts and drops EXACT;
  * the carry: in each of the three (the ESIKF's two IF nodes a body: its
    normal equations, and after the solve between them its step), a body
    skipped after one that ran
    leaves every tensor reachable from it bit for bit as it was, and a body
    that ran wrote some; the poisoning changes no result above.

The `cuda` test (skips here) captures a step of IF nodes and the KITTI-
shaped frame (its LIO and mesh graphs) on the card: the set kernel
against its plain version (the host read) on true and false predicates,
the graph's IF nodes (two a body in the max_iterations − 1 ESIKF bodies
after the first, which runs with no node, set by one launch; one a level
in max_layers − 1; one a chunk), no body holding a mem_alloc, mem_free or
event node, captured equal to eager bit for bit, and every kernel's device
runs equal to the outer launches × replays plus each body's launches × the
runs of its body.
The reference is imported inside fixtures, so on the GPU machine (no JAX)

    python -m pytest --noconftest -m cuda tests/test_torch_conditional.py
"""

import dataclasses
import functools
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

from immesh_tpu_torch import interop
from immesh_tpu_torch.config import LioConfig as TLC
from immesh_tpu_torch.config import VoxelMapConfig as TVC
from immesh_tpu_torch.core import so3
from immesh_tpu_torch.kernels import graph_cond
from immesh_tpu_torch.lio import esikf as tesikf
from immesh_tpu_torch.map import voxel_map as tvoxel
from immesh_tpu_torch.mesh import triangles as ttri
from immesh_tpu_torch.utils import graphs

_VM = dict(voxel_size=1.0, capacity=2 ** 10, max_layers=3,
           touched_voxels_per_scan=128, max_points_per_voxel=60)
# (converge_rot_deg, converge_trans_m) → the reference's iteration count
_CONVERGE = {1: (1e6, 1e6), 2: (0.5, 0.005), 4: (0.0, 0.0)}
# the mesh cut: a 64-voxel work list in chunks of 8
_BUDGET, _CHUNK = 64, 8


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if f.metadata.get("pytree_node", True)}
    return np.asarray(obj)


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _same(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.dtype == b.dtype and torch.equal(_bits(a), _bits(b))


# ---------------------------------------------------------------------------
# the spy: poison what a body made, snapshot what it reaches
# ---------------------------------------------------------------------------
class _Made(TorchDispatchMode):
    """The tensors the ops under it return in fresh storage (neither an
    in-place op's nor a view's)."""

    def __init__(self):
        super().__init__()
        self.made = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        schema = func._schema
        if not schema.is_mutable and all(r.alias_info is None
                                         for r in schema.returns):
            self.made += [t for t in tree_leaves(out)
                          if isinstance(t, torch.Tensor)]
        return out


def _poison(tensors) -> int:
    """Invert every bit of each tensor's storage; returns the storages."""
    seen = set()
    for t in tensors:
        st = t.untyped_storage()
        if st.nbytes() == 0 or st.data_ptr() in seen:
            continue
        seen.add(st.data_ptr())
        torch.tensor([], dtype=torch.uint8).set_(st).bitwise_not_()
    return len(seen)


def _reach(x, seen=None) -> list:
    """The tensors reachable from x: through dataclasses, dicts, lists,
    tuples, partials, bound methods and closures."""
    seen = set() if seen is None else seen
    if id(x) in seen:
        return []
    seen.add(id(x))
    if torch.is_tensor(x):
        return [x]
    if dataclasses.is_dataclass(x) and not isinstance(x, type):
        kids = [getattr(x, f.name) for f in dataclasses.fields(x)]
    elif isinstance(x, dict):
        kids = list(x.values())
    elif isinstance(x, (list, tuple)):
        kids = list(x)
    elif isinstance(x, functools.partial):
        kids = [x.func, *x.args, *x.keywords.values()]
    elif hasattr(x, "__self__") and hasattr(x, "__func__"):
        kids = [x.__self__, x.__func__]
    elif callable(x) and getattr(x, "__closure__", None):
        kids = [c.cell_contents for c in x.__closure__]
    else:
        kids = []
    return [t for k in kids for t in _reach(k, seen)]


@pytest.fixture
def spy(monkeypatch):
    """device_if in the three modules, as the host `if` it is on the CPU,
    with each taken body's fresh tensors poisoned after it and every call
    logged: (site, taken, the carry's tensors unchanged by the call)."""
    log = []

    def device_if(pred, body, what="body"):
        carry = _reach(body)
        before = [t.clone() for t in carry]
        taken = graph_cond.taken_plain(pred)
        if taken:
            with _Made() as mode:
                body()
            _poison(mode.made)
        log.append((what, taken, all(_same(a, b)
                                     for a, b in zip(carry, before))))

    for mod in (tesikf, tvoxel, ttri):
        monkeypatch.setattr(mod, "device_if", device_if)
    return log


def _check_carry(log, site: str, first_logged: bool = True) -> None:
    """A body skipped after one that ran left its carry unchanged; a body
    that ran changed it.  The first body that ran is the site's first
    logged call, or (`first_logged` False: the ESIKF's first body, which
    runs with no device_if) none of them."""
    calls = [(taken, same) for what, taken, same in log if what == site]
    assert calls and (calls[0][0] or not first_logged), calls
    for k, (taken, same) in enumerate(calls):
        assert same != taken, (site, k, calls)


# ---------------------------------------------------------------------------
# the reference
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def J():
    """The reference's modules (JAX on the CPU, as conftest sets it)."""
    import jax
    import jax.numpy as jnp
    from immesh_tpu.config import LioConfig, MeshConfig, VoxelMapConfig
    from immesh_tpu.core.geometry import lidar_point_cov_body
    from immesh_tpu.core.state import EsikfState
    from immesh_tpu.lio import esikf
    from immesh_tpu.map.voxel_map import VoxelMap
    from immesh_tpu.mesh import triangles
    from immesh_tpu.mesh.global_map import GlobalPointMap
    return SimpleNamespace(jax=jax, jnp=jnp, LC=LioConfig, VC=VoxelMapConfig,
                           MC=MeshConfig, pcov=lidar_point_cov_body,
                           State=EsikfState, esikf=esikf, VM=VoxelMap,
                           tri=triangles, GM=GlobalPointMap)


def _planes(rng, n=1500, blob=True):
    """Ground and a wall with centimetre noise, and a noisy blob that
    spills voxels into the finer levels."""
    g = np.c_[rng.uniform(-4, 4, (n, 2)), rng.normal(0, 0.01, n)]
    w = np.c_[rng.uniform(-4, 4, n // 2), rng.normal(2.3, 0.01, n // 2),
              rng.uniform(0, 3, n // 2)]
    parts = [g, w] + ([rng.normal([1.5, -1.5, 1.5], 0.6, (n // 4, 3))]
                      if blob else [])
    p = np.concatenate(parts).astype(np.float32)
    s2 = rng.uniform(1e-4, 1e-3, len(p)).astype(np.float32)
    return p, s2, np.ones(len(p), bool)


@pytest.fixture(scope="module")
def plane_map(J):
    """The reference map after two scans of the planes (jitted once)."""
    jvm = J.VM.create(J.VC(**_VM))
    update = J.jax.jit(lambda vm, p, s2, m: vm.update(p, s2, m))
    rng = np.random.default_rng(31)
    for _ in range(2):
        jvm = update(jvm, *map(J.jnp.asarray, _planes(rng)))
    return jvm


def _port(name, obj, vm_cfg=None):
    cfg = SimpleNamespace(voxel_map=vm_cfg)
    return interop.from_reference({name: _tree(obj)}, cfg, device="cpu")[name]


# ---------------------------------------------------------------------------
# the ESIKF
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("iterations", sorted(_CONVERGE))
def test_early_exit_esikf_matches_the_reference_while_loop(
        J, plane_map, spy, monkeypatch, iterations):
    rot_deg, trans_m = _CONVERGE[iterations]
    kw = dict(max_iterations=4, converge_rot_deg=rot_deg,
              converge_trans_m=trans_m)
    jlio, tlio = J.LC(**kw), TLC(**kw)
    jvc, tvc = J.VC(**_VM), TVC(**_VM)
    rng = np.random.default_rng(32)
    p, _, _ = _planes(rng, 900, blob=False)
    ang = np.deg2rad(0.6) * np.array([0.3, -0.5, 0.8])
    R = np.asarray(so3.exp(torch.tensor(ang, dtype=torch.float64)))
    t = np.array([0.04, -0.03, 0.01])
    body = ((p - t) @ R).astype(np.float32)  # world = R · body + t
    pcov = np.asarray(J.pcov(J.jnp.asarray(body), 0.02, 0.05))
    mask = rng.random(len(body)) < 0.97

    calls = [0]
    inner = J.esikf.associate

    def counted(*args, **kwargs):
        J.jax.debug.callback(lambda: calls.__setitem__(0, calls[0] + 1))
        return inner(*args, **kwargs)

    monkeypatch.setattr(J.esikf, "associate", counted)
    prior = J.State.identity()
    js, jdiag = J.jax.jit(lambda st, vm, *a: J.esikf.lio_update(
        st, vm, *a, jlio, jvc))(prior, plane_map,
                                *map(J.jnp.asarray, (body, pcov, mask)))
    J.jax.block_until_ready(js)
    assert calls[0] == iterations  # the case is what it says

    tvm, tprior = _port("vm", plane_map, tvc), _port("state", prior)
    args = (_t(body), _t(pcov), _t(mask))
    ts, tdiag = tesikf.lio_update(tprior, tvm, *args, tlio, tvc)
    assert int(tdiag["iterations"]) == iterations
    assert bool(tdiag["converged"]) == bool(jdiag["converged"])
    assert abs(int(tdiag["n_effective"]) - int(jdiag["n_effective"])) <= 2
    np.testing.assert_allclose(np.asarray(js.pos), ts.pos.numpy(), atol=1e-4)
    dR = so3.log(_t(np.asarray(js.rot)).T @ ts.rot)
    assert float(dR.norm()) < 1e-5
    jc = np.asarray(js.cov)
    np.testing.assert_allclose(jc, ts.cov.numpy(), rtol=0,
                               atol=1e-3 * np.abs(jc).max())
    # the first body runs unconditionally (the while_loop's first test
    # holds); each later one is two IF nodes on one predicate: its normal
    # equations, then (after the solve) its step
    for site in ("esikf", "esikf_step"):
        assert [taken for what, taken, _ in spy if what == site] == [
            k < iterations for k in range(1, 4)]
        _check_carry(spy, site, first_logged=False)

    # bit for bit the masked form (every body runs, the dead ones masked)
    ms, mdiag = tesikf.iterated_update(
        tprior, lambda st: tesikf.associate(st, tvm, *args, tvc), tlio,
        reduce=lambda sums: sums)
    for f in dataclasses.fields(ms):
        assert _same(getattr(ms, f.name), getattr(ts, f.name)), f.name
    for k in mdiag:
        assert _same(mdiag[k], tdiag[k]), k


# ---------------------------------------------------------------------------
# the refinement levels
# ---------------------------------------------------------------------------
def _check_vm(jvm, tvm):
    for name in ("count", "plane_valid", "subdivided"):
        np.testing.assert_array_equal(np.asarray(getattr(jvm, name)),
                                      getattr(tvm, name).numpy(), name)
    np.testing.assert_array_equal(np.asarray(jvm.table.keys),
                                  tvm.table.keys.numpy())
    np.testing.assert_array_equal(np.asarray(jvm.table.fp),
                                  tvm.table.fp.numpy())
    for name in ("sum_p", "sum_ppT", "sigma2_sum"):
        np.testing.assert_allclose(np.asarray(getattr(jvm, name)),
                                   getattr(tvm, name).numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=name)
    for name in ("center", "var_c"):
        np.testing.assert_allclose(np.asarray(getattr(jvm, name)),
                                   getattr(tvm, name).numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    jl, tl = np.asarray(jvm.lam), tvm.lam.numpy()
    scale = np.abs(jl).max(-1, keepdims=True)
    assert (np.abs(jl - tl) <= 1e-5 + 1e-3 * scale).all()


def _map_tensors(vm) -> list:
    return [vm.table.keys, vm.table.fp] + [getattr(vm, n)
                                           for n in vm._FIELDS]


@pytest.mark.parametrize("blob", [False, True], ids=["skipped", "taken"])
def test_levels_skip_as_the_reference_cond(J, plane_map, spy, blob):
    """The ground away from the blob and the wall, in voxels that are not
    subdivided, stays planar, so the reference's lax.cond skips levels 1
    and 2; the whole scene with the blob takes level 1."""
    p, s2, m = _planes(np.random.default_rng(33), blob=blob)
    tvm = _port("vm", plane_map, TVC(**_VM))
    if not blob:
        keep = (p[:, 0] < 0) & (p[:, 1] < 1.5) & (np.abs(p[:, 2]) < 0.1)
        keep &= ~tvm.parent_mask(_t(p), _t(m), 1).numpy()
        p, s2, m = p[keep], s2[keep], m[keep]
    every = tvm.clone()
    jvm = J.jax.jit(lambda vm, *a: vm.update(*a))(
        plane_map, *map(J.jnp.asarray, (p, s2, m)))
    levels = int(tvm.update_levels(_t(p), _t(s2), _t(m)))
    taken = [t for _, t, _ in spy]
    assert len(taken) == _VM["max_layers"] - 1 and taken[0] == blob
    assert taken == sorted(taken, reverse=True) and sum(taken) == levels
    _check_vm(jvm, tvm)
    if blob:
        _check_carry(spy, "level")
    else:
        assert all(same for _, _, same in spy)

    # bit for bit the form that runs every level, an empty one a no-op
    every._update_level(_t(p), _t(s2), _t(m), 0,
                        _VM["touched_voxels_per_scan"])
    lm = _t(m)
    for lvl in range(1, _VM["max_layers"]):
        lm = every.parent_mask(_t(p), lm, lvl)
        every._update_level(_t(p), _t(s2), lm, lvl,
                            _VM["touched_voxels_per_scan"])
    for a, b in zip(_map_tensors(tvm), _map_tensors(every)):
        assert _same(a, b)


# ---------------------------------------------------------------------------
# the mesh chunks
# ---------------------------------------------------------------------------
def _mesh_cfg(MC):
    return MC(pts_minimum_scale=0.15, voxel_resolution=0.6,
              points_capacity=2048, voxel_capacity=2 ** 10,
              active_voxels_per_frame=_BUDGET, file_voxels_per_frame=256,
              max_pts_per_frame=1500, mesh_chunk=_CHUNK)


@pytest.fixture(scope="module")
def mesh_case(J):
    """A reference point map after one scan of a gently curved patch (22
    active voxels of the 64-voxel work list), its work list, and the
    reference's triangulation of it in chunks of 8."""
    mc = _mesh_cfg(J.MC)
    rng = np.random.default_rng(34)
    xy = rng.uniform(-1.0, 1.0, (600, 2))
    z = 0.05 * np.sin(xy[:, 0]) + rng.normal(0, 0.005, len(xy))
    pts = np.c_[xy, z].astype(np.float32)
    mask = np.ones(len(pts), bool)
    pos = np.array([0.0, 0.0, 1.5], np.float32)
    gm, slots, smask, _ = J.jax.jit(lambda g, *a: g.append_frame(*a))(
        J.GM.create(mc), J.jnp.asarray(pts), J.jnp.asarray(mask))
    ref = J.jax.jit(lambda *a: J.tri.triangulate_voxels(*a, mc, _CHUNK))(
        gm, slots, smask, J.jnp.asarray(pos))
    return SimpleNamespace(mc=mc, gm=gm, slots=np.asarray(slots),
                           smask=np.asarray(smask), pos=pos,
                           ref=[np.asarray(x) for x in ref])


def test_chunks_skip_as_the_reference_cond(mesh_case, spy):
    from immesh_tpu_torch.config import MeshConfig
    c = mesh_case
    tmc = MeshConfig(**dataclasses.asdict(c.mc))
    gm = interop.from_reference({"gm": _tree(c.gm)},
                                SimpleNamespace(mesh=tmc), device="cpu")["gm"]
    ids, counts, dropped = ttri.triangulate_voxels(
        gm, _t(c.slots), _t(c.smask), _t(c.pos), tmc, _CHUNK)
    for got, want in zip((ids, counts, dropped), c.ref):
        np.testing.assert_array_equal(want, got.numpy())
    assert int(counts.sum()) > 0
    taken = [t for _, t, _ in spy]
    n_active = int(c.smask.sum())
    assert 0 < n_active < _BUDGET - _CHUNK
    # the work list is compacted, active voxels first: a chunk runs iff it
    # holds an active voxel
    assert taken == [c0 < n_active for c0 in range(0, _BUDGET, _CHUNK)]
    _check_carry(spy, "chunk")


# ---------------------------------------------------------------------------
# device_if itself
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("value", [False, True])
def test_device_if_on_the_cpu_is_the_host_if(value):
    out = torch.zeros(2)
    graphs.device_if(torch.tensor(value), lambda: out.add_(1.0))
    assert out.tolist() == [float(value)] * 2
    assert graph_cond.launches == 0 and graph_cond._lib is None


def test_the_cpu_step_never_loads_the_library():
    """A CPU step takes the plain version (the host read): no IF node, no
    library, nothing counted."""
    before = graph_cond.captured
    log = []
    graphs.device_if(torch.tensor(True), lambda: log.append(1), "x")
    assert log == [1] and graph_cond.captured == before
    assert graph_cond._lib is None
    assert graph_cond.taken([3, 5]) == [0, 0]


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
class _Toy(graphs.CapturedStep):
    """A step of three IF nodes: x += 1 where p[0], x += 10 where p[1],
    x += 100 where p[2]."""

    def __call__(self, x, p):
        return self._run((x,), (p,))

    def _pointers(self, x):
        return (x.data_ptr(),)

    def _step(self, x, p):
        for k in range(3):
            graphs.device_if(p[k], functools.partial(x.add_, 10.0 ** k),
                             f"toy{k}")
        return x.sum()


@pytest.mark.cuda
def test_if_nodes_on_the_card():
    """The set kernel against its plain version, the captured LIO and mesh
    steps' IF nodes and their bodies, captured equal to eager, and the
    device runs that the bodies that ran account for."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    import chip_smoke
    from immesh_tpu_torch.kernels import hash_probe as hp
    from immesh_tpu_torch.kernels import pairs_argmin as pk
    from immesh_tpu_torch.kernels import scatter_drop as sd
    from immesh_tpu_torch.runtime.joint import JointPipeline
    dev = torch.device("cuda")

    # the set kernel: each replay's bodies are the host read's
    graph_cond.reset_launches()
    x = torch.zeros(1, device=dev)
    toy = _Toy(dev)
    rng = np.random.default_rng(35)
    want = 0.0
    for k in range(12):
        p = torch.tensor(rng.random(3) < 0.5, device=dev)
        toy(x, p)
        want += sum(10.0 ** j for j in range(3) if bool(p[j].cpu()))
        assert float(x.cpu()) == want
    (g,) = toy.graphs
    assert len(g.bodies) == 3 and graph_cond.captured == 3
    assert graph_cond.runs() == 3 * g.replays == 3 * 11
    assert g.nodes()["conditional"] == 3

    cfg = chip_smoke.small_config()
    sim = chip_smoke.make_sim(cfg.preprocess.max_points, 16)
    pipes = [JointPipeline(cfg, adaptive_mesh_budget=256, device=dev,
                           graph=gr) for gr in (False, True)]
    for mod in (hp, sd, pk, graph_cond):
        mod.reset_launches()
    n = 8
    iterations = levels = chunks = 0
    for k in range(n):
        b = chip_smoke.bundle(sim.frame(k), cfg, dev)
        outs = [p.step(b) for p in pipes]
        (we, de), (wc, dc) = outs
        e, c = pipes
        assert chip_smoke.lio_differs(e.lio.state, c.lio.state, e.lio.vm,
                                      c.lio.vm) == []
        assert chip_smoke.mesh_differs(e.mesh, c.mesh, [
            ("world", we, wc), *[(x, de[x], dc[x]) for x in de],
            *zip(("slots", "smask"), e.mesh.last_active,
                 c.mesh.last_active)]) == []
        if k > 0:  # frame 0 is the eager warm-up
            # the first ESIKF body runs with no IF node
            iterations += int(dc["iterations"]) - 1
            levels += int(dc["levels"])
            smask = c.mesh.last_active[1]
            chunks += sum(bool(smask[i:i + cfg.mesh.mesh_chunk].any())
                          for i in range(0, smask.numel(),
                                         cfg.mesh.mesh_chunk))
    torch.cuda.synchronize()
    fgs = pipes[1].captured.graphs  # the frame: its LIO and mesh graphs
    bodies = [bd for fg in fgs for bd in fg.bodies]
    sites = {}
    for bd in bodies:
        sites[bd.what] = sites.get(bd.what, 0) + 1
        kinds = bd.nodes()
        assert not {"mem_alloc", "mem_free", "event_record",
                    "wait_event"} & set(kinds), kinds
    assert sites == {"esikf": cfg.lio.max_iterations - 1,
                     "esikf_step": cfg.lio.max_iterations - 1,
                     "level": cfg.voxel_map.max_layers - 1,
                     "chunk": -(-cfg.mesh.active_voxels_per_frame
                                // cfg.mesh.mesh_chunk)}
    assert sum(fg.nodes()["conditional"] for fg in fgs) == sum(
        sites.values())
    # one set launch a predicate: an ESIKF body's two nodes share one
    assert sum(fg.captured["graph_cond"] for fg in fgs) == sum(
        sites.values()) - sites["esikf"]
    # the bodies that ran, by the set kernel's own counters and by diag
    taken = graph_cond.taken([bd.slot for bd in bodies])
    ran = {}
    for bd, t in zip(bodies, taken):
        ran[bd.what] = ran.get(bd.what, 0) + t
    assert ran == {"esikf": iterations, "esikf_step": iterations,
                   "level": levels, "chunk": chunks}
    launches = {**hp.launches, "scatter_drop": sd.launches,
                "pairs_argmin": pk.launches}
    runs = {**hp.runs(), "scatter_drop": sd.runs(),
            "pairs_argmin": pk.runs()}
    for k in runs:
        want = launches[k] + sum(fg.replays * fg.captured.get(k, 0)
                                 for fg in fgs) + sum(
            t * bd.captured.get(k, 0) for bd, t in zip(bodies, taken))
        assert runs[k] == want, k
    assert graph_cond.runs() == sum(fg.replays * fg.captured["graph_cond"]
                                    for fg in fgs)
