"""The LIO step's device-side control flow: the ESIKF iterations and the
refinement levels as the captured CUDA graph runs them (each body under
utils/graphs.py::device_if, an IF node on the card, a host `if` here), and
the plane map's in-place compaction, each against the JAX reference on
seeded numpy inputs.

  * iterated_update (lio_update) runs up to max_iterations static bodies,
    those after convergence skipped.  Against the reference's while_loop on inputs
    that converge at iteration 1, at iteration 2 and never (stopping at
    max_iterations): the iteration count EQUAL (the reference's counted by
    its association calls, run without jit), the state within
    tests/test_torch_lio_mesh.py's tolerances (pose 1e-4 m and 1e-5 rad,
    covariance rtol 1e-3 of its largest entry: another summation order and
    another 18×18 Cholesky), n_effective within 2.  Against the port's own
    host loop (the form before PR 10) and the masked form the multi-rank
    step runs (every body, the dead ones masked), bit for bit.
  * VoxelMap.update skips an empty refinement level: bit for bit the update
    that runs every level (an empty one an exact no-op), and against
    the reference's lax.cond on a scan whose refinement level is skipped
    and on one whose level is taken (keys, fp, counts and flags EXACT;
    moments rtol 1e-6; centres and var_c rtol 1e-4, as tests/
    test_torch_map.py holds them; eigenvalues within 1e-5 plus 1e-3 of the
    voxel's largest: the closed form takes arccos of a ratio near ±1, where
    an f32 ulp of the ratio moves the angle by ~√ε).
  * VoxelMap.compact copies the compacted map back into the same tensors:
    equal to the reference's compact, every data_ptr unchanged.

The `cuda` test holds the captured LIO step to the eager step on the card
bit for bit, and the hash and scatter kernels' device run counts to their
eager launches plus the graph's replays and the runs of its IF nodes'
bodies; it skips without a card.  The reference is imported inside a
fixture, so on the GPU machine (no JAX)

    python -m pytest --noconftest -m cuda tests/test_torch_lio_graph.py
"""

import dataclasses
import math
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from immesh_tpu_torch import interop
from immesh_tpu_torch.config import LioConfig as TLC
from immesh_tpu_torch.config import VoxelMapConfig as TVC
from immesh_tpu_torch.core import so3
from immesh_tpu_torch.core.ops import nan_where_failed
from immesh_tpu_torch.core.state import STATE_DIM
from immesh_tpu_torch.lio import esikf as tesikf
from immesh_tpu_torch.lio.association import associate
from immesh_tpu_torch.map.hash import EMPTY, voxel_coords

_VM = dict(voxel_size=1.0, capacity=2 ** 10, max_layers=3,
           touched_voxels_per_scan=128, max_points_per_voxel=60)
# (converge_rot_deg, converge_trans_m) → the reference's iteration count
_CONVERGE = {1: (1e6, 1e6), 2: (0.5, 0.005), 4: (0.0, 0.0)}


def _t(x):
    return torch.from_numpy(np.array(x))


def _tree(obj):
    if dataclasses.is_dataclass(obj):
        return {f.name: _tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if f.metadata.get("pytree_node", True)}
    return np.asarray(obj)


def _port(name, obj, vm_cfg=None):
    cfg = SimpleNamespace(voxel_map=vm_cfg)
    return interop.from_reference({name: _tree(obj)}, cfg, device="cpu")[name]


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


@pytest.fixture(scope="module")
def J():
    """The reference's modules (JAX on the CPU, as conftest sets it)."""
    import jax
    import jax.numpy as jnp
    from immesh_tpu.config import LioConfig, VoxelMapConfig
    from immesh_tpu.core.geometry import lidar_point_cov_body
    from immesh_tpu.core.state import EsikfState
    from immesh_tpu.lio import esikf
    from immesh_tpu.map.voxel_map import VoxelMap
    return SimpleNamespace(jax=jax, jnp=jnp, LC=LioConfig, VC=VoxelMapConfig,
                           pcov=lidar_point_cov_body, State=EsikfState,
                           esikf=esikf, VM=VoxelMap)


@pytest.fixture(scope="module")
def plane_map(J):
    """The reference map after two scans of the planes (jitted once)."""
    jvm = J.VM.create(J.VC(**_VM))
    update = J.jax.jit(lambda vm, p, s2, m: vm.update(p, s2, m))
    rng = np.random.default_rng(21)
    for _ in range(2):
        jvm = update(jvm, *map(J.jnp.asarray, _planes(rng)))
    return jvm


# ---------------------------------------------------------------------------
# the ESIKF
# ---------------------------------------------------------------------------
def _problem(J, rng):
    """A scan of the planes seen from a pose 5 cm and 0.6° off the prior's
    (identity): body-frame points, their covariances, the mask."""
    p, _, _ = _planes(rng, 900, blob=False)
    ang = np.deg2rad(0.6) * np.array([0.3, -0.5, 0.8])
    R = np.asarray(so3.exp(torch.tensor(ang, dtype=torch.float64)))
    t = np.array([0.04, -0.03, 0.01])
    body = ((p - t) @ R).astype(np.float32)  # world = R · body + t
    pcov = np.asarray(J.pcov(J.jnp.asarray(body), 0.02, 0.05))
    mask = rng.random(len(body)) < 0.97
    return body, pcov, mask


def _jax_update(J, prior, jvm, body, pcov, mask, lio, vm_cfg, monkeypatch):
    """The reference's lio_update run without jit, its iterations counted
    by its association calls."""
    calls = [0]
    inner = J.esikf.associate

    def counted(*args, **kw):
        calls[0] += 1
        return inner(*args, **kw)

    monkeypatch.setattr(J.esikf, "associate", counted)
    with J.jax.disable_jit():
        st, diag = J.esikf.lio_update(
            prior, jvm, *map(J.jnp.asarray, (body, pcov, mask)), lio, vm_cfg)
    return st, diag, calls[0]


def _early_exit_update(state_prop, assoc_fn, lio_cfg):
    """The port's ESIKF loop before the masking: a host test of convergence
    between iterations, as the reference's while_loop ends."""
    dtype, dev = state_prop.rot.dtype, state_prop.rot.device
    eye = torch.eye(STATE_DIM, dtype=dtype, device=dev)
    p_inv = nan_where_failed(*torch.linalg.inv_ex(state_prop.cov + eye * 1e-9))
    rot_thresh = torch.tensor(lio_cfg.converge_rot_deg * math.pi / 180.0,
                              dtype=dtype)
    trans_thresh = torch.tensor(lio_cfg.converge_trans_m, dtype=dtype)
    state, converged, A_last, it = state_prop, torch.tensor(False), p_inv, 0
    n_eff = torch.tensor(0)
    while it < lio_cfg.max_iterations and not bool(converged):
        assoc = assoc_fn(state)
        h6, z, r_inv = assoc["h6"], assoc["z"], assoc["r_inv"]
        hw = h6 * r_inv[:, None]
        A = p_inv.clone()
        A[0:6, 0:6] += hw.T @ h6
        b = p_inv @ state_prop.boxminus(state)
        b[0:6] += hw.T @ (-z)
        L = nan_where_failed(*torch.linalg.cholesky_ex(A + eye * 1e-9))
        delta = torch.cholesky_solve(b[:, None], L)[:, 0]
        state = state.boxplus(delta)
        converged = ((torch.linalg.norm(delta[0:3]) < rot_thresh)
                     & (torch.linalg.norm(delta[3:6]) < trans_thresh))
        n_eff = torch.sum(assoc["valid"].to(torch.int32))
        A_last, it = A, it + 1
    cov = nan_where_failed(*torch.linalg.inv_ex(A_last + eye * 1e-9))
    return state.replace(cov=0.5 * (cov + cov.T)), converged, n_eff, it


@pytest.mark.parametrize("iterations", sorted(_CONVERGE))
def test_masked_esikf_matches_the_reference_loop(J, plane_map, monkeypatch,
                                                 iterations):
    rot_deg, trans_m = _CONVERGE[iterations]
    jlio = J.LC(max_iterations=4, converge_rot_deg=rot_deg,
                converge_trans_m=trans_m)
    tlio = TLC(max_iterations=4, converge_rot_deg=rot_deg,
               converge_trans_m=trans_m)
    jvc, tvc = J.VC(**_VM), TVC(**_VM)
    body, pcov, mask = _problem(J, np.random.default_rng(22))
    prior = J.State.identity()
    js, jdiag, j_it = _jax_update(J, prior, plane_map, body, pcov, mask,
                                  jlio, jvc, monkeypatch)
    assert j_it == iterations  # the case is what it says

    tvm, tprior = _port("vm", plane_map, tvc), _port("state", prior)
    args = (_t(body), _t(pcov), _t(mask))
    ts, tdiag = tesikf.lio_update(tprior, tvm, *args, tlio, tvc)
    assert int(tdiag["iterations"]) == j_it
    assert bool(tdiag["converged"]) == bool(jdiag["converged"])
    assert int(tdiag["n_effective"]) > 500
    assert abs(int(tdiag["n_effective"]) - int(jdiag["n_effective"])) <= 2
    np.testing.assert_allclose(np.asarray(js.pos), ts.pos.numpy(), atol=1e-4)
    dR = so3.log(_t(np.asarray(js.rot)).T @ ts.rot)
    assert float(dR.norm()) < 1e-5
    jc = np.asarray(js.cov)
    np.testing.assert_allclose(jc, ts.cov.numpy(), rtol=0,
                               atol=1e-3 * np.abs(jc).max())

    # bit for bit the host loop and the masked form (every body runs, the
    # dead ones masked): the skipped bodies change nothing
    es, conv, n_eff, it = _early_exit_update(
        tprior, lambda st: associate(st, tvm, *args, tvc), tlio)
    assert it == iterations and bool(conv) == bool(tdiag["converged"])
    assert int(n_eff) == int(tdiag["n_effective"])
    ms, mdiag = tesikf.iterated_update(
        tprior, lambda st: associate(st, tvm, *args, tvc), tlio,
        reduce=lambda sums: sums)
    for f in dataclasses.fields(es):
        assert torch.equal(getattr(es, f.name), getattr(ts, f.name)), f.name
        assert torch.equal(getattr(ms, f.name), getattr(ts, f.name)), f.name
    assert all(torch.equal(mdiag[k], tdiag[k]) for k in tdiag)


# ---------------------------------------------------------------------------
# the refinement levels and the compaction
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("blob", [False, True], ids=["skipped", "taken"])
def test_update_runs_every_level_as_the_reference(J, plane_map, blob):
    """The ground away from the blob and the wall (x < 0, y < 1.5) touches
    no subdivided voxel and spills none, so the reference skips refinement
    levels 1 and 2 under its lax.cond; the whole scene with the blob takes
    them."""
    p, s2, m = _planes(np.random.default_rng(23), blob=blob)
    if not blob:
        keep = (p[:, 0] < 0) & (p[:, 1] < 1.5) & (np.abs(p[:, 2]) < 0.1)
        p, s2, m = p[keep], s2[keep], m[keep]
    tvm = _port("vm", plane_map, TVC(**_VM))
    every = tvm.clone()
    jvm = J.jax.jit(lambda vm, *a: vm.update(*a))(plane_map, *map(
        J.jnp.asarray, (p, s2, m)))
    levels = int(tvm.update_levels(_t(p), _t(s2), _t(m)))
    assert (levels > 0) == blob
    _check_vm(jvm, tvm)

    # the same update with every level run, an empty one an exact no-op:
    # the masked form the captured step ran before its IF nodes
    every._update_level(_t(p), _t(s2), _t(m), 0,
                        _VM["touched_voxels_per_scan"])
    lm = _t(m)
    for lvl in range(1, _VM["max_layers"]):
        parent = every.table.lookup(voxel_coords(_t(p), 1.0, lvl - 1))
        lm = lm & (parent >= 0) & every.subdivided[parent.clamp(min=0).long()]
        every._update_level(_t(p), _t(s2), lm, lvl,
                            _VM["touched_voxels_per_scan"])
    for (n, a), b in zip([("keys", tvm.table.keys), ("fp", tvm.table.fp)]
                         + [(n, getattr(tvm, n)) for n in tvm._FIELDS],
                         [every.table.keys, every.table.fp]
                         + [getattr(every, n) for n in every._FIELDS]):
        assert torch.equal(a, b), n


def test_compact_in_place_matches_the_reference(J, plane_map):
    tvm = _port("vm", plane_map, TVC(**_VM))
    tensors = [tvm.table.keys, tvm.table.fp] + [getattr(tvm, n)
                                                for n in tvm._FIELDS]
    ptrs = [t.data_ptr() for t in tensors]
    live = int((tvm.table.keys[:, 0] != EMPTY).sum())
    center = np.array([1.0, -0.5, 0.0], np.float32)
    jvm = plane_map.compact(J.jnp.asarray(center), 2.5)
    tvm.compact(_t(center), 2.5)
    assert 0 < int(tvm.n_voxels()) < live
    _check_vm(jvm, tvm)
    assert [t.data_ptr() for t in [tvm.table.keys, tvm.table.fp] + [
        getattr(tvm, n) for n in tvm._FIELDS]] == ptrs


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_captured_step_equals_the_eager_step_on_the_card():
    """The KITTI-shaped LIO on the card, eager and captured from the same
    start: state, world scan, diag and every plane-map tensor bit for bit
    on every frame, a compaction included.  The hash, scatter and
    segmented-sum kernels' device counters see the eager launches, every
    replay of the kernels recorded into the graph outside its IF nodes,
    and every run of a body (the set kernel's taken counts) times the
    kernels recorded into it; the graph holds those kernels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    import chip_smoke
    from immesh_tpu_torch.kernels import graph_cond as gc
    from immesh_tpu_torch.kernels import hash_probe as hp
    from immesh_tpu_torch.kernels import scatter_drop as sd
    from immesh_tpu_torch.kernels import segment_sum as ss
    from immesh_tpu_torch.lio.pipeline import LioPipeline
    dev = torch.device("cuda")
    cfg = chip_smoke.small_config()
    sim = chip_smoke.make_sim(cfg.preprocess.max_points, 16)
    pipes = [LioPipeline(cfg, device=dev, graph=g) for g in (False, True)]
    hp.reset_launches()
    sd.reset_launches()
    ss.reset_launches()
    gc.reset_launches()
    for k in range(8):
        b = chip_smoke.bundle(sim.frame(k), cfg, dev)
        outs = [p.step(b) for p in pipes]
        if k == 4:
            for p in pipes:
                chip_smoke.compact_half(p.vm, p.state.pos)
        (we, de), (wc, dc) = outs
        extra = [("world", we, wc)] + [(n, de[n], dc[n]) for n in de]
        assert chip_smoke.lio_differs(pipes[0].state, pipes[1].state,
                                      pipes[0].vm, pipes[1].vm, extra) == []
    assert pipes[1].captured.replays == 7
    (g,) = pipes[1].captured.graphs
    launches = {**hp.launches, "scatter_drop": sd.launches,
                "segment_sum": ss.launches}
    runs = {**hp.runs(), "scatter_drop": sd.runs(), "segment_sum": ss.runs()}
    # the graph's counts cover every counted kernel imported so far; the
    # LIO runs no pairs_argmin, and its lookups are the planes and parent
    # forms (no coords-form lookup, no neighbourhood)
    captured = {k: n + sum(b.captured.get(k, 0) for b in g.bodies)
                for k, n in g.captured.items()}
    assert captured.pop("pairs_argmin", 0) == 0
    # IF nodes: two an ESIKF body after the first (one set launch sets
    # both), one a refinement level
    assert len(g.bodies) == (2 * (cfg.lio.max_iterations - 1)
                             + cfg.voxel_map.max_layers - 1)
    assert captured.pop("graph_cond") == (cfg.lio.max_iterations - 1
                                          + cfg.voxel_map.max_layers - 1)
    assert captured == {**hp.captured, "scatter_drop": sd.captured,
                        "segment_sum": ss.captured}
    assert captured.pop("hash_lookup") == 0
    assert captured.pop("hash_lookup_neighbors") == 0
    assert all(n > 0 for n in captured.values())
    taken = gc.taken([b.slot for b in g.bodies])
    assert runs == {k: launches[k] + 7 * g.captured[k] + sum(
        t * b.captured[k] for t, b in zip(taken, g.bodies)) for k in runs}
    assert g.nodes()["kernel"] > sum(captured.values())
