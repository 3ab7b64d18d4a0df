"""The mesh step in the form its captured CUDA graph runs, and the host
polls as the reference's asynchronous copies, against the JAX reference.

One run drives both: the reference's JointPipeline and the port's (on the
CPU) side by side on a KITTI-shaped sequence of the outdoor simulator cut
to 2,048 rays and 6 frames, chunks of 16 voxels, a 64-voxel budget (128
in the hi variant) and capacities that both high-water marks cross (a
128-slot plane map of one level, a 2,048-point mesh map).  The reference's mesh state
before each frame, its world scan and work list, and the inputs and
outputs of its mesh compactions are recorded; the port starts from them
through interop.from_reference, so each comparison is one step without
accumulated drift.  The reference's joint program is compiled once: its
hi-budget variant computes the same bits (reference behaviour 7), so the
run passes it the base config and logs the budget it was asked for.

  (a) The chunk loop (each chunk under utils/graphs.py::device_if, an IF
      node in the captured graph, a host `if` here) equals the masked loop
      that runs every chunk bit for bit, and the reference's lax.cond loop
      within tests/test_torch_lio_mesh.py's tolerances: point ids, slots,
      work list, counters and triangles EXACT, smoothed positions 1e-5 m.
      Frame 0 leaves chunks empty; an empty chunk's body gives exactly the
      empty result.
  (b) append_frame's per-voxel counts (a scatter-add of ones where it had
      torch.bincount) equal the reference's, exactly, on every frame.
  (c) GlobalPointMap.compact + remap_store, which copy back into the same
      tensors, equal the reference's compaction on every compaction the
      run makes, with every data_ptr of the map and the store unchanged.
  (d) An append cut (MeshConfig.ablate "app_active0") puts the map back in
      place: the map's bits as before the frame, frame_no + 1, pointers
      unchanged.
  (e) With the polls copied to the host asynchronously (device.HostCopy),
      the port's plane-map and mesh compactions fall on the same frames as
      the reference's, which runs both its budgets; the port, which
      computes no hi-budget config, gives the reference's result on its
      hi frames.
  (f) The mesh step reads no device value on the host but its chunks'
      tests (device_if's host read, which the captured step makes an IF
      node's set kernel): Tensor.__bool__, __int__, __float__, __index__,
      item, tolist and nonzero raise while it runs (outside the kernels'
      plain versions, which stand for a kernel launch on the CPU, and that
      read, one a chunk); with that read trapped too it trips the trap.
  (g) On the card (`cuda`, skips here): the captured JointPipeline (its
      LIO graph, then its mesh graph on the mesh half's own stream)
      against the eager one bit for bit, one mesh graph, and
      pairs_argmin's device runs = its eager launches + the runs of the
      chunk bodies (the set kernel's taken counts) x their recorded
      launches.  The reference is imported inside a fixture, so on the
      GPU machine (no JAX)

    python -m pytest --noconftest -m cuda tests/test_torch_mesh_graph.py
"""

import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from immesh_tpu_torch import interop
from immesh_tpu_torch.config import ImMeshConfig as TConfig
from immesh_tpu_torch.mesh import triangles as ttri
from immesh_tpu_torch.mesh.pipeline import _compact_mesh, mesh_step
from immesh_tpu_torch.utils.graphs import tensors

N_RAYS, N_FRAMES = 2048, 6
CHUNK, BUDGET, HI_BUDGET, THRESHOLD = 16, 64, 128, 60


def _config(presets):
    base = presets["kitti"]()
    return base.replace(
        preprocess=base.preprocess.__class__(
            lidar_type=100, blind=0.05, max_points=N_RAYS),
        voxel_map=dataclasses.replace(
            base.voxel_map, capacity=128, touched_voxels_per_scan=256,
            max_layers=1),
        lio=dataclasses.replace(base.lio, map_update_points=1024),
        mesh=base.mesh.__class__(
            pts_minimum_scale=0.15, voxel_resolution=0.6,
            points_capacity=2048, voxel_capacity=2 ** 10,
            compact_check_every=8, local_map_radius=40.0,
            active_voxels_per_frame=BUDGET, file_voxels_per_frame=512,
            max_pts_per_frame=1000, mesh_chunk=CHUNK))


def _tree(obj):
    """A reference pytree as nested dicts of numpy copies (data fields)."""
    if dataclasses.is_dataclass(obj):
        return {f.name: _tree(getattr(obj, f.name))
                for f in dataclasses.fields(obj)
                if f.metadata.get("pytree_node", True)}
    return np.array(obj)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    """Eager CPU ops on these small tensors gain nothing from threads, and
    the test workers share the host's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def run():
    import immesh_tpu.mesh.pipeline as jmesh
    import immesh_tpu.runtime.joint as jjoint
    import immesh_tpu_torch.runtime.joint as tjoint
    from immesh_tpu.config import PRESETS
    from immesh_tpu.frontend.sim import (
        ForwardTrajectory, LidarImuSimulator, outdoor_scene)
    from immesh_tpu.frontend.types import ScanBundle as JBundle
    from immesh_tpu_torch.frontend.types import ScanBundle as TBundle

    cfg = _config(PRESETS)
    tcfg = TConfig.from_dict(cfg.to_dict())
    sim = LidarImuSimulator(scene=outdoor_scene(length=400.0),
                            traj=ForwardTrajectory(speed=9.0), n_rays=N_RAYS,
                            rings=16, max_range=120.0, seed=0)
    jp = jjoint.JointPipeline(cfg, adaptive_mesh_budget=HI_BUDGET,
                              adaptive_threshold=THRESHOLD)
    tp = tjoint.JointPipeline(tcfg, adaptive_mesh_budget=HI_BUDGET,
                              adaptive_threshold=THRESHOLD, device="cpu")
    budgets = []  # the budget the reference's joint program was asked for
    compactions = []  # (inputs, outputs) of the reference's mesh compactions

    def recorder(module, name, log, base=None):
        """module.<name>, whose last argument is the frame's config, with
        the budget of each call logged; with `base`, the reference's joint
        program runs with the base config, so it is compiled once: its
        hi-budget variant computes the same bits (reference behaviour 7,
        the budget reaches the mesh step only through gm.cfg)."""
        inner = getattr(module, name)

        def recorded(*args):
            log.append(args[-1].mesh.active_voxels_per_frame)
            if base is not None:
                args = args[:-1] + (base,)
            return inner(*args)
        return recorded

    compact = jmesh._compact_mesh_jit

    def recorded_compact(gm, store, center, radius):
        inputs = (_tree(gm), _tree(store), np.array(center), np.array(radius))
        out = compact(gm, store, center, radius)
        compactions.append((inputs, (_tree(out[0]), _tree(out[1]))))
        return out

    mp = pytest.MonkeyPatch()
    mp.setattr(jjoint, "joint_step",
               recorder(jjoint, "joint_step", budgets, base=cfg))
    mp.setattr(jmesh, "_compact_mesh_jit", recorded_compact)
    frames = []
    try:
        for k in range(N_FRAMES):
            f = sim.frame(k)
            args = (f.pts, f.t_rel, f.imu_stamps, f.imu_acc, f.imu_gyr,
                    f.scan_duration, N_RAYS, cfg.imu.max_imu_per_scan)
            before = {"gm": _tree(jp.mesh.gm), "store": _tree(jp.store)}
            n_comp = jp.mesh.n_compactions
            jb = JBundle.from_numpy(*args)
            jw, jd = jp.step(jb)
            tp.step(TBundle.from_numpy(*args, device="cpu"))
            frames.append(dict(
                before=before, world=np.array(jw), mask=np.array(jb.mask),
                pos=np.array(jp.state.pos),
                slots=np.array(jp.mesh.last_active[0]),
                smask=np.array(jp.mesh.last_active[1]),
                diag={k: int(v) for k, v in jd.items()
                      if k.startswith(("drop_", "tris_", "n_active"))},
                # the state after the step, where no mesh compaction followed
                after=(None if jp.mesh.n_compactions > n_comp else
                       {"gm": _tree(jp.mesh.gm), "store": _tree(jp.store)}),
                comp=((jp.lio.n_compactions, jp.mesh.n_compactions),
                      (tp.lio.n_compactions, tp.mesh.n_compactions))))
    finally:
        mp.undo()
    return SimpleNamespace(cfg=cfg, tcfg=tcfg, frames=frames,
                           budgets=budgets, compactions=compactions)


def _port(run, tree):
    return interop.from_reference(tree, run.tcfg, device="cpu")


def _same_bits(a, b) -> bool:
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return a.dtype == b.dtype and torch.equal(a, b)


def _check_mesh(jt, gm, store):
    """The port's map and store against the reference's (numpy trees):
    EXACT but for the smoothed positions (1e-5 m)."""
    tt, ts = interop.to_numpy(gm), interop.to_numpy(store)
    for name in ("pts", "pt_count", "vox_pt_idx", "vox_pts", "vox_n",
                 "vox_new", "vox_meshed", "frame_no"):
        np.testing.assert_array_equal(jt["gm"][name], tt[name], name)
    for table in ("dedup", "vox"):
        for f in ("keys", "fp"):
            np.testing.assert_array_equal(jt["gm"][table][f], tt[table][f])
    for name in ("pts_smooth", "vox_pts_sm"):
        np.testing.assert_allclose(jt["gm"][name], tt[name], atol=1e-5)
    for name in ("tri_ids", "tri_n", "dirty"):
        np.testing.assert_array_equal(jt["store"][name], ts[name], name)


# ---------------------------------------------------------------------------
# (a) the masked chunk loop
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("k", [0, 1])
def test_masked_chunk_loop_equals_the_skipping_loop_and_the_reference(
        run, k, monkeypatch):
    f = run.frames[k]
    outs = {}
    for skip in (True, False):
        if not skip:  # the masked loop: every chunk's body runs
            monkeypatch.setattr(ttri, "device_if",
                                lambda pred, body, what="": body())
        o = _port(run, f["before"])
        _, _, n, slots, smask, diag = mesh_step(
            o["gm"], o["store"], _t(f["world"]), _t(f["mask"]),
            _t(f["pos"]), CHUNK)
        outs[skip] = (o, n, slots, smask, diag)
    (om, n, slots, smask, diag), (os_, *rest) = outs[True], outs[False]
    for a, b in zip(tensors((om, n, slots, smask, diag)),
                    tensors((os_, *rest))):
        assert _same_bits(a, b)
    # the reference (its lax.cond loop inside the joint program)
    _check_mesh(f["after"], om["gm"], om["store"])
    np.testing.assert_array_equal(f["slots"], slots.numpy())
    np.testing.assert_array_equal(f["smask"], smask.numpy())
    assert {**{k: int(v) for k, v in diag.items()},
            "n_active_voxels": int(n)} == f["diag"]
    assert int(om["store"].n_triangles()) > 0

    # the chunk bodies on the map after the step: a chunk with no active
    # point gives exactly the empty result
    gm, cfg = om["gm"], run.tcfg.mesh
    pull = gm.pull_neighborhood(slots, smask)
    key = gm.vox.keys[slots.clamp(min=0).long(), :3]
    empty = 0
    for c0 in range(0, BUDGET, CHUNK):
        sl = slice(c0, c0 + CHUNK)
        if bool(pull["mask"][sl].any()):
            continue
        empty += 1
        got = ttri._chunk_impl(pull["pts"][sl], pull["pts_sm"][sl],
                               pull["mask"][sl], pull["idx"][sl], key[sl],
                               _t(f["pos"]), cfg)
        for a, b in zip(got, ttri._empty(CHUNK, cfg.tris_per_voxel, "cpu")):
            assert _same_bits(a, b)
    assert empty == (2 if k == 0 else 0)  # frame 0: 23 active voxels of 64


# ---------------------------------------------------------------------------
# (b) append_frame's counts
# ---------------------------------------------------------------------------
def test_append_counts_match_the_reference(run):
    checked = 0
    for f in run.frames:
        if f["after"] is None:
            continue
        o = _port(run, f["before"])
        gm, slots, smask, _ = o["gm"].append_frame(_t(f["world"]),
                                                   _t(f["mask"]))
        jg = f["after"]["gm"]
        np.testing.assert_array_equal(jg["vox_n"], gm.vox_n.numpy())
        np.testing.assert_array_equal(jg["vox_pt_idx"], gm.vox_pt_idx.numpy())
        assert int(gm.pt_count) == int(jg["pt_count"])
        # the step's mark_meshed then zeroes the re-meshed voxels' counts
        new = gm.vox_new.clone()
        new[slots[smask].long()] = 0
        np.testing.assert_array_equal(jg["vox_new"], new.numpy())
        checked += 1
    assert checked >= 3


# ---------------------------------------------------------------------------
# (c) compaction in place
# ---------------------------------------------------------------------------
def test_compaction_in_place_matches_the_reference(run):
    assert len(run.compactions) >= 2
    for (jgm, jst, center, radius), (ogm, ost) in run.compactions:
        o = _port(run, {"gm": jgm, "store": jst})
        ptrs = [t.data_ptr() for t in tensors((o["gm"], o["store"]))]
        _compact_mesh(o["gm"], o["store"], _t(center), _t(radius))
        assert [t.data_ptr() for t in tensors((o["gm"], o["store"]))] == ptrs
        assert 0 < int(o["gm"].pt_count) < int(jgm["pt_count"])
        tt, ts = interop.to_numpy(o["gm"]), interop.to_numpy(o["store"])
        for name in ("pts", "pts_smooth", "pt_count", "vox_pt_idx",
                     "vox_pts", "vox_pts_sm", "vox_n", "vox_new",
                     "vox_meshed"):
            np.testing.assert_array_equal(ogm[name], tt[name], name)
        for table in ("dedup", "vox"):
            for f in ("keys", "fp"):
                np.testing.assert_array_equal(ogm[table][f], tt[table][f])
        for name in ("tri_ids", "tri_n", "dirty"):
            np.testing.assert_array_equal(ost[name], ts[name], name)


# ---------------------------------------------------------------------------
# (d) an append cut in place
# ---------------------------------------------------------------------------
def test_append_cut_restores_the_map_in_place(run):
    f = run.frames[3]
    gm = _port(run, f["before"])["gm"]
    gm.cfg = dataclasses.replace(gm.cfg, ablate="app_active0")
    before = gm.clone()
    ptrs = [t.data_ptr() for t in tensors(gm)]
    _, slots, smask, drops = gm.append_frame(_t(f["world"]), _t(f["mask"]))
    assert [t.data_ptr() for t in tensors(gm)] == ptrs
    assert int(gm.frame_no) == int(before.frame_no) + 1
    gm.frame_no.sub_(1)
    for a, b in zip(tensors(gm), tensors(before)):
        assert _same_bits(a, b)
    assert not bool(smask.any()) and int(slots.abs().sum()) == 0
    assert all(int(v) == 0 for v in drops.values())


# ---------------------------------------------------------------------------
# (e) the decision frames
# ---------------------------------------------------------------------------
def test_polls_decide_on_the_reference_frames(run):
    for f in run.frames:
        assert f["comp"][0] == f["comp"][1]
    lio, mesh = run.frames[-1]["comp"][1]
    assert lio >= 2 and mesh >= 2           # both high-water marks crossed
    assert len(run.budgets) == N_FRAMES
    assert set(run.budgets) == {BUDGET, HI_BUDGET}  # the reference ran both


def test_one_mesh_step_serves_both_budgets(run):
    """The hi-budget config never reaches the mesh step (reference
    behaviour 7), so the port computes none: a port MeshPipeline stepped
    from the reference's start of each hi frame that no compaction
    followed gives the reference's recorded map, store, work list, active
    count and drop counters (as (a) holds them: exact but for the smoothed
    positions)."""
    from immesh_tpu_torch.mesh.pipeline import MeshPipeline
    hi = [f for f, budget in zip(run.frames, run.budgets)
          if budget == HI_BUDGET and f["after"] is not None]
    assert hi
    for f in hi:
        mp = MeshPipeline(run.tcfg, device="cpu")
        o = _port(run, f["before"])
        mp.gm, mp.store = o["gm"], o["store"]
        n_active, drops = mp.step(_t(f["world"]), _t(f["mask"]),
                                  _t(f["pos"]))
        _check_mesh(f["after"], mp.gm, mp.store)
        np.testing.assert_array_equal(f["slots"], mp.last_active[0].numpy())
        np.testing.assert_array_equal(f["smask"], mp.last_active[1].numpy())
        assert {**{k: int(v) for k, v in drops.items()},
                "n_active_voxels": int(n_active)} == f["diag"]
        assert mp.n_compactions == 0


# ---------------------------------------------------------------------------
# (f) no host read
# ---------------------------------------------------------------------------
_READS = ("__bool__", "__int__", "__float__", "__index__", "item", "tolist",
          "nonzero")


@pytest.fixture
def host_reads(monkeypatch):
    """Trap the tensor methods that read a device value on the host while
    `trap.on`; the kernels' plain versions (a kernel launch on the card)
    run with the trap off."""
    from immesh_tpu_torch.kernels import hash_probe, pairs_argmin, scatter_drop
    trap = SimpleNamespace(on=False)

    def trapped(name, inner):
        def f(*args, **kwargs):
            if trap.on:
                raise AssertionError(f"host read: Tensor.{name}")
            return inner(*args, **kwargs)
        return f

    def untrapped(inner):
        def f(*args, **kwargs):
            on, trap.on = trap.on, False
            try:
                return inner(*args, **kwargs)
            finally:
                trap.on = on
        return f

    for name in _READS:
        monkeypatch.setattr(torch.Tensor, name,
                            trapped(name, getattr(torch.Tensor, name)))
    monkeypatch.setattr(torch, "nonzero", trapped("nonzero", torch.nonzero))
    for mod, name in ((hash_probe, "lookup_plain"),
                      (hash_probe, "insert_plain"),
                      (scatter_drop, "set_plain"), (scatter_drop, "add_plain"),
                      (scatter_drop, "set_group_plain"),
                      (scatter_drop, "add_group_plain"),
                      (pairs_argmin, "pairs_argmin_plain")):
        monkeypatch.setattr(mod, name, untrapped(getattr(mod, name)))
    return trap


def test_masked_mesh_step_reads_nothing_on_the_host(run, host_reads,
                                                    monkeypatch):
    from immesh_tpu_torch.kernels import graph_cond
    f = run.frames[0]
    args = (_t(f["world"]), _t(f["mask"]), _t(f["pos"]), CHUNK)
    read = graph_cond.taken_plain
    reads = []

    def counted(pred):
        on, host_reads.on = host_reads.on, False
        try:
            reads.append(read(pred))
        finally:
            host_reads.on = on
        return reads[-1]

    monkeypatch.setattr(graph_cond, "taken_plain", counted)
    o = _port(run, f["before"])
    host_reads.on = True
    try:
        out = mesh_step(o["gm"], o["store"], *args)
    finally:
        host_reads.on = False
    assert int(out[2]) == f["diag"]["n_active_voxels"]
    # one read a chunk: frame 0's 23 active voxels fill two of four
    assert reads == [True, True, False, False]
    monkeypatch.setattr(graph_cond, "taken_plain", read)
    o = _port(run, f["before"])
    host_reads.on = True
    try:
        with pytest.raises(AssertionError, match="Tensor.__bool__"):
            mesh_step(o["gm"], o["store"], *args)
    finally:
        host_reads.on = False


# ---------------------------------------------------------------------------
# (g) on the card
# ---------------------------------------------------------------------------
@pytest.mark.cuda
def test_captured_mesh_step_equals_the_eager_step_on_the_card():
    """The KITTI-shaped JointPipeline on the card, eager (graph=False) and
    captured from the same start, bit for bit on every frame (map, store,
    work list, diag), a forced compaction of both maps included; one mesh
    graph; and pairs_argmin's device runs =
    its eager launches + the graph's replays x its recorded launches."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    import chip_smoke
    from immesh_tpu_torch.kernels import graph_cond as gc
    from immesh_tpu_torch.kernels import pairs_argmin as pk
    from immesh_tpu_torch.runtime.joint import JointPipeline
    dev = torch.device("cuda")
    cfg = chip_smoke.small_config()
    sim = chip_smoke.make_sim(cfg.preprocess.max_points, 16)
    pipes = [JointPipeline(cfg, adaptive_mesh_budget=256, device=dev,
                           graph=g) for g in (False, True)]
    pk.reset_launches()
    gc.reset_launches()
    n = 8
    for k in range(n):
        b = chip_smoke.bundle(sim.frame(k), cfg, dev)
        outs = [p.step(b) for p in pipes]
        if k == 4:
            for p in pipes:
                chip_smoke.compact_half(p.lio.vm, p.state.pos)
                chip_smoke.compact_mesh_half(p.mesh, p.state.pos)
        (we, de), (wc, dc) = outs
        e, c = pipes
        assert chip_smoke.mesh_differs(e.mesh, c.mesh, [
            ("world", we, wc), *[(x, de[x], dc[x]) for x in de],
            *zip(("slots", "smask"), e.mesh.last_active,
                 c.mesh.last_active)]) == []
    torch.cuda.synchronize()
    assert pipes[1].mesh.stream is not None  # the mesh half's own stream
    (g,) = pipes[1].mesh.captured.graphs
    assert g.replays == n - 1 and g.captured["pairs_argmin"] == 0
    chunks = [b for b in g.bodies if b.what == "chunk"]
    assert len(chunks) == 2  # 128 voxels, 64 a chunk
    assert pk.captured == sum(b.captured["pairs_argmin"] for b in chunks)
    taken = gc.taken([b.slot for b in g.bodies])
    assert pk.runs() == pk.launches + sum(
        t * b.captured["pairs_argmin"] for t, b in zip(taken, g.bodies))
    assert g.nodes()["kernel"] > sum(g.captured.values())
