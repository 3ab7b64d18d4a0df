"""Port parity, multi-rank LIO and window BA: immesh_tpu_torch/dist/comm.py,
dist/lio.py and the group-reduced half of dist/window_ba.py, run as two
gloo ranks (spawned processes, FileStore rendezvous) and held against the
JAX dist/ steps on a 2-device CPU mesh.

One world of 2 ranks is spawned for the module (tests/torch_dist_worker.py
runs every scenario in it).  Tolerances, with their reasons:
  * comm: the gathered sum is bit-identical on every rank and equals the
    rank-order sum; gathers and ring exchanges exact;
  * window BA at world 2: 1e-4 on pos, rot and d against JAX's
    make_dist_window_ba and against the port's single-device solve (the
    bound of tests/test_window_ba.py:168 for the JAX dist solver);
  * dp LIO (PRESETS["sim"], 2,048 rays, 5 frames after static_init):
    replicated state and map bit-identical on both ranks; pose within
    1e-4 m of JAX's dp step at world 2 over the 5 chained frames (the
    per-step bound of test_torch_lio_mesh.py; measured ≤ 1e-5 m: the 6×6
    sums are taken in another order than XLA's psum), covariance rtol 1e-3
    of its largest entry; both within 0.05 m of the single-device pipeline
    (tests/test_dist.py:73).  The 2,048 rays all fall in rank 0's rows of
    the 8,192-row bundle (as on the JAX mesh), so a second case fills both
    ranks (8,192 rays) at map_update_points 2,048: each rank's downsample
    then truncates at 1,024 cells, the regime of the KITTI operating point
    on the card (chip_smoke phase 13a).  There the pose is held to JAX's dp
    step at 1e-3 m, the bound tests/test_torch_runtime.py puts on chained
    IMU-on frames (measured ≤ 8.6e-5 m), the covariance at rtol 1e-2 of its
    largest entry (measured 1.5e-3, on frame 1: the IMU-on sequence's first
    frames are ill-posed, ROADMAP queue 3 item 10);
  * _merge_aggregates: EXACT against JAX's on the same gathered rows."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

import torch_dist_worker as worker
from immesh_tpu.config import PRESETS as JPRESETS
from immesh_tpu.core.state import EsikfState as JState
from immesh_tpu.dist import lio as jdlio
from immesh_tpu.dist.window_ba import WindowProblem as JProblem
from immesh_tpu.dist.window_ba import make_dist_window_ba as j_dist_ba
from immesh_tpu.frontend.sim import LidarImuSimulator as JSim
from immesh_tpu.frontend.types import ScanBundle as JBundle
from immesh_tpu.lio import imu as jimu
from immesh_tpu.map.voxel_map import VoxelMap as JVoxelMap
from immesh_tpu_torch.config import PRESETS
from immesh_tpu_torch.dist import lio as tdlio
from immesh_tpu_torch.dist import window_ba as tba
from immesh_tpu_torch.dist.multihost import run_world
from immesh_tpu_torch.frontend.types import ScanBundle as TBundle
from immesh_tpu_torch.lio.pipeline import LioPipeline as TLio
from test_window_ba import _make_problem

WORLD = 2
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


def _problem_np():
    prob, _, _ = _make_problem(np.random.default_rng(0))
    return {k: np.array(v) for k, v in prob._asdict().items()}


# (rays, map_update_points or None for the preset's): the dp LIO cases
DP_CASES = {"preset": (N_RAYS, None), "truncating": (8192, 2048)}


@pytest.fixture(scope="module")
def ranks():
    jobs = [("comm_ops", {}), ("window_ba", {"prob": _problem_np()})]
    jobs += [("dp_lio", {"n_rays": n, "seed": SEED, "frames": FRAMES,
                         "update_points": up})
             for n, up in DP_CASES.values()]
    names = ["comm_ops", "window_ba"] + [f"dp_{c}" for c in DP_CASES]
    return [dict(zip(names, out))
            for out in run_world(worker.run_all, WORLD, (jobs,))]


# ---------------------------------------------------------------------------
def test_psum_is_the_rank_order_sum_on_every_rank(ranks):
    a, b = (r["comm_ops"] for r in ranks)
    for key in ("x", "i", "b"):
        np.testing.assert_array_equal(a[key], b[key])
    blocks = []
    for rank in range(WORLD):
        rng = np.random.default_rng(100 + rank)
        blocks.append((rng.standard_normal(1000).astype(np.float32) * 1e3,
                       rng.integers(-1000, 1000, 7).astype(np.int32)))
    np.testing.assert_array_equal(a["x"], blocks[0][0] + blocks[1][0])
    np.testing.assert_array_equal(a["i"], blocks[0][1] + blocks[1][1])
    np.testing.assert_array_equal(a["b"], blocks[0][0][:5] + blocks[1][0][:5])


def test_gathers_and_ring_exchange(ranks):
    for rank, r in enumerate(ranks):
        c = r["comm_ops"]
        np.testing.assert_array_equal(c["gather"], [[0, 0], [1, 2]])
        np.testing.assert_array_equal(c["flags"], [[True, True],
                                                   [False, True]])
        peer = (rank - 1) % WORLD
        np.testing.assert_array_equal(c["right_f"], np.full(3, float(peer)))
        np.testing.assert_array_equal(c["right_b"], [peer, peer % 2 == 1])
        np.testing.assert_array_equal(c["left"], np.full(2, (rank + 1) % WORLD))


# ---------------------------------------------------------------------------
def test_window_ba_world2_matches_jax_and_single_device(ranks):
    prob = _problem_np()
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))
    jout = j_dist_ba(mesh, iterations=6)(
        JProblem(**{k: jnp.asarray(v) for k, v in prob.items()}))
    single = tba.solve_window(
        tba.WindowProblem(**{k: torch.from_numpy(v) for k, v in prob.items()}),
        iterations=6)
    a, b = (r["window_ba"] for r in ranks)
    for key in ("rot", "pos", "normal", "d", "cost"):
        np.testing.assert_array_equal(a[key], b[key])
    for key in ("pos", "rot", "d"):
        np.testing.assert_allclose(a[key], np.asarray(jout[key]), atol=1e-4)
        np.testing.assert_allclose(a[key], single[key].numpy(), atol=1e-4)


# ---------------------------------------------------------------------------
def _jax_dp(n_rays, update_points):
    """JAX make_dp_lio_step on a 2-device mesh, the same frames."""
    cfg = JPRESETS["sim"]()
    if update_points is not None:
        cfg = cfg.replace(lio=dataclasses.replace(
            cfg.lio, map_update_points=update_points))
    sim = JSim(n_rays=n_rays, seed=SEED)
    acc, gyr = sim.static_imu(100)
    mesh = Mesh(np.array(jax.devices()[:WORLD]), ("dp",))
    step, shard = jdlio.make_dp_lio_step(mesh, cfg)
    state = jimu.static_init(jnp.asarray(acc), jnp.asarray(gyr), cfg.imu,
                             JState.identity())
    vm = JVoxelMap.create(cfg.voxel_map)
    pos, cov = [], []
    for k in range(FRAMES):
        f = sim.frame(k)
        b = JBundle.from_numpy(f.pts, f.t_rel, f.imu_stamps, f.imu_acc,
                               f.imu_gyr, f.scan_duration,
                               cfg.preprocess.max_points,
                               cfg.imu.max_imu_per_scan)
        state, vm, world, diag = step(state, vm, shard(b))
        pos.append(np.asarray(state.pos))
        cov.append(np.asarray(state.cov))
    return {"pos": np.stack(pos), "cov": np.stack(cov),
            "n_voxels": int(vm.n_voxels())}


@pytest.mark.parametrize("case", list(DP_CASES))
def test_dp_lio_replicas_bit_identical(ranks, case):
    a, b = (r[f"dp_{case}"] for r in ranks)
    for key in ("pos", "rot", "cov", "n_eff", "vm"):
        np.testing.assert_array_equal(a[key], b[key], key)
    # each rank returns its own rows of the world scan
    assert a["world"].shape == (PRESETS["sim"]().preprocess.max_points
                                // WORLD, 3)
    assert not np.array_equal(a["world"], b["world"])


def test_dp_lio_truncating_matches_jax_dp(ranks):
    dp = ranks[0]["dp_truncating"]
    jdp = _jax_dp(*DP_CASES["truncating"])
    np.testing.assert_allclose(dp["pos"], jdp["pos"], atol=1e-3)
    scale = np.abs(jdp["cov"]).max()
    np.testing.assert_allclose(dp["cov"], jdp["cov"], atol=1e-2 * scale)
    assert dp["n_eff"][-1] > 500


def test_dp_lio_matches_jax_dp_and_tracks_single_device(ranks):
    dp = ranks[0]["dp_preset"]
    jax_dp = _jax_dp(*DP_CASES["preset"])
    np.testing.assert_allclose(dp["pos"], jax_dp["pos"], atol=1e-4)
    scale = np.abs(jax_dp["cov"]).max()
    np.testing.assert_allclose(dp["cov"], jax_dp["cov"], atol=1e-3 * scale)
    assert dp["n_eff"][-1] > 500
    assert abs(dp["n_voxels"] - jax_dp["n_voxels"]) <= 0.01 * jax_dp[
        "n_voxels"]

    cfg = PRESETS["sim"]()
    sim = JSim(n_rays=N_RAYS, seed=SEED)
    ref = TLio(cfg, device="cpu")
    ref.static_init(*sim.static_imu(100))
    for k in range(FRAMES):
        f = sim.frame(k)
        ref.step(TBundle.from_numpy(
            f.pts, f.t_rel, f.imu_stamps, f.imu_acc, f.imu_gyr,
            f.scan_duration, cfg.preprocess.max_points,
            cfg.imu.max_imu_per_scan, device="cpu"))
    p_ref = ref.state.pos.numpy()
    assert np.linalg.norm(dp["pos"][-1] - p_ref) < 0.05
    assert np.linalg.norm(jax_dp["pos"][-1] - p_ref) < 0.05


# ---------------------------------------------------------------------------
def _gathered_rows(seed, blocks=WORLD, u=64):
    """Per-rank deduplicated aggregate lists as scan_aggregates makes them
    (unique valid keys first, padding rows repeating one key with zero
    moments), concatenated in rank order; keys overlap across blocks."""
    rng = np.random.default_rng(seed)
    uc, agg, ok = [], [], []
    for _ in range(blocks):
        m = int(rng.integers(u // 2, u))
        keys = rng.choice(7 ** 3, size=m, replace=False)
        c = np.stack([keys // 49 - 3, (keys // 7) % 7 - 3, keys % 7 - 3,
                      np.ones(m, np.int64)], -1).astype(np.int32)
        pad = np.repeat(c[-1:], u - m, axis=0)
        uc.append(np.concatenate([c, pad]))
        a = rng.standard_normal((u, 11)).astype(np.float32)
        a[m:] = 0.0
        agg.append(a)
        ok.append(np.arange(u) < m)
    return np.concatenate(uc), np.concatenate(agg), np.concatenate(ok)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_merge_aggregates_matches_jax_exactly(seed):
    uc, agg, ok = _gathered_rows(seed)
    ju, ja, jo = jdlio._merge_aggregates(jnp.asarray(uc), jnp.asarray(agg),
                                         jnp.asarray(ok))
    tu, ta, to = tdlio._merge_aggregates(torch.from_numpy(uc),
                                         torch.from_numpy(agg),
                                         torch.from_numpy(ok))
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo))
    np.testing.assert_array_equal(tu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    n = int(to.sum())
    assert 0 < n < len(ok.nonzero()[0])  # some keys merged across blocks
