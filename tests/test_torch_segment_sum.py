"""The segmented sum (kernels/segment_sum.py, reached through
core/ops.py::segment_sum) against the JAX reference, and its CUDA kernel
against the composition it replaced on the card.

On the CPU: the plain version against `jax.ops.segment_sum` and a
sequential `np.add.at`, bit for bit, with ids outside [0, S) dropped
(negative ones and ones at or past S); the kernel's schedule
(csrc/segment_sum.cu: a warp a segment, tiles of 32·kR rows padded with
+0.0, 4 rows a shared load, 32 columns a block along y) emulated in NumPy,
bit for bit against the sequential sum; the callers' sums against the
parent's composition (one more segment for the discarded rows, sliced off);
the argument contract; and no module of the port calling
torch.segment_reduce.

The `cuda` tests hold the kernel bit for bit to the parent's
`values[order]` + `torch.segment_reduce` at the callers' shapes (the scan's
downsample, (131,072, 4) into 8,192 with a 3,229-row segment and 32,212
dropped rows; a map-update level, (8,192, 11) into 4,096 with 5,920
dropped) and to the plain version on the CPU at other widths and layouts,
count its launches, captured launches and device runs, and replay the
KITTI-shaped frame's graphs bit for bit against the eager frame; they skip
without a card.  The reference is imported inside the tests, so on the GPU
machine (no JAX)

    python -m pytest --noconftest -m cuda tests/test_torch_segment_sum.py
"""

import pathlib

import numpy as np
import pytest
import torch

from immesh_tpu_torch.core import ops
from immesh_tpu_torch.kernels import build
from immesh_tpu_torch.kernels import segment_sum as ss

_PKG = pathlib.Path(__file__).resolve().parent.parent / "immesh_tpu_torch"


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _sequential(values: np.ndarray, seg: np.ndarray, S: int) -> np.ndarray:
    """The rows of each id in [0, S) added one at a time in input order,
    from zeros (np.add.at is unbuffered and sequential)."""
    out = np.zeros((S,) + values.shape[1:], np.float32)
    keep = (seg >= 0) & (seg < S)
    np.add.at(out, seg[keep], values[keep])
    return out


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.uint32)


def _ids(rng, n: int, S: int, long: int = 0, dropped: int = 0,
         negative: int = 0) -> np.ndarray:
    """n segment ids in [0, S), `long` of them one id (a long segment),
    `dropped` of them S or above and `negative` below 0, shuffled."""
    seg = rng.integers(0, S, n)
    if long:
        seg[seg == 17 % S] = (17 % S + 1) % S
        seg[:long] = 17 % S
    seg[long:long + dropped] = S + rng.integers(0, 3, dropped)
    seg[long + dropped:long + dropped + negative] = -1 - rng.integers(
        0, 3, negative)
    return seg[rng.permutation(n)]


# (rows, trailing shape, segments, long segment, dropped, negative)
CASES = {
    "many_tiles": (1500, (4,), 9, 700, 100, 20),
    "empty_kept_segments": (40, (4,), 500, 0, 5, 0),
    "all_dropped": (64, (11,), 16, 0, 64, 0),
    "one_row": (1, (4,), 3, 0, 0, 0),
    "c1_vector": (300, (), 7, 120, 30, 10),
    "c11": (2000, (11,), 300, 90, 400, 0),
    "c18": (600, (6, 3), 12, 200, 0, 40),
    "c3": (500, (3,), 40, 150, 0, 0),
    "c40_two_column_blocks": (400, (40,), 5, 160, 30, 0),
}


def _case(name: str, seed: int = 0):
    rng = np.random.default_rng(seed)
    n, row, S, long, dropped, negative = CASES[name]
    values = (rng.normal(size=(n,) + row) * 1e3).astype(np.float32)
    flat = values.reshape(n, -1)
    flat[rng.random(flat.shape) < 0.05] = -0.0   # signed zeros stay exact
    flat[:3] = 1e30   # large terms: the order shows in the low bits
    return values, _ids(rng, n, S, long, dropped, negative), S


# ---------------------------------------------------------------------------
# the plain version (the CPU path)
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(CASES))
def test_plain_version_is_the_reference_bit_for_bit(name):
    import jax
    import jax.numpy as jnp
    values, seg, S = _case(name)
    got = ops.segment_sum(torch.from_numpy(values), torch.from_numpy(seg), S)
    assert tuple(got.shape) == (S,) + values.shape[1:]
    want = _sequential(values, seg, S)
    ref = np.asarray(jax.ops.segment_sum(jnp.asarray(values),
                                         jnp.asarray(seg), num_segments=S))
    assert np.array_equal(_bits(got.numpy()), _bits(want))
    assert np.array_equal(_bits(ref), _bits(want))


def test_plain_version_takes_a_strided_view():
    rng = np.random.default_rng(4)
    wide = torch.from_numpy(rng.normal(size=(800, 9)).astype(np.float32))
    values = wide[:, 2:7]                  # neither rows nor columns packed
    seg = torch.from_numpy(_ids(rng, 800, 31, 300, 50, 5))
    got = ops.segment_sum(values, seg, 31)
    want = _sequential(values.numpy(), seg.numpy(), 31)
    assert np.array_equal(_bits(got.numpy()), _bits(want))
    got = ops.segment_sum(wide.t()[3], seg, 31)       # a strided (N,) row
    assert np.array_equal(_bits(got.numpy()),
                          _bits(_sequential(wide.numpy()[:, 3],
                                            seg.numpy(), 31)))


# ---------------------------------------------------------------------------
# the kernel's schedule, emulated
# ---------------------------------------------------------------------------
def _template(C: int):
    """(kC, kR) of segment_sum_launch for C columns."""
    for kc, kr in ((4, 4), (8, 2), (16, 1)):
        if C <= kc:
            return kc, kr
    return 32, 1


def _emulate(values: np.ndarray, order: np.ndarray,
             offsets: np.ndarray) -> np.ndarray:
    """csrc/segment_sum.cu's schedule in NumPy f32: per column block of 32
    (grid.y) and segment (a warp), tiles of 32·kR rows gathered through
    `order` with the rows past the segment's end +0.0, each column added down
    the tile 4 rows a shared load, to the segment's row count rounded up to
    4."""
    v = values.reshape(values.shape[0], -1)
    C = v.shape[1]
    S = offsets.shape[0] - 1
    kc, kr = _template(C)
    rows_a_tile = 32 * kr
    out = np.empty((S, C), np.float32)
    for c0 in range(0, C, 32):
        nc = min(C - c0, kc)
        for s in range(S):
            begin, end = int(offsets[s]), int(offsets[s + 1])
            acc = np.zeros(nc, np.float32)
            for first in range(begin, end, rows_a_tile):
                tile = np.zeros((rows_a_tile, nc), np.float32)
                live = min(rows_a_tile, end - first)
                tile[:live] = v[order[first:first + live], c0:c0 + nc]
                for r in range(0, live, 4):
                    for q in range(4):
                        acc = acc + tile[r + q]
            out[s, c0:c0 + nc] = acc
    return out.reshape((S,) + values.shape[1:])


@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_schedule_is_the_sequential_sum(name):
    values, seg, S = _case(name, seed=1)
    t = torch.from_numpy(seg)
    order = torch.argsort(t, stable=True)
    offsets = torch.searchsorted(t[order], torch.arange(S + 1))
    got = _emulate(values, order.numpy(), offsets.numpy())
    assert np.array_equal(_bits(got), _bits(_sequential(values, seg, S)))


def test_padding_with_positive_zero_keeps_every_bit():
    """The tile's rows past a segment's end are +0.0: x + (+0.0) is x for
    every sum the chain can hold (it never becomes −0.0), infinities too."""
    x = np.array([0.0, -0.0, 1e-45, -1e-45, 3.5, -np.inf, np.inf, 1e38],
                 np.float32)
    acc = np.float32(0.0) + x             # the first add of a segment
    assert not np.signbit(acc[1])          # +0.0 + (−0.0) = +0.0
    assert np.array_equal(_bits(acc + np.float32(0.0)), _bits(acc))


# ---------------------------------------------------------------------------
# the callers and the contract
# ---------------------------------------------------------------------------
def _parent_sum(values, seg, S):
    """The parent's composition: ids ≥ S moved to one extra segment, summed
    with the others by torch.segment_reduce and sliced off."""
    seg = torch.clamp(seg.long(), max=S)
    order = torch.argsort(seg, stable=True)
    offsets = torch.searchsorted(seg[order], torch.arange(S + 2,
                                                          device=seg.device))
    return torch.segment_reduce(values[order], "sum", offsets=offsets,
                                axis=0, unsafe=True)[:-1]


def test_callers_equal_the_parent_composition():
    """voxel_downsample's and scan_aggregates' ids (frame_unique_coords,
    with masked and overflowing rows at id k) summed into k segments give
    the parent's k + 1 segments less the last, bit for bit."""
    from immesh_tpu_torch.map.hash import frame_unique_coords
    rng = np.random.default_rng(5)
    pts = torch.from_numpy(rng.normal(0, 6, (4000, 3)).astype(np.float32))
    mask = torch.from_numpy(rng.random(4000) < 0.8)
    coords = torch.floor(pts / 0.5).to(torch.int32)
    for k in (64, 4096):           # overflow, and room for every cell
        seg, _, _ = frame_unique_coords(coords, mask, k)
        w = (seg < k).to(pts.dtype)
        feats = torch.cat([pts * w[:, None], w[:, None]], dim=-1)
        got = ops.segment_sum(feats, seg, k)
        assert torch.equal(got.view(torch.int32),
                           _parent_sum(feats, seg, k).view(torch.int32))


def test_argument_contract():
    v = torch.zeros(5, 4)
    order = torch.arange(5)
    with pytest.raises(TypeError, match="int64"):
        ss.sum_plain(v, order.int(), torch.tensor([0, 5]))
    with pytest.raises(ValueError, match="one entry a row"):
        ss.sum_plain(v, order[:4], torch.tensor([0, 5]))
    with pytest.raises(ValueError, match="segments"):
        ss.sum_plain(v, order, torch.zeros((), dtype=torch.int64))
    with pytest.raises(ValueError, match="row axis"):
        ss.sum_plain(torch.zeros(()), order, torch.tensor([0, 5]))
    with pytest.raises(ValueError, match="CUDA device"):
        ss.sum_cuda(v, order, torch.tensor([0, 5]))


def test_a_cpu_tensor_never_loads_the_cuda_library(monkeypatch):
    def no_build(name):
        raise AssertionError(f"the CPU path loaded lib{name}")

    monkeypatch.setattr(build, "load", no_build)
    monkeypatch.setattr(ss, "_lib", None)
    monkeypatch.setattr(ss, "launches", 0)
    out = ops.segment_sum(torch.ones(6, 2), torch.tensor([0, 2, 2, 5, 1, 0]),
                          3)
    assert out.tolist() == [[2, 2], [1, 1], [2, 2]]
    assert ss.launches == 0 and ss.captured == 0 and ss.runs() == 0


def test_a_tensor_off_the_cpu_never_takes_the_plain_version(monkeypatch):
    def plain(*args):
        raise AssertionError("the plain version ran on a tensor off the CPU")

    monkeypatch.setattr(ss, "sum_plain", plain)
    values = torch.empty((16, 4), device="meta")
    seg = torch.empty(16, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        ops.segment_sum(values, seg, 8)


def test_no_module_of_the_port_calls_segment_reduce(monkeypatch):
    """The port's sources name no torch.segment_reduce, and the CPU path of
    both callers runs with it trapped."""
    for path in _PKG.rglob("*.py"):
        assert "segment_reduce" not in path.read_text(), path

    def trap(*args, **kwargs):
        raise AssertionError("torch.segment_reduce was called")

    monkeypatch.setattr(torch, "segment_reduce", trap)
    from immesh_tpu_torch.config import VoxelMapConfig
    from immesh_tpu_torch.lio.downsample import voxel_downsample
    from immesh_tpu_torch.map.voxel_map import VoxelMap
    rng = np.random.default_rng(6)
    pts = torch.from_numpy(rng.normal(0, 5, (2048, 3)).astype(np.float32))
    mask = torch.ones(2048, dtype=torch.bool)
    out, out_mask = voxel_downsample(pts, mask, 0.5, 256)
    assert int(out_mask.sum()) == 256
    vm = VoxelMap.create(VoxelMapConfig(capacity=1024, max_layers=2),
                         device="cpu")
    _, agg, ok = vm.scan_aggregates(pts, torch.full((2048,), 1e-4), mask, 0,
                                    128)
    assert tuple(agg.shape) == (128, 11)
    assert float(agg[ok][:, 9].sum()) == float(torch.sum(
        agg[:, 9])) > 0


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
def _card_case(dev, n, row, S, long, dropped, seed):
    rng = np.random.default_rng(seed)
    values = torch.from_numpy(
        (rng.normal(size=(n,) + row) * 50).astype(np.float32)).to(dev)
    seg = torch.from_numpy(_ids(rng, n, S, long, dropped)).to(dev)
    return values, seg


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [
    (131072, (4,), 8192, 3229, 32212),   # the scan's downsample
    (8192, (11,), 4096, 60, 5920)])      # a map-update level
def test_kernel_equals_the_parent_composition_on_the_card(dev, shape):
    n, row, S, long, dropped = shape
    values, seg = _card_case(dev, n, row, S, long, dropped, seed=7)
    before = ss.launches
    got = ops.segment_sum(values, seg, S)
    want = _parent_sum(values, seg, S)
    torch.cuda.synchronize()
    assert ss.launches == before + 1
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    plain = ops.segment_sum(values.cpu(), seg.cpu(), S)
    assert torch.equal(got.cpu().view(torch.int32), plain.view(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
def test_kernel_equals_the_plain_version_on_the_card(dev, name):
    values, seg, S = _case(name, seed=2)
    got = ops.segment_sum(torch.from_numpy(values).to(dev),
                          torch.from_numpy(seg).to(dev), S)
    want = _sequential(values, seg, S)
    assert np.array_equal(_bits(got.cpu().numpy()), _bits(want))


@pytest.mark.cuda
def test_kernel_takes_strided_and_misaligned_views(dev):
    rng = np.random.default_rng(8)
    wide = torch.from_numpy(rng.normal(size=(5000, 13)).astype(np.float32))
    seg = torch.from_numpy(_ids(rng, 5000, 300, 900, 700, 3))
    for view in (wide[:, 1:5], wide[:, 4:8], wide[:, 0:11], wide.t()[2],
                 wide[::2, :4]):
        s = seg[: view.shape[0]]
        got = ops.segment_sum(_on_card(view, wide, dev), s.to(dev), 300)
        want = _sequential(view.numpy(), s.numpy(), 300)
        assert np.array_equal(_bits(got.cpu().numpy()), _bits(want))


def _on_card(view: torch.Tensor, base: torch.Tensor, dev) -> torch.Tensor:
    """The same view of `base` copied to the card (strides kept)."""
    return torch.as_strided(base.to(dev), view.shape, view.stride(),
                            view.storage_offset())


@pytest.mark.cuda
def test_a_failed_build_or_launch_raises(dev, monkeypatch):
    seg = torch.zeros(1, dtype=torch.int32, device=dev)

    def broken(name):
        raise RuntimeError("building the port's native sources failed")

    monkeypatch.setattr(ss, "_lib", None)
    monkeypatch.setattr(build, "load", broken)
    with pytest.raises(RuntimeError, match="failed"):
        ops.segment_sum(torch.ones(1, 4, device=dev), seg, 1)
    monkeypatch.undo()
    too_wide = torch.ones(1, 32 * 65535 + 1, device=dev)   # grid.y refused
    with pytest.raises(RuntimeError, match="launch failed"):
        ops.segment_sum(too_wide, seg, 1)


@pytest.mark.cuda
def test_counts_split_launches_captured_and_device_runs(dev):
    """An eager call counts in `launches`; one under stream capture in
    `captured`; the kernel's device counter sees the eager run and every
    replay, and each replay sums the values it finds."""
    values, seg = _card_case(dev, 3000, (11,), 200, 300, 400, seed=9)
    ops.segment_sum(values, seg, 200)    # loads the library before a capture
    ss.reset_launches()
    eager = ops.segment_sum(values, seg, 200)
    assert torch.equal(eager.view(torch.int32),
                       _parent_sum(values, seg, 200).view(torch.int32))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = ops.segment_sum(values, seg, 200)
    assert (ss.launches, ss.captured, ss.runs()) == (1, 1, 1)
    for _ in range(3):
        values.mul_(1.5)
        graph.replay()
        want = ops.segment_sum(values, seg, 200)
        assert torch.equal(out.view(torch.int32), want.view(torch.int32))
    assert (ss.launches, ss.captured, ss.runs()) == (4, 1, 7)
    ss.reset_launches()
    assert (ss.launches, ss.captured, ss.runs()) == (0, 0, 0)


@pytest.mark.cuda
def test_kitti_frame_graph_replays_the_eager_frame_on_the_card(dev):
    """The KITTI-shaped frame (small_config) as its captured LIO and mesh
    graphs and eagerly from the same start, bit for bit every frame; the
    kernel's device runs are the eager launches plus the LIO graph's
    replays and its level bodies' runs times the launches recorded into
    them (the mesh graph holds none)."""
    import chip_smoke
    from immesh_tpu_torch.kernels import graph_cond as gc
    from immesh_tpu_torch.runtime.joint import JointPipeline
    cfg = chip_smoke.small_config()
    sim = chip_smoke.make_sim(cfg.preprocess.max_points, 16)
    one = JointPipeline(cfg, adaptive_mesh_budget=256, device=dev)
    eager = JointPipeline(cfg, adaptive_mesh_budget=256, device=dev,
                          graph=False)
    ss.reset_launches()
    gc.reset_launches()
    n = 6
    for k in range(n):
        b = chip_smoke.bundle(sim.frame(k), cfg, dev)
        (we, de), (w1, d1) = eager.step(b), one.step(b)
        assert chip_smoke.lio_differs(eager.lio.state, one.lio.state,
                                      eager.lio.vm, one.lio.vm,
                                      [("world", we, w1)]) == []
        assert chip_smoke.mesh_differs(eager.mesh, one.mesh) == []
    torch.cuda.synchronize()
    g, mg = one.captured.graphs  # the LIO graph's segmented sums
    assert g.replays == mg.replays == n - 1
    assert mg.captured.get("segment_sum", 0) == 0 and not any(
        bd.captured.get("segment_sum", 0) for bd in mg.bodies)
    bodies = g.bodies
    taken = gc.taken([bd.slot for bd in bodies])
    in_bodies = sum(t * bd.captured.get("segment_sum", 0)
                    for t, bd in zip(taken, bodies))
    assert g.captured.get("segment_sum", 0) >= 1 and in_bodies >= 1
    assert ss.runs() == ss.launches + g.replays * g.captured[
        "segment_sum"] + in_bodies
