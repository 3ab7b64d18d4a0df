"""Tests of the port that need the card: the CUDA kernels against their
plain versions, and the int32 hash arithmetic on the card against the CPU.

They skip without a CUDA device.  This file imports neither JAX nor the
reference, so on the GPU machine (which has no JAX) it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from immesh_tpu_torch.kernels import build
from immesh_tpu_torch.kernels import incircle as ik
from immesh_tpu_torch.kernels import pairs_argmin as pk
from immesh_tpu_torch.map.hash import _fingerprint, _hash, frame_unique_coords
from immesh_tpu_torch.mesh import delaunay as td
from immesh_tpu_torch.mesh.triangles import _pos_hash

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    return torch.device("cuda")


def _voxels(seed, A, K, fill=0.6):
    """Voxel point sets with a cocircular grid, an all-masked voxel and one
    with a single valid point, a share `fill` of valid points elsewhere."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-0.5, 0.5, (A, K, 2)).astype(np.float32)
    g = np.stack(np.meshgrid(np.arange(7), np.arange(7)), -1).reshape(-1, 2)
    uv[0, :len(g[:K])] = g[:K] * 0.1
    mask = rng.random((A, K)) < fill
    mask[0, :len(g[:K])] = True
    mask[1] = False
    mask[2] = False
    mask[2, K // 2] = True
    tb = rng.integers(-2 ** 31, 2 ** 31 - 1, (A, K), dtype=np.int32)
    return (torch.from_numpy(uv), torch.from_numpy(mask),
            torch.from_numpy(tb))


@pytest.mark.parametrize("A,K,fill", [
    (512, 48, 0.6), (509, 48, 0.6), (64, 128, 0.6), (8, 1, 0.6),
    (64, 48, 0.5), (64, 20, 0.5), (512, 48, 0.05), (512, 48, 1.0),
    (64, 128, 1.0)])
def test_kernel_matches_plain_version_bitwise(dev, A, K, fill):
    uv, mask, tb = _voxels(A + K, A, K, fill)
    if A > 4 and K >= 3:
        # voxel 3: every valid point left of the edge 0→1 (right of 1→0);
        # voxel 4: every valid point on one line (no third vertex anywhere)
        uv[3, :, 1] = torch.linspace(0.1, 0.45, K)
        uv[3, :2] = torch.tensor([[0.0, 0.0], [0.5, 0.0]])
        mask[3] = True
        uv[4, :, 0] = torch.linspace(-0.4, 0.4, K)
        uv[4, :, 1] = 0.0
        mask[4] = True
    uv, mask, tb = uv.to(dev), mask.to(dev), tb.to(dev)
    ch = td.pairs_channels(uv, mask, tiebreak=tb, tie_scale=0.02)
    before = pk.launches
    Wk = pk.pairs_argmin(*ch)
    torch.cuda.synchronize()
    assert pk.launches == before + 1
    assert torch.equal(Wk, pk.pairs_argmin_plain(*ch))
    if A > 4 and K >= 3:
        assert (Wk[4] == -1).all()
        assert (Wk[3, 1, 0] == -1) and (Wk[3, 0, 1] >= 2)


def test_kernel_matches_plain_version_on_hard_geometry(dev):
    """Near-ties for the kernel's certified sweep (points on near-parallel
    scan lines, duplicated points, a voxel at the 1e-3 scale floor) and its
    exact fallback (a coordinate past 2^16, a negative eps)."""
    rng = np.random.default_rng(7)
    A, K = 64, 48
    uv = rng.uniform(-0.3, 0.3, (A, K, 2)).astype(np.float32)
    mask = rng.random((A, K)) < 0.7
    for a in range(0, 16):                       # three scan lines
        t = rng.uniform(-0.3, 0.3, K).astype(np.float32)
        line = rng.integers(0, 3, K)
        uv[a, :, 0] = t
        uv[a, :, 1] = 0.05 * line + 1e-4 * rng.standard_normal(K) + 0.01 * t
    uv[16:24, K // 2:] = uv[16:24, :K // 2]      # every point twice
    uv[24:32] *= 1e-3
    uv[32, 5] = [7e4, 1.0]
    mask[32, 5] = True
    tb = rng.integers(-2 ** 31, 2 ** 31 - 1, (A, K), dtype=np.int32)
    uv, mask, tb = (torch.from_numpy(x).to(dev) for x in (uv, mask, tb))
    u, v, lift, valid, d_eps = td.pairs_channels(uv, mask, tiebreak=tb,
                                                 tie_scale=0.02)
    d_eps = d_eps.clone()
    d_eps[33] = -1e-4
    ch = (u, v, lift, valid, d_eps)
    Wk = pk.pairs_argmin(*ch)
    torch.cuda.synchronize()
    assert torch.equal(Wk, pk.pairs_argmin_plain(*ch))
    assert (Wk[:32] >= 0).any(-1).any(-1).all()


def _planted_ties(seed, A, K):
    """Rotated, shifted and scaled 7×7 grids (their first K points), all
    valid, with a zero tiebreak so the lift is u² + v² unperturbed: the
    corners of each grid square are cocircular, so many rows (i, j) hold
    several k whose rounded ratios RN(Np/d) are equal."""
    rng = np.random.default_rng(seed)
    g = np.stack(np.meshgrid(np.arange(7), np.arange(7)), -1).reshape(-1, 2)
    g = g[:K] - 3.0
    uv = np.zeros((A, K, 2), np.float32)
    for a in range(A):
        th = rng.uniform(0.0, 2.0 * np.pi)
        rot = np.array([[np.cos(th), -np.sin(th)], [np.sin(th), np.cos(th)]])
        uv[a] = (g * rng.uniform(0.03, 0.1)) @ rot + rng.uniform(-0.05, 0.05, 2)
    return (torch.from_numpy(uv), torch.ones((A, K), dtype=torch.bool),
            torch.zeros((A, K), dtype=torch.int32))


def test_certified_sweep_settles_planted_ties(dev, tmp_path):
    """Both branches of the kernel's certified sweep that decide exactness
    run and give the plain version's W: the exact resolution of the k it
    cannot prove out, and the tie rule (equal rounded ratios go to the
    smaller k).  A build of the kernel with branch counters, on planted
    ties."""
    lib_path = str(tmp_path / "libpairs_argmin_counted.so")
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS,
                    "-DPAIRS_ARGMIN_BRANCH_COUNTS", "-o", lib_path,
                    build.source_path(pk.NAME)], check=True)
    lib = pk._bind(ctypes.CDLL(lib_path))
    read = lib.pairs_argmin_branch_counts
    read.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    counts = (ctypes.c_ulonglong * 2)()
    assert read(counts) == 0                     # and zeroed
    uv, mask, tb = (x.to(dev) for x in _planted_ties(5, 64, 48))
    ch = td.pairs_channels(uv, mask, tiebreak=tb, tie_scale=0.02)
    W = torch.empty((64, 48, 48), dtype=torch.int32, device=dev)
    pk._launch(lib, *ch, W)
    torch.cuda.synchronize()
    assert read(counts) == 0
    resolved, ties = counts
    print(f"planted ties: {resolved} k resolved exactly, {ties} ties taken "
          f"by the smaller k")
    assert torch.equal(W, pk.pairs_argmin_plain(*ch))
    assert ties > 0 and resolved > ties


def test_kernel_wrapper_rejects_bad_inputs(dev):
    uv, mask, tb = (x.to(dev) for x in _voxels(0, 16, 48))
    ch = td.pairs_channels(uv, mask, tiebreak=tb)
    with pytest.raises(TypeError):
        pk.pairs_argmin(*(x.double() for x in ch))
    with pytest.raises(ValueError):
        pk.pairs_argmin(ch[0][:, :40].contiguous(), *ch[1:])
    with pytest.raises(ValueError, match="contiguous"):
        pk.pairs_argmin(ch[0].t().contiguous().t(), *ch[1:])
    big = torch.zeros(2, 129, device=dev)
    with pytest.raises(ValueError):
        pk.pairs_argmin(big, big, big, big, torch.zeros(2, device=dev))


def test_int32_hash_arithmetic_is_the_same_on_the_card(dev):
    rng = np.random.default_rng(0)
    c = torch.from_numpy(
        rng.integers(-2 ** 31, 2 ** 31 - 1, (4096, 4), dtype=np.int32))
    p = torch.from_numpy(rng.normal(0, 100, (4096, 3)).astype(np.float32))
    assert torch.equal(_hash(c, 2 ** 18 - 1), _hash(c.to(dev), 2 ** 18 - 1).cpu())
    assert torch.equal(_fingerprint(c), _fingerprint(c.to(dev)).cpu())
    assert torch.equal(_pos_hash(p), _pos_hash(p.to(dev)).cpu())
    small = torch.from_numpy(rng.integers(-3, 3, (4096, 3), dtype=np.int32))
    m = torch.from_numpy(rng.random(4096) < 0.8)
    for a, b in zip(frame_unique_coords(small, m, 100),
                    frame_unique_coords(small.to(dev), m.to(dev), 100)):
        assert torch.equal(a, b.cpu())


def _incircle_args(seed, A, K, dev):
    """delaunay_mask's kernel inputs with the edge cases: a cocircular grid
    (voxel 0), an all-masked voxel (1), a collinear voxel (2), a NaN
    coordinate on a masked point (3: every live candidate NaN) and on a
    valid point (4: the voxel's scale is NaN, every candidate −inf)."""
    uv, mask, tb = _voxels(seed, A, K)
    if A > 4:
        uv[2, :, 0] = torch.linspace(-0.4, 0.4, K)
        uv[2, :, 1] = 0.5 * uv[2, :, 0]
        mask[2] = True
        uv[3, 1, 0] = float("nan")
        mask[3, 1] = False
        uv[4, 2, 1] = float("nan")
        mask[4, 2] = True
    uv, mask, tb = uv.to(dev), mask.to(dev), tb.to(dev)
    u, v, lift, scale = td._lifted(uv, mask, 1e-6, tb, 0.02)
    return (u.contiguous(), v.contiguous(), lift.contiguous(),
            mask.to(torch.float32).contiguous(),
            (1e-6 * scale * scale).contiguous(), td._tri_candidates(K, dev))


@pytest.mark.parametrize("A,K", [(512, 48), (509, 48), (64, 20), (8, 128),
                                 (3, 3), (64, 47)])
def test_incircle_kernel_matches_plain_version(dev, A, K):
    args = _incircle_args(A + K, A, K, dev)
    before = ik.launches
    out = ik.incircle_min_scores(*args)
    torch.cuda.synchronize()
    assert ik.launches == before + 1
    want = ik.incircle_min_scores_plain(*args)
    assert torch.equal(torch.isnan(out), torch.isnan(want))
    assert torch.equal(out.nan_to_num(), want.nan_to_num())
    if A > 4:
        gated = torch.isneginf(out)
        assert gated[1].all() and gated[2].all() and gated[4].all()
        assert torch.isnan(out[3][~gated[3]]).all()


def test_incircle_kernel_wrapper_rejects_bad_inputs(dev):
    args = _incircle_args(0, 16, 24, dev)
    with pytest.raises(TypeError):
        ik.incircle_min_scores(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        ik.incircle_min_scores(*args[:5], args[5] + 24)
    with pytest.raises(ValueError, match="contiguous"):
        ik.incircle_min_scores(args[0].t().contiguous().t(), *args[1:])
    with pytest.raises(ValueError):
        ik.incircle_min_scores(*args[:5], args[5].cpu())
    half = args[3].clone()
    half[5, 0] = 0.5
    with pytest.raises(ValueError, match="1.0 and 0.0"):
        ik.incircle_min_scores(*args[:3], half, *args[4:])


def test_delaunay_mask_on_the_card_equals_the_cpu(dev):
    uv, mask, tb = _voxels(3, 64, 48)
    cpu = td.delaunay_mask(uv, mask, tiebreak=tb, tie_scale=0.02)
    card = td.delaunay_mask(uv.to(dev), mask.to(dev), tiebreak=tb.to(dev),
                            tie_scale=0.02)
    assert torch.equal(cpu[0], card[0].cpu())
    assert torch.equal(cpu[1], card[1].cpu())
