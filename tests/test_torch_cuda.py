"""Tests of the port that need the card: the CUDA kernels against their
plain versions, and the int32 hash arithmetic on the card against the CPU.

They skip without a CUDA device.  This file imports neither JAX nor the
reference, so on the GPU machine (which has no JAX) it runs on its own:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

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


def _voxels(seed, A, K):
    """Voxel point sets with a cocircular grid, an all-masked voxel and one
    with a single valid point, ~40 % masking elsewhere."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-0.5, 0.5, (A, K, 2)).astype(np.float32)
    g = np.stack(np.meshgrid(np.arange(7), np.arange(7)), -1).reshape(-1, 2)
    uv[0, :len(g[:K])] = g[:K] * 0.1
    mask = rng.random((A, K)) < 0.6
    mask[0, :len(g[:K])] = True
    mask[1] = False
    mask[2] = False
    mask[2, K // 2] = True
    tb = rng.integers(-2 ** 31, 2 ** 31 - 1, (A, K), dtype=np.int32)
    return (torch.from_numpy(uv), torch.from_numpy(mask),
            torch.from_numpy(tb))


@pytest.mark.parametrize("A,K", [(512, 48), (509, 48), (64, 128), (8, 1)])
def test_kernel_matches_plain_version_bitwise(dev, A, K):
    uv, mask, tb = (x.to(dev) for x in _voxels(A + K, A, K))
    ch = td.pairs_channels(uv, mask, tiebreak=tb, tie_scale=0.02)
    before = pk.launches
    Wk = pk.pairs_argmin(*ch)
    torch.cuda.synchronize()
    assert pk.launches == before + 1
    assert torch.equal(Wk, pk.pairs_argmin_plain(*ch))


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
                                 (3, 3)])
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


def test_delaunay_mask_on_the_card_equals_the_cpu(dev):
    uv, mask, tb = _voxels(3, 64, 48)
    cpu = td.delaunay_mask(uv, mask, tiebreak=tb, tie_scale=0.02)
    card = td.delaunay_mask(uv.to(dev), mask.to(dev), tiebreak=tb.to(dev),
                            tie_scale=0.02)
    assert torch.equal(cpu[0], card[0].cpu())
    assert torch.equal(cpu[1], card[1].cpu())
