"""The premises of the Delaunay kernels' schedules, on the CPU.

csrc/pairs_argmin.cu sweeps i, j and k over each voxel's valid points only,
compacted in ascending original order.  That is the same W as the sweep over
all K points: an invalid k never wins, skipping it keeps the order of the
rest (so the first minimum over ascending k is unchanged), and rows and
columns of invalid points are −1.  Here the plain version run on each
voxel's compacted points, scattered back to original indices, is held equal
to the plain version on the full set.

csrc/incircle.cu sweeps each candidate's plane over the valid points only,
as ((nx·u + ny·v) + nz·L) − off, and takes the masked points in as one
minimum with 0 (NaN where a masked point or the plane is not finite).
With every w 1.0 or 0.0 that is the plain version's minimum over all K
points, value for value; the wrappers reject any other w.
"""

import numpy as np
import pytest
import torch

from immesh_tpu_torch.kernels import incircle as ik
from immesh_tpu_torch.kernels.pairs_argmin import pairs_argmin_plain
from immesh_tpu_torch.mesh.delaunay import _lifted, _tri_candidates
from immesh_tpu_torch.mesh.delaunay import pairs_channels


def _compacted(u, v, lift, valid, d_eps):
    """pairs_argmin_plain voxel by voxel on the valid points only, in
    ascending original order, scattered back: what the kernel computes."""
    A, K = u.shape
    W = torch.full((A, K, K), -1, dtype=torch.int32)
    for a in range(A):
        idx = torch.nonzero(valid[a] > 0).squeeze(-1)        # ascending
        n = idx.numel()
        if n == 0:
            continue
        Wc = pairs_argmin_plain(
            u[a, idx][None].contiguous(), v[a, idx][None].contiguous(),
            lift[a, idx][None].contiguous(), torch.ones(1, n),
            d_eps[a:a + 1])[0]                                # (n, n)
        W[a][idx[:, None], idx[None, :]] = torch.where(
            Wc >= 0, idx[Wc.clamp(min=0).long()].to(torch.int32), -1)
    return W


def _voxels(seed, K, fills):
    """One voxel per entry of `fills`: an int is that many valid points, a
    float that share of K; then a cocircular grid voxel and a voxel with a
    NaN coordinate on a valid point."""
    rng = np.random.default_rng(seed)
    A = len(fills) + 2
    uv = rng.uniform(-0.3, 0.3, (A, K, 2)).astype(np.float32)
    mask = np.zeros((A, K), bool)
    for a, f in enumerate(fills):
        m = round(f * K) if isinstance(f, float) else f
        mask[a, rng.permutation(K)[:m]] = True
    g = np.stack(np.meshgrid(np.arange(7), np.arange(7)), -1).reshape(-1, 2)
    g = (g[:K] * 0.1 - 0.3).astype(np.float32)
    uv[-2, :len(g)] = g
    mask[-2, :len(g)] = True
    mask[-1] = rng.random(K) < 0.5
    mask[-1, 3] = True
    uv[-1, 3, 0] = np.nan
    tb = rng.integers(-2 ** 31, 2 ** 31 - 1, (A, K), dtype=np.int32)
    return torch.from_numpy(uv), torch.from_numpy(mask), torch.from_numpy(tb)


@pytest.mark.parametrize("K", [20, 48, 128])
def test_compacted_sweep_gives_the_same_w(K):
    uv, mask, tb = _voxels(K, K, [0, 1, 2, 0.5, 0.5, 1.0])
    ch = pairs_channels(uv, mask, tiebreak=tb, tie_scale=0.02)
    W = pairs_argmin_plain(*ch)
    assert torch.equal(_compacted(*ch), W)
    # the cases are live: third vertices exist, and the NaN voxel is all −1
    assert (W[3] >= 0).any() and (W[-2] >= 0).any()
    assert (W[-1] == -1).all() and (W[:3] == -1).all()


def _incircle_folded(u, v, lift, w, min_area, tris):
    """The incircle min scores as csrc/incircle.cu forms them: the plain
    version's planes, swept over the valid points with w = 1 folded out,
    the masked points entering as one minimum with 0 (or NaN)."""
    ia, ib, ic = (tris[:, c].long() for c in range(3))
    ua, va, la = u[:, ia], v[:, ia], lift[:, ia]
    e1u, e1v, e1l = u[:, ib] - ua, v[:, ib] - va, lift[:, ib] - la
    e2u, e2v, e2l = u[:, ic] - ua, v[:, ic] - va, lift[:, ic] - la
    area2 = e1u * e2v - e1v * e2u
    ccw = torch.sign(area2)
    nx = (e1v * e2l - e1l * e2v) * ccw
    ny = (e1l * e2u - e1u * e2l) * ccw
    nz = area2 * ccw
    off = (nx * ua + ny * va) + nz * la
    ok = w > 0
    s = (((nx[..., None] * u[:, None] + ny[..., None] * v[:, None])
          + nz[..., None] * lift[:, None]) - off[..., None])   # (A, T, K)
    best = torch.amin(torch.where(ok[:, None], s, torch.inf), dim=-1)
    masked_finite = (ok | (torch.isfinite(u) & torch.isfinite(v)
                           & torch.isfinite(lift))).all(-1)
    plane_finite = (torch.isfinite(nx) & torch.isfinite(ny)
                    & torch.isfinite(nz) & torch.isfinite(off))
    folded = torch.where(masked_finite[:, None] & plane_finite,
                         torch.minimum(best, torch.zeros(())), torch.nan)
    best = torch.where((~ok).any(-1)[:, None], folded, best)
    live = (ok[:, ia] & ok[:, ib] & ok[:, ic]
            & (torch.abs(area2) > min_area[:, None]))
    return torch.where(live, best, -torch.inf)


@pytest.mark.parametrize("K", [20, 48])
def test_incircle_folded_sweep_gives_the_same_scores(K):
    uv, mask, tb = _voxels(K + 1, K, [0, 3, 0.5, 0.8, 1.0])
    uv[3, 0, 0] = np.nan                       # on a masked point
    mask[3, 0] = False
    u, v, lift, scale = _lifted(uv, mask, 1e-6, tb, 0.02)
    args = (u.contiguous(), v.contiguous(), lift.contiguous(),
            mask.to(torch.float32), (1e-6 * scale * scale).contiguous(),
            _tri_candidates(K, "cpu"))
    want = ik.incircle_min_scores_plain(*args)
    got = _incircle_folded(*args)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(got.nan_to_num(), want.nan_to_num())
    # the cases are live: kept, swept and NaN scores all occur
    assert bool((want >= -1e-6).any()) and bool(torch.isfinite(want).any())
    assert bool(torch.isnan(want[3]).any())


def test_incircle_rejects_weights_other_than_one_and_zero():
    uv, mask, tb = _voxels(0, 20, [0.5])
    u, v, lift, scale = _lifted(uv, mask, 1e-6, tb, 0.02)
    w = mask.to(torch.float32)
    w[0, 0] = 0.5
    with pytest.raises(ValueError, match="1.0 and 0.0"):
        ik.incircle_min_scores(u.contiguous(), v.contiguous(),
                               lift.contiguous(), w, 1e-6 * scale * scale,
                               _tri_candidates(20, "cpu"))
