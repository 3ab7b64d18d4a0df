"""Port parity, Delaunay layer: the pairs-argmin kernel's plain version
against the reference's Pallas kernel (run in interpret mode, as
tests/test_mesh.py runs it), the Delaunay core and its helpers, and the
dispatch rule of the kernel wrapper.

The plain version repeats the Pallas kernel's difference formula in the
same operation order, so W must match BIT FOR BIT — including cocircular
grids, masked and nearly empty voxels and NaN inputs.  The one exception
is an exact tie between two third-vertex candidates, which XLA:CPU's
multiply-add contraction can resolve the other way (held to a stated tie
margin below; ROADMAP queue 3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from immesh_tpu.mesh import delaunay as jd
from immesh_tpu_torch.kernels import pairs_argmin as pk
from immesh_tpu_torch.mesh import delaunay as td


def _t(x):
    return torch.from_numpy(np.array(x))


def _voxels(seed, A, K):
    """uv point sets with the kernel's hard cases: a 7×7 grid (cocircular
    quads), an all-masked voxel, one and two valid points, ~40 % masking."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-0.5, 0.5, (A, K, 2)).astype(np.float32)
    g = np.stack(np.meshgrid(np.arange(7), np.arange(7)), -1).reshape(-1, 2)
    g = (g[:K] * 0.1).astype(np.float32)
    uv[0, :len(g)] = g
    mask = rng.random((A, K)) < 0.6
    mask[0, :len(g)] = True
    mask[1] = False
    mask[2] = False
    mask[2, 3] = True
    mask[3] = False
    mask[3, [1, K - 2]] = True
    tb = rng.integers(-2 ** 31, 2 ** 31 - 1, (A, K), dtype=np.int32)
    return uv, mask, tb


@pytest.mark.parametrize("K", [24, 48])
def test_plain_version_matches_pallas_kernel_bitwise(K):
    A = 11   # not a multiple of the Pallas kernel's 8-voxel blocks
    uv, mask, _ = _voxels(K, A, K)
    rng = np.random.default_rng(K + 1)
    u, v = uv[..., 0], uv[..., 1]
    lift = (u * u + v * v
            + rng.uniform(0, 1e-4, (A, K)).astype(np.float32))
    lift[4, 5] = np.nan    # NaN in a k-sweep: jnp.min propagates it → −1
    eps = np.full(A, 1e-6, np.float32)
    Wj = np.asarray(jd._pairs_argmin_tpu(
        jnp.asarray(u), jnp.asarray(v), jnp.asarray(lift), jnp.asarray(lift),
        jnp.asarray(mask), jnp.asarray(eps), interpret=True))
    Wt = pk.pairs_argmin_plain(_t(u), _t(v), _t(lift),
                               _t(mask.astype(np.float32)), _t(eps)).numpy()
    np.testing.assert_array_equal(Wj, Wt)
    assert (Wt[1] == -1).all() and (Wt[2] == -1).all() and (Wt[3] == -1).all()
    assert (Wt[0] >= 0).sum() > 0 and (Wt[4] == -1).any()


@pytest.mark.parametrize("K", [24, 48])
def test_delaunay_pairs_match_reference_interpret(K):
    uv, mask, tb = _voxels(K + 7, 9, K)
    jW, jemit = jd.delaunay_pairs_w(jnp.asarray(uv), jnp.asarray(mask),
                                    tiebreak=jnp.asarray(tb), tie_scale=0.02,
                                    impl="interpret")
    tW, temit = td.delaunay_pairs_w(_t(uv), _t(mask), tiebreak=_t(tb),
                                    tie_scale=0.02)
    np.testing.assert_array_equal(np.asarray(jW), tW.numpy())
    np.testing.assert_array_equal(np.asarray(jemit), temit.numpy())
    assert temit.sum() > 0
    # the materialized triples with the default (small) tie perturbation:
    # the 7×7 grid of voxel 0 then holds exact cocircular ties, which
    # XLA:CPU resolves with multiply-adds contracted into FMAs inside the
    # jitted interpret-mode kernel (u·u + v·v under jit already rounds as
    # fma(u, u, v·v)), so W may differ there — only at tie level
    jt, jk = jd.delaunay_pairs(jnp.asarray(uv), jnp.asarray(mask),
                               impl="interpret")
    tt, tk = td.delaunay_pairs(_t(uv), _t(mask))
    jW3 = np.asarray(jt)[..., 2].reshape(-1, K, K)
    tW3 = tt[..., 2].numpy().reshape(-1, K, K)
    u, v, L = (c.numpy().astype(np.float64)
               for c in td.pairs_channels(_t(uv), _t(mask))[:3])
    for a, i, j in zip(*np.nonzero(jW3 != tW3)):
        gap = abs(_ratio64(u[a], v[a], L[a], i, j, jW3[a, i, j])
                  - _ratio64(u[a], v[a], L[a], i, j, tW3[a, i, j]))
        assert gap <= TIE_GAP, (a, i, j, gap)
    tied = (jW3 != tW3).any(axis=(1, 2))
    assert not tied[1:].any()          # only the gridded voxel has ties
    np.testing.assert_array_equal(np.asarray(jk)[~tied], tk.numpy()[~tied])
    np.testing.assert_array_equal(np.asarray(jt)[~tied], tt.numpy()[~tied])


# largest f64 gap between the slope ratios Np/d of two third-vertex
# candidates that still counts as a tie: ≈8 f32 ulps of the unit-scale
# differences the ratio is computed from
TIE_GAP = 1e-6


def _ratio64(u, v, L, i, j, k):
    """Np/d of candidate k for edge i→j, in f64."""
    du_j, dv_j, dL_j = u[j] - u[i], v[j] - v[i], L[j] - L[i]
    du_k, dv_k, dL_k = u[k] - u[i], v[k] - v[i], L[k] - L[i]
    d = du_j * dv_k - dv_j * du_k
    return (dL_k * (du_j ** 2 + dv_j ** 2) - (du_k * du_j + dv_k * dv_j) * dL_j) / d


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    uv, mask, tb = _voxels(3, 6, 24)
    ch = td.pairs_channels(_t(uv), _t(mask), tiebreak=_t(tb))
    pk.reset_launches()
    W = pk.pairs_argmin(*ch)
    td.delaunay_pairs_w(_t(uv), _t(mask), tiebreak=_t(tb))
    assert pk.launches == 0
    assert torch.equal(W, pk.pairs_argmin_plain(*ch))


def test_cuda_wrapper_rejects_what_the_kernel_does_not_take():
    u = torch.zeros(4, 8)
    args = [u, u, u, u, torch.zeros(4)]
    with pytest.raises(ValueError, match="CUDA"):
        pk.pairs_argmin_cuda(*args)
    assert pk.MAX_K == 128   # the kernel stages K ≤ 128 points in shared memory


def test_pca_projection_and_filters_match_reference():
    rng = np.random.default_rng(9)
    A, K = 8, 48
    pts = rng.normal(size=(A, K, 3)).astype(np.float32) * [1.0, 0.5, 0.01]
    pts += rng.normal(size=(A, 1, 3)).astype(np.float32) * 30
    mask = rng.random((A, K)) < 0.7
    for j, t in zip(jd.pca_project(jnp.asarray(pts), jnp.asarray(mask)),
                    td.pca_project(_t(pts), _t(mask))):
        np.testing.assert_allclose(np.abs(np.asarray(j)), np.abs(t.numpy()),
                                   rtol=1e-4, atol=1e-4)
    p0, p1, p2 = (rng.normal(size=(500, 3)).astype(np.float32)
                  for _ in range(3))
    p2[:50] = p0[:50] + 1e-3 * (p1[:50] - p0[:50])   # slivers
    np.testing.assert_array_equal(
        np.asarray(jd.angle_filter(jnp.asarray(p0), jnp.asarray(p1),
                                   jnp.asarray(p2), 150.0)),
        td.angle_filter(_t(p0), _t(p1), _t(p2), 150.0).numpy())
    keep = rng.random((A, 300)) < 0.2
    for cap in (16, 400):   # overflow is dropped / cap beyond candidates
        jr, jm = jd.compact_triangles(jnp.asarray(keep), None, cap)
        tr, tm = td.compact_triangles(_t(keep), cap)
        np.testing.assert_array_equal(np.asarray(jr), tr.numpy())
        np.testing.assert_array_equal(np.asarray(jm), tm.numpy())
