"""Port parity, the Delaunay incircle oracle: the plain version of the
incircle kernel against the reference's Pallas `_incircle_kernel` (run in
interpret mode, launched exactly as `delaunay_mask`'s TPU branch launches
it), and the port's `delaunay_mask` against the reference's (its jnp
fallback on the CPU) and against scipy.

Tolerances, with their reasons:
  * min scores: 2e-7·scale⁴ per voxel, a fifth of the keep threshold
    ε = 1e-6·scale⁴ (5.5e-8·scale⁴ measured) — the Pallas kernel contracts
    the K-sweep as one f32 dot (another summation order) and XLA:CPU fuses
    its jitted plane arithmetic into FMAs, so scores differ by a few ulps
    of the O(scale⁴) terms; the −inf gates agree exactly;
  * keep masks: equal wherever the f64 incircle margin of the triangle is
    above tie level (1e-5), the rule tests/test_mesh.py holds the reference
    to against scipy — the reference's fallback masks own vertices, the
    kernel formulation does not, and f32 cannot resolve closer ties."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from immesh_tpu.mesh import delaunay as jd
from immesh_tpu_torch.kernels import incircle as ik
from immesh_tpu_torch.mesh import delaunay as td

TIE_SCALE = 0.02  # MeshConfig.tie_scale of the presets


def _round_up(x, m):
    return (x + m - 1) // m * m


def _voxels(seed, A, K):
    """Random voxels with a cocircular grid (voxel 0), an all-masked voxel
    (1), a collinear voxel (2) and ~20 % masking elsewhere."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-0.5, 0.5, (A, K, 2)).astype(np.float32)
    mask = rng.random((A, K)) < 0.8
    g = np.stack(np.meshgrid(np.arange(5), np.arange(5)), -1).reshape(-1, 2)
    n = min(len(g), K)
    uv[0, :n] = g[:n] * 0.1 - 0.2
    mask[0, :n] = True
    mask[1] = False
    uv[2, :, 0] = np.linspace(-0.4, 0.4, K)
    uv[2, :, 1] = 0.5 * uv[2, :, 0]
    mask[2] = True
    tb = rng.integers(-2 ** 31, 2 ** 31 - 1, (A, K), dtype=np.int32)
    return uv, mask, tb


def _port_inputs(uv, mask, tb):
    """The kernel's inputs exactly as the port's delaunay_mask builds them."""
    uv_t, m_t = torch.from_numpy(uv), torch.from_numpy(mask)
    u, v, lift, scale = td._lifted(uv_t, m_t, 1e-6, torch.from_numpy(tb),
                                   TIE_SCALE)
    w = m_t.to(torch.float32)
    min_area = 1e-6 * scale ** 2
    tris = td._tri_candidates(uv.shape[1], "cpu")
    return (u.contiguous(), v.contiguous(), lift.contiguous(), w.contiguous(),
            min_area.contiguous(), tris), scale


def _pallas_min_scores(u, v, lift, w, min_area, tris):
    """`_incircle_min_scores` as delaunay_mask's TPU branch calls it, with
    interpret=True."""
    A, K = u.shape
    T = tris.shape[0]
    Kp, Tp, Ap, tt = _round_up(K, 128), _round_up(T, 1024), _round_up(A, 8), 1024
    uvlw8 = np.zeros((Ap, 8, Kp), np.float32)
    for c, x in enumerate((u * w, v * w, lift * w, w, u, v, lift)):
        uvlw8[:A, c, :K] = x
    tris8 = np.zeros((8, Tp), np.int32)
    tris8[0:3, :T] = tris.T
    scal = np.zeros((Ap, 128), np.float32)
    scal[:A, 0] = min_area
    out = pl.pallas_call(
        jd._incircle_kernel,
        grid=(Ap // 8, Tp // tt),
        in_specs=[
            pl.BlockSpec((8, 8, Kp), lambda a, t: (a, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((8, tt), lambda a, t: (0, t),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((8, 128), lambda a, t: (a, 0),
                         memory_space=pltpu.VMEM),
        ],
        out_specs=pl.BlockSpec((8, tt), lambda a, t: (a, t),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((Ap, Tp), jnp.float32),
        interpret=True,
    )(jnp.asarray(uvlw8), jnp.asarray(tris8), jnp.asarray(scal))
    return np.asarray(out)[:A, :T]


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_version_matches_pallas_kernel(seed):
    A, K = 8, 24
    uv, mask, tb = _voxels(seed, A, K)
    args, scale = _port_inputs(uv, mask, tb)
    got = ik.incircle_min_scores(*args).numpy()       # CPU → plain version
    want = _pallas_min_scores(*(x.numpy() for x in args))
    gated = np.isneginf(want)
    np.testing.assert_array_equal(np.isneginf(got), gated)
    assert gated[1].all() and gated[2].all()          # masked, collinear
    assert (~gated).sum() > 1000
    s4 = (scale.numpy() ** 4)[:, None]
    err = np.abs(np.where(gated, 0.0, got) - np.where(gated, 0.0, want)) / s4
    assert err.max() <= 2e-7, err.max()


def test_plain_version_propagates_nan():
    A, K = 8, 24
    uv, mask, tb = _voxels(5, A, K)
    args, _ = _port_inputs(uv, mask, tb)
    u = args[0].clone()
    u[3, 7] = float("nan")
    out = ik.incircle_min_scores(u, *args[1:])
    tris = args[5]
    has7 = (tris == 7).any(-1)
    # a candidate with the NaN vertex fails its area gate; every other
    # valid candidate of that voxel sweeps the NaN point and scores NaN
    assert torch.isneginf(out[3, has7]).all()
    live = ~torch.isneginf(out[3])
    assert live.any() and torch.isnan(out[3, live]).all()
    assert not torch.isnan(out[4]).any()
    keep = out >= -1e-6
    assert not keep[3].any()


def _incircle_margin(uv, tri, n):
    """f64 oracle: max signed incircle value of any non-vertex point
    (positive ⇒ some point is inside the circumcircle ⇒ not Delaunay); the
    function of tests/test_mesh.py."""
    a, b, c = (uv[i].astype(np.float64) for i in tri)
    area = (b[0] - a[0]) * (c[1] - a[1]) - (b[1] - a[1]) * (c[0] - a[0])
    worst = -np.inf
    for d in range(n):
        if d in tri:
            continue
        q = uv[d].astype(np.float64)
        m = np.array([
            [a[0] - q[0], a[1] - q[1], (a[0] - q[0]) ** 2 + (a[1] - q[1]) ** 2],
            [b[0] - q[0], b[1] - q[1], (b[0] - q[0]) ** 2 + (b[1] - q[1]) ** 2],
            [c[0] - q[0], c[1] - q[1], (c[0] - q[0]) ** 2 + (c[1] - q[1]) ** 2],
        ])
        worst = max(worst, np.linalg.det(m) * np.sign(area))
    return worst


def _sorted_set(tris):
    return {tuple(sorted(t)) for t in np.asarray(tris)}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("n", [8, 20, 40])
def test_delaunay_mask_matches_reference_and_scipy(seed, n):
    from scipy.spatial import Delaunay as SciDelaunay

    rng = np.random.default_rng(seed)
    k = 48
    uv = np.zeros((1, k, 2), np.float32)
    uv[0, :n] = rng.uniform(-0.5, 0.5, (n, 2))
    mask = np.zeros((1, k), bool)
    mask[0, :n] = True

    tris, keep = td.delaunay_mask(torch.from_numpy(uv), torch.from_numpy(mask))
    jtris, jkeep = jd.delaunay_mask(jnp.asarray(uv), jnp.asarray(mask))
    np.testing.assert_array_equal(tris.numpy(), np.asarray(jtris))
    ours = _sorted_set(tris.numpy()[keep[0].numpy()])
    for other in (_sorted_set(np.asarray(jtris)[np.asarray(jkeep[0])]),
                  _sorted_set(SciDelaunay(uv[0, :n].astype(np.float64))
                              .simplices)):
        for t in ours ^ other:
            margin = abs(_incircle_margin(uv[0], t, n))
            assert margin < 1e-5, (t, margin)
    assert len(ours) >= n - 2


def test_collinear_degenerate():
    k = 48
    uv = np.zeros((1, k, 2), np.float32)
    uv[0, :10, 0] = np.linspace(0, 1, 10)
    mask = np.zeros((1, k), bool)
    mask[0, :10] = True
    _, keep = td.delaunay_mask(torch.from_numpy(uv), torch.from_numpy(mask))
    assert int(keep.sum()) == 0


def test_dispatch_raises_on_a_bad_input():
    uv, mask, tb = _voxels(0, 8, 24)
    args, _ = _port_inputs(uv, mask, tb)
    with pytest.raises(TypeError):
        ik.incircle_min_scores(args[0].double(), *args[1:])
    with pytest.raises(ValueError):
        ik.incircle_min_scores(*args[:5], args[5] + 30)
    big = torch.zeros(2, 129)
    with pytest.raises(ValueError):
        ik.incircle_min_scores(big, big, big, big, torch.zeros(2),
                               torch.zeros((1, 3), dtype=torch.int32))


def test_launch_count_is_untouched_by_the_plain_version():
    ik.reset_launches()
    uv, mask, tb = _voxels(0, 8, 24)
    ik.incircle_min_scores(*_port_inputs(uv, mask, tb)[0])
    assert ik.launches == 0
