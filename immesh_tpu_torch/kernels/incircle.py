"""Delaunay incircle min-score — the CUDA kernel's binding, its plain PyTorch
version, and the rule that picks between them.

Replaces immesh_tpu/mesh/delaunay.py::_incircle_kernel (launched by
`_incircle_min_scores`).  For every voxel a and candidate triangle
t = (ia, ib, ic) of the shared (T, 3) table:

    out[a, t] = min_k (nx·u_k·w_k + ny·v_k·w_k + nz·L_k·w_k − off·w_k)

over the CCW-oriented lifted plane (nx, ny, nz, −off) through the three
vertices, with L the perturbed paraboloid lift and w the 1/0 validity; −inf
where a vertex is masked or |2·area| ≤ min_area[a], NaN where a score in the
sweep is NaN (jnp.min propagates it).  The operation order is written down
in csrc/incircle.cu; the plain version repeats it.

Dispatch: a CPU tensor takes `incircle_min_scores_plain`; a CUDA tensor
launches the kernel in csrc/incircle.cu or raises — there is no fallback.
"""

from __future__ import annotations

import ctypes

import torch

from immesh_tpu_torch.kernels import build as _build

NAME = "incircle"
MAX_K = 128
TILE = 1024  # candidates per step of the plain version

launches = 0  # kernel launches since the last reset_launches()


def reset_launches() -> None:
    global launches
    launches = 0


_lib = None


def _library() -> ctypes.CDLL:
    """The kernel's library, built, loaded and its entry point's arguments
    declared at first use."""
    global _lib
    if _lib is None:
        lib = _build.load(NAME)
        lib.incircle_launch.argtypes = [ctypes.c_void_p] * 6 + [
            ctypes.c_int] * 3 + [ctypes.c_void_p, ctypes.c_void_p]
        lib.incircle_launch.restype = ctypes.c_int
        _lib = lib
    return _lib


def _launch(u, v, lift, w, min_area, tris, out) -> None:
    """One counted launch on the current stream into the preallocated out,
    without checks: incircle_min_scores_cuda's last step, and what timing
    code calls."""
    global launches
    A, K = u.shape
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _library().incircle_launch(
            u.data_ptr(), v.data_ptr(), lift.data_ptr(), w.data_ptr(),
            min_area.data_ptr(), tris.data_ptr(), A, K, tris.shape[0],
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"incircle kernel launch failed: CUDA error {err}")
    launches += 1


def _check(u, v, lift, w, min_area, tris, cuda: bool):
    A, K = u.shape
    T = tris.shape[0]
    for name, x, shape, dtype in (
            ("u", u, (A, K), torch.float32), ("v", v, (A, K), torch.float32),
            ("lift", lift, (A, K), torch.float32),
            ("w", w, (A, K), torch.float32),
            ("min_area", min_area, (A,), torch.float32),
            ("tris", tris, (T, 3), torch.int32)):
        if x.device != u.device or (cuda and x.device.type != "cuda"):
            raise ValueError(f"{name} must lie on u's CUDA device")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0 < K <= MAX_K:
        raise ValueError(f"K={K} outside (0, {MAX_K}]")
    if T and (int(tris.min()) < 0 or int(tris.max()) >= K):
        raise ValueError(f"tris holds a vertex index outside [0, {K})")
    # the kernel folds masked points in as exact zeros (csrc/incircle.cu)
    if bool(((w != 0.0) & (w != 1.0)).any()):
        raise ValueError("w holds a value other than 1.0 and 0.0")


def incircle_min_scores_cuda(u, v, lift, w, min_area, tris) -> torch.Tensor:
    """Launch the kernel: (A, K) f32 u, v, lift, w (1.0/0.0), (A,) f32
    min_area and a (T, 3) int32 candidate table on one CUDA device →
    (A, T) f32 min scores."""
    _check(u, v, lift, w, min_area, tris, cuda=True)
    A, K = u.shape
    T = tris.shape[0]
    out = torch.empty((A, T), dtype=torch.float32, device=u.device)
    if A == 0 or T == 0:
        return out
    _launch(u, v, lift, w, min_area, tris, out)
    return out


def incircle_min_scores_plain(u, v, lift, w, min_area, tris) -> torch.Tensor:
    """Plain PyTorch version with the kernel's formula and operation order,
    looping over tiles of TILE candidates so that no (A, T, K) tensor
    exists.  Same arguments and result as incircle_min_scores_cuda."""
    _check(u, v, lift, w, min_area, tris, cuda=False)
    A, K = u.shape
    T = tris.shape[0]
    out = torch.empty((A, T), dtype=torch.float32, device=u.device)
    uw, vw, lw = u * w, v * w, lift * w                   # (A, K)
    uw, vw, lw, wk = (x[:, None, :] for x in (uw, vw, lw, w))
    neg_inf = torch.tensor(-float("inf"), dtype=torch.float32,
                           device=u.device)
    for t0 in range(0, T, TILE):
        tri = tris[t0:t0 + TILE].long()
        ia, ib, ic = tri[:, 0], tri[:, 1], tri[:, 2]
        ua, va, la = u[:, ia], v[:, ia], lift[:, ia]      # (A, t)
        e1u, e1v, e1l = u[:, ib] - ua, v[:, ib] - va, lift[:, ib] - la
        e2u, e2v, e2l = u[:, ic] - ua, v[:, ic] - va, lift[:, ic] - la
        area2 = e1u * e2v - e1v * e2u
        ccw = torch.sign(area2)
        nx = (e1v * e2l - e1l * e2v) * ccw
        ny = (e1l * e2u - e1u * e2l) * ccw
        nz = area2 * ccw
        off = (nx * ua + ny * va) + nz * la
        s = (((nx[..., None] * uw + ny[..., None] * vw) + nz[..., None] * lw)
             - off[..., None] * wk)                       # (A, t, K)
        min_s = torch.amin(s, dim=-1)
        ok = ((w[:, ia] > 0) & (w[:, ib] > 0) & (w[:, ic] > 0)
              & (torch.abs(area2) > min_area[:, None]))
        out[:, t0:t0 + TILE] = torch.where(ok, min_s, neg_inf)
    return out


def incircle_min_scores(u, v, lift, w, min_area, tris) -> torch.Tensor:
    """(A, T) f32 min scores: the plain version for CPU tensors, the kernel
    for CUDA tensors."""
    if u.device.type == "cpu":
        return incircle_min_scores_plain(u, v, lift, w, min_area, tris)
    return incircle_min_scores_cuda(u, v, lift, w, min_area, tris)
