"""Edge-neighbor Delaunay argmin — the CUDA kernel's binding, its plain
PyTorch version, and the rule that picks between them.

Replaces immesh_tpu/mesh/delaunay.py::_pairs_kernel (launched by
`_pairs_argmin_tpu`).  For every voxel a and directed pair i→j:

    W[a, i, j] = first argmin over valid k with d > ε of Np / d, or −1,
    d  = (p_j − p_i) × (p_k − p_i)                    (2·area, k left of i→j)
    Np = (L_k − L_i)·|p_j − p_i|² − ((p_k − p_i)·(p_j − p_i))·(L_j − L_i)

with L the perturbed paraboloid lift; rows with i invalid are all −1, and a
NaN ratio anywhere in a row's k-sweep gives −1 (jnp.min propagates NaN).

Dispatch: a CPU tensor takes `pairs_argmin_plain`; a CUDA tensor launches
the kernel in csrc/pairs_argmin.cu or raises — there is no fallback.

Counts: `launches` the kernel launches the wrapper made, `captured` those it
recorded into a CUDA graph under stream capture (they run at each replay,
not then), and `runs()` the kernel's runs on the device, eager and replayed,
from a counter the kernel itself adds to.
"""

from __future__ import annotations

import ctypes

import torch

from immesh_tpu_torch.kernels import build as _build

NAME = "pairs_argmin"
MAX_K = 128
_BIG = 3.4e38

launches = 0  # kernel launches since the last reset_launches()
captured = 0  # launches recorded into a CUDA graph since then
_build.register_captured(lambda: {"pairs_argmin": captured})
_devices = set()  # the CUDA devices the kernel was launched on


def reset_launches() -> None:
    """launches, captured and the device's run counter to 0."""
    global launches, captured
    launches = captured = 0
    if _lib is not None:
        _build.reset_runs(_lib, NAME, _devices)


def runs() -> int:
    """The kernel's runs on the device since reset_launches(), eager and
    replayed in CUDA graphs (synchronises the devices it ran on)."""
    return 0 if _lib is None else _build.read_runs(_lib, NAME, 1,
                                                   _devices)[0]


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry point's arguments on a loaded library of
    csrc/pairs_argmin.cu."""
    fn = lib.pairs_argmin_launch
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_int,
                                            ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _build.bind_runs(lib, NAME)
    return lib


_lib = None


def _library() -> ctypes.CDLL:
    """The kernel's library, built, loaded and bound at first use."""
    global _lib
    if _lib is None:
        _lib = _bind(_build.load(NAME))
    return _lib


def _launch(lib: ctypes.CDLL, u, v, lift, valid, d_eps, W) -> None:
    """One counted launch on the current stream into the preallocated W
    (in `captured` under stream capture, else in `launches`), without
    checks: pairs_argmin_cuda's last step, and what timing code calls with
    `_library()`."""
    global launches, captured
    A, K = u.shape
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.pairs_argmin_launch(
            u.data_ptr(), v.data_ptr(), lift.data_ptr(), valid.data_ptr(),
            d_eps.data_ptr(), A, K, W.data_ptr(), stream)
        capturing = torch.cuda.is_current_stream_capturing()
    if err != 0:
        raise RuntimeError(
            f"pairs_argmin kernel launch failed: CUDA error {err}")
    _devices.add(u.device.index)
    if capturing:
        captured += 1
    else:
        launches += 1


def pairs_argmin_cuda(u, v, lift, valid, d_eps) -> torch.Tensor:
    """Launch the kernel: (A, K) f32 u, v, lift, valid (1.0/0.0) and (A,)
    f32 d_eps on one CUDA device → W (A, K, K) int32."""
    A, K = u.shape
    for name, x, shape in (("u", u, (A, K)), ("v", v, (A, K)),
                           ("lift", lift, (A, K)), ("valid", valid, (A, K)),
                           ("d_eps", d_eps, (A,))):
        if x.device.type != "cuda" or x.device != u.device:
            raise ValueError(f"{name} must lie on u's CUDA device")
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 0 < K <= MAX_K:
        raise ValueError(f"K={K} outside (0, {MAX_K}]")
    W = torch.empty((A, K, K), dtype=torch.int32, device=u.device)
    if A == 0:
        return W
    _launch(_library(), u, v, lift, valid, d_eps, W)
    return W


def pairs_argmin_plain(u, v, lift, valid, d_eps) -> torch.Tensor:
    """Plain PyTorch version with the kernel's difference formula and
    operation order, looping over the edge tail i so no (A, K, K, K) tensor
    exists.  Same arguments and result as pairs_argmin_cuda."""
    A, K = u.shape
    dev = u.device
    big = torch.tensor(_BIG, dtype=torch.float32, device=dev)
    kio = torch.arange(K, dtype=torch.int32, device=dev)
    kbig = torch.tensor(0x3FFFFFFF, dtype=torch.int32, device=dev)
    ok = valid > 0.0
    okjk = ok[:, :, None] & ok[:, None, :]                  # (A, j, k)
    eps = d_eps[:, None, None]
    W = torch.full((A, K, K), -1, dtype=torch.int32, device=dev)
    # (A, j, 1) and (A, 1, k) views of the channels
    uj, vj, Lj = u[:, :, None], v[:, :, None], lift[:, :, None]
    uk, vk, Lk = u[:, None, :], v[:, None, :], lift[:, None, :]
    for i in range(K):
        ui = u[:, i, None, None]
        vi = v[:, i, None, None]
        Li = lift[:, i, None, None]
        du_j, dv_j, dL_j = uj - ui, vj - vi, Lj - Li
        du_k, dv_k, dL_k = uk - ui, vk - vi, Lk - Li
        d = du_j * dv_k - dv_j * du_k       # 2·area, k left of i→j
        mp = du_k * du_j + dv_k * dv_j      # (p_k−p_i)·(p_j−p_i)
        e2 = du_j * du_j + dv_j * dv_j      # |p_j−p_i|²
        Np = dL_k * e2 - mp * dL_j
        vld = okjk & (d > eps)
        r = torch.where(vld, Np / torch.where(vld, d, 1.0), big)
        best = torch.amin(r, dim=-1)                          # (A, j)
        bk = torch.amin(torch.where(r == best[..., None], kio, kbig), dim=-1)
        row = torch.where(best < big, bk, -1)
        W[:, i, :] = torch.where(ok[:, i, None], row, -1)
    return W


def pairs_argmin(u, v, lift, valid, d_eps) -> torch.Tensor:
    """W (A, K, K) int32: the plain version for CPU tensors, the kernel for
    CUDA tensors."""
    if u.device.type == "cpu":
        return pairs_argmin_plain(u, v, lift, valid, d_eps)
    return pairs_argmin_cuda(u, v, lift, valid, d_eps)
