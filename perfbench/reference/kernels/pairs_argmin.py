"""Edge-neighbor Delaunay argmin, plain PyTorch version.  For every voxel a
and directed pair i→j:

    W[a, i, j] = first argmin over valid k with d > ε of Np / d, or −1,
    d  = (p_j − p_i) × (p_k − p_i)                    (2·area, k left of i→j)
    Np = (L_k − L_i)·|p_j − p_i|² − ((p_k − p_i)·(p_j − p_i))·(L_j − L_i)

with L the perturbed paraboloid lift; rows with i invalid are all −1, and a
NaN ratio anywhere in a row's k-sweep gives −1."""

from __future__ import annotations


import torch


NAME = "pairs_argmin"
MAX_K = 128
_BIG = 3.4e38

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
    return pairs_argmin_plain(u, v, lift, valid, d_eps)
