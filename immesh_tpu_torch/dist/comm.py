"""The collectives of the port's dist/ layer, over torch.distributed.

The JAX package reduces and exchanges inside `shard_map` with
`jax.lax.psum`, `all_gather` and `ppermute`; here each rank is one process
and calls these helpers on its own tensors, with a process group in place
of the mesh axis (None = the default group).

  * `psum` gathers every rank's block and adds the blocks in rank order on
    every rank, instead of `all_reduce`: gloo's and NCCL's reduction
    algorithms do not promise the same bits on every rank, and the ESIKF
    decides on the host whether to iterate again — one rank leaving the
    loop while another enters the next collective is a deadlock.  Summing
    identical gathered blocks in one order gives identical bits everywhere.
  * `all_gather` keeps the static shapes of the JAX gathers (list form,
    which every backend takes).
  * `ppermute` is one `batch_isend_irecv` to rank + shift and from
    rank − shift (mod n); at world 1 the peer is the rank itself, and a
    local copy stands in for JAX handing a chip its own block.

Backend limits are decided from the backend, never from a caught error:
gloo takes CUDA tensors for its collectives but reads point-to-point
buffers from host memory, so `ppermute` stages CUDA tensors through the
host on gloo.  Every staged transfer is counted in `staged`.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

staged = 0  # host-staged transfers since the last reset_counts()


def reset_counts() -> None:
    global staged
    staged = 0


def rank_size(group: Optional[dist.ProcessGroup] = None):
    """(this process's rank in `group`, the group's size)."""
    return dist.get_rank(group), dist.get_world_size(group)


def _to_wire(x: torch.Tensor) -> torch.Tensor:
    # bool travels as uint8 (not every backend reduces or sends bool)
    return (x.to(torch.uint8) if x.dtype == torch.bool else x).contiguous()


def _from_wire(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return x.to(torch.bool) if dtype == torch.bool else x


def all_gather(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None
               ) -> List[torch.Tensor]:
    """Every rank's `x` (same shape and dtype on every rank), in rank
    order."""
    wire = _to_wire(x)
    out = [torch.empty_like(wire) for _ in range(dist.get_world_size(group))]
    dist.all_gather(out, wire, group=group)
    return [_from_wire(o, x.dtype) for o in out]


def all_gather_cat(x: torch.Tensor,
                   group: Optional[dist.ProcessGroup] = None) -> torch.Tensor:
    """Every rank's `x` concatenated along dim 0 in rank order — the
    reshape(-1, …) of a JAX all_gather."""
    return torch.cat(all_gather(x, group), dim=0)


def psum(tensors: Dict[str, torch.Tensor],
         group: Optional[dist.ProcessGroup] = None) -> Dict[str, torch.Tensor]:
    """Σ over ranks of each tensor, bit-identical on every rank: the
    tensors of one dtype travel as one flat block, the gathered blocks are
    added in rank order ((b0 + b1) + b2 …)."""
    out = {}
    by_dtype: Dict[torch.dtype, List[str]] = {}
    for name, t in tensors.items():
        by_dtype.setdefault(t.dtype, []).append(name)
    for names in by_dtype.values():
        flat = torch.cat([tensors[n].reshape(-1) for n in names])
        blocks = all_gather(flat, group)
        acc = blocks[0]
        for b in blocks[1:]:
            acc = acc + b
        off = 0
        for n in names:
            t = tensors[n]
            out[n] = acc[off:off + t.numel()].reshape(t.shape)
            off += t.numel()
    return out


def ppermute(tensors: Sequence[torch.Tensor], shift: int,
             group: Optional[dist.ProcessGroup] = None) -> List[torch.Tensor]:
    """Send `tensors` to rank (r + shift) mod n and return the ones rank
    (r − shift) mod n sent, in one batch of point-to-point operations."""
    global staged
    rank, n = rank_size(group)
    dst, src = (rank + shift) % n, (rank - shift) % n
    if dst == rank:
        return [t.clone() for t in tensors]
    dev = tensors[0].device
    stage = dev.type == "cuda" and dist.get_backend(group) == "gloo"
    wires = [_to_wire(t) for t in tensors]
    if stage:
        wires = [w.cpu() for w in wires]
        staged += 1
    recv = [torch.empty_like(w) for w in wires]
    g_dst = dist.get_global_rank(group, dst) if group is not None else dst
    g_src = dist.get_global_rank(group, src) if group is not None else src
    ops = ([dist.P2POp(dist.isend, w, g_dst, group) for w in wires]
           + [dist.P2POp(dist.irecv, r, g_src, group) for r in recv])
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return [_from_wire(r.to(dev), t.dtype) for r, t in zip(recv, tensors)]
