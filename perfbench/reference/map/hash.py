"""Open-addressing spatial hash table — batched, SoA, updated in place.

Port of immesh_tpu/map/hash.py (reference src/voxel_loc.hpp:106-127 and the
prime-mix `Hash_map_3d`, src/tools/tools_kd_hash.hpp:54-136):

  * keys are raw int32 (kx, ky, kz, level) quadruples; slots and
    fingerprints come from wrapping int32 multiplies, as in the reference;
  * `lookup` is a batched double-hashing probe loop comparing 4 B key
    fingerprints only — a fingerprint collision inside a probe chain
    mis-resolves a lookup persistently until the next compaction, exactly
    like the reference, so the port's slots stay identical to it;
  * `insert` compares full keys and resolves same-slot claims by a
    scatter-min tournament: the lowest lane id wins.

Both probe loops, with the hash arithmetic and voxel_coords, live in
kernels/hash_probe.py: the plain PyTorch loops on the CPU, and on the card
one CUDA kernel launch a call with no host read, as the reference's
`lax.while_loop`s never leave the device.  The plane and mesh maps call
that module's lookup forms, which make their keys from points or slots,
directly.  Where the JAX reference returns a new table, the port updates
`keys`/`fp` in place (JAX donated these buffers in joint_step).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from perfbench.reference.device import resolve_device
from perfbench.reference.kernels import hash_probe
from perfbench.reference.kernels.hash_probe import (  # noqa: F401
    EMPTY, _fingerprint, _hash, voxel_coords)


@dataclass
class HashTable:
    keys: torch.Tensor  # (capacity, 4) int32; keys[:, 0] == EMPTY ⇒ free slot
    fp: torch.Tensor    # (capacity,) int32 key fingerprint; 0 ⇒ free slot
    capacity: int
    max_probe: int

    @classmethod
    def create(cls, capacity: int, max_probe: int = 32,
               device="cuda") -> "HashTable":
        if capacity & (capacity - 1) != 0:
            raise ValueError("capacity must be a power of two")
        if capacity >= 2 ** 31:
            raise ValueError("capacity must fit int32")
        dev = resolve_device(device)
        keys = torch.full((capacity, 4), EMPTY, dtype=torch.int32, device=dev)
        return cls(keys=keys, fp=torch.zeros(capacity, dtype=torch.int32,
                                             device=dev),
                   capacity=capacity, max_probe=max_probe)

    def clone(self) -> "HashTable":
        """A copy of the table that shares no tensor with this one."""
        return replace(self, keys=self.keys.clone(), fp=self.fp.clone())

    @property
    def _mask(self) -> int:
        return self.capacity - 1

    # ------------------------------------------------------------------
    def lookup(self, coords: torch.Tensor) -> torch.Tensor:
        """Batched lookup. coords: (N, 4) int32 → slot: (N,) int32, -1 if absent.

        The probe loop is kernels/hash_probe.py's: its plain version on the
        CPU, one CUDA kernel launch on the card."""
        return hash_probe.lookup(coords.contiguous(), self.fp, self.max_probe)

    # ------------------------------------------------------------------
    def insert(self, coords: torch.Tensor, valid: torch.Tensor):
        """Batched find-or-insert of UNIQUE keys, in place.

        coords: (U, 4), valid: (U,).  Returns (slots, new): slots[i] = -1 for
        invalid entries or on probe/capacity exhaustion; new[i] marks lanes
        that claimed a previously empty slot (the reference reads this off
        the old table as `keys[slot] == EMPTY`).  Keys must be mutually
        unique where valid.  The probe rounds are kernels/hash_probe.py's."""
        return hash_probe.insert(coords.contiguous(), valid.contiguous(),
                                 self.keys, self.fp, self.max_probe)

    def occupancy(self) -> torch.Tensor:
        return torch.sum(self.keys[:, 0] != EMPTY)


def frame_unique_coords(coords: torch.Tensor, mask: torch.Tensor, k: int):
    """Exact first-occurrence dedup of int32 coordinate rows within one frame.

    coords: (N, C) int32 rows; mask: (N,) validity.  Returns (seg, first,
    n_uniq) exactly as immesh_tpu.map.hash.frame_unique_coords: seg (N,) ∈
    [0, k] in coordinate-sorted order (k ⇒ invalid or overflow), first (k,)
    the lowest input row of each unique key (N ⇒ pad), n_uniq the true
    number of distinct valid keys.  The reference's one lexicographic
    `lax.sort(num_keys=C)` is chained stable sorts, last key first."""
    n, c = coords.shape
    dev = coords.device
    cols = [torch.where(mask, coords[:, i], 0x7FFFFFFF) for i in range(c)]
    order = torch.arange(n, device=dev)
    for col in reversed(cols):
        order = order[torch.argsort(col[order], stable=True)]
    diff = torch.zeros(n - 1, dtype=torch.bool, device=dev)
    for col in cols:
        sc = col[order]
        diff = diff | (sc[1:] != sc[:-1])
    head = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), diff])
    rank = torch.cumsum(head.to(torch.int32), 0, dtype=torch.int32) - 1
    valid_s = mask[order]
    segs = torch.where(valid_s & (rank < k), rank, k)
    seg = torch.empty(n, dtype=torch.int32, device=dev)
    seg[order] = segs
    first = torch.full((k + 1,), n, dtype=torch.int32, device=dev)
    first.scatter_reduce_(0, segs.long(), order.to(torch.int32), reduce="amin")
    n_uniq = torch.sum((head & valid_s).to(torch.int32))
    return seg, first[:k], n_uniq
