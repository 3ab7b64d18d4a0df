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

Where the JAX reference returns a new table, the port updates `keys`/`fp`
in place (JAX donated these buffers in joint_step).
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import torch

from immesh_tpu_torch.core.ops import div, set_drop
from immesh_tpu_torch.device import resolve_device

# same primes as the reference's spatial hash (tools_kd_hash.hpp:77)
_P1 = 73856093
_P2 = 19349669
_P3 = 83492791
_P4 = 3145739

EMPTY = 0x7FFFFFFF  # sentinel coordinate for unoccupied slots


def _hash(coords: torch.Tensor, mask: int) -> torch.Tensor:
    """coords: (..., 4) int32 → slot index in [0, capacity). capacity = mask+1."""
    h = (
        coords[..., 0] * _P1
        ^ coords[..., 1] * _P2
        ^ coords[..., 2] * _P3
        ^ coords[..., 3] * _P4
    )
    return h & mask


def _fingerprint(coords: torch.Tensor) -> torch.Tensor:
    """coords: (..., 4) int32 → odd nonzero int32 key fingerprint (Weyl
    constants, forced odd; 0 in the fp array encodes an empty slot)."""
    h = (coords[..., 0] * -1640531527
         + coords[..., 1] * -1274297907
         + coords[..., 2] * -1981354251
         + coords[..., 3] * 1183186591)
    h = h ^ (coords[..., 0] << 13) ^ (coords[..., 2] >> 7)
    return h | 1


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

        Probe rounds run until every lane resolved (found or proven absent)
        or max_probe is reached; each round is one gather + compare."""
        n = coords.shape[0]
        h0 = _hash(coords, self._mask)
        fpq = _fingerprint(coords)
        done = torch.zeros(n, dtype=torch.bool, device=coords.device)
        slot = torch.full((n,), -1, dtype=torch.int32, device=coords.device)
        r = 0
        while r < self.max_probe and not bool(done.all()):
            cand = (h0 + r * fpq) & self._mask
            f = self.fp[cand.long()]
            is_empty = f == 0
            match = f == fpq
            slot = torch.where(~done & match & ~is_empty, cand, slot)
            # empty slot before a match ⇒ key absent (probe-sequence invariant)
            done = done | match | is_empty
            r += 1
        return slot

    # ------------------------------------------------------------------
    def insert(self, coords: torch.Tensor, valid: torch.Tensor):
        """Batched find-or-insert of UNIQUE keys, in place.

        coords: (U, 4), valid: (U,).  Returns (slots, new): slots[i] = -1 for
        invalid entries or on probe/capacity exhaustion; new[i] marks lanes
        that claimed a previously empty slot (the reference reads this off
        the old table as `keys[slot] == EMPTY`).  Keys must be mutually
        unique where valid."""
        u = coords.shape[0]
        dev = coords.device
        h0 = _hash(coords, self._mask)
        fpq = _fingerprint(coords)
        ids = torch.arange(u, dtype=torch.int32, device=dev)
        nowin = 0x3FFFFFFF
        # index `capacity` is the drop lane of the claim scratch
        claim = torch.full((self.capacity + 1,), nowin, dtype=torch.int32,
                           device=dev)
        done = ~valid
        slot = torch.full((u,), -1, dtype=torch.int32, device=dev)
        new = torch.zeros(u, dtype=torch.bool, device=dev)
        r = 0
        while r < self.max_probe and not bool(done.all()):
            cand = (h0 + r * fpq) & self._mask
            k = self.keys[cand.long()]
            is_empty = k[:, 0] == EMPTY
            match = torch.all(k == coords, dim=-1)
            slot = torch.where(~done & match, cand, slot)
            done = done | match

            attempt = ~done & is_empty
            catt = torch.where(attempt, cand, self.capacity).long()
            claim.scatter_reduce_(0, catt, ids, reduce="amin")
            won = attempt & (claim[catt] == ids)
            set_drop(self.keys, cand, coords, won)
            set_drop(self.fp, cand, fpq, won)
            slot = torch.where(won, cand, slot)
            new = new | won
            claim[catt] = nowin  # restore scratch
            done = done | won
            r += 1
        return slot, new

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
    big = torch.tensor(0x7FFFFFFF, dtype=torch.int32, device=dev)
    cols = [torch.where(mask, coords[:, i], big) for i in range(c)]
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


def voxel_coords(pts: torch.Tensor, voxel_size: float,
                 level: int = 0) -> torch.Tensor:
    """World points (N, 3) → int32 key quadruples (N, 4) at the given level
    (floor quantization; level ℓ uses voxel_size / 2^ℓ)."""
    size = voxel_size / (2 ** level)
    c = torch.floor(div(pts, size)).to(torch.int32)
    lvl = torch.full((pts.shape[0], 1), level, dtype=torch.int32,
                     device=pts.device)
    return torch.cat([c, lvl], dim=-1)
