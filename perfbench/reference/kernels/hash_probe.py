"""Batched probes of the open-addressing spatial hash table: the plain
PyTorch versions only (lookup in its four forms, insert), run for every
device."""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from perfbench.reference.core.ops import div, set_drop

NAME = "hash_probe"

# same primes as the reference's spatial hash (tools_kd_hash.hpp:77)
_P1 = 73856093
_P2 = 19349669
_P3 = 83492791
_P4 = 3145739

EMPTY = 0x7FFFFFFF  # sentinel coordinate for unoccupied slots
# the largest insert the cluster form takes: a cluster of 8 blocks of 1,024
# threads, two lanes a thread (csrc/hash_probe.cu's kClusterMaxLanes)
CLUSTER_MAX_LANES = 16384
INSERT_PATHS = {"grid": 0, "cluster": 1}  # the C entry point's `path`
_NOWIN = 0x3FFFFFFF  # the plain insert's claim scratch when no lane claims

# the 3×3×3 neighbourhood offsets in meshgrid "ij" order; the kernel's
# j ↦ (j // 9 − 1, j // 3 % 3 − 1, j % 3 − 1)
_OFFS = np.stack(np.meshgrid(
    np.arange(-1, 2), np.arange(-1, 2), np.arange(-1, 2), indexing="ij"
), axis=-1).reshape(27, 3).astype(np.int32)
_OFFS_ON: Dict[torch.device, torch.Tensor] = {}

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


def voxel_coords(pts: torch.Tensor, voxel_size: float,
                 level: int = 0) -> torch.Tensor:
    """World points (N, 3) → int32 key quadruples (N, 4) at the given level
    (floor quantization; level ℓ uses voxel_size / 2^ℓ)."""
    size = voxel_size / (2 ** level)
    c = torch.floor(div(pts, size)).to(torch.int32)
    lvl = torch.full((pts.shape[0], 1), level, dtype=torch.int32,
                     device=pts.device)
    return torch.cat([c, lvl], dim=-1)


def level_sizes(voxel_size: float, levels: int) -> np.ndarray:
    """The f32 voxel edge of each level as voxel_coords divides by it:
    Python's float64 voxel_size / 2^ℓ rounded once to f32 (what
    torch.full((), ·, float32) holds)."""
    return np.array([voxel_size / (2 ** lvl) for lvl in range(levels)],
                    np.float32)


def _neighbor_offsets(device) -> torch.Tensor:
    """_OFFS on `device`, copied there once (a copy from the host's pageable
    memory is refused under stream capture, so the mesh step's first,
    eager frame makes it)."""
    dev = torch.device(device)
    offs = _OFFS_ON.get(dev)
    if offs is None:
        offs = _OFFS_ON[dev] = torch.from_numpy(_OFFS).to(dev)
    return offs


def _neighbor_keys(keys: torch.Tensor) -> torch.Tensor:
    """(A, 4) voxel keys → (A·27, 4) keys of their 3×3×3 neighborhoods."""
    A = keys.shape[0]
    nb = keys[:, None, :3] + _neighbor_offsets(keys.device)[None]
    z = torch.zeros((A, 27, 1), dtype=torch.int32, device=keys.device)
    return torch.cat([nb, z], dim=-1).reshape(A * 27, 4)


# ---------------------------------------------------------------------------
# plain versions: the CPU path and the kernels' oracle
# ---------------------------------------------------------------------------
def lookup_plain(coords: torch.Tensor, fp: torch.Tensor,
                 max_probe: int) -> torch.Tensor:
    """coords (N, 4) int32, fp (capacity,) int32 → slot (N,) int32, −1 if
    absent.  Probe rounds run until every lane resolved (found or proven
    absent) or max_probe is reached; each round is one gather + compare."""
    n = coords.shape[0]
    mask = fp.shape[0] - 1
    h0 = _hash(coords, mask)
    fpq = _fingerprint(coords)
    done = torch.zeros(n, dtype=torch.bool, device=coords.device)
    slot = torch.full((n,), -1, dtype=torch.int32, device=coords.device)
    r = 0
    while r < max_probe and not bool(done.all()):
        cand = (h0 + r * fpq) & mask
        f = fp[cand.long()]
        is_empty = f == 0
        match = f == fpq
        slot = torch.where(~done & match & ~is_empty, cand, slot)
        # empty slot before a match ⇒ key absent (probe-sequence invariant)
        done = done | match | is_empty
        r += 1
    return slot


def _descend(s_all: torch.Tensor, plane_valid: torch.Tensor,
             subdivided: torch.Tensor):
    """(found, slot) of each lane's level descent over its (L, ...) lookup
    slots: the coarsest level whose voxel is planar, descending only
    through present, subdivided voxels (VoxelMap.query_planes)."""
    shape, dev = s_all.shape[1:], s_all.device
    slot = torch.zeros(shape, dtype=torch.int32, device=dev)
    found = torch.zeros(shape, dtype=torch.bool, device=dev)
    descend = torch.ones(shape, dtype=torch.bool, device=dev)
    for s in s_all:
        sc = s.clamp(min=0)
        present = descend & (s >= 0)
        use = present & plane_valid[sc.long()] & ~found
        slot = torch.where(use, sc, slot)
        found = found | use
        descend = present & subdivided[sc.long()]
    return found, slot


def lookup_planes_plain(q: torch.Tensor, voxel_size: float, levels: int,
                        fp: torch.Tensor, plane_valid: torch.Tensor,
                        subdivided: torch.Tensor, max_probe: int,
                        near: bool):
    """(found (N,) bool, slot (N,) int32) of the multi-level plane lookup of
    the (N, 3) points q: VoxelMap.lookup_planes_stack's one batched probe
    of every level's keys and its descent.  near=True adds
    lio/association.py's near-voxel probe, shifted one voxel on every axis
    where the point lies in the outer quarter, taken where the point's own
    descent found no plane (its own voxel absent included); slot is 0
    where nothing was found."""
    if near:
        qs = div(q, voxel_size)
        frac = qs - torch.floor(qs) - 0.5  # ∈ [-0.5, 0.5)
        shift = torch.where(torch.abs(frac) > 0.25, torch.sign(frac),
                            torch.zeros_like(frac)) * voxel_size
        probes = torch.stack([q, q + shift], dim=0)
    else:
        probes = q[None]
    P, N, _ = probes.shape
    flat = probes.reshape(P * N, 3)
    keys = torch.cat([voxel_coords(flat, voxel_size, lvl)
                      for lvl in range(levels)], dim=0)  # (L·P·N, 4)
    s_all = lookup_plain(keys, fp, max_probe).reshape(levels, P, N)
    found_s, slot_s = _descend(s_all, plane_valid, subdivided)
    if not near:
        return found_s[0], slot_s[0]
    take = ~found_s[0] & found_s[1]
    slot = torch.where(take, slot_s[1], slot_s[0])
    return found_s[0] | take, slot


def lookup_parent_plain(pts: torch.Tensor, voxel_size: float, level: int,
                        fp: torch.Tensor, subdivided: torch.Tensor,
                        mask: torch.Tensor, max_probe: int) -> torch.Tensor:
    """mask & (each point's voxel at `level` is present and subdivided):
    the (N,) bool mask of refinement level `level` + 1 in
    VoxelMap.update_levels, from the (N, 3) points and level `level`'s."""
    parent = lookup_plain(voxel_coords(pts, voxel_size, level), fp,
                          max_probe)
    return mask & (parent >= 0) & subdivided[parent.clamp(min=0).long()]


def lookup_neighbors_plain(slots: torch.Tensor, keys: torch.Tensor,
                           fp: torch.Tensor, max_probe: int) -> torch.Tensor:
    """(A·27,) int32 slots of the 3×3×3 neighbourhoods of the table's (A,)
    slots (keys[slots] + each _OFFS row, 4th column 0), −1 where absent."""
    return lookup_plain(_neighbor_keys(keys[slots.long()]), fp, max_probe)


def insert_plain(coords: torch.Tensor, valid: torch.Tensor,
                 keys: torch.Tensor, fp: torch.Tensor, max_probe: int):
    """Find-or-insert of the (U, 4) int32 keys where valid (U,) bool, into
    keys (capacity, 4) and fp (capacity,) in place.  Returns (slots, new):
    slots −1 for invalid lanes and on exhaustion, new where the lane claimed
    a previously empty slot.  Same-slot claims go to the lowest lane id by a
    scatter-min tournament."""
    u = coords.shape[0]
    dev = coords.device
    capacity = fp.shape[0]
    mask = capacity - 1
    h0 = _hash(coords, mask)
    fpq = _fingerprint(coords)
    ids = torch.arange(u, dtype=torch.int32, device=dev)
    # index `capacity` is the drop lane of the claim scratch
    claim = torch.full((capacity + 1,), _NOWIN, dtype=torch.int32,
                       device=dev)
    done = ~valid
    slot = torch.full((u,), -1, dtype=torch.int32, device=dev)
    new = torch.zeros(u, dtype=torch.bool, device=dev)
    r = 0
    while r < max_probe and not bool(done.all()):
        cand = (h0 + r * fpq) & mask
        k = keys[cand.long()]
        is_empty = k[:, 0] == EMPTY
        match = torch.all(k == coords, dim=-1)
        slot = torch.where(~done & match, cand, slot)
        done = done | match

        attempt = ~done & is_empty
        catt = torch.where(attempt, cand, capacity).long()
        claim.scatter_reduce_(0, catt, ids, reduce="amin")
        won = attempt & (claim[catt] == ids)
        set_drop(keys, cand, coords, won)
        set_drop(fp, cand, fpq, won)
        slot = torch.where(won, cand, slot)
        new = new | won
        claim[catt] = _NOWIN  # restore scratch
        done = done | won
        r += 1
    return slot, new


def lookup(coords: torch.Tensor, fp: torch.Tensor,
           max_probe: int) -> torch.Tensor:
    """slot (N,) int32: the plain version for CPU tensors, the kernel for
    CUDA tensors."""
    return lookup_plain(coords, fp, max_probe)


def lookup_planes(q: torch.Tensor, voxel_size: float, levels: int,
                  fp: torch.Tensor, plane_valid: torch.Tensor,
                  subdivided: torch.Tensor, max_probe: int, near: bool):
    """(found, slot) of the plane map's descent (lookup_planes_plain): the
    plain version for CPU tensors, the kernel for CUDA tensors."""
    return lookup_planes_plain(q, voxel_size, levels, fp, plane_valid,
                                   subdivided, max_probe, near)


def lookup_parent(pts: torch.Tensor, voxel_size: float, level: int,
                  fp: torch.Tensor, subdivided: torch.Tensor,
                  mask: torch.Tensor, max_probe: int) -> torch.Tensor:
    """The next refinement level's mask (lookup_parent_plain): the plain
    version for CPU tensors, the kernel for CUDA tensors."""
    return lookup_parent_plain(pts, voxel_size, level, fp, subdivided,
                                   mask, max_probe)


def lookup_neighbors(slots: torch.Tensor, keys: torch.Tensor,
                     fp: torch.Tensor, max_probe: int) -> torch.Tensor:
    """The (A·27,) neighbourhood slots (lookup_neighbors_plain): the plain
    version for CPU tensors, the kernel for CUDA tensors."""
    return lookup_neighbors_plain(slots, keys, fp, max_probe)


def insert(coords: torch.Tensor, valid: torch.Tensor, keys: torch.Tensor,
           fp: torch.Tensor, max_probe: int):
    """(slots, new), keys and fp updated in place: the plain version for CPU
    tensors, the kernel for CUDA tensors."""
    return insert_plain(coords, valid, keys, fp, max_probe)
