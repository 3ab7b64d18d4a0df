"""Batched probes of the open-addressing spatial hash table — the CUDA
kernels' bindings, their plain PyTorch versions, and the rule that picks
between them.

Replaces the reference's two on-device probe loops, the `lax.while_loop`s of
immesh_tpu/map/hash.py's HashTable.lookup (:127) and HashTable.insert
(:186).  Both walk the double-hashing sequence

    cand_r = (_hash(key) + r · _fingerprint(key)) & (capacity − 1),  r < max_probe

  * lookup: a lane stops at the first slot whose 4 B fingerprint equals its
    own (found) or is 0 (absent, −1).  Only fingerprints are compared, so a
    collision inside a probe chain aliases the lookup, as in the reference;
  * insert: round-synchronous find-or-insert of unique keys.  In round r
    every unresolved lane reads `keys` as round r − 1 left them, takes the
    slot on a full-key match, and among the lanes that attempt one empty
    slot the lowest lane id wins and writes keys and fp in place.

The lookup has four launch forms, each taking its input as its caller
holds it and returning what the caller's torch code returns; that code is
each form's plain version (`*_plain`), built on lookup_plain:
  * lookup (coords): (N, 4) int32 keys → slots (HashTable.lookup, which
    no path of the port calls since the other forms took its callers);
  * lookup_planes: (N, 3) points → (found, slot) of the plane map's
    descent through its levels, with the near-voxel probe of
    lio/association.py (near=True) or without (near=False:
    VoxelMap.lookup_planes_stack, query_planes);
  * lookup_parent: VoxelMap.update_levels' parent probe, a refinement
    level's mask from the points' voxels one level up;
  * lookup_neighbors: the 3×3×3 neighbourhoods of a mesh voxel table's
    slots (GlobalPointMap._dilate_active, _neighborhood).
On the card each is one launch that makes its keys, probes and reduces.
The coords form's launch is a programmatic dependent of the stream's
previous kernel.

Dispatch: a CPU tensor takes the plain version; a CUDA tensor launches the
kernel in csrc/hash_probe.cu or raises — there is no fallback.  An insert
of u lanes takes one of the kernel's two forms by u alone (insert_path):
up to CLUSTER_MAX_LANES one thread block or one thread-block cluster with
block and cluster barriers ("cluster"; every per-frame insert), above it
one cooperative launch with grid barriers ("grid"; a compaction's
rebuild).  Both give the same bits; a refused launch raises.

Counts, by kernel: `launches` the launches the wrappers made, `captured`
those they recorded into a CUDA graph under stream capture (they run at
each replay, not then), and `runs()` the kernels' runs on the device, eager
and replayed, from counters the kernels themselves add to.
"""

from __future__ import annotations

import ctypes
from typing import Dict

import numpy as np
import torch

from immesh_tpu_torch.core.ops import div, set_drop
from immesh_tpu_torch.kernels import build as _build

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

# kernel launches by kernel since the last reset_launches(), and those
# recorded into a CUDA graph since then, in the order of the device's run
# counters (csrc/hash_probe.cu's kRun*)
KERNELS = ("hash_lookup", "hash_insert", "hash_lookup_planes",
           "hash_lookup_parent", "hash_lookup_neighbors")
launches = dict.fromkeys(KERNELS, 0)
captured = dict.fromkeys(KERNELS, 0)
# the insert launches recorded into a CUDA graph since then, by form
captured_paths = {"grid": 0, "cluster": 0}
_build.register_captured(lambda: dict(captured))
_devices = set()  # the CUDA devices the kernels were launched on


def reset_launches() -> None:
    """launches, captured and the device's run counters to 0."""
    for name in launches:
        launches[name] = captured[name] = 0
    for path in captured_paths:
        captured_paths[path] = 0
    if _lib is not None:
        _build.reset_runs(_lib, NAME, _devices)


def runs() -> dict:
    """Each kernel's runs on the device since reset_launches(), eager and
    replayed in CUDA graphs (synchronises the devices they ran on)."""
    n = ([0] * len(KERNELS) if _lib is None else
         _build.read_runs(_lib, NAME, len(KERNELS), _devices))
    return dict(zip(KERNELS, n))


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


# ---------------------------------------------------------------------------
# the CUDA kernels
# ---------------------------------------------------------------------------
def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C entry points' arguments on a loaded library of
    csrc/hash_probe.cu."""
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.hash_lookup_launch.argtypes = [p, p, i, i, i, p, p]
    lib.hash_insert_launch.argtypes = [p, p, i, p, p, i, i, p, p, p, i, p]
    lib.hash_lookup_planes_launch.argtypes = [p, i, p, i, i, p, i, p, p, i,
                                              p, p, p]
    lib.hash_lookup_parent_launch.argtypes = [p, i, f, i, p, i, p, p, i, p, p]
    lib.hash_lookup_neighbors_launch.argtypes = [p, i, p, p, i, i, p, p]
    for fn in ("hash_lookup_launch", "hash_insert_launch",
               "hash_lookup_planes_launch", "hash_lookup_parent_launch",
               "hash_lookup_neighbors_launch"):
        getattr(lib, fn).restype = i
    lib.hash_probe_run_kinds.argtypes = []
    lib.hash_probe_run_kinds.restype = i
    if lib.hash_probe_run_kinds() != len(KERNELS):
        raise RuntimeError(f"{NAME}: the library counts "
                           f"{lib.hash_probe_run_kinds()} kernels' runs, "
                           f"KERNELS names {len(KERNELS)}")
    lib.hash_lookup_planes_max_levels.argtypes = []
    lib.hash_lookup_planes_max_levels.restype = i
    lib.hash_insert_cluster_max_lanes.argtypes = []
    lib.hash_insert_cluster_max_lanes.restype = i
    if lib.hash_insert_cluster_max_lanes() != CLUSTER_MAX_LANES:
        raise RuntimeError(f"{NAME}: the library's cluster form takes "
                           f"{lib.hash_insert_cluster_max_lanes()} lanes, "
                           f"CLUSTER_MAX_LANES says {CLUSTER_MAX_LANES}")
    _build.bind_runs(lib, NAME)
    return lib


_lib = None


def _library() -> ctypes.CDLL:
    """The kernels' library, built, loaded and bound at first use."""
    global _lib
    if _lib is None:
        _lib = _bind(_build.load(NAME))
    return _lib


def _check(err: int, name: str, device, capturing: bool) -> None:
    """Raise on a launch's error; else count it, in `captured` under
    stream capture."""
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    _devices.add(device.index)
    (captured if capturing else launches)[name] += 1


def _stream_launch(device, name: str, fn, *args) -> bool:
    """Call the C entry point fn(*args, stream) on `device`'s current
    stream and count the launch (_check).  Returns whether the stream was
    capturing."""
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*args, stream)
        capturing = torch.cuda.is_current_stream_capturing()
    _check(err, name, device, capturing)
    return capturing


def _launch_lookup(lib, coords, fp, max_probe: int, slot) -> None:
    """One counted lookup launch on the current stream into the
    preallocated slot, without checks: lookup_cuda's last step, and what
    timing code calls with `_library()`."""
    _stream_launch(coords.device, "hash_lookup", lib.hash_lookup_launch,
                   coords.data_ptr(), fp.data_ptr(), coords.shape[0],
                   fp.shape[0], max_probe, slot.data_ptr())


def _launch_planes(lib, q, sizes: np.ndarray, near: bool, fp, plane_valid,
                   subdivided, max_probe: int, found, slot) -> None:
    """One counted planes-form launch into the preallocated found and slot,
    without checks (sizes: level_sizes', f32, passed by value)."""
    _stream_launch(
        q.device, "hash_lookup_planes", lib.hash_lookup_planes_launch,
        q.data_ptr(), q.shape[0], sizes.ctypes.data, sizes.shape[0],
        int(near), fp.data_ptr(), fp.shape[0], plane_valid.data_ptr(),
        subdivided.data_ptr(), max_probe, found.data_ptr(), slot.data_ptr())


def _launch_parent(lib, pts, size: float, level: int, fp, subdivided, mask,
                   max_probe: int, out) -> None:
    """One counted parent-form launch into the preallocated out, without
    checks (size: the level's f32 edge)."""
    _stream_launch(
        pts.device, "hash_lookup_parent", lib.hash_lookup_parent_launch,
        pts.data_ptr(), pts.shape[0], size, level, fp.data_ptr(),
        fp.shape[0], subdivided.data_ptr(), mask.data_ptr(), max_probe,
        out.data_ptr())


def _launch_neighbors(lib, slots, keys, fp, max_probe: int, out) -> None:
    """One counted neighbours-form launch into the preallocated out,
    without checks."""
    _stream_launch(
        slots.device, "hash_lookup_neighbors",
        lib.hash_lookup_neighbors_launch, slots.data_ptr(), slots.shape[0],
        keys.data_ptr(), fp.data_ptr(), fp.shape[0], max_probe,
        out.data_ptr())


def insert_path(u: int) -> str:
    """The insert kernel's form for u lanes: "cluster" (one block, or one
    cluster of 2, 4 or 8 blocks) up to CLUSTER_MAX_LANES, else "grid" (the
    cooperative launch)."""
    return "cluster" if u <= CLUSTER_MAX_LANES else "grid"


def _launch_insert(lib, coords, valid, keys, fp, max_probe: int, slot, new,
                   flags, path: str = None) -> None:
    """One counted insert launch on the current stream, without checks, in
    the form `path` (insert_path's by default; flags: (max_probe,) int32
    scratch of the "grid" form, None for the other)."""
    path = insert_path(coords.shape[0]) if path is None else path
    if _stream_launch(
            coords.device, "hash_insert", lib.hash_insert_launch,
            coords.data_ptr(), valid.data_ptr(), coords.shape[0],
            keys.data_ptr(), fp.data_ptr(), fp.shape[0], max_probe,
            slot.data_ptr(), new.data_ptr(),
            None if flags is None else flags.data_ptr(), INSERT_PATHS[path]):
        captured_paths[path] += 1


def _check_inputs(dev, specs) -> None:
    for name, x, dtype, shape in specs:
        if x.device.type != "cuda" or x.device != dev:
            raise ValueError(f"{name} must lie on coords' CUDA device")
        if x.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} has shape {tuple(x.shape)}, "
                             f"expected {shape}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_table(fp: torch.Tensor, max_probe: int) -> int:
    cap = fp.shape[0]
    if cap <= 0 or cap & (cap - 1) or cap >= 2 ** 31:
        raise ValueError(f"capacity {cap} is not a power of two below 2^31")
    if max_probe < 0:
        raise ValueError(f"max_probe={max_probe} < 0")
    return cap


def lookup_cuda(coords: torch.Tensor, fp: torch.Tensor,
                max_probe: int) -> torch.Tensor:
    """Launch the lookup kernel: same arguments and result as lookup_plain,
    on one CUDA device."""
    cap = _check_table(fp, max_probe)
    n = coords.shape[0]
    _check_inputs(coords.device, (("coords", coords, torch.int32, (n, 4)),
                                  ("fp", fp, torch.int32, (cap,))))
    slot = torch.empty(n, dtype=torch.int32, device=coords.device)
    if n == 0:
        return slot
    _launch_lookup(_library(), coords, fp, max_probe, slot)
    return slot


def lookup_planes_cuda(q: torch.Tensor, voxel_size: float, levels: int,
                       fp: torch.Tensor, plane_valid: torch.Tensor,
                       subdivided: torch.Tensor, max_probe: int,
                       near: bool):
    """Launch the planes form: same arguments and result as
    lookup_planes_plain, on one CUDA device."""
    cap = _check_table(fp, max_probe)
    n = q.shape[0]
    _check_inputs(q.device, (("q", q, torch.float32, (n, 3)),
                             ("fp", fp, torch.int32, (cap,)),
                             ("plane_valid", plane_valid, torch.bool, (cap,)),
                             ("subdivided", subdivided, torch.bool, (cap,))))
    most = _library().hash_lookup_planes_max_levels()
    if not 1 <= levels <= most:
        raise ValueError(f"levels={levels} is not in [1, {most}]")
    found = torch.empty(n, dtype=torch.bool, device=q.device)
    slot = torch.empty(n, dtype=torch.int32, device=q.device)
    if n:
        _launch_planes(_library(), q, level_sizes(voxel_size, levels), near,
                       fp, plane_valid, subdivided, max_probe, found, slot)
    return found, slot


def lookup_parent_cuda(pts: torch.Tensor, voxel_size: float, level: int,
                       fp: torch.Tensor, subdivided: torch.Tensor,
                       mask: torch.Tensor, max_probe: int) -> torch.Tensor:
    """Launch the parent form: same arguments and result as
    lookup_parent_plain, on one CUDA device."""
    cap = _check_table(fp, max_probe)
    n = pts.shape[0]
    _check_inputs(pts.device, (("pts", pts, torch.float32, (n, 3)),
                               ("fp", fp, torch.int32, (cap,)),
                               ("subdivided", subdivided, torch.bool, (cap,)),
                               ("mask", mask, torch.bool, (n,))))
    out = torch.empty(n, dtype=torch.bool, device=pts.device)
    if n:
        size = float(level_sizes(voxel_size, level + 1)[level])
        _launch_parent(_library(), pts, size, level, fp, subdivided, mask,
                       max_probe, out)
    return out


def lookup_neighbors_cuda(slots: torch.Tensor, keys: torch.Tensor,
                          fp: torch.Tensor, max_probe: int) -> torch.Tensor:
    """Launch the neighbours form: same arguments and result as
    lookup_neighbors_plain, on one CUDA device (slots in [−capacity,
    capacity), as torch's indexing takes them)."""
    cap = _check_table(fp, max_probe)
    a = slots.shape[0]
    _check_inputs(slots.device, (("slots", slots, torch.int32, (a,)),
                                 ("keys", keys, torch.int32, (cap, 4)),
                                 ("fp", fp, torch.int32, (cap,))))
    if keys.data_ptr() % 16:
        raise ValueError("keys must be 16-byte aligned (one row a load)")
    out = torch.empty(a * 27, dtype=torch.int32, device=slots.device)
    if a:
        _launch_neighbors(_library(), slots, keys, fp, max_probe, out)
    return out


def insert_cuda(coords: torch.Tensor, valid: torch.Tensor, keys: torch.Tensor,
                fp: torch.Tensor, max_probe: int, path: str = None):
    """Launch the insert kernel: same arguments, in-place updates and result
    as insert_plain, on one CUDA device; in insert_path's form, or in
    `path` (the "cluster" form refuses more than CLUSTER_MAX_LANES)."""
    cap = _check_table(fp, max_probe)
    u = coords.shape[0]
    _check_inputs(coords.device, (("coords", coords, torch.int32, (u, 4)),
                                  ("valid", valid, torch.bool, (u,)),
                                  ("keys", keys, torch.int32, (cap, 4)),
                                  ("fp", fp, torch.int32, (cap,))))
    if keys.data_ptr() % 16:
        raise ValueError("keys must be 16-byte aligned (one row a load)")
    dev = coords.device
    slot = torch.empty(u, dtype=torch.int32, device=dev)
    new = torch.empty(u, dtype=torch.bool, device=dev)
    if u == 0:
        return slot, new
    path = insert_path(u) if path is None else path
    if path not in INSERT_PATHS:
        raise ValueError(f"path {path!r} is none of {sorted(INSERT_PATHS)}")
    flags = (torch.empty(max_probe, dtype=torch.int32, device=dev)
             if path == "grid" else None)
    _launch_insert(_library(), coords, valid, keys, fp, max_probe, slot, new,
                   flags, path)
    return slot, new


def lookup(coords: torch.Tensor, fp: torch.Tensor,
           max_probe: int) -> torch.Tensor:
    """slot (N,) int32: the plain version for CPU tensors, the kernel for
    CUDA tensors."""
    if coords.device.type == "cpu":
        return lookup_plain(coords, fp, max_probe)
    return lookup_cuda(coords, fp, max_probe)


def lookup_planes(q: torch.Tensor, voxel_size: float, levels: int,
                  fp: torch.Tensor, plane_valid: torch.Tensor,
                  subdivided: torch.Tensor, max_probe: int, near: bool):
    """(found, slot) of the plane map's descent (lookup_planes_plain): the
    plain version for CPU tensors, the kernel for CUDA tensors."""
    if q.device.type == "cpu":
        return lookup_planes_plain(q, voxel_size, levels, fp, plane_valid,
                                   subdivided, max_probe, near)
    return lookup_planes_cuda(q, voxel_size, levels, fp, plane_valid,
                              subdivided, max_probe, near)


def lookup_parent(pts: torch.Tensor, voxel_size: float, level: int,
                  fp: torch.Tensor, subdivided: torch.Tensor,
                  mask: torch.Tensor, max_probe: int) -> torch.Tensor:
    """The next refinement level's mask (lookup_parent_plain): the plain
    version for CPU tensors, the kernel for CUDA tensors."""
    if pts.device.type == "cpu":
        return lookup_parent_plain(pts, voxel_size, level, fp, subdivided,
                                   mask, max_probe)
    return lookup_parent_cuda(pts, voxel_size, level, fp, subdivided, mask,
                              max_probe)


def lookup_neighbors(slots: torch.Tensor, keys: torch.Tensor,
                     fp: torch.Tensor, max_probe: int) -> torch.Tensor:
    """The (A·27,) neighbourhood slots (lookup_neighbors_plain): the plain
    version for CPU tensors, the kernel for CUDA tensors."""
    if slots.device.type == "cpu":
        return lookup_neighbors_plain(slots, keys, fp, max_probe)
    return lookup_neighbors_cuda(slots, keys, fp, max_probe)


def insert(coords: torch.Tensor, valid: torch.Tensor, keys: torch.Tensor,
           fp: torch.Tensor, max_probe: int):
    """(slots, new), keys and fp updated in place: the plain version for CPU
    tensors, the kernel for CUDA tensors."""
    if coords.device.type == "cpu":
        return insert_plain(coords, valid, keys, fp, max_probe)
    return insert_cuda(coords, valid, keys, fp, max_probe)
