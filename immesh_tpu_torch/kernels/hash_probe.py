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

import torch

from immesh_tpu_torch.core.ops import set_drop
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

# kernel launches by kernel since the last reset_launches(), and those
# recorded into a CUDA graph since then
launches = {"hash_lookup": 0, "hash_insert": 0}
captured = {"hash_lookup": 0, "hash_insert": 0}
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
    n = ([0, 0] if _lib is None else
         _build.read_runs(_lib, NAME, 2, _devices))
    return dict(zip(launches, n))


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
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hash_lookup_launch.argtypes = [p, p, i, i, i, p, p]
    lib.hash_insert_launch.argtypes = [p, p, i, p, p, i, i, p, p, p, i, p]
    lib.hash_lookup_launch.restype = i
    lib.hash_insert_launch.restype = i
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


def _launch_lookup(lib, coords, fp, max_probe: int, slot) -> None:
    """One counted lookup launch on the current stream into the
    preallocated slot, without checks: lookup_cuda's last step, and what
    timing code calls with `_library()`."""
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hash_lookup_launch(
            coords.data_ptr(), fp.data_ptr(), coords.shape[0], fp.shape[0],
            max_probe, slot.data_ptr(), stream)
        capturing = torch.cuda.is_current_stream_capturing()
    _check(err, "hash_lookup", coords.device, capturing)


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
    with torch.cuda.device(coords.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.hash_insert_launch(
            coords.data_ptr(), valid.data_ptr(), coords.shape[0],
            keys.data_ptr(), fp.data_ptr(), fp.shape[0], max_probe,
            slot.data_ptr(), new.data_ptr(),
            None if flags is None else flags.data_ptr(), INSERT_PATHS[path],
            stream)
        capturing = torch.cuda.is_current_stream_capturing()
    _check(err, "hash_insert", coords.device, capturing)
    if capturing:
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


def insert(coords: torch.Tensor, valid: torch.Tensor, keys: torch.Tensor,
           fp: torch.Tensor, max_probe: int):
    """(slots, new), keys and fp updated in place: the plain version for CPU
    tensors, the kernel for CUDA tensors."""
    if coords.device.type == "cpu":
        return insert_plain(coords, valid, keys, fp, max_probe)
    return insert_cuda(coords, valid, keys, fp, max_probe)
