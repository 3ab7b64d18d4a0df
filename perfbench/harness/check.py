"""The comparison that decides `correct`: frames of the program against the
plain reference (perfbench/reference/), number by number, each against a
limit the configuration file states.

What is checked:
  * the start: the reference runs the run's first frames from its own
    initial state, made from the configuration and the static IMU samples
    alone, and each is compared with the program's state after the frame;
  * frames of the measured window: the reference takes the program's state
    before the frame (its only input from the program, which it cannot
    re-derive without running the whole window again) and the frame's
    scan, runs the frame, and is compared with the program's state after
    it.  The frames are drawn from the seed, and the window's first
    compaction of either map is added where one falls in it, and with
    window BA on its first refinement.

The numbers, each the largest over the frames checked:
  pose_m      |p_program − p_reference| of the position, m; infinite
              where the window's last pose is not finite
  state_rel   the filter state's worst leaf (rot, pos, vel, bg, ba, grav,
              cov): max |a − b| over max(max |b| of the leaf, the median
              leaf's max |b|)
  map_rel     the plane map's float leaves (moments, planes) the same way
  map_ints    the share of plane-map slots whose key, fingerprint, plane
              flag or subdivision flag differ
  points_rel  the point map's float leaves (raw and smoothed positions)
  mesh_ints   the worst share of rows that differ over the point map's and
              the triangle store's integer and bool leaves (tables, slots,
              counts, triangle ids)
and, with window BA on (the configuration's `ba.enabled`), whose limits
then have to state it:
  window_rel  the BA window's worst leaf (keyframe rotations, positions,
              body points, the last window's cost) as state_rel takes its
              leaves; a keyframe count, a refinement count or a point mask
              that differs, a program window that is not finite, or a run
              that checked no refinement frame counts as infinite
and, with a wire traffic (the frames fed through the program's receiver;
the reference's bundle then made by the reference receiver from the same
packets and IMU messages), whose limits then have to state it:
  bundle_ints the share of the frame's bundle rows whose bits differ in
              any field: point rows (points, times, mask), IMU rows
              (stamps, accelerations, rates, mask) and the duration
A NaN on one side only counts as an infinite gap; a number that reads NaN
on any frame reads infinite."""

from __future__ import annotations

import contextlib
import math
import statistics
from typing import Dict, Iterable

import torch

NUMBERS = ("pose_m", "state_rel", "map_rel", "map_ints", "points_rel",
           "mesh_ints")


def _gap(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a − b| with NaN == NaN and NaN against a number infinite."""
    a, b = a.double(), b.double()
    na, nb = torch.isnan(a), torch.isnan(b)
    if bool((na != nb).any()):
        return float("inf")
    d = torch.where(na, torch.zeros_like(a), (a - b).abs())
    return float(d.max()) if d.numel() else 0.0


def _rel(prog: Dict, ref: Dict, names: Iterable[str]) -> float:
    """The worst leaf's gap over max(its reference scale, the median
    leaf's)."""
    names = [n for n in names if n in ref]
    scale = {n: float(ref[n].double().abs().nan_to_num().max())
             if ref[n].numel() else 0.0 for n in names}
    med = statistics.median(scale.values()) if scale else 0.0
    worst = 0.0
    for n in names:
        g = _gap(prog[n], ref[n])
        worst = max(worst, g / max(scale[n], med, 1e-30))
    return worst


def _rows_differ(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(rows,) bool: rows of a leaf that differ anywhere."""
    if a.dim() == 0:
        return (a != b).reshape(1)
    return (a != b).reshape(a.shape[0], -1).any(dim=1)


def _ints(prog: Dict, ref: Dict, names: Iterable[str]) -> float:
    worst = 0.0
    for n in names:
        if n in ref:
            d = _rows_differ(prog[n], ref[n])
            worst = max(worst, float(d.sum()) / max(1, d.numel()))
    return worst


_STATE = ("rot", "pos", "vel", "bg", "ba", "grav", "cov")
_VM_FLOAT = ("sum_p", "sum_ppT", "count", "sigma2_sum", "normal", "d",
             "center", "cov_nn", "var_c", "lam")
_GM_FLOAT = ("pts", "pts_smooth", "vox_pts", "vox_pts_sm")
_GM_INT = ("pt_count", "dedup.keys", "dedup.fp", "vox.keys", "vox.fp",
           "vox_pt_idx", "vox_n", "vox_new", "vox_meshed", "frame_no")
_STORE_INT = ("tri_ids", "tri_n", "dirty")
_WINDOW = ("rot", "pos", "pts", "last_cost")
_BUNDLE = (("pts", "t_rel", "mask"),
           ("imu_stamps", "imu_acc", "imu_gyr", "imu_mask"),
           ("scan_duration",))


def _finite(w: Dict) -> bool:
    """A window's poses, its kept points and, once it has refined, its
    cost are finite."""
    return bool(torch.isfinite(w["rot"]).all()
                and torch.isfinite(w["pos"]).all()
                and torch.isfinite(w["pts"][w["mask"]]).all()
                and (w["n_refinements"] == 0
                     or math.isfinite(w["last_cost"])))


def window_rel(prog: Dict, ref: Dict) -> float:
    """The BA windows' worst leaf; infinite where the keyframe count, the
    refinement count or a point mask differs, or the program's window is
    not finite."""
    if (prog["rot"].shape != ref["rot"].shape
            or prog["n_refinements"] != ref["n_refinements"]
            or not torch.equal(prog["mask"], ref["mask"])
            or not _finite(prog)):
        return float("inf")
    prog, ref = ({**x, "last_cost": torch.tensor(x["last_cost"])}
                 for x in (prog, ref))
    return _rel(prog, ref, _WINDOW)


def _bits(x: torch.Tensor) -> torch.Tensor:
    """A float32 leaf as the integers of its bits."""
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def bundle_ints(prog: Dict, ref: Dict) -> float:
    """The share of a bundle's rows (its point rows, IMU rows and the
    duration) whose bits differ in any of their fields."""
    differ = rows = 0
    for group in _BUNDLE:
        d = None
        for n in group:
            r = _rows_differ(_bits(prog[n]), _bits(ref[n]))
            d = r if d is None else d | r
        differ += int(d.sum())
        rows += d.numel()
    return differ / rows


def compare(prog: Dict[str, Dict], ref: Dict[str, Dict]) -> Dict[str, float]:
    """The numbers for one frame: `prog` and `ref` as {"state", "vm", "gm",
    "store"} of flatten() dicts, on one device, and "ba" (on the host)
    where the reference has a BA window: then window_rel too; and "bundle"
    where the reference's bundle came from its receiver: then
    bundle_ints."""
    ps, rs = prog["state"], ref["state"]
    vm_p, vm_r = prog["vm"], ref["vm"]
    slots = torch.zeros(vm_r["table.fp"].shape[0], dtype=torch.bool,
                        device=vm_r["table.fp"].device)
    for n in ("table.keys", "table.fp", "plane_valid", "subdivided"):
        slots |= _rows_differ(vm_p[n], vm_r[n])
    mesh = max(_ints(prog["gm"], ref["gm"], _GM_INT),
               _ints(prog["store"], ref["store"], _STORE_INT))
    out = {
        "pose_m": float(torch.linalg.norm(ps["pos"].double()
                                          - rs["pos"].double())),
        "state_rel": _rel(ps, rs, _STATE),
        "map_rel": _rel(vm_p, vm_r, _VM_FLOAT),
        "map_ints": float(slots.sum()) / slots.numel(),
        "points_rel": _rel(prog["gm"], ref["gm"], _GM_FLOAT),
        "mesh_ints": mesh,
    }
    if "ba" in ref:
        out["window_rel"] = window_rel(prog["ba"], ref["ba"])
    if "bundle" in ref:
        out["bundle_ints"] = bundle_ints(prog["bundle"], ref["bundle"])
    return out


def worst(rows) -> Dict[str, float]:
    """Each number's largest value over the frames' rows (the numbers the
    first row has); a NaN on any row reads infinite."""
    return {n: max(math.inf if math.isnan(r[n]) else r[n] for r in rows)
            for n in rows[0]}


@contextlib.contextmanager
def precision(mode: str):
    """float32 with TF32 off ("fp32", what the configurations state), or
    with TF32 on ("tf32", the control: the nearest precision below)."""
    m = torch.backends.cuda.matmul
    old = (m.allow_tf32, torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    on = mode == "tf32"
    if mode not in ("fp32", "tf32"):
        raise ValueError(f"precision {mode!r}")
    m.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    torch.set_float32_matmul_precision("high" if on else "highest")
    try:
        yield
    finally:
        m.allow_tf32, torch.backends.cudnn.allow_tf32 = old[:2]
        torch.set_float32_matmul_precision(old[2])


def verdict(readings: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number read at or under its limit (a NaN fails); a number
    whose limit the configuration does not state is an error."""
    missing = sorted(set(readings) - set(limits))
    if missing:
        raise KeyError(f"the configuration's limits lack {missing}")
    return all(readings[n] <= limits[n] for n in readings)
