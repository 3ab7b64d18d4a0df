"""One run of one cell: set-up, the measured window, the traced segment
(`--trace 1`), the check against the plain reference, and the result.

The stream is closed-loop replay: scan k + 1 is handed to the entry once
scan k's pose is on the host.  A frame's latency runs from handing its scan
(with a wire traffic, its first message) to the entry until its pose is on
the host; `frame_ms` is the window's wall time over the frames it
completed, `frame_ms_p95` the 95th percentile of every latency in the
window, `setup_s` process start to the first timed frame (the program's
kernels built on a checkout's first run, the scans made, the lead-in and
warm-up frames run, the graphs captured)."""

from __future__ import annotations

import dataclasses
import gc
import subprocess
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from perfbench.harness import check
from perfbench.harness.cell import Cell, readers
from perfbench.sim.stream import make_stream

START_FRAMES = 3   # frames the reference runs from its own initial state
SAMPLES = 3        # window frames drawn from the seed for the check
TRACE_FRAMES = 40  # frames of the traced segment


@dataclasses.dataclass
class Run:
    """What a run measured, as the per-layer readers see it."""
    config: dict                     # the configuration file
    frame_ms: List[float]            # each window frame's latency
    window_s: float
    spans_ms: Optional[List[float]]  # each frame's graph device span
    diag: Dict[str, List[float]]     # per-frame diag counts
    compacted: List[bool]            # frames on which either map compacted
    graph_nodes: Optional[Dict[str, int]]
    profile: object                  # trace.Profile, or None
    notes: List[str]                 # lines for standard error
    card: str = ""                   # the card's name and power limit
    receive_ms: Optional[List[float]] = None  # each frame's receiver time


@dataclasses.dataclass
class Sample:
    k: int
    before: dict
    after: dict = None
    prev_compacted: tuple = (False, False)


def flat_parts(entry) -> dict:
    from perfbench.reference.step import flatten
    return {n: flatten(o) for n, o in entry.parts().items()}


def compaction_counts(entry) -> tuple:
    return (entry.lio.n_compactions, entry.mesh.n_compactions)


def occupancy(entry) -> tuple:
    """The occupancy the last frame left, as the program's pending host
    copies of it hold it: the plane map's voxels, and the mesh maps'
    (points, voxels); None where no poll is pending."""
    lio = getattr(entry.lio, "_occ_pending", None)
    mesh = getattr(entry.mesh, "_occ_pending", None)
    return (None if lio is None else lio.value(),
            None if mesh is None else tuple(mesh.value()))


def pending_polls(entry, cfg: dict) -> tuple:
    """Whether each map's compaction poll, which the entry reads after the
    next frame, calls for a compaction (`occupancy` over the high-water
    mark)."""
    lio, mesh = occupancy(entry)
    vm, mc = cfg["voxel_map"], cfg["mesh"]
    out = [lio is not None and vm["compact_check_every"] > 0
           and lio > vm["compact_high_water"] * vm["capacity"]]
    if mesh is None or mc["compact_check_every"] <= 0:
        out.append(False)
    else:
        n_p, n_v = mesh
        out.append(n_p > mc["compact_high_water"] * mc["points_capacity"]
                   or n_v > mc["compact_high_water"] * mc["voxel_capacity"])
    return tuple(out)


def card_line() -> str:
    """The card's name and power limit, as nvidia-smi reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{torch.cuda.get_device_name()} (nvidia-smi: {e})"
    return out[0] if out else torch.cuda.get_device_name()


def sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reference_input(rcfg, stream, k: int, dev):
    """The reference's bundle of frame k, and what its row adds: the
    stream's bundle; or with a wire, the reference receiver's bundle of the
    frame's messages (frame k − 1's IMU messages before them, which hold
    the sample at the scan's start), kept in the row as "bundle"."""
    from perfbench.reference import step as R
    if stream.wire is None:
        return R.bundle_of(stream.bundle(k)), {}
    from perfbench.reference.frontend.sync import receive
    b = receive(rcfg, [stream.wire.frame(j) for j in (k - 1, k) if j >= 0],
                dev)
    return b, {"bundle": R.flatten(b)}


def reference_rows(cell: Cell, stream, start, samples, dev, mode: str):
    """The reference's state after each checked frame, as flatten() dicts:
    the start frames from its own initial state, the window's from the
    program's state before each."""
    from perfbench.reference import step as R
    from perfbench.reference.config import ImMeshConfig
    rcfg = ImMeshConfig.from_dict(cell.config["config"])
    out = []
    with check.precision(mode):
        fr = R.initial_frame(rcfg, dev, stream.static_imu)
        polls = (False, False)
        for k in range(len(start)):
            if k > 0:
                polls = (not polls[0] and R.lio_poll(fr, rcfg),
                         not polls[1] and R.mesh_poll(fr, rcfg))
            b, extra = reference_input(rcfg, stream, k, dev)
            R.run_frame(rcfg, fr, b, polls)
            out.append({**R.flat_frame(fr), **extra})
        for s in samples:
            fr = R.frame_from(rcfg, s.before)
            polls = (not s.prev_compacted[0] and R.lio_poll(fr, rcfg),
                     not s.prev_compacted[1] and R.mesh_poll(fr, rcfg))
            b, extra = reference_input(rcfg, stream, s.k, dev)
            R.run_frame(rcfg, fr, b, polls)
            out.append({**R.flat_frame(fr), **extra})
            del fr
    return out


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool,
             t_start: float, device="cuda", control: Optional[str] = None,
             setup_frames: Optional[int] = None) -> dict:
    """One run; returns {"result": the result line's object, "lines":
    the check's lines for standard error}.  `setup_frames` (tests) cuts
    the warm-up; `control` = "tf32" judges the reference in TF32 in the
    program's place."""
    from immesh_tpu_torch.config import ImMeshConfig
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.init()
    t_init = time.perf_counter()
    cfgd = cell.config["config"]
    cfg = ImMeshConfig.from_dict(cfgd)
    stream = make_stream(cfgd, cell.config["sensor"], cell.traffic, seed,
                         dev)
    sync(dev)
    t_scans = time.perf_counter()
    entry = cell.entry()(cfg, cell.config.get("entry_args", {}),
                         stream.static_imu, dev)
    n_setup = (cell.traffic["lead_in"] + cell.traffic["warmup"]
               if setup_frames is None else setup_frames)
    n_setup = max(n_setup, START_FRAMES)
    start = []
    counts, prev = compaction_counts(entry), (False, False)
    for k in range(n_setup):
        entry.step(stream.feed(k))
        if k < START_FRAMES:
            sync(dev)
            start.append(flat_parts(entry))
        now = compaction_counts(entry)
        prev, counts = tuple(a > b for a, b in zip(now, counts)), now
    sync(dev)
    rng = np.random.default_rng(seed)
    at = sorted(rng.uniform(0.05, 0.9, SAMPLES) * seconds)
    if trace:
        for c in entry.captured():
            c.replay_events = []
    samples, done_compaction = [], [False, False]
    lat, diag_it, diag_act, compacted = [], [], [], []
    # with BA on, the window's first refinement is checked: a frame is a
    # candidate while the window holds one keyframe short of full
    ba_at = (cfgd["ba"]["window_size"] - 1 if cfgd["ba"]["enabled"]
             else None)
    refined, ba_due, ba_checked = [], ba_at is not None, None
    k = n_setup
    setup_s = time.perf_counter() - t_start
    notes = [f"set-up {setup_s!r} s: imports and the device "
             f"{t_init - t_start!r} s, scans {t_scans - t_init!r} s, then "
             f"{n_setup} frames {time.perf_counter() - t_scans!r} s"]
    if stream.wire is not None:
        notes.append(f"wire: {stream.wire.layout} packets of "
                     f"{stream.wire.nbytes()} bytes, made in set-up")
    w0 = time.perf_counter()
    t = w0
    while t - w0 < seconds:
        polls = ((False, False) if all(done_compaction)
                 else pending_polls(entry, cfgd))
        take = bool(at) and t - w0 >= at[0]
        for i in (0, 1):
            if polls[i] and not done_compaction[i]:
                take = done_compaction[i] = True
        ba_try = ba_due and entry.keyframes() == ba_at
        take = take or ba_try
        s = None
        if take:
            while at and t - w0 >= at[0]:
                at.pop(0)
            s = Sample(k, flat_parts(entry), prev_compacted=prev)
            sync(dev)
        b = stream.feed(k)
        t0 = time.perf_counter()
        pos, diag = entry.step(b)
        t = time.perf_counter()
        lat.append(1e3 * (t - t0))
        diag_it.append(diag["iterations"])
        diag_act.append(diag["n_active_voxels"])
        if ba_at is not None:
            refined.append(diag["ba_refined"])
            if ba_try and diag["ba_refined"]:
                ba_due, ba_checked = False, k
        now = compaction_counts(entry)
        prev = tuple(a > b for a, b in zip(now, counts))
        compacted.append(any(prev))
        counts = now
        if s is not None:
            s.after = flat_parts(entry)
            samples.append(s)
            sync(dev)
            t = time.perf_counter()
        k += 1
    window_s = t - w0
    n = len(lat)
    recv = getattr(entry, "receive_ms", None)
    recv = None if recv is None else recv[n_setup:n_setup + n]
    failed = [j for j in getattr(entry, "failed", ())
              if n_setup <= j < n_setup + n]
    notes.append(f"{n} frames in {window_s!r} s; compactions (plane map, "
                 f"mesh maps) {compaction_counts(entry)}, of them "
                 f"{sum(compacted)} frames in the window")
    lio_occ, mesh_occ = occupancy(entry)
    notes.append(f"occupancy the last frame left: plane map {lio_occ} of "
                 f"{cfgd['voxel_map']['capacity']} slots, mesh map "
                 f"(points, voxels) {mesh_occ} of "
                 f"({cfgd['mesh']['points_capacity']}, "
                 f"{cfgd['mesh']['voxel_capacity']})")
    if ba_at is not None:
        notes.append(f"window BA: {sum(refined)} refinements in the window; "
                     f"the first checked: frame {ba_checked}")
    pose_finite = bool(torch.isfinite(torch.as_tensor(pos)).all())
    if not pose_finite:
        notes.append(f"the window's last pose is not finite: {pos}")
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    sync(dev)
    spans = None
    if trace and entry.captured():
        per = [[a.elapsed_time(b) for a, b in c.replay_events]
               for c in entry.captured()]
        spans = [sum(x) for x in zip(*per)][-n:]
        for c in entry.captured():
            c.replay_events = None
    nodes = None
    graphs = [g for c in entry.captured() for g in c.graphs]
    if graphs:
        nodes = {}
        for g in graphs:
            for kind, m in g.nodes().items():
                nodes[kind] = nodes.get(kind, 0) + m
    prof = None
    if trace and dev.type == "cuda":
        from perfbench.harness.trace import profile
        prof = profile(TRACE_FRAMES,
                       lambda i: entry.step(stream.feed(k + i)))
    diag = {"iterations": [float(x) for x in torch.stack(
                [torch.as_tensor(x) for x in diag_it]).cpu()],
            "n_active_voxels": [float(x) for x in torch.stack(
                [torch.as_tensor(x) for x in diag_act]).cpu()]}
    if ba_at is not None:
        diag["ba_refined"] = refined
    # the program's state is freed before the reference runs
    prog_rows = start + [s.after for s in samples]
    no_bundle = list(getattr(entry, "failed", ()))
    if no_bundle:
        notes.append(f"frames whose receiver gave no bundle: {no_bundle}")
    entry.release()
    del entry, diag_it, diag_act
    gc.collect()
    t_ref = time.perf_counter()
    ref = reference_rows(cell, stream, start, samples, dev, "fp32")
    if control is not None:
        prog_rows = reference_rows(cell, stream, start, samples, dev,
                                   control)
    notes.append(f"reference {time.perf_counter() - t_ref!r} s")
    rows = [check.compare(p, r) for p, r in zip(prog_rows, ref)]
    readings = check.worst(rows)
    if not pose_finite:
        readings["pose_m"] = float("inf")
    if ba_at is not None and ba_checked is None:
        readings["window_rel"] = float("inf")   # no refinement checked
    limits = cell.config["limits"]
    # a frame that never got its bundle is an answer that never came
    correct = check.verdict(readings, limits) and not no_bundle
    run = Run(cell.config, lat, window_s, spans, diag, compacted, nodes,
              prof, notes, card_line() if dev.type == "cuda" else "cpu",
              recv)
    result = {"correct": correct, "attempted": n, "failed": len(failed)}
    if trace:
        metrics, read = {}, readers(cell)
        for m in cell.per_layer:
            v = read[m["name"]](run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
        result["metrics"] = metrics
    else:
        values = {"frame_ms": 1e3 * window_s / max(n, 1),
                  "frame_ms_p95": float(np.percentile(lat, 95)),
                  "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
    result["device"] = {
        "platform": "gpu" if dev.type == "cuda" else dev.type,
        "kind": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                 else "cpu"),
        "count": 1, "memory_peak_bytes": int(peak)}
    if prof is not None:
        result["device"]["busy_s"] = prof.busy_s
        result["device"]["window_s"] = prof.window_s
        result["breakdown"] = prof.breakdown()
    result["check"] = {name: {"value": readings[name],
                              "limit": limits[name]}
                       for name in readings}
    lines = run.notes + [
        f"checked {len(start)} start frames and window frames "
        f"{[s.k for s in samples]} against the reference"
        + (f" (control: the reference in {control})" if control else "")]
    lines += [f"check {name} {readings[name]!r} limit {limits[name]!r}"
              for name in readings]
    return {"result": result, "lines": lines}
