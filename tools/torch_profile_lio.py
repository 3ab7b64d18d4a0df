"""The PyTorch port's LIO step, stage by stage, on the GPU.

    python3 tools/torch_profile_lio.py [--path kitti|avia] [--warm-frames N]
                                       [--repeat R] [--device cuda]

The port's counterpart of tools/profile_lio.py.  A LioPipeline warms up on
--warm-frames scans of chip_smoke.py's simulator (kitti: kitti_config, the
131,072-ray outdoor scans, IMU-less; avia: PRESETS["avia"], 32,768-point
scans, the IMU on and the LiDAR at the preset's extrinsics), then freezes
the next frame.  compose() runs that frame's LIO step as its stages, in
lio_step's order, each on the previous one's outputs, against a copy of the
map; its intermediates are the fixed inputs every stage is timed on:

  kitti: const_propagate, deskew_const, downsample, pcov, associate_x1,
         esikf_update_x3, map_update, world_transform
  avia:  extrinsic (the scan into the body frame), imu_propagate, deskew,
         downsample, pcov (with the LiDAR-frame round trip and rotation of
         lio/pipeline.py::point_cov), associate_x1, esikf_update_x3,
         map_update, world_transform

associate_x1 is one association at the propagated state, which
esikf_update_x3 (lio_update) runs once per live body (the bodies after
convergence are skipped: read on the host here, an IF node in the captured
step); the live iterations are printed, and associate_x1 stays out of the
stages' sum.
map_update inserts the downsampled scan at the posterior pose, as lio_step
does (the JAX tool uses the propagated one).  The port updates the map in
place, so map_update runs on copies of the map made before its timed loop,
one a call; every other stage only reads the pipeline's map, which is
checked bit for bit after each stage.

Each stage runs once untimed, then --repeat times back to back with one
device synchronisation at the end: wall ms per call, the JAX tool's
measure.  No stage reads a device value on the host but esikf_update_x3
and map_update, which read the convergence test once a body and a level's
mask once a level (the eager form of the captured step's IF nodes), so the
host enqueues ahead of the card between those reads and the wall time is
the larger of the two.  A whole
lio_step on the same frame, timed the same way on map copies, stands beside
the stages' sum, and so does "in seq": each stage's ms inside compose() on
--repeat map copies, synchronised before and after every stage, whose sum
is the step's own time.  The host's load moves these times by tens of per
cent within a run, so the measurement runs ROUNDS times and each time is
the least over the rounds (every round stands in the JSON).  After the
timings, one further call a stage under torch.profiler gives kernel
launches, host syncs (cudaStream/DeviceSynchronize), copies
(cudaMemcpyAsync) and device-busy ms (utils/timers.py::profile_counts).
The last line is a JSON object with the JAX tool's keys (ms per call) and
these.  On the card a last row, lio_step_graph, is the same step as
LioPipeline runs it there, one captured CUDA graph (lio/captured.py), on a
copy of the map: warmed up and captured on the frozen frame, its first
replay held bit for bit to lio_step, then called back to back (each call
copies the bundle and state in, replays and copies the outputs out; the
map grows by the same scan at every replay), and once under the profiler.
The pipeline itself runs eagerly (graph=False), so the stages split it.
`--device cuda` (the default) raises without a card; `--device cpu` runs
here, where the profiler sees no device, its counts read 0 and there is no
graph row.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the configurations and the simulators)

from immesh_tpu_torch.device import resolve_device, synchronize  # noqa: E402
from immesh_tpu_torch.lio import esikf  # noqa: E402
from immesh_tpu_torch.lio import imu as imu_mod  # noqa: E402
from immesh_tpu_torch.lio.association import associate  # noqa: E402
from immesh_tpu_torch.lio.captured import CapturedLioStep  # noqa: E402
from immesh_tpu_torch.lio.downsample import voxel_downsample  # noqa: E402
from immesh_tpu_torch.lio.pipeline import (  # noqa: E402
    LioPipeline, extrinsics, grow_map, lio_step, point_cov)
from immesh_tpu_torch.utils.timers import profile_counts  # noqa: E402

MUTATES_MAP = ("map_update",)  # timed on copies of the map
IN_ESIKF = ("associate_x1",)   # contained in esikf_update_x3: not summed
ROUNDS = 3  # timing rounds; a time is its least over them (host load adds)


def stage_names(cfg) -> tuple:
    """The stages of cfg's LIO step, in lio_step's order."""
    ext = extrinsics(cfg.imu, torch.zeros(0)) is not None
    return ((("extrinsic",) if ext else ())
            + (("imu_propagate", "deskew") if cfg.imu.imu_en
               else ("const_propagate", "deskew_const"))
            + ("downsample", "pcov", "associate_x1", "esikf_update_x3")
            + (("map_update",) if cfg.lio.update_map else ())
            + ("world_transform",))


def _stage_fns(cfg) -> dict:
    """name → f(x, vm, bundle) → the stage's outputs: the code of lio_step,
    cut at its stages; x holds the earlier stages' outputs."""
    lio_cfg, map_cfg, imu_cfg = cfg.lio, cfg.voxel_map, cfg.imu

    def extrinsic(x, vm, b):
        ext = x["ext"]  # made once, as LioPipeline does
        return {"pts_body": b.pts @ ext[0].T + ext[1]}

    def const_propagate(x, vm, b):
        return {"state_prop": imu_mod.const_velocity_propagate(
            x["state"], b.scan_duration, imu_cfg)}

    def deskew_const(x, vm, b):
        st, T = x["state"], b.scan_duration
        return {"pts_end": imu_mod.deskew_const_twist(
            x["pts_body"], b.t_rel, T, st.bg * T, st.vel * T)}

    def imu_propagate(x, vm, b):
        state_prop, seg = imu_mod.imu_propagate(x["state"], b, imu_cfg)
        return {"state_prop": state_prop, "seg": seg}

    def deskew(x, vm, b):
        return {"pts_end": imu_mod.deskew(x["seg"], x["state_prop"],
                                          x["pts_body"], b.t_rel)}

    def downsample(x, vm, b):
        down_pts, down_mask = voxel_downsample(
            x["pts_end"], b.mask, lio_cfg.downsample_voxel,
            lio_cfg.map_update_points)
        return {"down_pts": down_pts, "down_mask": down_mask}

    def pcov(x, vm, b):
        return {"pcov": point_cov(x["down_pts"], x["ext"], map_cfg)}

    def associate_x1(x, vm, b):
        return {"assoc": associate(x["state_prop"], vm, x["down_pts"],
                                   x["pcov"], x["down_mask"], map_cfg)}

    def esikf_update_x3(x, vm, b):
        state_new, diag = esikf.lio_update(
            x["state_prop"], vm, x["down_pts"], x["pcov"], x["down_mask"],
            lio_cfg, map_cfg)
        return {"state_new": state_new, "diag": diag}

    def map_update(x, vm, b):
        grow_map(vm, x["state_new"], x["down_pts"], x["pcov"],
                 x["down_mask"])
        return {}

    def world_transform(x, vm, b):
        return {"world": x["state_new"].transform_points(x["pts_end"])}

    return {f.__name__: f for f in (
        extrinsic, const_propagate, deskew_const, imu_propagate, deskew,
        downsample, pcov, associate_x1, esikf_update_x3, map_update,
        world_transform)}


def compose(state, vm, bundle, cfg, clock=None) -> dict:
    """lio_step(state, vm, bundle, cfg) run as its stages in order (all but
    associate_x1), each on the earlier ones' outputs; `vm` is updated in
    place.  Returns every intermediate: state_prop, pts_end, down_pts,
    down_mask, pcov, state_new, diag, world.  `clock(name, run)`, where
    given, makes each stage's call run()."""
    fns = _stage_fns(cfg)
    x = {"state": state, "pts_body": bundle.pts,
         "ext": extrinsics(cfg.imu, bundle.pts)}
    for name in stage_names(cfg):
        if name not in IN_ESIKF:
            def run(f=fns[name]):
                return f(x, vm, bundle)
            x.update(clock(name, run) if clock else run())
    return x


def lio_stages(x: dict, bundle, cfg) -> dict:
    """name → f(vm): that stage alone on compose()'s intermediates x,
    against the map vm (which map_update changes in place)."""
    fns = _stage_fns(cfg)
    return {name: (lambda vm, f=fns[name]: f(x, vm, bundle))
            for name in stage_names(cfg)}


def bits(t: torch.Tensor) -> torch.Tensor:
    """t's bit pattern (NaNs compare equal to themselves)."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def same_map(a, b) -> bool:
    """The two plane maps are bit-identical."""
    pairs = [(a.table.keys, b.table.keys), (a.table.fp, b.table.fp)] + [
        (getattr(a, n), getattr(b, n)) for n in a._FIELDS]
    return all(torch.equal(bits(p), bits(q)) for p, q in pairs)


def same_state(a, b) -> bool:
    """The two filter states are bit-identical."""
    return all(torch.equal(bits(getattr(a, f.name)), bits(getattr(b, f.name)))
               for f in dataclasses.fields(a))


def esikf_iterations(fn) -> int:
    """Run fn(), the esikf_update_x3 stage, once: the ESIKF's live
    iterations (diag["iterations"], the reference while_loop's trip count;
    each live body runs one association)."""
    return int(fn()["diag"]["iterations"])


def wall_ms(fn, maps, dev) -> float:
    """Mean wall ms of fn(m) over the maps, called back to back after one
    untimed call on maps[0], with one synchronisation at the end."""
    fn(maps[0])
    synchronize(dev)
    t0 = time.perf_counter()
    for m in maps[1:]:
        fn(m)
    synchronize(dev)
    return 1e3 * (time.perf_counter() - t0) / (len(maps) - 1)


def in_sequence_ms(state, maps, bundle, cfg, dev) -> dict:
    """Mean ms of each stage inside compose(), once on each of the maps,
    with a synchronisation before and after every stage."""
    acc = {}

    def clock(name, run):
        synchronize(dev)
        t0 = time.perf_counter()
        got = run()
        synchronize(dev)
        acc[name] = acc.get(name, 0.0) + 1e3 * (time.perf_counter() - t0)
        return got

    for m in maps:
        compose(state, m, bundle, cfg, clock)
    return {name: ms / len(maps) for name, ms in acc.items()}


def profile_lio(cfg, scans, device="cuda", warm_frames: int = 5,
                repeat: int = 20, static_imu=None) -> dict:
    """Warm a LioPipeline on scans[:warm_frames] (simulator frames; the IMU
    initialised from `static_imu` = (acc, gyr) first where given), freeze
    scans[warm_frames] and time each stage.  Returns the tool's output:
    under each stage's name its ms per call back to back, and
    "in_sequence" (per stage its ms inside compose(), synchronised around
    it), "lio_step_ms", "stages_sum_ms", "in_sequence_sum_ms" (each the
    least over ROUNDS rounds, whose values stand in "rounds"), "profiled"
    (per stage, and for lio_step, launches, syncs, copies and busy_ms of
    one call), "esikf_iterations",
    "compose_matches" (state, world scan and map of compose() against
    lio_step, bit for bit) and "map_unchanged" (per stage: the pipeline's
    map bit-identical after it)."""
    dev = resolve_device(device)
    pipe = LioPipeline(cfg, device=dev, graph=False)
    if static_imu is not None:
        pipe.static_init(*static_imu)
    bundles = [chip_smoke.bundle(f, cfg, dev)
               for f in scans[:warm_frames + 1]]
    for b in bundles[:warm_frames]:
        pipe.step(b)
    b, state, vm = bundles[warm_frames], pipe.state, pipe.vm
    snapshot = vm.clone()
    vm_composed = vm.clone()
    x = compose(state, vm_composed, b, cfg)

    def whole(m):
        return lio_step(state, m, b, cfg, pipe.ext)

    st_ref, vm_ref, world_ref, _ = whole(vm.clone())
    out = {"path": "avia" if cfg.imu.imu_en else "kitti",
           "device": str(dev), "frame": warm_frames, "repeat": repeat,
           "compose_matches": {
               "state": same_state(x["state_new"], st_ref),
               "world": torch.equal(bits(x["world"]), bits(world_ref)),
               "map": same_map(vm_composed, vm_ref)}}
    del vm_composed, vm_ref

    def maps_for(name, n):  # map_update changes its map: a copy a call
        return ([vm.clone() for _ in range(n)] if name in MUTATES_MAP
                else [vm] * n)

    stages = lio_stages(x, b, cfg)
    per_round = {name: [] for name in ("lio_step", *stages)}
    seq_rounds = []
    for _ in range(ROUNDS):  # timings first, the profiler after them
        per_round["lio_step"].append(wall_ms(
            whole, [vm.clone() for _ in range(repeat + 1)], dev))
        for name, fn in stages.items():
            per_round[name].append(wall_ms(fn, maps_for(name, repeat + 1),
                                           dev))
        seq_rounds.append(in_sequence_ms(
            state, [vm.clone() for _ in range(repeat)], b, cfg, dev))
    out["rounds"] = dict(per_round, in_sequence=seq_rounds)
    out["lio_step_ms"] = min(per_round.pop("lio_step"))
    out.update({name: min(ms) for name, ms in per_round.items()})
    out["in_sequence"] = {name: min(r[name] for r in seq_rounds)
                          for name in seq_rounds[0]}
    out["stages_sum_ms"] = sum(out[n] for n in stages if n not in IN_ESIKF)
    out["in_sequence_sum_ms"] = sum(out["in_sequence"].values())

    m = vm.clone()  # outside the profiled call: its copies are not the step's
    _, out["lio_step_profiled"] = profile_counts(lambda: whole(m))
    profiled, unchanged = {}, {}
    for name, fn in stages.items():
        m = maps_for(name, 1)[0]
        _, profiled[name] = profile_counts(lambda: fn(m))
        if name == "esikf_update_x3":
            out["esikf_iterations"] = esikf_iterations(lambda: fn(vm))
        unchanged[name] = same_map(vm, snapshot)
    out["profiled"] = profiled
    out["map_unchanged"] = unchanged
    out["esikf_bodies"] = cfg.lio.max_iterations
    if dev.type == "cuda":
        out.update(graph_row(state, vm, b, cfg, pipe.ext, dev, repeat))
    if dev.type == "cpu":
        out["note"] = ("CPU run: the profiler traces no device, so launches, "
                       "syncs, copies and busy_ms read 0")
    return out


def graph_row(state, vm, b, cfg, ext, dev, repeat: int) -> dict:
    """lio_step as the captured graph on a copy of the map (see the module
    note): "lio_step_graph_ms" (least of ROUNDS rounds, each in
    "lio_step_graph_rounds"), "lio_step_graph_profiled" (one call),
    "lio_step_graph_nodes" (the graph's nodes by type, from the graph
    itself: exact where the profiler may drop records) and
    "graph_matches" (its first replay against lio_step on a copy of the
    same map: state, world scan and map bit for bit)."""
    m = vm.clone()
    cap = CapturedLioStep(cfg, ext, dev)
    cap(state, m, b)                      # the warm-up: eager, a real step
    ref = m.clone()
    st_e, _, world_e, _ = lio_step(state, ref, b, cfg, ext)
    st_g, world_g, _ = cap(state, m, b)   # captured, then replayed
    matches = (same_state(st_g, st_e) and same_map(m, ref)
               and torch.equal(bits(world_g), bits(world_e)))
    del ref
    rounds = [wall_ms(lambda mm: cap(state, mm, b), [m] * (repeat + 1), dev)
              for _ in range(ROUNDS)]
    _, prof = profile_counts(lambda: cap(state, m, b))
    return {"lio_step_graph_ms": min(rounds),
            "lio_step_graph_rounds": rounds,
            "lio_step_graph_profiled": prof,
            "lio_step_graph_nodes": cap.graphs[0].nodes(),
            "graph_matches": matches}


def table(out: dict) -> list:
    """The output as text lines, a row a stage."""
    rows = [f"{'stage':<16} {'ms/call':>9} {'in seq':>8} {'launches':>8} "
            f"{'syncs':>6} {'copies':>6} {'busy ms':>8}"]
    seq = dict(out["in_sequence"], lio_step=out["in_sequence_sum_ms"])
    whole = ["lio_step"] + (["lio_step_graph"] if "graph_matches" in out
                            else [])
    for name in [*out["profiled"], *whole]:
        p = out["profiled"].get(name) or out[f"{name}_profiled"]
        ms = out[f"{name}_ms" if name in whole else name]
        in_seq = f"{seq[name]:8.3f}" if name in seq else f"{'-':>8}"
        rows.append(f"{name:<16} {ms:9.3f} {in_seq} {p['launches']:8d} "
                    f"{p['syncs']:6d} {p['copies']:6d} {p['busy_ms']:8.3f}")
    rows.append(f"ms/call: back to back, least of {len(out['rounds']['lio_step'])} "
                f"rounds; in seq: inside the composed step, synchronised "
                f"around each stage. Stages' sum (without associate_x1) "
                f"{out['stages_sum_ms']:.3f} ms, in sequence "
                f"{out['in_sequence_sum_ms']:.3f} ms, against lio_step "
                f"{out['lio_step_ms']:.3f} ms; ESIKF iterations "
                f"{out['esikf_iterations']} live of {out['esikf_bodies']} "
                f"bodies (each runs associate once)")
    if "graph_matches" in out:
        rows.append(f"lio_step_graph: the captured step, called back to "
                    f"back; first replay bit-identical to lio_step: "
                    f"{out['graph_matches']}; the graph's nodes "
                    f"{out['lio_step_graph_nodes']}")
    if "note" in out:
        rows.append(out["note"])
    return rows


def scans_of(path: str, n: int):
    """(cfg, n simulator frames, static IMU samples or None) of a path."""
    if path == "kitti":
        cfg = chip_smoke.kitti_config()
        sim = chip_smoke.make_sim(cfg.preprocess.max_points, 64)
        return cfg, [sim.frame(k) for k in range(n)], None
    cfg = chip_smoke.avia_config()
    sim = chip_smoke.make_avia_sim(cfg)
    static = sim.static_imu(100)  # drawn first, as the demo does
    return cfg, [sim.frame(k) for k in range(n)], static


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("kitti", "avia"), default="kitti")
    ap.add_argument("--warm-frames", type=int, default=5)
    ap.add_argument("--repeat", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    cfg, scans, static = scans_of(args.path, args.warm_frames + 1)
    out = profile_lio(cfg, scans, dev, args.warm_frames, args.repeat, static)
    if dev.type == "cuda":
        print(chip_smoke.smi_line())
    print("\n".join(table(out)))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
