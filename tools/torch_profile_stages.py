"""The PyTorch port's KITTI frame, stage by stage, on the GPU.

    python3 tools/torch_profile_stages.py [--frames N] [--warmup N]
                                          [--device cuda]

The port's counterpart of tools/profile_stages.py.  At chip_smoke.py's
kitti_config (131,072-ray outdoor simulator scans), every frame runs on a
LioPipeline's and a MeshPipeline's live state, one stage at a time, each
timed alone with a device synchronisation before and after:

  lio       lio_step (propagate, deskew, downsample, ESIKF, map update)
  append    GlobalPointMap.append_frame (dedup, hash insert, filing)
  smooth    smooth_active
  pull      pull_neighborhood
  delaunay  triangulate_voxels(..., mesh_chunk), pairs_argmin included
  apply     apply_triangles + mark_meshed

As in the JAX tool, `delaunay` runs the pull again inside
triangulate_voxels (mesh/triangles.py), so total_ms counts the pull twice;
no maybe_compact runs, and MeshConfig.ablate stays None.  It prints the
mean ms of each stage over the timed frames, n_frames and total_ms under
the JAX tool's keys.  Beside them: per stage the pairs_argmin launches a
timed frame, and the kernel launches, host syncs
(cudaStream/DeviceSynchronize), copies (cudaMemcpyAsync) and device-busy
ms of the last warm-up frame, whose stages run under torch.profiler
(utils/timers.py::profile_counts).  `--device cuda` (the default) raises
without a card; `--device cpu` runs here, where the profiler sees no
device and its counts read 0.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the KITTI configuration and scans)

from immesh_tpu_torch.device import resolve_device, synchronize  # noqa: E402
from immesh_tpu_torch.kernels import pairs_argmin as pk  # noqa: E402
from immesh_tpu_torch.lio.pipeline import LioPipeline, lio_step  # noqa: E402
from immesh_tpu_torch.mesh import triangles  # noqa: E402
from immesh_tpu_torch.mesh.pipeline import MeshPipeline  # noqa: E402
from immesh_tpu_torch.utils.timers import profile_counts  # noqa: E402

STAGES = ("lio", "append", "smooth", "pull", "delaunay", "apply")


def frame_stages(lio, mesh, bundle, cfg) -> dict:
    """name → f(): the frame's stages on the pipelines' live state, to be
    called in STAGES order (each reads what the one before left)."""
    got = {}

    def s_lio():
        lio.state, lio.vm, got["world"], _ = lio_step(lio.state, lio.vm,
                                                      bundle, cfg, lio.ext)

    def s_append():
        mesh.gm, got["slots"], got["smask"], _ = mesh.gm.append_frame(
            got["world"], bundle.mask)

    def s_smooth():
        mesh.gm.smooth_active(got["slots"], got["smask"])

    def s_pull():
        mesh.gm.pull_neighborhood(got["slots"], got["smask"])

    def s_delaunay():
        got["ids"], got["counts"], _ = triangles.triangulate_voxels(
            mesh.gm, got["slots"], got["smask"], lio.state.pos, cfg.mesh,
            cfg.mesh.mesh_chunk)

    def s_apply():
        triangles.apply_triangles(mesh.store, got["slots"], got["smask"],
                                  got["ids"], got["counts"])
        mesh.gm.mark_meshed(got["slots"], got["smask"])

    return dict(zip(STAGES, (s_lio, s_append, s_smooth, s_pull, s_delaunay,
                             s_apply)))


def run_stages(cfg, scans, device="cuda", warmup: int = 3) -> dict:
    """Run scans (simulator frames) through the stages, the first `warmup`
    untimed, the last of those under the profiler.  Returns the tool's
    output plus "frames" (per frame the position and each stage's ms and
    pairs_argmin launches) and "pipes" (the LioPipeline and MeshPipeline)."""
    dev = resolve_device(device)
    # both eager (graph=False), so the stages split them
    lio = LioPipeline(cfg, device=dev, graph=False)
    mesh = MeshPipeline(cfg, device=dev, graph=False)
    frames, profiled = [], {}
    for k, f in enumerate(scans):
        b = chip_smoke.bundle(f, cfg, dev)
        rec = {"ms": {}, "pairs_launches": {}}
        for name, fn in frame_stages(lio, mesh, b, cfg).items():
            if k == warmup - 1:
                _, profiled[name] = profile_counts(fn)
                continue
            before = pk.launches
            synchronize(dev)
            t0 = time.perf_counter()
            fn()
            synchronize(dev)
            rec["ms"][name] = 1e3 * (time.perf_counter() - t0)
            rec["pairs_launches"][name] = pk.launches - before
        rec["pos"] = lio.state.pos.cpu().numpy().astype(np.float64)
        frames.append(rec)
    timed = frames[warmup:]
    out = {name: float(np.mean([r["ms"][name] for r in timed]))
           for name in STAGES}
    out["n_frames"] = len(timed)
    out["total_ms"] = sum(out[name] for name in STAGES)
    out["pairs_launches_per_frame"] = {
        name: sum(r["pairs_launches"][name] for r in timed) / len(timed)
        for name in STAGES}
    out["profiled"] = profiled
    out["device"] = str(dev)
    if dev.type == "cpu":
        out["note"] = ("CPU run: the profiler traces no device, so launches, "
                       "syncs, copies and busy_ms read 0")
    out["frames"] = frames
    out["pipes"] = (lio, mesh)
    return out


def table(out: dict) -> list:
    """The output as text lines, a row a stage."""
    rows = [f"{'stage':<9} {'ms':>8} {'pairs/fr':>8} {'launches':>8} "
            f"{'syncs':>6} {'copies':>6} {'busy ms':>8}"]
    for name in STAGES:
        p = out["profiled"].get(name, {"launches": 0, "syncs": 0,
                                        "copies": 0, "busy_ms": 0.0})
        rows.append(f"{name:<9} {out[name]:8.3f} "
                    f"{out['pairs_launches_per_frame'][name]:8.1f} "
                    f"{p['launches']:8d} {p['syncs']:6d} {p['copies']:6d} "
                    f"{p['busy_ms']:8.3f}")
    rows.append(f"total {out['total_ms']:.3f} ms over {out['n_frames']} "
                f"frames (the pull counted twice: delaunay pulls again)")
    if "note" in out:
        rows.append(out["note"])
    return rows


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    dev = resolve_device(args.device)
    cfg = chip_smoke.kitti_config()
    sim = chip_smoke.make_sim(cfg.preprocess.max_points, 64)
    out = run_stages(cfg, [sim.frame(k)
                           for k in range(args.warmup + args.frames)],
                     dev, args.warmup)
    out.pop("frames"), out.pop("pipes")
    if dev.type == "cuda":
        print(chip_smoke.smi_line())
    print("\n".join(table(out)))
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
