"""End-to-end ablation of the PyTorch port: ms per frame per config variant.

    python3 tools/torch_ablate_e2e.py [--device cuda] [--frames N]
                                      [--warmup N] [variant ...]

The port's counterpart of tools/ablate_e2e.py, with the same VARIANTS and
apply_variant.  It runs JointPipeline (LioPipeline for "lioonly") at the
KITTI operating point of chip_smoke.py (kitti_config, 131,072-ray outdoor
simulator scans; no adaptive re-mesh budget, as the JAX tool), synchronises
the device after every frame and around the frame's mesh step, and prints
one JSON line per variant: ms per frame and ms of its mesh step (median and
p90 over the timed frames), pairs_argmin launches per frame, live
triangles and map points at the end.  The mesh step's time leaves the LIO
step's jitter out of the difference between two cuts.  The LIO step runs as
a LioPipeline runs it on the card (one captured CUDA graph); the mesh step
runs eagerly (a JointPipeline with graph=False composes that LioPipeline
and its own eager MeshPipeline), so the host timer around it splits it
from the frame.  Chaining the
MeshConfig.ablate cuts (app_cell0 … app_active0, skip_tri … sort30) gives
each stage of the mesh step its cost as the difference between two lines.
`--device cuda` (the default) raises without a card.
"""

import argparse
import dataclasses
import json
import os
import statistics
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke  # noqa: E402  (the KITTI configuration and scans)

VARIANTS = {
    "base": {},
    "nosmooth": {"mesh.pull_smooth_lam": 0.0},
    "a256": {"mesh.active_voxels_per_frame": 256},
    "a1024": {"mesh.active_voxels_per_frame": 1024},
    "a2048": {"mesh.active_voxels_per_frame": 2048},
    "chunk128": {"mesh.mesh_chunk": 128},
    "chunk512": {"mesh.mesh_chunk": 512},
    "pull32": {"mesh.pull_capacity": 32},
    "file2048": {"mesh.file_voxels_per_frame": 2048},
    "lioonly": {"_lio_only": True},
    # cumulative in-program truncation (MeshConfig.ablate)
    "app_cell0": {"mesh.ablate": "app_cell0"},
    "app_insert0": {"mesh.ablate": "app_insert0"},
    "app_alloc0": {"mesh.ablate": "app_alloc0"},
    "app_file0": {"mesh.ablate": "app_file0"},
    "app_active0": {"mesh.ablate": "app_active0"},
    "skip_tri": {"mesh.ablate": "skip_tri"},
    "pull0": {"mesh.ablate": "pull0"},
    "argmin0": {"mesh.ablate": "argmin0"},
    "pairs0": {"mesh.ablate": "pairs0"},
    "compact0": {"mesh.ablate": "compact0"},
    "tri30": {"mesh.ablate": "tri30"},
    "fake_tri3": {"mesh.ablate": "fake_tri3"},
    "gather0": {"mesh.ablate": "gather0"},
    "sort30": {"mesh.ablate": "sort30"},
}


def apply_variant(cfg, kv):
    """cfg with each "group.field" of kv set; keys starting with "_" are
    run options, not config fields."""
    for k, v in kv.items():
        if k.startswith("_"):
            continue
        group, field = k.split(".")
        cfg = cfg.replace(**{group: dataclasses.replace(
            getattr(cfg, group), **{field: v})})
    return cfg


def run_variant(name, kv, frames, warmup, device="cuda", scans=None):
    """Run one variant for warmup + frames scans (made from
    chip_smoke.make_sim unless `scans`, simulator frames, are given).
    Returns the summary the tool prints, plus "frames": per timed and
    warm-up frame its ms, its mesh step's ms, pairs_argmin launches, active
    voxels and position.  The mesh step is timed through a wrapper put in
    place of mesh/pipeline.py's mesh_step for the run."""
    import immesh_tpu_torch.mesh.pipeline as mesh_pipeline
    import immesh_tpu_torch.runtime.joint as joint
    from immesh_tpu_torch.device import resolve_device, synchronize
    from immesh_tpu_torch.kernels import pairs_argmin as pk
    from immesh_tpu_torch.lio.pipeline import LioPipeline

    dev = resolve_device(device)
    cfg = apply_variant(chip_smoke.kitti_config(), kv)
    if scans is None:
        sim = chip_smoke.make_sim(cfg.preprocess.max_points, 64)
        scans = [sim.frame(k) for k in range(warmup + frames)]
    bundles = [chip_smoke.bundle(f, cfg, dev) for f in scans[:warmup + frames]]

    mesh_step, mesh_ms = mesh_pipeline.mesh_step, []

    def timed_mesh_step(*args):
        synchronize(dev)
        t0 = time.perf_counter()
        out = mesh_step(*args)
        synchronize(dev)
        mesh_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    lio_only = kv.get("_lio_only", False)
    if lio_only:
        pipe = LioPipeline(cfg, device=dev)
    else:
        pipe = joint.JointPipeline(cfg, device=dev, graph=False)
        pipe.lio = LioPipeline(cfg, device=dev)  # captured on the card
    synchronize(dev)
    per_frame = []
    mesh_pipeline.mesh_step = timed_mesh_step
    try:
        for b in bundles:
            before, n_mesh = pk.launches, len(mesh_ms)
            t0 = time.perf_counter()
            _, diag = pipe.step(b)
            synchronize(dev)
            ms = 1e3 * (time.perf_counter() - t0)
            per_frame.append({
                "ms": ms, "mesh_ms": sum(mesh_ms[n_mesh:]),
                "launches": pk.launches - before,
                "active": 0 if lio_only else int(diag["n_active_voxels"]),
                "pos": pipe.state.pos.cpu().numpy().astype(np.float64)})
    finally:
        mesh_pipeline.mesh_step = mesh_step
    timed = per_frame[warmup:]
    ms = [f["ms"] for f in timed]
    mms = [f["mesh_ms"] for f in timed]
    return {
        "variant": name,
        "ms_median": statistics.median(ms),
        "ms_p90": float(np.percentile(ms, 90)),
        "mesh_ms_median": statistics.median(mms),
        "mesh_ms_p90": float(np.percentile(mms, 90)),
        "pairs_launches_per_frame": sum(f["launches"] for f in timed)
        / len(timed),
        "triangles": 0 if lio_only else int(pipe.store.n_triangles()),
        "map_points": 0 if lio_only else int(pipe.mesh.gm.n_points()),
        "frames": per_frame,
    }


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--warmup", type=int, default=3)
    ap.add_argument("variants", nargs="*", default=["base"])
    args = ap.parse_args()
    from immesh_tpu_torch.device import resolve_device
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        print(chip_smoke.smi_line(), flush=True)
    for name in args.variants:
        out = run_variant(name, VARIANTS[name], args.frames, args.warmup,
                          device=dev)
        out.pop("frames")
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
