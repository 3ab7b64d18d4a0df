"""The hash lookup's coords form (csrc/hash_probe.cu's hash_lookup_kernel)
beside another checkout's, at the keys its users probe: against the
parent's kernel, launched in stream order, this tells what the
programmatic dependent launch buys.

    python3 tools/torch_lookup_coords.py --parent _parent [--frames N]
                                         [--out chiprun_out/coords.json]

Builds two libraries of csrc/hash_probe.cu with kernels/build.py's
NVCC_FLAGS, one nvcc each, started together, into
immesh_tpu_torch/_build/coords_ab/: the other checkout's ("parent") and
this tree's ("change").  A KITTI JointPipeline runs eagerly (graph=False)
over chip_smoke.py's first N scans and records its last frame's
lookup-form calls; the coords keys of the costliest planes, parent and
neighbours calls (chip_smoke.FormCall.keys: the reference's
HashTable.lookup at each call) are the three shapes.  For each shape, in
turns (parent, change, change, parent): the device time of a launch in a
chain of 50 back to back (chip_smoke.device_ms) and of a launch inside a
chain of 50 captured as one CUDA graph and replayed, and of a (torch
kernel, coords launch) pair in a mixed chain of MIXED pairs, eager and
captured (a torch kernel, which never waits on griddepcontrol, before each
launch: the place of a hand-written kernel in the port's graphs), every
launch's slots bit for bit those of lookup_plain; each variant's captured
chains' edges by kind (utils/graphs.py::graph_edges).  Prints the card's
name and power limit first; the last line is one JSON object, also
written to --out.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = ("parent", "change")
TURNS = ("parent", "change", "change", "parent")
# (torch kernel, coords launch) pairs of the mixed chain
MIXED = 25


def build_variants(parent_root: str) -> dict:
    """{variant: library}, each source compiled by its own nvcc."""
    from immesh_tpu_torch.kernels import build
    out_dir = os.path.join(build.BUILD_DIR, "coords_ab")
    os.makedirs(out_dir, exist_ok=True)
    here = build.source_path("hash_probe")
    srcs = {"parent": os.path.join(parent_root, "immesh_tpu_torch", "csrc",
                                   "hash_probe.cu"),
            "change": here}
    procs = {}
    for name, src in srcs.items():
        lib = os.path.join(out_dir, f"libhash_probe_{name}.so")
        cmd = [build._nvcc(), *build.NVCC_FLAGS, "-o", lib, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       lib, src)
    libs = {}
    for name, (proc, lib, src) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"building {src} failed:\n{log}")
        cdll = ctypes.CDLL(lib)
        p, i = ctypes.c_void_p, ctypes.c_int
        cdll.hash_lookup_launch.argtypes = [p, p, i, i, i, p, p]
        cdll.hash_lookup_launch.restype = i
        libs[name] = cdll
    return libs


def launcher(lib, keys, fp, max_probe: int, out):
    """A function that launches the library's coords lookup of keys into
    out on the current stream and raises on a launch error."""
    head = (keys.data_ptr(), fp.data_ptr(), keys.shape[0], fp.shape[0],
            max_probe)

    def launch():
        err = lib.hash_lookup_launch(*head, out.data_ptr(),
                                     torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"hash_lookup launch failed: CUDA error {err}")
    return launch


def shapes_from_frames(dev, n_frames: int) -> dict:
    """{name: (keys, fp, max_probe)}: the coords keys of the costliest
    planes, parent and neighbours calls of an eager KITTI JointPipeline's
    last frame over chip_smoke's first n_frames scans."""
    import chip_smoke as cs
    from immesh_tpu_torch.runtime.joint import JointPipeline
    cfg = cs.kitti_config()
    _, gt = cs.kitti_scans(n_frames)
    pipe = JointPipeline(cfg, adaptive_mesh_budget=2048, device=dev,
                         graph=False)
    for f in gt[:-1]:
        pipe.step(cs.bundle(f, cfg, dev))
    _, calls = cs.record_probes(lambda: pipe.step(cs.bundle(gt[-1], cfg,
                                                            dev)))
    torch.cuda.synchronize()
    _, forms = cs.split_calls(calls)
    return {name: cs.coords_call(cs.costliest_form(forms, kind))
            for name, kind in (("lio_planes", "planes"),
                               ("lio_parent", "parent"),
                               ("mesh_neighbors", "neighbors"))}


def measure(lib, keys, fp, max_probe: int, dev, want) -> dict:
    """One turn of a variant on a shape: eager chain, captured chain, and
    the mixed chain eager and captured."""
    import chip_smoke as cs
    from immesh_tpu_torch.utils.graphs import graph_edges
    n = keys.shape[0]
    out = torch.empty(n, dtype=torch.int32, device=dev)
    eager = cs.device_ms(launcher(lib, keys, fp, max_probe, out))
    outs = [torch.empty(n, dtype=torch.int32, device=dev)
            for _ in range(cs.COORDS_CHAIN)]
    if not cs.same_bits(out, want):
        raise AssertionError("a coords lookup differs from lookup_plain")
    launches = [launcher(lib, keys, fp, max_probe, o) for o in outs]
    graph, chain = cs.chain_graph(lambda: [f() for f in launches],
                                  cs.COORDS_CHAIN, outs, want, dev)
    small = torch.zeros(4096, device=dev)

    def mixed():
        for f in launches[:MIXED]:
            small.add_(1.0)
            f()

    mixed_eager = cs.device_ms(mixed, n=2) / MIXED
    mgraph, mixed_graph = cs.chain_graph(mixed, MIXED, outs[:MIXED], want,
                                         dev)
    return {"ms": eager, "chain_graph_ms": chain,
            "edges": graph_edges(graph), "mixed_ms": mixed_eager,
            "mixed_graph_ms": mixed_graph,
            "mixed_edges": graph_edges(mgraph)}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", required=True,
                    help="root of the checkout to compare with")
    ap.add_argument("--frames", type=int, default=43,
                    help="KITTI scans before the recorded frame's keys")
    ap.add_argument("--out", default=None, help="also write the JSON here")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_lookup_coords: needs a CUDA device", flush=True)
        return 2
    import chip_smoke as cs
    from immesh_tpu_torch.kernels import hash_probe as hp
    dev = torch.device("cuda", 0)
    print(cs.smi_line(), flush=True)
    libs = build_variants(args.parent)
    shapes = shapes_from_frames(dev, args.frames)
    result = {"card": cs.smi_line(), "shapes": {}}
    for name, (keys, fp, mp) in shapes.items():
        want = hp.lookup_plain(keys, fp, mp)
        turns = {v: [] for v in VARIANTS}
        for v in TURNS:
            turns[v].append(measure(libs[v], keys, fp, mp, dev, want))
        row = {"keys": keys.shape[0], "slots": fp.shape[0],
               "max_probe": mp, "turns": turns}
        result["shapes"][name] = row
        print(f"{name}: ({keys.shape[0]}, 4) into {fp.shape[0]} slots: "
              + "; ".join(
                  f"{v} us eager " + " / ".join(
                      f"{1e3 * t['ms']:.3f}" for t in turns[v])
                  + ", in a captured chain " + " / ".join(
                      f"{1e3 * t['chain_graph_ms']:.3f}" for t in turns[v])
                  + f", edges {turns[v][0]['edges']}, a (torch, coords) "
                  "pair eager " + " / ".join(
                      f"{1e3 * t['mixed_ms']:.3f}" for t in turns[v])
                  + ", captured " + " / ".join(
                      f"{1e3 * t['mixed_graph_ms']:.3f}" for t in turns[v])
                  + f", edges {turns[v][0]['mixed_edges']}"
                  for v in VARIANTS),
              flush=True)
    line = json.dumps(result)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
