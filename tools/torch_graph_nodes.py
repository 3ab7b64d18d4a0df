"""Which ops of the ESIKF body add graph memory nodes under CUDA-graph
capture, how many nodes the IF sites' torch predicates make, and whether
torch.cholesky_solve and two triangular solves give the same bits.

    python3 tools/torch_graph_nodes.py [--device cuda|cpu] [--systems N]

A conditional body may hold no mem_alloc or mem_free node
(csrc/graph_cond.cu), so lio/esikf.py keeps every op that adds one outside
its IF nodes.  On the card each op of the body's solve (cholesky_ex,
cholesky_solve, two solve_triangular, inv_ex, the (N, 6) product, an 18×18
matrix-vector product, a norm) runs once eagerly on a fresh stream and is
then captured alone with torch.cuda.graph on it, twice; the captured
graphs' nodes are printed by type (utils/graphs.py::graph_nodes).  So is
each IF site's predicate as torch made it before the set kernel made it
itself (the `site_` rows): the ESIKF's `~converged`, a refinement level's
`levels + m.any().to(int32)` over 8,192 points, a KITTI chunk's
`pmask[sl].any()` over 512 rows of 48.  Then, on
--device, N random SPD 18×18 systems of the ESIKF's scale are solved both
ways and the count whose solutions differ in bits is printed.  On the card
it prints the card's name and power limit first; the last line is one JSON
object.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def two_triangular(b, L):
    y = torch.linalg.solve_triangular(L, b, upper=False)
    return torch.linalg.solve_triangular(L.T, y, upper=True)


def capture_nodes(dev) -> dict:
    """Each op captured alone, twice: its graphs' nodes by type."""
    from immesh_tpu_torch.utils.graphs import graph_nodes
    gen = torch.Generator(device=dev).manual_seed(0)
    M = torch.randn(18, 18, device=dev, generator=gen)
    A = M @ M.T + 18 * torch.eye(18, device=dev)
    b = torch.randn(18, 1, device=dev, generator=gen)
    L = torch.linalg.cholesky(A)
    h6 = torch.randn(8192, 6, device=dev, generator=gen)
    ops = {"cholesky_ex": lambda: torch.linalg.cholesky_ex(A),
           "cholesky_solve": lambda: torch.cholesky_solve(b, L),
           "solve_triangular_x2": lambda: two_triangular(b, L),
           "inv_ex": lambda: torch.linalg.inv_ex(A),
           "mm_8192x6": lambda: h6.T @ h6,
           "mv_18": lambda: A @ b[:, 0],
           "norm": lambda: torch.linalg.norm(b)}
    conv = torch.zeros((), dtype=torch.bool, device=dev)
    m = torch.zeros(8192, dtype=torch.bool, device=dev)
    levels = torch.zeros((), dtype=torch.int32, device=dev)
    pmask = torch.zeros(1024, 48, dtype=torch.bool, device=dev)
    ops.update({
        "site_esikf_live": lambda: ~conv,
        "site_level_taken_count": lambda: levels + m.any().to(torch.int32),
        "site_chunk_any": lambda: pmask[512:1024].any()})
    out = {}
    for name, fn in ops.items():
        out[name] = []
        for _ in range(2):
            s = torch.cuda.Stream(dev)
            s.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(s):
                fn()
            torch.cuda.current_stream(dev).wait_stream(s)
            g = torch.cuda.CUDAGraph(keep_graph=True)
            with torch.cuda.graph(g, stream=s):
                fn()
            out[name].append(graph_nodes(g))
        print(f"{name}: {out[name]}", flush=True)
    return out


def differing_solves(dev, n: int) -> int:
    """Of n random SPD 18×18 systems (entries ~1e3, a diagonal ~1e-3),
    how many cholesky_solve and two triangular solves answer with other
    bits."""
    gen = torch.Generator(device=dev).manual_seed(1)
    bad = 0
    for _ in range(n):
        M = torch.randn(18, 18, device=dev, generator=gen)
        A = M @ M.T * 1e3 + torch.diag(
            torch.rand(18, device=dev, generator=gen) * 1e-3)
        L = torch.linalg.cholesky(A)
        b = torch.randn(18, 1, device=dev, generator=gen)
        bad += int(not torch.equal(torch.cholesky_solve(b, L),
                                   two_triangular(b, L)))
    return bad


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--systems", type=int, default=500)
    args = ap.parse_args()
    dev = torch.device(args.device)
    out = {"device": str(dev)}
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            print("torch_graph_nodes: no CUDA device", file=sys.stderr)
            return 2
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], check=True, capture_output=True,
            text=True).stdout.strip().splitlines()[0])
        out["nodes"] = capture_nodes(dev)
    out["differing_solves"] = differing_solves(dev, args.systems)
    out["systems"] = args.systems
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
