"""Run one cell of the benchmark once and print its result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1> [--control tf32]

From the root of a checkout: the cell, its configuration, traffic and
metrics are found by name (perfbench/README.md).  The last line of standard
output is the result, one JSON object; the check's numbers, each beside its
limit, are the last lines of standard error.  `--control tf32` puts the
plain reference, computed with TF32 matmuls, in the program's place for the
check (it has to come out not correct).  Exits non-zero, printing no
result, without a CUDA device, or if JAX or the JAX package was loaded."""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
FORBIDDEN = ("jax", "jaxlib", "flax", "immesh_tpu")


def cache_dirs() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths."""
    base = os.path.join(HERE, ".cache")
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = os.path.join(base, sub)


def forbidden_modules() -> list:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", choices=("tf32",))
    args = ap.parse_args(argv)
    cache_dirs()
    sys.path.insert(0, ROOT)
    import torch

    from perfbench.harness import cell as cells
    from perfbench.harness.window import run_cell

    cell = cells.load(args.workload)
    chips = next(w["chips"] for w in json.load(open(
        os.path.join(ROOT, "BENCHMARK.json")))["workloads"]
        if w["name"] == args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), T_START,
                   control=args.control)
    bad = forbidden_modules()
    if bad:
        print(f"loaded in this process: {bad}", file=sys.stderr)
        return 3
    for line in out["lines"]:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out["result"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
