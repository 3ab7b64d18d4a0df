"""The check's readings at a cell's own size, on the card, in one process:
sound runs, the TF32 control and the faults perfbench/tools/faults.py
plants, over seeds; one JSON line a run.  A configuration's limits are set
from them (PERF.md §2).

    python3 perfbench/tools/readings.py --workload avia-indoor-ba.ba-window \
        [--config avia-indoor-ba --traffic ba-window] \
        --seeds 3101,3102,3103 --modes none,tf32,one_iteration_fewer \
        --seconds 2 [--setup-frames 20] [--out readings.jsonl] \
        [--device cuda]

From the root of a checkout.  A mode is `none`, `tf32` or a fault's name
in perfbench/tools/faults.py's FAULTS, BA_FAULTS or WIRE_FAULTS.  With --config and
--traffic the cell is configs/<config>.json under traffic/<traffic>.json,
listed in BENCHMARK.json or not."""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--config")
    ap.add_argument("--traffic")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--modes", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--setup-frames", type=int)
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    from perfbench.run import cache_dirs
    cache_dirs()
    import torch

    from perfbench.harness import cell as cells
    from perfbench.harness.window import run_cell
    from perfbench.tools import faults as F

    w = args.workload
    faults = {**F.FAULTS, **F.BA_FAULTS, **F.WIRE_FAULTS}
    for seed in (int(x) for x in args.seeds.split(",")):
        for mode in args.modes.split(","):
            c = (cells.assemble(w, args.config, args.traffic)
                 if args.config else cells.load(w))
            mp = F.Patch()
            if mode in faults:
                faults[mode](mp)
            t0 = time.perf_counter()
            try:
                out = run_cell(c, seed, args.seconds, False, t0,
                               device=args.device,
                               control="tf32" if mode == "tf32" else None,
                               setup_frames=args.setup_frames)
            finally:
                mp.undo()
            res = out["result"]
            rec = {"workload": w, "seed": seed, "mode": mode,
                   "correct": res["correct"],
                   "check": {k: v["value"] for k, v in res["check"].items()},
                   "lines": [x for x in out["lines"] if x.startswith(
                       ("window BA", "checked"))]}
            print(json.dumps(rec), flush=True)
            if args.out:
                with open(args.out, "a") as f:
                    f.write(json.dumps(rec) + "\n")
            if torch.cuda.is_available():
                torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
