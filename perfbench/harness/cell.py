"""Finding a cell's parts by name: BENCHMARK.json's entry for the
workload, its configuration (configs/<config>.json), its traffic mix
(traffic/<traffic>.json), its entry adapter (entries/<entry>.py, named by
the configuration, or entries/wire.py where the traffic names a wire), and
each metric it reports (end-to-end ones measured here, per-layer ones read
by metrics/<metric>.py)."""

from __future__ import annotations

import dataclasses
import importlib
import importlib.util
import json
import os
from typing import Callable, Dict, List

PERFBENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(PERFBENCH)


def _json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass
class Cell:
    name: str
    config_name: str
    traffic_name: str
    config: dict     # the configuration file
    traffic: dict    # the traffic file
    end_to_end: List[dict]
    per_layer: List[dict]

    def entry(self):
        """The configuration's entry adapter class; with a wire traffic,
        entries/wire.py, which feeds the runtime entry through the
        program's receiver."""
        name = self.config["entry"]
        if "wire" in self.traffic:
            if name != "runtime":
                raise ValueError(f"a wire traffic feeds the runtime entry, "
                                 f"not {name!r}")
            name = "wire"
        return importlib.import_module(f"perfbench.entries.{name}").Entry


def _reports(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def load(workload: str, bench_path: str = None) -> Cell:
    """The cell `workload` of BENCHMARK.json (at the checkout's root)."""
    bench = _json(bench_path or os.path.join(ROOT, "BENCHMARK.json"))
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(it has {sorted(cells)})")
    w = cells[workload]
    return assemble(workload, w["config"], w["traffic"], bench)


def assemble(workload: str, config: str, traffic: str,
             bench: dict = None) -> Cell:
    """The cell `workload` of configs/<config>.json under
    traffic/<traffic>.json, with the metrics `bench` (BENCHMARK.json by
    default) gives it; the cell need not be in BENCHMARK.json."""
    bench = bench or _json(os.path.join(ROOT, "BENCHMARK.json"))
    e2e = [m for m in bench["end_to_end"] if _reports(m, workload)]
    names = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if _reports(m, workload) and m["moves"] in names]
    return Cell(workload, config, traffic,
                _json(os.path.join(PERFBENCH, "configs", config + ".json")),
                _json(os.path.join(PERFBENCH, "traffic", traffic + ".json")),
                e2e, layer)


def reader(metric: str) -> Callable:
    """metrics/<metric>.py's read(run): the metric's value, or None where
    the run has nothing for it to read."""
    path = os.path.join(PERFBENCH, "metrics", metric + ".py")
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def readers(cell: Cell) -> Dict[str, Callable]:
    return {m["name"]: reader(m["name"]) for m in cell.per_layer}
