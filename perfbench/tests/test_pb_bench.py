"""BENCHMARK.json against the benchmark's contract, and the per-layer
readers on runs that have something, and nothing, to read."""

import json
import os
import re

import pytest

from perfbench.harness import cell as cells
from perfbench.harness.cell import PERFBENCH, ROOT
from perfbench.harness.window import Run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))


def test_keys_names_and_files():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["perfbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(
        names)
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("perfbench/")
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert all(NAME.match(k) for k in c["reduced"])
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(set(pairs)) == len(pairs)
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert os.path.exists(os.path.join(PERFBENCH, "traffic",
                                           w["traffic"] + ".json"))


def test_metrics():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert {"frame_ms", "frame_ms_p95", "setup_s"} <= e2e
    for m in BENCH["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["source"] in ("host_clock",
                                                         "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert os.path.exists(os.path.join(PERFBENCH, "metrics",
                                           m["name"] + ".py"))
    for w in BENCH["workloads"]:
        c = cells.load(w["name"])
        assert c.per_layer, w["name"]


def _run(**kw):
    base = dict(config=cells.load("kitti-hdl64.loop-urban").config,
                frame_ms=[], window_s=0.0, spans_ms=None,
                diag={"iterations": [], "n_active_voxels": []},
                compacted=[], graph_nodes=None, profile=None, notes=[],
                card="")
    base.update(kw)
    return Run(**base)


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]]
                         + ["ba_refine_frame_ms", "receive_ms"])
def test_a_reader_with_nothing_to_read_returns_nothing(metric):
    assert cells.reader(metric)(_run()) is None


def test_readers_read():
    from perfbench.harness.trace import Profile
    prof = Profile([("pairs_argmin_kernel", 0.0, 100.0),
                    ("x", 50.0, 100.0)], 1e-3, 150e-6, [], 1)
    run = _run(frame_ms=[10.0, 30.0], window_s=0.05, spans_ms=[8.0, 20.0],
               diag={"iterations": [2, 3], "n_active_voxels": [4, 0],
                     "ba_refined": [False, True]},
               compacted=[False, True], graph_nodes={"kernel": 7},
               profile=prof, receive_ms=[1.5, 2.5])
    r = {name: cells.reader(name)(run) for name in
         [m["name"] for m in BENCH["per_layer"]]
         + ["ba_refine_frame_ms", "receive_ms"]}
    assert r["outside_graph_ms"] == 6.0
    assert r["graph_kernel_nodes"] == 7
    assert r["esikf_iterations"] == 2.5 and r["remeshed_voxels"] == 2.0
    assert r["compact_frame_ms"] == 30.0
    assert r["receive_ms"] == 2.0
    assert r["ba_refine_frame_ms"] == 30.0
    assert abs(r["device_idle"] - 44.0) < 1e-9
    assert 0 < r["roofline.pairs_argmin"] < 100
    assert abs(prof.busy_s - 150e-6) < 1e-12 and prof.gaps() == []
