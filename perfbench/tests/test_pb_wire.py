"""A wire traffic on the CPU at a cut size: the scans serialised to Livox
CustomMsg packets and IMU messages (perfbench/sim/wire.py), the reference
receiver (perfbench/reference/frontend/) against the program's receiver
bit for bit on every bundle field, and a harness run of the wire cell,
which BENCHMARK.json does not list yet (PERF.md, Open questions), with
the per-layer entries that would list it."""

import dataclasses
import json
import os
import time

import numpy as np
import pytest
import torch

from perfbench.harness import cell as cells
from perfbench.harness import check
from perfbench.harness.window import run_cell
from perfbench.reference.config import ImMeshConfig as RefConfig
from perfbench.reference.frontend.sync import receive
from perfbench.reference.step import flatten
from perfbench.sim.stream import make_stream
from perfbench.sim.wire import CUSTOM_POINT
from perfbench.tests.small import WIRE, small_cell

FRAMES = 6
# what BENCHMARK.json's per-layer entries would say with the cell listed
WITH_WIRE = ("outside_graph_ms", "graph_kernel_nodes", "esikf_iterations",
             "remeshed_voxels", "device_idle")
RECEIVE_MS = {"name": "receive_ms", "unit": "ms", "better": "lower",
              "source": "host_clock", "layer": "receiver",
              "moves": "frame_ms", "workloads": [WIRE[0]]}


def _listed(c):
    """The cell `c` with the per-layer metrics it would report, listed."""
    with open(os.path.join(cells.ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    for m in bench["per_layer"]:
        if m["name"] in WITH_WIRE:
            m["workloads"].append(WIRE[0])
    bench["per_layer"].append(RECEIVE_MS)
    c.per_layer = cells.assemble(*WIRE, bench).per_layer
    return c


@pytest.fixture(scope="module")
def stream():
    c = small_cell(*WIRE)
    return c, make_stream(c.config["config"], c.config["sensor"], c.traffic,
                          2 ** 31 + 17, "cpu")


def _program(cfgd):
    from immesh_tpu_torch.config import ImMeshConfig
    from immesh_tpu_torch.frontend.preprocess import decode_raw_buffer
    from immesh_tpu_torch.frontend.sync import PacketSynchronizer
    cfg = ImMeshConfig.from_dict(cfgd)
    sync = PacketSynchronizer(cfg, device="cpu")

    def step(f):
        for t, a, g in zip(f.imu_t.tolist(), f.imu_acc, f.imu_gyr):
            sync.push_imu(t, a, g)
        sync.push_scan(decode_raw_buffer(f.data, f.n, f.layout,
                                         cfg.preprocess, stamp=f.stamp,
                                         duration=f.duration))
        return sync.next_bundle()
    return step


def _spoiled(f):
    """Frame f with its first record NaN (the times rebase to the second),
    one NaN in y, one at zero range, one inside the blind range, one beyond
    the maximum range."""
    rec = np.frombuffer(f.data, CUSTOM_POINT).copy()
    rec["x"][0] = np.nan
    rec["y"][5] = np.nan
    for i, v in ((10, 0.0), (15, 0.05), (20, 200.0)):
        rec["x"][i] = rec["y"][i] = rec["z"][i] = v
    return dataclasses.replace(f, data=rec.tobytes())


def _equal_bits(prog, ref):
    p, r = flatten(prog), flatten(ref)
    for n in r:
        assert torch.equal(check._bits(p[n]), check._bits(r[n])), n
    assert check.bundle_ints(p, r) == 0.0


@pytest.mark.parametrize("spoil", [False, True])
def test_reference_receiver_follows_the_program_bit_for_bit(stream, spoil):
    c, s = stream
    cfgd = c.config["config"]
    rcfg = RefConfig.from_dict(cfgd)
    step = _program(cfgd)
    frames = [s.wire.frame(k) for k in range(FRAMES)]
    if spoil:
        frames = [_spoiled(f) for f in frames]
    for k, f in enumerate(frames):
        prog = step(f)
        ref = receive(rcfg, frames[max(k - 1, 0):k + 1], "cpu")
        _equal_bits(prog, ref)
        n = int(ref.mask.sum())
        assert n == f.n - (5 if spoil else 0), k
        assert int(ref.imu_mask.sum()) == len(s.wire.frame(0).imu_t), k


def test_the_wire_carries_the_stream(stream):
    """The receiver's bundle is the stream's up to the wire's own making:
    times rounded to the ns (and rebased where the sweep's first ray
    missed), each boundary IMU sample the previous scan's last."""
    c, s = stream
    rcfg = RefConfig.from_dict(c.config["config"])
    for k in range(FRAMES):
        b = s.bundle(k)
        ref = receive(rcfg, [s.wire.frame(j) for j in (k - 1, k) if j >= 0],
                      "cpu")
        assert torch.equal(ref.mask, b["mask"]) and torch.equal(ref.pts,
                                                                b["pts"])
        n = int(b["mask"].sum())
        t0 = float(b["t_rel"][0])
        assert float((ref.t_rel[:n] - (b["t_rel"][:n] - t0)).abs().max()
                     ) <= 1e-8
        for name in ("imu_stamps", "imu_gyr", "imu_acc", "imu_mask"):
            want = b[name].clone()
            if k > 0 and name in ("imu_acc", "imu_gyr"):
                want[0] = s.bundle(k - 1)[name][int(b["imu_mask"].sum()) - 1]
            assert torch.equal(getattr(ref, name), want), (k, name)


def test_a_wire_run_is_correct_on_all_seven_numbers():
    out = run_cell(_listed(small_cell(*WIRE)), 13, 1.5, True,
                   time.perf_counter(), device="cpu",
                   setup_frames=4)["result"]
    assert out["correct"] is True, out["check"]
    assert out["check"] == {n: {"value": 0.0, "limit": v["limit"]}
                            for n, v in out["check"].items()}
    assert list(out["check"]) == list(check.NUMBERS) + ["bundle_ints"]
    assert out["failed"] == 0 and out["attempted"] > 0
    assert out["metrics"]["receive_ms"]["value"] > 0
