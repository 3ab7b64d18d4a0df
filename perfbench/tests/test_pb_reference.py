"""The plain reference (perfbench/reference/) against the program on the
CPU at a cut size.  On the CPU the program runs its steps eagerly with its
kernels' plain versions, the same arithmetic the reference copies op for
op, so every leaf of the state agrees bit for bit: the filter state, the
plane map, the point map and the triangle store, through the frames on
which the maps compact, and with window BA on the BA window through the
frames that refine it."""

import pytest
import torch

from perfbench.harness import check
from perfbench.harness.window import compaction_counts, flat_parts
from perfbench.reference import step as R
from perfbench.reference.config import ImMeshConfig as RefConfig
from perfbench.sim.stream import make_stream
from perfbench.tests.small import BA, small_cell

FRAMES = 14  # two refinements of the cut BA window


@pytest.mark.parametrize("workload", ["kitti-hdl64.loop-urban",
                                      "avia-indoor.orbit-room", BA[0]])
def test_reference_follows_the_program_bit_for_bit(workload):
    from immesh_tpu_torch.config import ImMeshConfig
    ba = workload == BA[0]
    c = small_cell(*BA) if ba else small_cell(workload)
    cfgd = c.config["config"]
    stream = make_stream(cfgd, c.config["sensor"], c.traffic, 7, "cpu")
    entry = c.entry()(ImMeshConfig.from_dict(cfgd), c.config["entry_args"],
                      stream.static_imu, torch.device("cpu"))
    rcfg = RefConfig.from_dict(cfgd)
    fr = R.initial_frame(rcfg, "cpu", stream.static_imu)
    polls, counts, compactions, refined = (False, False), (0, 0), 0, 0
    for k in range(FRAMES):
        if k > 0:
            polls = (not polls[0] and R.lio_poll(fr, rcfg),
                     not polls[1] and R.mesh_poll(fr, rcfg))
        _, diag = entry.step(stream.bundle(k))
        out = R.run_frame(rcfg, fr, R.bundle_of(stream.bundle(k)), polls)
        now = compaction_counts(entry)
        assert tuple(a > b for a, b in zip(now, counts)) == polls, k
        assert diag.get("ba_refined", False) == out["ba_refined"], k
        compactions += sum(polls)
        refined += out["ba_refined"]
        counts = now
        got = check.compare(flat_parts(entry), R.flat_frame(fr))
        assert list(got) == list(check.NUMBERS) + ["window_rel"] * ba, k
        assert got == dict.fromkeys(got, 0.0), (k, got)
    assert compactions > 0
    assert refined >= (2 if ba else 0)


def test_frame_from_rebuilds_the_program_state():
    """A frame run from the program's state, flattened and rebuilt, gives
    what the program gives next."""
    from immesh_tpu_torch.config import ImMeshConfig
    c = small_cell("kitti-hdl64.loop-urban")
    cfgd = c.config["config"]
    stream = make_stream(cfgd, c.config["sensor"], c.traffic, 8, "cpu")
    entry = c.entry()(ImMeshConfig.from_dict(cfgd), c.config["entry_args"],
                      None, torch.device("cpu"))
    for k in range(3):
        entry.step(stream.bundle(k))
    before = flat_parts(entry)
    entry.step(stream.bundle(3))
    rcfg = RefConfig.from_dict(cfgd)
    fr = R.frame_from(rcfg, before)
    R.run_frame(rcfg, fr, R.bundle_of(stream.bundle(3)),
                (R.lio_poll(fr, rcfg), R.mesh_poll(fr, rcfg)))
    got = check.compare(flat_parts(entry), R.flat_frame(fr))
    assert got == dict.fromkeys(check.NUMBERS, 0.0)
