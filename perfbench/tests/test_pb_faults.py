"""A run of the harness on the CPU, at a cut size, with the timed path
broken underneath by perfbench/tools/faults.py's plants: `correct` has to
come out false for each fault this system's cells can have, and true with
nothing broken.  The window BA faults run on a run whose window begins one
refinement in, so that a correction is behind the checked refinement; the
receiver's faults on the wire cell."""

import time

import pytest

from perfbench.harness.window import run_cell
from perfbench.tests.small import BA, WIRE, small_cell
from perfbench.tools.faults import BA_FAULTS, FAULTS, WIRE_FAULTS


def _run(workload, seconds=1.5, setup_frames=4):
    c = (small_cell(*BA) if workload == BA[0] else small_cell(*WIRE)
         if workload == WIRE[0] else small_cell(workload))
    return run_cell(c, 11, seconds, False,
                    time.perf_counter(), device="cpu",
                    setup_frames=setup_frames)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_step_is_not_correct(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    out = _run("kitti-hdl64.loop-urban")["result"]
    assert out["correct"] is False, out["check"]


@pytest.mark.parametrize("fault", sorted(BA_FAULTS))
def test_a_broken_window_is_not_correct(monkeypatch, fault):
    BA_FAULTS[fault](monkeypatch)
    out = _run(BA[0], 2.5, 10)["result"]
    assert out["correct"] is False, out["check"]


@pytest.mark.parametrize("fault", sorted(WIRE_FAULTS))
def test_a_broken_receiver_is_not_correct(monkeypatch, fault):
    WIRE_FAULTS[fault](monkeypatch)
    out = _run(WIRE[0])["result"]
    assert out["correct"] is False, out["check"]


@pytest.mark.parametrize("workload", ["kitti-hdl64.loop-urban",
                                      "avia-indoor.orbit-room", BA[0],
                                      WIRE[0]])
def test_a_sound_run_is_correct(workload):
    # the BA cell's window as its faults': one refinement in, whatever the
    # CPU's speed
    out = (_run(BA[0], 2.5, 10) if workload == BA[0]
           else _run(workload))["result"]
    assert out["correct"] is True, out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "check"
