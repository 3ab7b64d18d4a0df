"""Window BA in the check, on the CPU at a cut size (4,096 rays, a window
of 3 keyframes): the reference's solve_window against the program's bit
for bit, a harness run whose checked frames hold a refinement, reading
0.0 on every number, window_rel with them, and a run that checks none,
which is not correct.  The frame by frame comparison
with BA on is test_pb_reference.py's."""

import time

import torch

from perfbench.harness import check
from perfbench.harness.window import run_cell
from perfbench.reference.dist import window_ba as ref_ba
from perfbench.sim.stream import make_stream
from perfbench.tests.small import BA, small_cell


def test_solve_window_follows_the_program_bit_for_bit():
    """The first window the program solves, solved again by the
    reference's solve_window: every output the same bits."""
    from immesh_tpu_torch.config import ImMeshConfig
    import immesh_tpu_torch.lio.window as pw
    c = small_cell(*BA)
    cfgd = c.config["config"]
    stream = make_stream(cfgd, c.config["sensor"], c.traffic, 9, "cpu")
    entry = c.entry()(ImMeshConfig.from_dict(cfgd), c.config["entry_args"],
                      stream.static_imu, torch.device("cpu"))
    probs, inner = [], pw.solve_window

    def keep(prob, **kw):
        sol = inner(prob, **kw)
        probs.append((prob, kw, sol))
        return sol
    pw.solve_window = keep
    try:
        k = 0
        while not probs and k < 20:
            entry.step(stream.bundle(k))
            k += 1
    finally:
        pw.solve_window = inner
    prob, kw, sol = probs[0]
    ref = ref_ba.solve_window(ref_ba.WindowProblem(*prob), **kw)
    assert set(ref) == set(sol)
    for key in sol:
        assert torch.equal(sol[key], ref[key]), key
    assert int(prob.weight.sum()) > 0


def test_a_refinement_frame_is_checked():
    """A harness run whose window begins one refinement in: the window's
    first refinement frame is among the checked ones, and all seven
    numbers read 0.0."""
    out = run_cell(small_cell(*BA), 13, 2.5, False, time.perf_counter(),
                   device="cpu", setup_frames=10)
    res = out["result"]
    assert res["correct"] is True, res["check"]
    assert list(res["check"]) == list(check.NUMBERS) + ["window_rel"]
    assert all(v["value"] == 0.0 for v in res["check"].values()), res["check"]
    line = next(x for x in out["lines"] if x.startswith("window BA:"))
    assert not line.endswith("frame None"), line


def test_a_run_that_checks_no_refinement_is_not_correct():
    """Keyframe gates no motion passes: the window never fills, no frame
    refines, and the run is not correct, whatever else it reads."""
    c = small_cell(*BA)
    c.config["config"]["ba"].update(kf_trans_thresh=1e9,
                                    kf_rot_thresh_deg=1e9)
    out = run_cell(c, 13, 1.5, False, time.perf_counter(), device="cpu",
                   setup_frames=10)
    res = out["result"]
    assert res["correct"] is False, res["check"]
    assert res["check"]["window_rel"]["value"] == float("inf")
    assert all(res["check"][n]["value"] == 0.0 for n in check.NUMBERS)
    assert any(x.endswith("frame None") for x in out["lines"])


def test_a_nan_on_any_frame_reads_infinite():
    rows = [{"pose_m": 0.0}, {"pose_m": float("nan")}, {"pose_m": 1e-3}]
    assert check.worst(rows) == {"pose_m": float("inf")}
    assert check.worst(rows[::-1]) == {"pose_m": float("inf")}
