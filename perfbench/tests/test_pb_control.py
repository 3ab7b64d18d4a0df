"""The control on the card: the plain reference computed with TF32 matmuls
(the nearest precision below the float32-with-TF32-off the configurations
state), put in the program's place, has to come out not correct.  The
benchmark's own runs never run it; `python3 perfbench/run.py ... --control
tf32` runs it at a cell's own size.  On the CPU TF32 does not exist, so the
test needs the card."""

import time

import pytest
import torch

from perfbench.harness.window import run_cell
from perfbench.tests.small import BA, WIRE, small_cell


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["kitti-hdl64.loop-urban",
                                      "avia-indoor.orbit-room", BA[0],
                                      WIRE[0]])
def test_tf32_reference_is_not_correct(workload):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only there")
    ba = workload == BA[0]
    c = (small_cell(*BA) if ba else small_cell(*WIRE)
         if workload == WIRE[0] else small_cell(workload))
    out = run_cell(c, 21, 2.5 if ba else 2.0, False, time.perf_counter(),
                   device="cuda", control="tf32",
                   setup_frames=10 if ba else 4)["result"]
    assert out["correct"] is False, out["check"]
