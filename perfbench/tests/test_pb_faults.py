"""A run of the harness on the CPU, at a cut size, with the timed path
broken underneath: `correct` has to come out false for each fault this
system's cells can have, and true with nothing broken.

  * a step that returns its state unchanged (the LIO step hands back the
    filter state it was given);
  * half of the batch left out (the LIO step sees half of the scan's
    points);
  * an answer altered where it is produced (the LIO step's pose moved by
    5 mm; one triangle of the mesh step's store rewritten).
No cell spans chips, so no exchange between chips can be left out."""

import time

import pytest
import torch

from perfbench.harness.window import run_cell
from perfbench.tests.small import small_cell


def _lio(monkeypatch, wrap):
    import immesh_tpu_torch.lio.pipeline as lp
    inner = lp.lio_step
    monkeypatch.setattr(lp, "lio_step", lambda *a, **k: wrap(inner, *a, **k))


def unchanged(monkeypatch):
    def wrap(inner, state, vm, bundle, cfg, ext):
        _, vm, world, diag = inner(state, vm, bundle, cfg, ext)
        return state, vm, world, diag
    _lio(monkeypatch, wrap)


def half_batch(monkeypatch):
    def wrap(inner, state, vm, bundle, cfg, ext):
        keep = torch.arange(bundle.mask.shape[0]) % 2 == 0
        return inner(state, vm, bundle.__class__(
            **{**bundle.__dict__, "mask": bundle.mask & keep}), cfg, ext)
    _lio(monkeypatch, wrap)


def pose_altered(monkeypatch):
    def wrap(inner, state, vm, bundle, cfg, ext):
        state, vm, world, diag = inner(state, vm, bundle, cfg, ext)
        return state.replace(pos=state.pos + 0.005), vm, world, diag
    _lio(monkeypatch, wrap)


def triangle_altered(monkeypatch):
    import immesh_tpu_torch.mesh.pipeline as mp
    inner = mp.mesh_step

    def wrap(*a, **k):
        out = inner(*a, **k)
        store = out[1]
        live = (store.tri_n > 0).nonzero()
        if len(live):
            store.tri_ids[live[0, 0], 0] = store.tri_ids[live[0, 0], 0].flip(0)
        return out
    monkeypatch.setattr(mp, "mesh_step", wrap)


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "pose_altered": pose_altered, "triangle_altered": triangle_altered}


def _run(workload):
    return run_cell(small_cell(workload), 11, 1.5, False,
                    time.perf_counter(), device="cpu", setup_frames=4)


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_a_broken_step_is_not_correct(monkeypatch, fault):
    FAULTS[fault](monkeypatch)
    out = _run("kitti-hdl64.loop-urban")["result"]
    assert out["correct"] is False, out["check"]


@pytest.mark.parametrize("workload", ["kitti-hdl64.loop-urban",
                                      "avia-indoor.orbit-room"])
def test_a_sound_run_is_correct(workload):
    out = _run(workload)["result"]
    assert out["correct"] is True, out["check"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "check"
