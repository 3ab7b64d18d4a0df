"""Faults planted under the timed path, for the check to catch: each is a
function of a monkeypatch (pytest's fixture, or `Patch` here) that breaks
one step of the program.  perfbench/tests/test_pb_faults.py runs them on
the CPU at a cut size and perfbench/tools/readings.py on the card at a
cell's own size.

FAULTS, the faults this system's cells can have:
  * `unchanged`: a step that returns its state unchanged (the LIO step
    hands back the filter state it was given);
  * `half_batch`: half of the batch left out (the LIO step sees half of
    the scan's points);
  * `pose_altered`, `triangle_altered`: an answer altered where it is
    produced (the LIO step's pose moved by 5 mm; one triangle of the mesh
    step's store rewritten);
  * `goes_nan`: the filter's position made NaN after each frame from the
    fourth on, past the start frames (eager or captured alike), so that
    the reference, which follows the program's state, reads NaN beside
    it on every window frame.
No cell spans chips, so no exchange between chips can be left out.

BA_FAULTS, with window BA on:
  * `correction_dropped`: the correction not applied to the filter;
  * `refinement_skipped`: the window fills and is never solved;
  * `one_iteration_fewer`: one Gauss-Newton iteration fewer;
  * `points_before_correction`: the keyframe points sampled from the scan
    before the last window's correction (the world scan mapped back
    through it).

WIRE_FAULTS, in the receiver of a wire traffic (entries/wire.py):
  * `last_point_dropped`: the preprocessor drops the scan's last valid
    point;
  * `boundary_imu_dropped`: the IMU window leaves out the sample at the
    scan's start (sent with the scan before);
  * `times_truncated_to_us`: the decode truncates each point's time to a
    whole microsecond."""

from __future__ import annotations

import numpy as np
import torch


class Patch:
    """The part of pytest's monkeypatch a plant uses, for the tools."""

    def __init__(self):
        self._undo = []

    def setattr(self, obj, name: str, value) -> None:
        self._undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    def undo(self) -> None:
        while self._undo:
            obj, name, value = self._undo.pop()
            setattr(obj, name, value)


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


def goes_nan(monkeypatch):
    from immesh_tpu_torch.runtime.app import ImMeshRuntime
    from immesh_tpu_torch.runtime.joint import JointPipeline
    calls = []

    def plant(cls, name):
        inner = getattr(cls, name)

        def wrap(self, *a, **k):
            out = inner(self, *a, **k)
            calls.append(1)
            if len(calls) > 3:
                st = self.lio.state
                self.lio.state = st.replace(pos=st.pos * float("nan"))
            return out
        monkeypatch.setattr(cls, name, wrap)
    plant(JointPipeline, "step")
    plant(ImMeshRuntime, "process_frame")


FAULTS = {"unchanged": unchanged, "half_batch": half_batch,
          "pose_altered": pose_altered, "triangle_altered": triangle_altered,
          "goes_nan": goes_nan}


def _window(monkeypatch, name, wrap):
    import immesh_tpu_torch.lio.window as pw
    inner = getattr(pw.WindowBA, name)
    monkeypatch.setattr(pw.WindowBA, name,
                        lambda self, *a: wrap(inner, self, *a))


def correction_dropped(monkeypatch):
    def wrap(inner, self, vm):
        return dict(inner(self, vm), d_rot=np.eye(3, dtype=np.float32),
                    d_pos=np.zeros(3, np.float32))
    _window(monkeypatch, "refine", wrap)


def refinement_skipped(monkeypatch):
    _window(monkeypatch, "refine", lambda inner, self, vm: None)


def one_iteration_fewer(monkeypatch):
    import immesh_tpu_torch.lio.window as pw
    inner = pw.solve_window
    monkeypatch.setattr(pw, "solve_window", lambda prob, iterations, **kw:
                        inner(prob, iterations=iterations - 1, **kw))


def points_before_correction(monkeypatch):
    def refine(inner, self, vm):
        out = inner(self, vm)
        self.fault_corr = out["d_rot"], out["d_pos"]
        return out

    def observe(inner, self, rot, pos, world, mask, vm):
        if getattr(self, "fault_corr", None) is not None:
            dR, dp = (torch.from_numpy(np.asarray(x, np.float32)).to(
                world.device) for x in self.fault_corr)
            world = (world - dp) @ dR
        return inner(self, rot, pos, world, mask, vm)
    _window(monkeypatch, "refine", refine)
    _window(monkeypatch, "observe", observe)


BA_FAULTS = {"correction_dropped": correction_dropped,
             "refinement_skipped": refinement_skipped,
             "one_iteration_fewer": one_iteration_fewer,
             "points_before_correction": points_before_correction}


def last_point_dropped(monkeypatch):
    from immesh_tpu_torch.frontend.preprocess import Preprocessor
    inner = Preprocessor.process
    monkeypatch.setattr(Preprocessor, "process", lambda self, scan: tuple(
        x[:-1] for x in inner(self, scan)))


def boundary_imu_dropped(monkeypatch):
    from immesh_tpu_torch.frontend.sync import PacketSynchronizer
    inner = PacketSynchronizer.next_bundle

    def wrap(self):
        if self.scans:
            keep = [t != self.scans[0].stamp for t in self.imu_t]
            for name in ("imu_t", "imu_acc", "imu_gyr"):
                setattr(self, name, [x for x, k in zip(getattr(self, name),
                                                       keep) if k])
        return inner(self)
    monkeypatch.setattr(PacketSynchronizer, "next_bundle", wrap)


def times_truncated_to_us(monkeypatch):
    import immesh_tpu_torch.frontend.native as nat
    inner = nat.decode_filter

    def wrap(*a, **k):
        xyz, t, *rest = inner(*a, **k)
        t = (np.floor(t.astype(np.float64) * 1e6) / 1e6).astype(np.float32)
        return (xyz, t, *rest)
    monkeypatch.setattr(nat, "decode_filter", wrap)


WIRE_FAULTS = {"last_point_dropped": last_point_dropped,
               "boundary_imu_dropped": boundary_imu_dropped,
               "times_truncated_to_us": times_truncated_to_us}
