"""device_idle: 1 − Σ the frames' graph device spans (CUDA events around
each replay) over the window's wall time, in %.  The profiler's busy share
of the traced segment goes to standard error beside it."""


def read(run):
    if not run.spans_ms or run.window_s <= 0:
        return None
    if run.profile is not None:
        p = run.profile
        run.notes.append(f"device_idle: the profiler reads {p.busy_s!r} s "
                         f"busy in a traced segment of {p.window_s!r} s "
                         f"({p.frames} frames)")
    return 100.0 * (1.0 - sum(run.spans_ms) / (1e3 * run.window_s))
