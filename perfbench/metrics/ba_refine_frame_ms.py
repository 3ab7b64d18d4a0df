"""ba_refine_frame_ms: the mean latency of the window's frames that refined
the BA window (diag `ba_refined`); their count and share of the window go
to standard error beside it.  Nothing where no frame refined."""


def read(run):
    flags = run.diag.get("ba_refined") or []
    ms = [f for f, r in zip(run.frame_ms, flags) if r]
    if not ms:
        return None
    run.notes.append(f"ba_refine_frame_ms: {len(ms)} refinement frames of "
                     f"{len(run.frame_ms)} in the window "
                     f"({100.0 * len(ms) / len(run.frame_ms)!r} %)")
    return sum(ms) / len(ms)
