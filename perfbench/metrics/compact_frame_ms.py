"""compact_frame_ms: the mean latency of the window's frames on which the
plane map's or the mesh maps' compaction count rose; their count goes to
standard error beside it.  Nothing where no frame compacted."""


def read(run):
    ms = [f for f, c in zip(run.frame_ms, run.compacted) if c]
    run.notes.append(f"compact_frame_ms: {len(ms)} compaction frames of "
                     f"{len(run.frame_ms)} in the window")
    return sum(ms) / len(ms) if ms else None
