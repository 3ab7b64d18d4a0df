"""outside_graph_ms: the mean, over the window's frames, of a frame's
latency less the device span of its graph replays (CUDA events around each
replay of the captured steps): copies in and out, polls, the host's Python
and the pose read."""


def read(run):
    if not run.spans_ms:
        return None
    n = min(len(run.spans_ms), len(run.frame_ms))
    return sum(f - s for f, s in zip(run.frame_ms[-n:], run.spans_ms[-n:])) / n
