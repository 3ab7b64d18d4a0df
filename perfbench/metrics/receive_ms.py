"""receive_ms: the mean, over the window's frames, of the receiver's host
time: from a frame's first IMU message handed to the program's
synchronizer to next_bundle's return (the decode, its gates, the IMU
window, the bundle padded and uploaded), as entries/wire.py times it
around its calls into the receiver.  Nothing in a cell without a wire."""


def read(run):
    ms = run.receive_ms
    return sum(ms) / len(ms) if ms else None
