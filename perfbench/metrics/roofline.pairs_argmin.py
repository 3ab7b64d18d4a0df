"""roofline.pairs_argmin: the least time for one pairs_argmin launch's bytes
over the card's memory rate, divided by its mean device time in the traced
segment's profile, in %.  The bytes are fixed by the Delaunay argmin's
inputs and outputs, whatever kernel computes them: the (A, K) channels u,
v, lift and valid and the (A,) d_eps read once, the (A, K, K) int32 W
written once, with A the mesh chunk and K the pull capacity.  The card's
name and power limit go to standard error beside it."""

from perfbench.harness.peaks import HBM_BYTES_PER_S

KERNEL = "pairs_argmin"


def read(run):
    if run.profile is None:
        return None
    t = [d for name, _, d in run.profile.ops if KERNEL in name]
    if not t:
        return None
    mesh = run.config["config"]["mesh"]
    A, K = mesh["mesh_chunk"], mesh["pull_capacity"]
    nbytes = 4 * (4 * A * K + A) + 4 * A * K * K
    bound_us = 1e6 * nbytes / HBM_BYTES_PER_S
    mean_us = sum(t) / len(t)
    run.notes.append(f"roofline.pairs_argmin: {len(t)} launches, mean "
                     f"{mean_us!r} us against a bound of {bound_us!r} us "
                     f"at (A, K) = ({A}, {K}); card {run.card}")
    return 100.0 * bound_us / mean_us
