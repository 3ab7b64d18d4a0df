"""esikf_iterations: ESIKF bodies run a frame (the LIO diag's
`iterations`, kept on the device and read after the window), the mean over
the window."""


def read(run):
    it = run.diag.get("iterations")
    return sum(it) / len(it) if it else None
