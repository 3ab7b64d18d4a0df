"""remeshed_voxels: voxels re-meshed a frame (the mesh diag's
`n_active_voxels`, kept on the device and read after the window), the mean
over the window."""


def read(run):
    a = run.diag.get("n_active_voxels")
    return sum(a) / len(a) if a else None
