"""graph_kernel_nodes: the kernel nodes of the frame's captured graph or
graphs, the bodies of their IF nodes counted (utils/graphs.py's node
counts through the CUDA driver API)."""


def read(run):
    if not run.graph_nodes:
        return None
    return run.graph_nodes.get("kernel")
