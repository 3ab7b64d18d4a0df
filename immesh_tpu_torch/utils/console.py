"""Console color printing + process memory introspection — a copy of
immesh_tpu/utils/console.py (NumPy-free; importing the JAX package's copy
would import jax).

Mirrors the reference's `tools_color_printf.hpp` ANSI console helpers and
`tools_mem_used.h` RAM introspection — which the reference uses to size its
map reserves at startup (reference src/meshing/r3live/pointcloud_rgbd.cpp:
278-294: 1e8/1e6 slots below 16 GB, up to 1e9/1e7 above).  Here the same
logic recommends hash-table/point-slab capacities for `ImMeshConfig`: the
maps are fixed-capacity tensors, so capacity picking happens once,
host-side, before the maps are created."""

from __future__ import annotations

import os
import sys
from typing import Dict

ANSI = {
    "reset": "\033[0m", "bold": "\033[1m",
    "red": "\033[31m", "green": "\033[32m", "yellow": "\033[33m",
    "blue": "\033[34m", "magenta": "\033[35m", "cyan": "\033[36m",
    "white": "\033[37m",
}


def colorize(text: str, color: str, *, bold: bool = False,
             stream=None) -> str:
    """ANSI-wrap `text` if the stream is a TTY (else return it unchanged)."""
    stream = stream if stream is not None else sys.stdout
    if not (hasattr(stream, "isatty") and stream.isatty()):
        return text
    prefix = ANSI.get(color, "") + (ANSI["bold"] if bold else "")
    return f"{prefix}{text}{ANSI['reset']}"


def cprint(text: str, color: str = "white", *, bold: bool = False) -> None:
    print(colorize(text, color, bold=bold))


# ----------------------------------------------------------------------
def process_rss_mb() -> float:
    """Resident set size of this process in MB (0.0 if unknown)."""
    try:
        with open(f"/proc/{os.getpid()}/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / 1e6
    except (OSError, ValueError, IndexError):
        return 0.0


def total_ram_mb() -> float:
    """Total system RAM in MB (0.0 if unknown)."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemTotal:"):
                    return float(line.split()[1]) / 1e3
    except (OSError, ValueError, IndexError):
        pass
    return 0.0


def recommend_capacities(hbm_bytes: int = 16 << 30,
                         fraction: float = 0.25) -> Dict[str, int]:
    """Size the static map capacities from the accelerator's memory, the way
    the reference sizes its reserves from host RAM (pointcloud_rgbd.cpp:
    278-294).  `fraction` = share of HBM granted to the map state.

    Budget model (bytes/slot, from the SoA layouts):
      global point        12   (pts f32×3)
      mesh voxel        ~300   (keys 16 + pt_idx 4·32 + counters + tri_ids 4·64·3)
      plane voxel       ~250   (keys + moments 9·4 + plane params ~40·4)
    Returns power-of-two capacities: points_capacity, mesh_voxel_capacity,
    plane_voxel_capacity."""
    budget = int(hbm_bytes * fraction)
    # split: half to points, a quarter to each voxel table
    def pow2_below(n: int) -> int:
        p = 1
        while p * 2 <= n:
            p *= 2
        return max(p, 1024)

    return {
        "points_capacity": pow2_below((budget // 2) // 12),
        "mesh_voxel_capacity": pow2_below((budget // 4) // 300),
        "plane_voxel_capacity": pow2_below((budget // 4) // 250),
    }
