"""Cells cut to a size a test run holds: the configuration's scans and
capacities shrunk as chip_smoke.py's small_config and small_avia_config
shrink them, a short lap, few set-up frames, and a BA window of 3
keyframes where BA is on."""

from __future__ import annotations

from perfbench.harness import cell as cells


# cells BENCHMARK.json does not list yet (PERF.md, Open questions): their
# names, configurations and traffic; window BA's, and the receiver's
BA = ("avia-indoor-ba.ba-window", "avia-indoor-ba", "ba-window")
WIRE = ("avia-indoor.wire", "avia-indoor", "wire")


def small_cell(workload, config: str = None, traffic: str = None):
    """The cell `workload` of BENCHMARK.json, or of `config` under
    `traffic` where they are given, cut to size."""
    c = (cells.assemble(workload, config, traffic) if config
         else cells.load(workload))
    cfg = c.config["config"]
    if c.config["entry"] == "joint":
        cfg["preprocess"]["max_points"] = 8192
        cfg["voxel_map"].update(capacity=2 ** 13, touched_voxels_per_scan=512)
        cfg["lio"]["map_update_points"] = 2048
        cfg["mesh"].update(points_capacity=2 ** 13, voxel_capacity=2 ** 11,
                           local_map_radius=40.0, active_voxels_per_frame=128,
                           file_voxels_per_frame=1024, max_pts_per_frame=2000,
                           mesh_chunk=64)
        c.traffic["route"].update(b=10.0, rc=8.0)
        c.traffic["lap_frames"] = 120
    else:
        cfg["preprocess"]["max_points"] = 4096
        cfg["voxel_map"].update(capacity=2 ** 14, touched_voxels_per_scan=1024)
        cfg["lio"]["map_update_points"] = 2048
        cfg["mesh"].update(points_capacity=2 ** 16, voxel_capacity=2 ** 12,
                           active_voxels_per_frame=128,
                           file_voxels_per_frame=1024)
        c.traffic["lap_frames"] = 40
        if cfg["ba"]["enabled"]:
            cfg["ba"]["window_size"] = 3
    return c
