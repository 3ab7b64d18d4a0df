"""Per-frame incremental meshing step + host wrapper.

Port of immesh_tpu/mesh/pipeline.py (reference
`incremental_mesh_reconstruction`, ImMesh_mesh_reconstruction.cpp:92-267:
append → per-voxel pull/commit/push).  The map and store are updated in
place.  On a CUDA device `MeshPipeline` runs the step as one captured CUDA
graph, replayed every frame, empty chunks skipped on the device by IF nodes
(mesh/captured.py); `graph=False` and the CPU run `mesh_step` eagerly,
with the host-side skip of empty chunks.

The mesh half of a frame (`MeshPipeline.step`: the step, then the
compaction poll) runs on a CUDA stream of the pipeline's own where the
step is a captured graph, as the reference runs meshing on a worker thread
beside the odometry (SURVEY.md §3.3).  It starts after the work its
caller's stream holds, the LIO half that made its world scan and pose, and
an event recorded after it marks its end, so the caller's stream goes on
(the pose's read) without it.  Whoever reads what the half writes outside
it joins first (`join`: the caller's stream waits on that event, the host
does not): the `gm`, `store`, `last_active` and `last_drops` properties
do; the active-voxel count and drop counters that `step` returns are read
after a `join` too.  The eager step and the CPU stay on the caller's
stream, serial.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from immesh_tpu_torch.config import ImMeshConfig
from immesh_tpu_torch.core.ops import div
from immesh_tpu_torch.device import HostCopy, resolve_device
from immesh_tpu_torch.map.hash import EMPTY
from immesh_tpu_torch.mesh.captured import CapturedMeshStep
from immesh_tpu_torch.mesh.global_map import GlobalPointMap
from immesh_tpu_torch.mesh.triangles import (
    TriangleStore, mesh_voxels, remap_store)
from immesh_tpu_torch.utils.timers import trace


def mesh_step(gm: GlobalPointMap, store: TriangleStore,
              pts_world: torch.Tensor, mask: torch.Tensor,
              sensor_pos: torch.Tensor, chunk: int = 16):
    """Append one world-frame scan and re-mesh the active voxels.  Returns
    (gm, store, n_active, slots, smask, diag) like the reference.  A chunk
    of voxels with no active point is skipped (triangles.
    triangulate_voxels): on the device in the captured step, after a host
    read of its mask in the eager one.  The step up to the map's marking is
    the frame trace's `mesh` span."""
    with trace.device_span("mesh", pts_world.device):
        gm, slots, smask, drops = gm.append_frame(pts_world, mask)
        if gm.cfg.pull_smooth_lam > 0:
            # refresh the stored smoothed positions of the active voxels'
            # own points BEFORE triangulation (mesh_rec_geometry.cpp:
            # 333-369)
            gm.smooth_active(slots, smask)
        store, n_emitted, tri_drop = mesh_voxels(
            gm, store, slots, smask, sensor_pos, chunk)
        gm.mark_meshed(slots, smask)
    diag = {f"drop_{k}": v for k, v in drops.items()}
    diag["drop_tris"] = tri_drop
    diag["tris_emitted"] = n_emitted
    return gm, store, torch.sum(smask.to(torch.int32)), slots, smask, diag


class MeshPipeline:
    """Host-side wrapper holding the global map + triangle store.

    On a CUDA device the step is one captured CUDA graph (`graph=True`,
    mesh/captured.py) run on the pipeline's own stream (`step`);
    `graph=False` runs mesh_step eagerly there, as the CPU always does, on
    the caller's stream.

    While the frame trace is on, it counts three events of the half
    (utils/timers.py::FrameTrace.count), each found with one query of the
    last half's event, which never waits: `pose_before_mesh`, frames whose
    pose was read while their mesh half still ran (`count_pending`);
    `lio_over_mesh`, frames whose LIO step was launched while the previous
    mesh half still ran (`count_pending`); `mesh_joins`, joins of a reader
    outside the half that found it still running.  None is counted where
    the mesh is serial."""

    def __init__(self, cfg: ImMeshConfig, device="cuda", graph: bool = True):
        self.cfg = cfg
        self.device = resolve_device(device)
        self._gm = GlobalPointMap.create(cfg.mesh, device=self.device)
        self._store = TriangleStore.create(cfg.mesh, device=self.device)
        self.captured = (CapturedMeshStep(self.device)
                         if graph and self.device.type == "cuda" else None)
        # the mesh half's stream, where the step is a captured graph
        self.stream = (torch.cuda.Stream(self.device)
                       if self.captured is not None else None)
        self.done = None      # event recorded after the last half
        self.frame_idx = 0
        self._last_active = None  # (slots, smask) of the most recent step
        self._last_drops = None   # drop counters of the most recent step
        self.n_compactions = 0
        self._occ_pending = None  # previous frame's occupancy (HostCopy)

    # the mesh state as a reader outside the half sees it: joined first
    @property
    def gm(self) -> GlobalPointMap:
        self.join()
        return self._gm

    @gm.setter
    def gm(self, gm: GlobalPointMap) -> None:
        self._gm = gm

    @property
    def store(self) -> TriangleStore:
        self.join()
        return self._store

    @store.setter
    def store(self, store: TriangleStore) -> None:
        self._store = store

    @property
    def last_active(self):
        """(slots, smask) of the most recent step, or None."""
        self.join()
        return self._last_active

    @last_active.setter
    def last_active(self, active) -> None:
        self._last_active = active

    @property
    def last_drops(self):
        """The drop counters (device scalars) of the most recent step, or
        None."""
        self.join()
        return self._last_drops

    def count_pending(self, counter: str) -> None:
        """While the frame trace is on, count `counter` (pose_before_mesh or
        lio_over_mesh) where the last mesh half still runs: one query of its
        event, no wait."""
        if trace.on and self.done is not None and not self.done.query():
            trace.count(counter)

    def join(self, done=None) -> None:
        """Order the caller's current stream after the last mesh half (or
        the half whose `done` event is given): one wait on its event, none
        on the host.  Nothing on the half's own stream, or where the mesh
        is serial."""
        done = self.done if done is None else done
        if done is None:
            return
        current = torch.cuda.current_stream(self.device)
        if current == self.stream:
            return
        if trace.on and not done.query():
            trace.count("mesh_joins")
        current.wait_event(done)

    def step(self, pts_world, mask, sensor_pos):
        """The frame's mesh half, the one place that switches to the
        pipeline's stream: `advance`, then `maybe_compact`, on that stream
        where the step is a captured graph, after the work the caller's
        stream holds now, with the event `done` recorded after them;
        elsewhere on the caller's stream.  Returns (n_active, drops): the
        active-voxel count and the drop counters (`last_drops`' dict),
        device scalars the half writes, handed back without a wait: read
        them after `join()`."""
        if pts_world.shape[0] == 0:  # static shapes need ≥1 row; mask it out
            pts_world = torch.zeros((1, 3), dtype=torch.float32)
            mask = torch.zeros(1, dtype=torch.bool)
        args = [torch.as_tensor(x, device=self.device)
                for x in (pts_world, mask, sensor_pos)]
        if self.stream is None:
            n_active = self.advance(*args)
            self.maybe_compact(args[2])
            return n_active, self._last_drops
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        _crossing(args, self.stream)
        with torch.cuda.stream(self.stream):
            n_active = self.advance(*args)
            self.maybe_compact(args[2])
        _crossing((n_active, *self._last_active,
                   *self._last_drops.values()), caller)
        self.done = torch.cuda.Event()
        self.done.record(self.stream)
        return n_active, self._last_drops

    def advance(self, pts_world: torch.Tensor, mask: torch.Tensor,
                sensor_pos: torch.Tensor) -> torch.Tensor:
        """The mesh step on this pipeline's map and store, without the
        compaction trigger: the captured graph, or mesh_step eagerly, at
        the map's mesh_chunk, on the current stream, after the last half
        (`join`).  Sets last_active and last_drops; returns the
        active-voxel count (a device scalar)."""
        self.join()
        if self.captured is None:
            (self._gm, self._store, n_active, slots, smask,
             self._last_drops) = mesh_step(self._gm, self._store, pts_world,
                                          mask, sensor_pos,
                                          self._gm.cfg.mesh_chunk)
        else:
            n_active, slots, smask, self._last_drops = self.captured(
                self._gm, self._store, pts_world, mask, sensor_pos)
        self._last_active = (slots, smask)
        self.frame_idx += 1
        return n_active

    def maybe_compact(self, sensor_pos) -> bool:
        """Occupancy-triggered lifetime management (reference
        pointcloud_rgbd.cpp:278-294,425-455): when the point store or voxel
        table crossed the high-water mark on the PREVIOUS frame, evict
        outside the local-map radius and remap the triangle store.

        As the reference's one-frame-delayed poll, the occupancy is copied
        to the host asynchronously after each frame and read on the next
        (device.HostCopy), so no frame waits on its own work and the
        compactions fall on the same frames in both.  Part of the mesh
        half (`step`); alone, on the current stream after the last half
        (`join`)."""
        mc = self.cfg.mesh
        if mc.compact_check_every <= 0:
            return False
        self.join()
        gm = self._gm
        high_p = mc.compact_high_water * mc.points_capacity
        high_v = mc.compact_high_water * mc.voxel_capacity
        pending = self._occ_pending
        # a copy of pt_count's value now: the next frame writes it in place
        self._occ_pending = HostCopy(torch.stack([
            gm.n_points().to(torch.int64), gm.vox.occupancy()]))
        if pending is None:
            return False
        n_p, n_v = pending.value()
        if n_p <= high_p and n_v <= high_v:
            return False
        self._occ_pending = None  # state changes below invalidate the poll
        self.n_compactions += 1
        with trace.span("compact"):
            # hysteresis: target the LOW water mark, radius solved in one
            # pass
            low_p = mc.compact_low_water * mc.points_capacity
            low_v = mc.compact_low_water * mc.voxel_capacity
            center = torch.as_tensor(sensor_pos, device=self.device)
            radius = _keep_radius_mesh(gm, center, int(low_p),
                                       int(low_v), mc.local_map_radius)
            _compact_mesh(gm, self._store, center, radius)
            r = float(radius) * 0.7
            for _ in range(2):  # quantile-granularity guard, rarely taken
                if (int(gm.n_points()) <= high_p
                        and int(gm.vox.occupancy()) <= high_v):
                    break
                _compact_mesh(gm, self._store, center, torch.tensor(
                    r, dtype=torch.float32, device=self.device))
                r *= 0.7
        return True

    def pending_occupancy(self):
        """The mesh maps' (points, voxels) after the last frame, as the
        pending compaction poll holds them (the host copy maybe_compact
        reads on the next frame), or None where no poll is pending."""
        self.join()
        pending = self._occ_pending
        return None if pending is None else tuple(pending.value())

    def extract(self) -> Tuple[np.ndarray, np.ndarray]:
        """The current mesh on the host: (verts (P, 3), faces (F, 3)) with
        faces indexing the compacted vertex array."""
        tri = self.store.tri_ids.reshape(-1, 3).cpu().numpy()
        tri = tri[np.all(tri >= 0, axis=-1)]
        pts = self.gm.pts.cpu().numpy()
        used = np.unique(tri)
        remap = np.full(pts.shape[0], -1, np.int64)
        remap[used] = np.arange(used.size)
        return pts[used], remap[tri]


def _crossing(tensors, stream) -> None:
    """Tensors that cross between the caller's stream and the mesh half's:
    their memory is not handed out again until `stream`'s work queued at
    their release has run."""
    for t in tensors:
        if torch.is_tensor(t):
            t.record_stream(stream)


def _compact_mesh(gm: GlobalPointMap, store: TriangleStore,
                  center: torch.Tensor, radius) -> None:
    _, maps = gm.compact(center, radius)
    remap_store(store, maps["slot_map"], maps["idmap"])


def _keep_radius_mesh(gm: GlobalPointMap, center: torch.Tensor,
                      low_p: int, low_v: int, r_max: float) -> torch.Tensor:
    """Largest keep radius whose Chebyshev cube holds ≤ low-water voxels AND
    points: the (low_k)-th smallest live distance, one sort per table."""
    res = gm.cfg.voxel_resolution
    inf = float("inf")

    vkeys = gm.vox.keys
    vlive = vkeys[:, 0] != EMPTY
    vcen = (vkeys[:, :3].to(torch.float32) + 0.5) * res
    dv = torch.amax(torch.abs(vcen - center[None, :]), dim=-1)
    dv = torch.sort(torch.where(vlive, dv, torch.full_like(dv, inf)))[0]
    rv = dv[min(low_v, dv.shape[0]) - 1]

    alloc = (torch.arange(gm.pts.shape[0], device=gm.pts.device)
             < gm.pt_count)
    # a point survives iff its VOXEL center is inside the cube
    pc = (torch.floor(div(gm.pts, res)) + 0.5) * res
    dp = torch.amax(torch.abs(pc - center[None, :]), dim=-1)
    dp = torch.sort(torch.where(alloc, dp, torch.full_like(dp, inf)))[0]
    rp = dp[min(low_p, dp.shape[0]) - 1]

    r = torch.clamp(torch.minimum(rv, rp), max=r_max)
    # strictly below the quantile sample so the counted element is evicted
    return torch.where(torch.isfinite(r), r * (1.0 - 1e-6),
                       torch.full_like(r, r_max))
