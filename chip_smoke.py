"""Smoke run of the PyTorch/CUDA port on one GPU.

    python3 chip_smoke.py [--frames N]

Phases (each one passes or the script exits non-zero; nothing is caught):

  0. device   — requires CUDA and prints the card's name and power limit,
                the CUDA runtime and driver versions, and whether torch has
                CUDA-graph conditional nodes (the captured steps' IF nodes
                come from csrc/graph_cond.cu either way);
  1. build    — compiles every kernel from csrc/ with nvcc, one process per
                source, all started together; the driver's and
                graph_cond's runtime versions must reach CUDA 12.3;
  2. kernels  — holds each kernel (pairs_argmin, incircle) against its plain
                PyTorch version on the card (value-identical results):
                pairs_argmin at the KITTI chunk (512, 48), the Avia chunk
                (64, 48), ~5 %, ~50 % and 100 % valid points, K = 20 and
                128; then times each with CUDA events (device time per
                launch, and one wrapper call with its checks and host
                work) beside its bound and its plain version;
  3. ints     — the wrapping int32 hash arithmetic gives the same bits on the
                card as on the CPU, the hash_probe kernels too (insert and
                lookup on the card against the plain versions on the
                CPU), and segment sums are deterministic;
 3b. hash     — the hash_probe kernels (the insert and the lookup's four
                launch forms: coords, planes, parent, neighbours) against
                their plain versions on the card at the path's shapes: the
                KITTI LIO run eagerly (graph=False: a replay of the
                captured step calls no wrapper to record) over phase 4's
                scans to the plane-map load phase 4 reaches, every probe
                and lookup-form call of its last frame recorded (the map
                update's unique keys, the association's planes calls, the
                refinement levels' parent calls) and replayed through both
                on copies of the table it found (slots, new, keys, fp,
                found, masks bit for bit), also at HASH_SHORT_PROBE where
                lanes exhaust, each insert on every form of the kernel that
                takes its lanes (the cluster form up to CLUSTER_MAX_LANES,
                the cooperative grid always); random form calls on plane
                maps of the KITTI shape at 10 % and 90 % load and mesh
                voxel tables (max_probe exhaustion, NaN, ±inf and
                out-of-range points, reference behaviours 2 and 4 planted
                and checked); the coords form (no path calls it) on the
                keys the reference's HashTable.lookup probes at the LIO's
                costliest planes and parent calls and at the random calls,
                also at max_probe 0 and 1, from a misaligned row view, for
                n = 1 and replayed in a captured graph (check_coords); an
                insert of more lanes than the card holds threads (the grid
                form's grid-stride path, and a lookup of its keys); 0 host
                syncs a call under torch.profiler; the LIO's costliest
                insert, its planes and parent calls and the coords form on
                their keys timed (device time, one wrapper call, the plain
                version; for a form also the composition it replaced as one
                captured graph, with its kernel nodes; for the coords form
                one launch captured alone and a launch in a captured chain
                of COORDS_CHAIN, with the chain's edges: a programmatic
                edge is its programmatic dependent launch kept by the
                capture) beside a bound of the distinct bytes the call must
                move over the memory rate;
  4. main     — JointPipeline at the KITTI operating point (131,072-ray
                scans from the outdoor simulator) for warm-up plus N
                timed frames, the frame two captured CUDA graphs, its LIO
                step's and its mesh step's, the mesh
                half on its own stream (frame 0 eager, frame 1 captured,
                then replayed; so on every path but the ablation's and the
                stage profilers' mesh step and dist/); the two graphs' IF
                nodes and set launches by site and the bodies they ran
                against each frame's diag (check_sites);
                checks that pairs_argmin ran on the device (its own device
                counter) on every frame with active voxels and that every
                path kernel (pairs_argmin, the planes, parent and
                neighbours lookups, the insert, scatter_drop) ran (as on
                every later path): each launched by its wrapper
                and each run on the device, by the kernel's own device
                counter, exactly the eager launches plus every replay of
                the launches recorded into the graphs (path_counts), that
                poses follow the simulator's ground truth, that triangles
                exist and that a compaction fired; the probe, set_drop and
                add_drop calls outside the graphs (none during a capture)
                are recorded on the compacting frames and the last, and
                those of the mesh step on the same frames from an eager
                run of the mesh step over phase 4's world scans, which
                must end bit for bit as phase 4's map (eager_mesh_calls);
                the graphs' nodes counted by type;
 4b. hash path — every probe and lookup-form call of phase 4's compacting
                frames (the mesh dedup and voxel inserts at the tables'
                fullest, the neighbours calls, the compaction's rebuild
                inserts) and of its last frame, recorded during phase 4,
                replayed as in 3b; the last frame's costliest insert and
                neighbours call timed for the `kernels` line (the latter
                beside the composition it replaced, and the coords form on
                its keys, checked and timed as in 3b), its costliest insert
                of every other
                lane count (the LIO's 1,024, the mesh dedup's 10,000, the
                voxel insert) and each compacting frame's costliest insert
                (a rebuild, 131,072 lanes) timed too, each on every form
                that takes it;
  5. parity   — two small scan sequences, IMU-less KITTI-shaped and IMU-on
                Avia-shaped, run on the card and on the CPU (the path the
                tests hold against the JAX reference) agree;
  6. runtime  — ImMeshRuntime, the system's entry point, at the Avia
                operating point (32,768-point scans, IMU on at 200 Hz,
                LiDAR→IMU extrinsics) for 3 warm-up plus 30 timed frames,
                its LIO and mesh steps captured; checks pose, mesh
                accuracy, logs, PLY and checkpoint round-trips;
  7. audit    — the voxels re-meshed on the runtime's last frame go through
                pairs_argmin in the path's chunks (bit parity, device time,
                fill), the O(K⁴) incircle oracle delaunay_mask (the
                incircle kernel) and the production delaunay_pairs; every
                triangle on which the last two disagree must be a tie;
  8. ba       — ImMeshRuntime at the Avia operating point with window BA on
                at its defaults (8 keyframes of 512 points, 256 landmarks,
                4 GN iterations, pose feedback) for 3 warm-up plus
                BA_FRAMES timed frames: ≥ 3 refinements, finite costs,
                poses within BA_POSE_TOL_M of ground truth, pairs_argmin
                on the path; times frames with and without a refinement
                and each refine; the first window solved again on the CPU
                must agree with the card's solve;
  8b. ba_ab   — the localization replay of bench.py's `loc_kick0.2_w5`
                (a clean map, then a handicapped filter with recurring
                0.2 m kicks) with BA off and on: BA must lower the ATE;
  9. render   — from phase 8's runtime: reinforce() against the same
                rasterization on the CPU (time, peak memory), the snapshot
                views, the plane-map PLY round trip, the live viewer's
                endpoints over a few more frames, and the scipy oracle
                mesh's boundary edges beside the store's;
 10. frontend — the port's scanpack library built with the host C++
                compiler; its decode of a 131,072-point buffer with NaN,
                inf, blind, edge and out-of-range rows byte-identical to
                its NumPy oracle in every LAYOUTS entry (host ms of each);
                the IMU ring's push/drain round trip;
 11. replay   — the sensor-input paths into ImMeshRuntime: KITTI .bin
                scans (131,072 rays, clockwise outdoor simulator) through
                kitti_sequence → PacketSynchronizer (IMU off) →
                ImMeshRuntime.run, and the Avia preset from the wire
                (livox_custommsg bytes → decode_raw_buffer, the IMU
                streamed one sample at a time) → next_bundle() →
                process_frame; every pose within its bound, ATE, host ms of
                decode + preprocess + sync beside the frame's ms,
                pairs_argmin launched on both, the first bundles again on
                the CPU;
 12. texture  — on the Avia wire run: 1280×1024 camera frames ray-cast
                from the ground-truth poses and painted by a procedural
                field, rendered every TEX_EVERY-th frame from the estimated
                pose into a TexturePipeline (render ms, colours against the
                paint, one render against the CPU), lk_track of 1,140 grid
                features against the known image motion and the CPU, and
                the coloured mesh through save_ply / load_ply;
 13. dist     — the multi-rank dist/ path over torch.distributed, ranks
                spawned with a FileStore rendezvous (NCCL takes no two
                ranks on one card, so two ranks share the card over gloo):
                13a dp LIO + capacity-sharded mesh at the KITTI point,
                world 2, slab 32 (the pre-partitioned append), 3 warm-up +
                DIST_FRAMES frames — replicas bit-identical every frame,
                every pose within POSE_TOL_M, pairs_argmin launched on
                every rank and equal to its plain version on a rank's last
                real chunk, then the sharded-map LIO step (halo exchange
                staged through the host on gloo); 13b phase 4's first scans
                meshed at world 2 equal, triangle for triangle, a
                single-device MeshPipeline at budgets that drop nothing;
                13c phase 8's first window solved point-sharded at world 2
                against the card's single-device solve; 13d dp LIO +
                sharded mesh over NCCL at world 1; 13e the scaling curve at
                worlds 1 and 2;
 14. ablate   — the cumulative ablation sweep of tools/torch_ablate_e2e.py
                at the KITTI point on phase 4's scans (JointPipeline, 3
                warm-up + ABLATE_FRAMES frames a variant): base, lioonly,
                the five append cuts, the nine triangulation cuts in
                pipeline order, base again and fake_tri3; structural checks
                on every variant (no pairs_argmin launch before argmin0, one
                a frame with active voxels from it on, no triangles after a
                cut, no map points after an append cut, every pose within
                POSE_TOL_M; the chain runs ABLATE_PASSES times, a frame
                timed by its least time over the passes), W of argmin0's
                last chunk against the plain version, the map copy an append
                cut costs, and each stage's Δ ms and Δ launches;
 15. profile  — the two stage profilers: tools/torch_profile_lio.py at
                the KITTI point on phase 4's scans and at the Avia point
                (IMU on, extrinsics) on phase 6's simulator, PROFILE_WARM
                warm-up frames, then each LIO stage alone PROFILE_REPEAT
                times back to back, and inside the composed step, in
                three rounds, then once under torch.profiler (wall
                ms, launches, syncs, copies, device-busy ms, ESIKF
                iterations, the stages' sum beside a whole lio_step); the
                stages
                composed in order equal lio_step bit for bit and leave the
                pipeline's map bit-identical; tools/torch_profile_stages.py
                on phase 4's first 13 scans (lio, append, smooth, pull,
                delaunay, apply, each synchronised alone): pairs_argmin
                twice a frame in delaunay and nowhere else, W of its last
                chunk against the plain version, every pose within
                POSE_TOL_M.  Both run the LIO eagerly (graph=False), so
                the stages split it; torch_profile_lio adds the captured
                step as its lio_step_graph row, held bit for bit to
                lio_step;
 16. graph    — the captured LIO step: the KITTI LioPipeline (phase 4's
                3 + 40 scans) and the Avia ImMeshRuntime (3 + 30 frames,
                LIO and mesh) run eagerly (graph=False) and captured from
                the same start, in turns: state, pose, world scan, diag and
                every plane-map tensor (and the Avia triangles) bit for bit on
                every frame, both plane maps compacted to half their
                voxels after GRAPH_COMPACT_AT (neither reaches its
                high-water mark in these runs); ESIKF iterations equal, the
                frames where a refinement level was empty and where all
                max_iterations bodies ran live reported; ms a step eager
                against captured; the KITTI LIO graph's nodes kept for
                phase 17; one captured step under torch.profiler (0
                syncs); the IF nodes by site (in the KITTI LIO graph and
                the Avia's two an ESIKF body after the first, which runs
                with no node — its normal equations, then its step, both
                set by one launch — and one a refinement level) and the
                set launches by site (one a predicate), their bodies'
                node types (no allocation, free or event node), the bodies
                run on the device (the set kernel's taken counts) equal to
                what each frame's diag says (iterations − 1, levels,
                chunks with an active voxel), and the bodies, levels and
                chunks skipped a frame;
                the inserts recorded into the graphs all of the cluster
                form; the graph's kernel nodes and one captured step's
                device-busy ms; each LIO kernel's runs a frame;
                then scatter_drop against its plain version on every
                set_drop/add_drop call and set_drop_group/add_drop_group
                group recorded in phase 4's compacting and last frames and
                in the eager KITTI LIO's compacting and last frames, and on
                random calls and groups of every dtype and width at 1,024
                lanes and at twice the threads the card holds; 0 syncs a
                call; the last frame's costliest call timed for the
                `kernels` line, its costliest single call (a 768-byte
                slot-row set) and the LIO's costliest group (the plane
                refit's 8 fields, also timed as 8 single launches) too;
 17. frame graphs — the KITTI JointPipeline (phase 4's 3 + 40 scans) two
                ways from the same start, in turns: eager (graph=False,
                serial) and the frame's two captured graphs, the mesh half
                on its own stream; then the two again from a new start with
                the pose read alone (ms a frame, the share of frames whose
                LIO step overlapped the last mesh half), bit for bit at the
                end; then the Avia ImMeshRuntime (3 + 30 frames) with its
                mesh step eager and captured: point map, store, work list,
                active count, every drop counter, filter state and plane map
                bit for bit on every frame, the plane maps compacted to half
                after GRAPH_COMPACT_AT and the KITTI mesh maps on their own
                (Avia: both maps forced after GRAPH_AVIA_COMPACT_AT); the
                compaction frames equal; the two graphs' kernel, memcpy,
                memset and conditional nodes and recorded launches equal to
                phase 4's, the LIO graph's to phase 16's; the inserts of the
                cluster form; IF nodes and set launches by site, the bodies
                run on the device against diag, the chunks skipped a frame;
                one frame of each (no poll pending: the polls only copy)
                under torch.profiler, 0 syncs in the captured ones; ms a
                frame each way, and the frame split: wall, the frame's
                device span (CUDA events from the LIO replay's start to the
                mesh replay's end) and the time outside it, and the two
                graphs' device-busy ms replayed alone.

Phase 16b, after 16, holds segment_sum (csrc/segment_sum.cu) bit for bit
to the parent's `values[order]` + torch.segment_reduce (one segment more,
sliced off) and to its plain version on the CPU, on every call phase 16's
eager KITTI and Avia runs made on their recorded frames and at the
benchmark's call shapes (SUM_SHAPES), and times each call shape beside its
bound, the library's call and the parent's composition; the KITTI path's
costliest call also as a wrapper call and the plain version, one launch and
0 syncs a call.  main() traps torch.segment_reduce: a call on a CUDA tensor
outside that yardstick fails the run.

Phase 16a, before 16, holds the IF sites' set kernel (csrc/graph_cond.cu)
to its plain version, the predicate made by torch and read on the host: a
graph of 64 IF nodes replayed on random predicates runs each body exactly
where the host read says; every form (read, not, any over unaligned
spans, a level's and a chunk's bytes, the count set and added, one launch
setting 3 and 4 nodes across a cholesky_solve) equals the same step on
the CPU on random inputs; then each site of the path (the ESIKF body, a
level, a KITTI chunk) is timed as 64 copies in one graph, its launch that
makes the predicate against the parent's torch predicate nodes and a set
launch a node, predicate false and true.

Every path that captures checks the device runs of every kernel against
its eager launches, each graph's replays times the launches recorded
outside its IF nodes, and each body's runs (the set kernel's taken count)
times the launches recorded into it (path_counts).

The line before the last is a JSON object describing every kernel (for
pairs_argmin, the hash, scatter and segmented-sum kernels and the set
kernel "launches" by the wrapper — for the set kernel, which runs only in graphs, those it
recorded — and "device_runs" by the kernel's device counter, on the main
path and on each other path; for the lookup forms also the composition
each replaced, its time as one captured graph and its kernel nodes; for
the coords form, which no path calls (OFF_PATH: 0 launches and runs on
every path, or the path fails), one timing per key set: the LIO's planes
and parent keys and the mesh's neighbour keys; for segment_sum one timing
per call shape under "by_shape" and the rows each caller read and dropped);
the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import inspect
import json
import math
import os
import statistics
import subprocess
import sys
import time
from types import SimpleNamespace

import numpy as np
import torch

# the sources in immesh_tpu_torch/csrc
KERNELS = ("pairs_argmin", "incircle", "hash_probe", "scatter_drop",
           "graph_cond", "segment_sum")
# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth and non-tensor f32 rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 67e12
# poses lag the simulator's 2 s launch ramp (4.5 m/s², constant-twist model
# without an IMU); the reference LIO shows the same lag on these frames
POSE_TOL_M = 0.5
TIE_SCALE = 0.02  # MeshConfig.tie_scale of the kitti and avia presets
TRI_COUNT_RTOL = 0.05
# Avia runtime: the JAX reference ImMeshRuntime on the CPU, on these 33
# frames (same simulator, seed, static init and alignment of the initial
# frame; tests/torch_avia_reference.py), peaks at 0.0316 m pose error
# (frame 14) and ends at 0.0059 m; its mesh vertices lie 0.0501 m RMS from
# the analytic scene.  The bounds leave the port ~50 % above the
# reference's own error.
AVIA_POSE_TOL_M = 0.05
AVIA_MESH_RMS_TOL_M = 0.075
AVIA_FRAMES = 30  # timed, after 3 warm-up: the 33 frames the bounds come from
# IMU-on card-vs-CPU parity (phase 5).  On the first IMU_WARM frames of the
# indoor sequence the ESIKF matches only a few hundred points and stops at
# max_iterations without converging, so an ulp that flips one χ gate moves
# the pose by a step, and a chained pair drifts apart (7.1e-3 m by frame 3
# on an H100).  On those frames the CPU restarts from the card's state
# before every step, and the one step is held to IMU_WARM_STEP_TOL_M: 2× the
# worst one-step difference measured on an H100 (1.54e-3 m on frame 2;
# 6.4e-12, 3.5e-8 and 1.8e-5 m on frames 0, 1 and 3).  Each side's pose is
# also held to the simulator's ground truth at IMU_WARM_GT_TOL_M, 2× the
# JAX reference's own worst error on these frames (0.0049 m on frame 2,
# tests/torch_avia_reference.py); the card's peaks at 0.0051 m (frame 2,
# this phase's log on an H100).  From frame IMU_WARM on, the pair runs
# chained from the card's state.
IMU_WARM = 4
IMU_WARM_STEP_TOL_M = 3e-3
IMU_WARM_GT_TOL_M = 0.01
# BA-on Avia runtime (phase 8): the JAX reference ImMeshRuntime on the CPU,
# on these frames with window BA on at its defaults (same simulator, seed,
# static init and alignment; tests/torch_ba_reference.py) refines on frames
# 31, 52 and 73 and peaks at 0.0477 m pose error on frame 79, the last of
# the 80 (its error grows from frame ~55 and each refinement pulls it
# back).  The bound leaves the port ~50 % above the reference's own error;
# 3 warm-up plus BA_FRAMES timed frames reach the third refinement with 6
# frames to spare.
BA_REF_POSE_M = 0.0477
BA_POSE_TOL_M = 0.072
BA_FRAMES = 77
# the card's solve of the first window against the port's solve of the
# same WindowProblem on the CPU (cuSOLVER against LAPACK Cholesky)
BA_SOLVE_TOL = 1e-3
VIEWER_FRAMES = 3  # phase 9: frames run with the live viewer on
# phase 8b, bench.py's BA_SCENARIOS["loc_kick0.2_w5"] on the JAX reference
# (BENCH_DETAIL.json, ba_ab_table): ATE with BA off and on, metres
BA_AB_REF_M = (0.1338, 0.1258)
# phase 9: pixels hit on one side only when the card's depth image is held
# against the CPU's rasterization of the same mesh (a pixel centre exactly
# on an edge may fall either side), and the relative depth tolerance
RASTER_PIXEL_SHARE = 1e-3
RASTER_RTOL = 1e-5
# phase 11: KITTI replay frames timed after 3 warm-up, and the bundles of
# each sensor-input path run again on the CPU
REPLAY_FRAMES = 20
PARITY_FRAMES = 4
# phase 12: the camera of the R3LIVE handheld rig whose datasets the
# reference's texture application targets (1280×1024, f ≈ 863 px), mounted
# on the body looking forward (camera x right, y down, z along body +x)
CAM_W, CAM_H, CAM_F = 1280, 1024, 863.0
CAM_R_BC = np.array([[0.0, 0.0, 1.0], [-1.0, 0.0, 0.0], [0.0, -1.0, 0.0]])
CAM_T_BC = np.array([0.10, 0.0, 0.05])
TEX_EVERY = 3   # render every 3rd Avia frame (host ray-casting per image)
# median |colour − paint| over the coloured points: 1.5× the 1.39 the port
# gives on the CPU at a cut size (320×256 and 640×512 images, the Avia
# preset at 4,096 rays without compaction, 33 frames;
# tests/torch_texture_bounds.py)
TEX_COLOR_TOL = 2.1
# card against CPU: render_points fields at this relative tolerance where
# both took the same gate decision, and at most RENDER_FLIPS decisions
# apart (arccos and the bilinear weights may round differently); LK flows
# within LK_CPU_TOL_PX, at most LK_STATUS_FLIPS statuses apart.  Ten
# Gauss-Newton updates on 441-pixel sums taken in another order on each
# of 3 levels: the worst flow difference over the ~880 tracked features
# was 1.46e-3 px on an H100 (NVIDIA H100 80GB HBM3, 700.00 W); the bound
# is 3.4× that
RENDER_RTOL = 1e-5
RENDER_FLIPS = 2
LK_CPU_TOL_PX = 5e-3
LK_STATUS_FLIPS = 2
# LK from frame LK_FRAME to the next (launch ramp, ~18 px median motion)
# on a grid of 38 × 30 = 1,140 features; of the chosen ones (lk_truth),
# ≥ LK_MIN_TRACKED tracked, error median ≤ 1.5× and share within 1 px
# ≥ the 0.100 px and 0.962 the port gives on the CPU at full size
# (tests/torch_texture_bounds.py), less a margin
LK_FRAME = 9
LK_STEP, LK_MARGIN = 32, 40
LK_RANGE_PX = 40.0   # half window 10 × 2^(3 levels − 1)
LK_MIN_TRACKED = 0.9
LK_MEDIAN_TOL_PX = 0.15
LK_WITHIN_1PX = 0.9
# phase 13: the dist/ path.  Worlds of 2 ranks share the one card over
# gloo; DIST_SLAB = 32 meshing voxels per slab gives keep fraction × margin
# (32 + 4)/(32·2)·1.5 = 0.84 < 1, so the pre-partitioned append runs and
# the per-rank budgets scale (1024 → 864 active voxels, chunk 512 → 216)
DIST_WORLD = 2
DIST_SLAB = 32
DIST_FRAMES = 20          # timed, after 3 warm-up
DIST_SHARDED_LIO_FRAMES = 5
DIST_EXACT_FRAMES = 3     # phase 4's first scans, meshed again in 13b
NCCL_FRAMES = 4
SCALING_FRAMES = 4
# window BA, point-sharded against single-device (tests/test_window_ba.py:168)
DIST_BA_TOL = 1e-4
# dp LIO against the single-device pipeline (phase 4) is printed, not
# bounded.  The dp step downsamples each rank's rows to map_update_points /
# n cells; here rank 0's half of the scan holds more 0.5 m cells than that
# (4,544 against 4,096 on frame 5), so every frame it drops its forward-most
# cells and the two pipelines fit different points.  At 32,768 and 65,536
# rays no rank truncates and the JAX dp step parts from its single-device
# pipeline by 0.0062 and 0.0131 m (tests/torch_dist_reference.py --rays N),
# so the cut sizes cannot bound the full-width gap; the pose bound holds
# each pipeline to ground truth

# audit: a triangle on which the incircle oracle and the pairs argmin
# disagree must have an f64 incircle margin (on the lifted points both
# see) below this fraction of scale⁴ — 10× the keep threshold ε = 1e-6·s⁴
AUDIT_TIE = 1e-5
# phase 14: the cumulative chain of tools/torch_ablate_e2e.py, base first
# and last (host load moves frame times between runs), fake_tri3 beside it;
# the chain runs ABLATE_PASSES times and a frame's time is its least over
# the passes (host noise only adds)
ABLATE_WARMUP, ABLATE_FRAMES, ABLATE_PASSES = 3, 10, 3
ABLATE_CHAIN = ("base", "lioonly", "app_cell0", "app_insert0", "app_alloc0",
                "app_file0", "app_active0", "skip_tri", "pull0", "argmin0",
                "pairs0", "compact0", "tri30", "gather0", "sort30", "base",
                "fake_tri3")
ABLATE_NO_KERNEL = ("lioonly", "app_cell0", "app_insert0", "app_alloc0",
                    "app_file0", "app_active0", "skip_tri", "pull0")
# phase 15: tools/torch_profile_lio.py's warm-up frames and calls a stage
# (its defaults, but 10 calls for its 20), and
# tools/torch_profile_stages.py's frames (its defaults)
PROFILE_WARM, PROFILE_REPEAT = 5, 10
PROFILE_STAGES_WARMUP, PROFILE_STAGES_FRAMES = 3, 10
# phase 3b: the probe limit that exhausts lanes at the plane map's load
HASH_SHORT_PROBE = 1
# phase 16: the frames after which both pipelines compact their plane map
# to half its voxels (neither plane map reaches its high-water mark in
# these runs), and the Avia frames after 3 warm-up
GRAPH_COMPACT_AT = (15, 30)
GRAPH_AVIA_COMPACT_AT = 15
GRAPH_AVIA_FRAMES = 30
# the path kernels' launches and device runs on each path, by path
# (path_counts)
PATH_COUNTS = {}
# the kernels whose launches every path counts (path_counts): the LIO's
# lookups are the planes and parent forms, the mesh's the neighbours form;
# the LIO-only paths count all but pairs_argmin and the neighbours
PATH_KERNELS = ("pairs_argmin", "hash_lookup_planes", "hash_lookup_parent",
                "hash_lookup_neighbors", "hash_insert", "scatter_drop",
                "segment_sum")
LIO_KERNELS = ("hash_lookup_planes", "hash_lookup_parent", "hash_insert",
               "scatter_drop", "segment_sum")
# the IF nodes' set kernel (kernels/graph_cond.py): it runs only inside the
# captured graphs, so path_counts checks it on every path that captures
COND_KERNEL = "graph_cond"
COUNTED = PATH_KERNELS + (COND_KERNEL,)
# kernels that no path may launch, counted wherever path_now reads the
# counts all the same: the lookup's coords form, whose callers all moved to
# the three forms (path_counts fails if one ran)
OFF_PATH = ("hash_lookup",)
# the coords-form launches captured into one graph to read its edges and
# time a launch inside a replayed chain (coords_graph)
COORDS_CHAIN = 50
# the lookup forms (kernels/hash_probe.py), by the kernel's name
LOOKUP_FORMS = {"hash_lookup_planes": "planes",
                "hash_lookup_parent": "parent",
                "hash_lookup_neighbors": "neighbors"}


def log(msg: str) -> None:
    print(msg, flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout
    return out.strip().splitlines()[0]


def kitti_config():
    """bench.py::kitti_config: the kitti preset at its true operating point
    (131,072-point scans, IMU-less constant-twist mode, capacities sized so
    a 40-frame outdoor run crosses the compaction high-water mark)."""
    from immesh_tpu_torch.config import PRESETS
    base = PRESETS["kitti"]()
    return base.replace(
        preprocess=base.preprocess.__class__(
            lidar_type=100, blind=0.05, max_points=131072),
        voxel_map=dataclasses.replace(
            base.voxel_map, touched_voxels_per_scan=1024),
        mesh=base.mesh.__class__(
            pts_minimum_scale=0.15, voxel_resolution=0.6,
            points_capacity=2 ** 17, voxel_capacity=2 ** 15,
            compact_check_every=8, local_map_radius=120.0,
            active_voxels_per_frame=1024, mesh_chunk=512),
    )


def small_config():
    """A KITTI-shaped configuration cut to 8,192 rays and small capacities
    (the one tests/test_torch_joint.py holds against the JAX reference)."""
    from immesh_tpu_torch.config import PRESETS
    base = PRESETS["kitti"]()
    return base.replace(
        preprocess=base.preprocess.__class__(
            lidar_type=100, blind=0.05, max_points=8192),
        voxel_map=dataclasses.replace(
            base.voxel_map, capacity=2 ** 13, touched_voxels_per_scan=512),
        lio=dataclasses.replace(base.lio, map_update_points=2048),
        mesh=base.mesh.__class__(
            pts_minimum_scale=0.15, voxel_resolution=0.6,
            points_capacity=2 ** 13, voxel_capacity=2 ** 11,
            compact_check_every=8, local_map_radius=40.0,
            active_voxels_per_frame=128, file_voxels_per_frame=1024,
            max_pts_per_frame=2000, mesh_chunk=64),
    )


def make_sim(n_rays: int, rings: int, clockwise: bool = False):
    from immesh_tpu_torch.frontend.sim import (
        ForwardTrajectory, LidarImuSimulator, outdoor_scene)
    return LidarImuSimulator(
        scene=outdoor_scene(length=400.0), traj=ForwardTrajectory(speed=9.0),
        n_rays=n_rays, rings=rings, max_range=120.0, seed=0,
        clockwise=clockwise)


def bundle(f, cfg, device):
    from immesh_tpu_torch.frontend.types import ScanBundle
    return ScanBundle.from_numpy(
        f.pts, f.t_rel, f.imu_stamps, f.imu_acc, f.imu_gyr, f.scan_duration,
        cfg.preprocess.max_points, cfg.imu.max_imu_per_scan, device=device)


# ---------------------------------------------------------------------------
# phase 2: pairs_argmin against its plain version
# ---------------------------------------------------------------------------
def pairs_inputs(seed: int, A: int, K: int, fill: float = 0.5):
    """Channel inputs as delaunay_pairs_w builds them, from voxel-sized
    point sets with the cases the kernel must get right: a share `fill` of
    valid points, a gridded (cocircular) voxel, an all-masked voxel, voxels
    with one and two valid points."""
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-0.3, 0.3, (A, K, 2)).astype(np.float32)
    mask = rng.random((A, K)) < fill
    g = np.stack(np.meshgrid(np.arange(7), np.arange(7)), -1).reshape(-1, 2)
    g = (g[:K] * 0.1 - 0.3).astype(np.float32)
    uv[0, :len(g)] = g
    mask[0, :len(g)] = True
    mask[1] = False
    mask[2] = False
    mask[2, 5] = True
    mask[3] = False
    mask[3, [0, K - 1]] = True
    tb = rng.integers(-2 ** 31, 2 ** 31 - 1, (A, K), dtype=np.int32)
    return uv, mask, tb


def channels(uv, mask, tb, device):
    """(u, v, lift, valid, d_eps) as delaunay_pairs_w hands them to the
    kernel on the main path (tie_scale of the kitti preset)."""
    from immesh_tpu_torch.mesh.delaunay import pairs_channels
    return pairs_channels(
        torch.from_numpy(uv).to(device), torch.from_numpy(mask).to(device),
        tiebreak=torch.from_numpy(tb).to(device), tie_scale=TIE_SCALE)


def event_ms(fn, reps: int) -> float:
    """Median over `reps` single calls, each timed with CUDA events (host
    work inside fn included)."""
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def device_ms(launch, n: int = 50, batches: int = 5) -> float:
    """Device time of one launch: the median over `batches` of n back-to-back
    launches between two CUDA events, averaged over n.  A spin kernel holds
    the stream while the host enqueues them, so the host's time per launch
    stays out of the reading."""
    times = []
    for _ in range(batches):
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)  # ~10 ms at the H100's clock
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(n):
            launch()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / n)
    return statistics.median(times)


def pairs_bound_ms(u, v, valid, d_eps) -> tuple:
    """Least time for this data: operations the formula needs (6 per valid
    (i, j) pair for the edge terms, 5 per valid (i, j, k) for the side test
    and 8 more — difference, two products, sums and the divide — where k is
    left of the edge) over the f32 peak, against the bytes each input is
    read and the output written once over the memory rate."""
    A, K = u.shape
    ok = valid > 0
    n = ok.sum(-1).to(torch.float64)
    pairs = float((n * n).sum())
    triples = float((n * n * n).sum())
    left = 0.0
    for a0 in range(0, A, 64):
        uu, vv = u[a0:a0 + 64], v[a0:a0 + 64]
        du = uu[:, None, :] - uu[:, :, None]            # [a, i, j] = u_j − u_i
        dv = vv[:, None, :] - vv[:, :, None]
        d = (du[:, :, :, None] * dv[:, :, None, :]
             - dv[:, :, :, None] * du[:, :, None, :])   # [a, i, j, k]
        o = ok[a0:a0 + 64]
        okt = o[:, :, None, None] & o[:, None, :, None] & o[:, None, None, :]
        left += float((okt & (d > d_eps[a0:a0 + 64, None, None, None])).sum())
    ops = 6 * pairs + 5 * triples + 8 * left
    nbytes = 4 * (4 * A * K + A) + 4 * A * K * K
    t_ops = 1e3 * ops / PEAK_F32_OPS_PER_S
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


# (seed, A, K, share of valid points): the KITTI chunk (512, 48) at three
# seeds and at ~5 % and 100 % fill, the Avia chunk (64, 48), the smallest
# and largest K the kernel takes, and the rank-local chunk (216, 48) of the
# dist path (phase 13)
PAIRS_CASES = ((0, 512, 48, 0.5), (1, 512, 48, 0.5), (2, 509, 48, 0.5),
               (3, 64, 48, 0.5), (4, 512, 48, 0.05), (5, 512, 48, 1.0),
               (6, 64, 20, 0.5), (7, 64, 128, 0.5), (8, 64, 128, 1.0),
               (9, 216, 48, 0.5))


def phase_kernels(dev):
    from immesh_tpu_torch.kernels import pairs_argmin as pk
    from immesh_tpu_torch.mesh.delaunay import delaunay_pairs_w

    max_err = 0
    for seed, A, K, fill in PAIRS_CASES:
        uv, mask, tb = pairs_inputs(seed, A, K, fill)
        ch = channels(uv, mask, tb, dev)
        Wk = pk.pairs_argmin_cuda(*ch)
        Wp = pk.pairs_argmin_plain(*ch)
        torch.cuda.synchronize()
        diff = int((Wk.long() - Wp.long()).abs().max())
        max_err = max(max_err, diff)
        if not torch.equal(Wk, Wp):
            raise AssertionError(
                f"pairs_argmin: kernel and plain version differ at "
                f"{int((Wk != Wp).sum())} of {Wk.numel()} entries "
                f"(seed {seed}, A={A}, K={K}, fill {fill})")
        # the whole Delaunay core: card (kernel) against CPU (plain version)
        Wg, eg = delaunay_pairs_w(
            torch.from_numpy(uv).to(dev), torch.from_numpy(mask).to(dev),
            tiebreak=torch.from_numpy(tb).to(dev), tie_scale=TIE_SCALE)
        Wc, ec = delaunay_pairs_w(
            torch.from_numpy(uv), torch.from_numpy(mask),
            tiebreak=torch.from_numpy(tb), tie_scale=TIE_SCALE)
        if not (torch.equal(Wg.cpu(), Wc) and torch.equal(eg.cpu(), ec)):
            raise AssertionError(
                f"delaunay_pairs_w: card and CPU differ (seed {seed}): W at "
                f"{int((Wg.cpu() != Wc).sum())}, emit at "
                f"{int((eg.cpu() != ec).sum())}")
        log(f"[kernels] pairs_argmin seed={seed} A={A} K={K} fill "
            f"{float(mask.mean()):.3f}: W bit-identical ({Wk.numel()} "
            f"entries, {int((Wk >= 0).sum())} with a third vertex), "
            f"delaunay_pairs_w W/emit equal, {int(ec.sum())} triangles")

    lib = pk._library()
    entry = {"name": "pairs_argmin", "route": "cuda",
             "source": "immesh_tpu_torch/csrc/pairs_argmin.cu",
             "replaces": "immesh_tpu/mesh/delaunay.py:289",
             "max_abs_err": max_err, "library_ms": None}
    for A, key in ((512, ""), (64, "_64"), (216, "_216")):
        uv, mask, tb = pairs_inputs(0, A, 48)
        ch = channels(uv, mask, tb, dev)
        W = torch.empty((A, 48, 48), dtype=torch.int32, device=dev)
        ms = device_ms(lambda: pk._launch(lib, *ch, W))
        wrapper_ms = event_ms(lambda: pk.pairs_argmin_cuda(*ch), 50)
        bound_ms, bound_by = pairs_bound_ms(ch[0], ch[1], ch[3], ch[4])
        entry.update({"ms" + key: ms, "wrapper_ms" + key: wrapper_ms,
                      "bound_ms" + key: bound_ms, "bound_by" + key: bound_by})
        if A == 512:
            entry["plain_ms"] = event_ms(lambda: pk.pairs_argmin_plain(*ch), 5)
        log(f"[kernels] pairs_argmin ({A}, 48): kernel {1e3 * ms:.2f} us "
            f"(device time, median of 5 x 50 launches), wrapper call "
            f"{1e3 * wrapper_ms:.2f} us (median of 50), bound "
            f"{1e3 * bound_ms:.2f} us ({bound_by})"
            + (f", plain version {1e3 * entry['plain_ms']:.1f} us"
               if A == 512 else ""))
    return entry


# ---------------------------------------------------------------------------
# phase 2: incircle against its plain version
# ---------------------------------------------------------------------------
def incircle_inputs(seed: int, A: int, K: int, device):
    """(u, v, lift, w, min_area, tris) as delaunay_mask hands them to the
    kernel, from voxel-sized point sets with the cases the kernel must get
    right: ~20 % masked points, a gridded (cocircular) voxel, an all-masked
    voxel, a collinear voxel (every candidate −inf), a NaN coordinate on a
    masked point (every live candidate of that voxel NaN: keep is False)
    and one on a valid point (the voxel's scale is NaN: all −inf)."""
    from immesh_tpu_torch.mesh.delaunay import _lifted, _tri_candidates
    rng = np.random.default_rng(seed)
    uv = rng.uniform(-0.3, 0.3, (A, K, 2)).astype(np.float32)
    mask = rng.random((A, K)) < 0.8
    g = np.stack(np.meshgrid(np.arange(7), np.arange(7)), -1).reshape(-1, 2)
    g = (g[:K] * 0.1 - 0.3).astype(np.float32)
    uv[0, :len(g)] = g
    mask[0, :len(g)] = True
    mask[1] = False
    uv[2, :, 0] = np.linspace(-0.3, 0.3, K)
    uv[2, :, 1] = 0.5 * uv[2, :, 0]
    mask[2] = True
    uv[3, 1, 0] = np.nan
    mask[3, 1] = False
    uv[4, 2, 1] = np.nan
    mask[4, 2] = True
    tb = rng.integers(-2 ** 31, 2 ** 31 - 1, (A, K), dtype=np.int32)
    uv_t, m_t = (torch.from_numpy(x).to(device) for x in (uv, mask))
    u, v, lift, scale = _lifted(uv_t, m_t, 1e-6,
                                torch.from_numpy(tb).to(device), TIE_SCALE)
    return (u.contiguous(), v.contiguous(), lift.contiguous(),
            m_t.to(torch.float32).contiguous(),
            (1e-6 * scale * scale).contiguous(), _tri_candidates(K, device))


def incircle_bound_ms(w, out) -> tuple:
    """Least time for this data: 14 operations per candidate to gather its
    vertices and test its gates, 15 more to build the plane of a candidate
    that passes them and 8 per (candidate, valid point) of its sweep (four
    products, three sums, one compare), over the f32 peak; against each
    input read and the (A, T) output written once over the memory rate."""
    A, K = w.shape
    T = out.shape[1]
    swept = (~torch.isneginf(out)).sum(-1).to(torch.float64)    # (A,)
    n_valid = (w > 0).sum(-1).to(torch.float64)
    ops = 14.0 * A * T + float((swept * (15 + 8 * n_valid)).sum())
    nbytes = 4 * (4 * A * K + A) + 12 * T + 4 * A * T
    t_ops = 1e3 * ops / PEAK_F32_OPS_PER_S
    t_bytes = 1e3 * nbytes / PEAK_BYTES_PER_S
    return (max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes")


def same_values(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal values, NaN where the other has NaN, infinities equal."""
    return (torch.equal(torch.isnan(a), torch.isnan(b))
            and torch.equal(torch.nan_to_num(a), torch.nan_to_num(b)))


def phase_incircle(dev):
    from immesh_tpu_torch.kernels import incircle as ik

    max_err = 0.0
    for seed, A, K in ((0, 512, 48), (1, 509, 48), (2, 64, 20)):
        args = incircle_inputs(seed, A, K, dev)
        ok = ik.incircle_min_scores_cuda(*args)
        op = ik.incircle_min_scores_plain(*args)
        torch.cuda.synchronize()
        fin = torch.isfinite(ok) & torch.isfinite(op)
        if bool(fin.any()):
            max_err = max(max_err, float((ok - op)[fin].abs().max()))
        if not same_values(ok, op):
            raise AssertionError(
                f"incircle: kernel and plain version differ at "
                f"{int((ok.nan_to_num() != op.nan_to_num()).sum())} of "
                f"{ok.numel()} entries (seed {seed}, A={A}, K={K})")
        gated = torch.isneginf(ok)
        if not (gated[1].all() and gated[2].all() and gated[4].all()
                and torch.isnan(ok[3][~gated[3]]).all()
                and not torch.isnan(ok[5:]).any()):
            raise AssertionError(
                f"incircle: an edge-case voxel scored wrongly (seed {seed})")
        log(f"[kernels] incircle seed={seed} A={A} K={K}: min scores "
            f"value-identical ({ok.numel()} entries, {int(gated.sum())} "
            f"gated, {int(torch.isnan(ok).sum())} NaN, "
            f"{int((ok >= -1e-6).sum())} ≥ −1e-6)")

    args = incircle_inputs(0, 512, 48, dev)
    out = torch.empty((512, args[5].shape[0]), dtype=torch.float32,
                      device=dev)
    ms = device_ms(lambda: ik._launch(*args, out))
    wrapper_ms = event_ms(lambda: ik.incircle_min_scores_cuda(*args), 50)
    plain_ms = event_ms(lambda: ik.incircle_min_scores_plain(*args), 5)
    bound_ms, bound_by = incircle_bound_ms(args[3], out)
    log(f"[kernels] incircle (512, 48), T={args[5].shape[0]}: kernel "
        f"{1e3 * ms:.1f} us (device time, median of 5 x 50 launches), "
        f"wrapper call {1e3 * wrapper_ms:.1f} us (median of 50), plain "
        f"version {1e3 * plain_ms:.1f} us, bound {1e3 * bound_ms:.2f} us "
        f"({bound_by})")
    return {"name": "incircle", "route": "cuda",
            "source": "immesh_tpu_torch/csrc/incircle.cu",
            "replaces": "immesh_tpu/mesh/delaunay.py:44",
            "max_abs_err": max_err, "ms": ms, "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}


# ---------------------------------------------------------------------------
# phase 3: int32 arithmetic on the card
# ---------------------------------------------------------------------------
def phase_ints(dev):
    from immesh_tpu_torch.core.ops import segment_sum
    from immesh_tpu_torch.kernels import hash_probe as hp
    from immesh_tpu_torch.map.hash import (
        _fingerprint, _hash, frame_unique_coords)
    from immesh_tpu_torch.mesh.triangles import _pos_hash

    rng = np.random.default_rng(0)
    c = rng.integers(-2 ** 31, 2 ** 31 - 1, (4096, 4), dtype=np.int32)
    c[:8] = [[2 ** 31 - 1, -2 ** 31, 0, -1]] * 8
    p = rng.normal(0, 100, (4096, 3)).astype(np.float32)
    small = rng.integers(-3, 3, (4096, 3), dtype=np.int32)
    m = rng.random(4096) < 0.8
    tc, tp = torch.from_numpy(c), torch.from_numpy(p)
    checks = {
        "_hash": lambda x, _: _hash(x, 2 ** 18 - 1),
        "_fingerprint": lambda x, _: _fingerprint(x),
        "_pos_hash": lambda _, y: _pos_hash(y),
    }
    for name, fn in checks.items():
        a, b = fn(tc, tp), fn(tc.to(dev), tp.to(dev)).cpu()
        if not torch.equal(a, b):
            raise AssertionError(f"{name}: card and CPU bits differ")
    ts, tm = torch.from_numpy(small), torch.from_numpy(m)
    a = frame_unique_coords(ts, tm, 100)
    b = frame_unique_coords(ts.to(dev), tm.to(dev), 100)
    for x, y in zip(a, b):
        if not torch.equal(x, y.cpu()):
            raise AssertionError("frame_unique_coords: card and CPU differ")
    # segment sums (scan aggregates, downsampling) take no atomics: the
    # sequential sum, the CPU's bits, on every run; ids outside [0, 1025)
    # dropped
    vals = torch.from_numpy(rng.normal(size=(131072, 11)).astype(np.float32))
    seg = torch.from_numpy(rng.integers(-3, 1100, 131072))
    a = segment_sum(vals.to(dev), seg.to(dev), 1025)
    if not torch.equal(a, segment_sum(vals.to(dev), seg.to(dev), 1025)):
        raise AssertionError("segment_sum differs between two runs on the card")
    if not same_bits(a.cpu(), segment_sum(vals, seg, 1025)):
        raise AssertionError("segment_sum: card and CPU bits differ")
    # the hash kernels' own arithmetic: the same keys inserted and looked up
    # by the kernels on the card and by the plain versions on the CPU, in a
    # table at 50 % load (planted rows repeat: only the first is valid)
    valid = torch.ones(4096, dtype=torch.bool)
    valid[1:8] = False
    tables = [(torch.full((2 ** 13, 4), hp.EMPTY, dtype=torch.int32,
                          device=d),
               torch.zeros(2 ** 13, dtype=torch.int32, device=d))
              for d in ("cpu", dev)]
    a = hp.insert_plain(tc, valid, *tables[0], 32)
    a = a + (hp.lookup_plain(tc, tables[0][1], 32),)
    b = hp.insert_cuda(tc.to(dev), valid.to(dev), *tables[1], 32)
    b = b + (hp.lookup_cuda(tc.to(dev), tables[1][1], 32),)
    for x, y in zip(a + tables[0], b + tables[1]):
        if not torch.equal(x, y.cpu()):
            raise AssertionError("hash_probe kernels on the card and the "
                                 "plain versions on the CPU differ")
    log("[ints] _hash, _fingerprint, _pos_hash and frame_unique_coords are "
        "bit-identical on the card and the CPU, and so are the hash_probe "
        "kernels' slots, new flags, keys and fingerprints (4,096 int32 keys "
        "over the full range into 8,192 slots) against the plain versions "
        "on the CPU; so are segment_sum's sums (131,072 rows of 11 into "
        "1,025 segments, the ids outside them dropped)")


# ---------------------------------------------------------------------------
# phase 3b: the hash probe kernels against their plain versions
# ---------------------------------------------------------------------------
def reset_counts() -> None:
    """Every kernel's launch count to 0, just before a path is driven."""
    from immesh_tpu_torch.kernels import graph_cond as gc
    from immesh_tpu_torch.kernels import hash_probe as hp
    from immesh_tpu_torch.kernels import incircle as ik
    from immesh_tpu_torch.kernels import pairs_argmin as pk
    from immesh_tpu_torch.kernels import scatter_drop as sd
    from immesh_tpu_torch.kernels import segment_sum as ss
    pk.reset_launches()
    ik.reset_launches()
    hp.reset_launches()
    sd.reset_launches()
    ss.reset_launches()
    gc.reset_launches()


def launch_counts() -> dict:
    """Every kernel's launches by its wrapper since reset_counts(), by
    kernel: eager ones (a launch recorded into a CUDA graph counts in the
    module's `captured`, and its replays in the kernel's device counter,
    path_now)."""
    from immesh_tpu_torch.kernels import graph_cond as gc
    from immesh_tpu_torch.kernels import hash_probe as hp
    from immesh_tpu_torch.kernels import incircle as ik
    from immesh_tpu_torch.kernels import pairs_argmin as pk
    from immesh_tpu_torch.kernels import scatter_drop as sd
    from immesh_tpu_torch.kernels import segment_sum as ss
    return {"pairs_argmin": pk.launches, "incircle": ik.launches,
            **hp.launches, "scatter_drop": sd.launches,
            "segment_sum": ss.launches, COND_KERNEL: gc.launches}


def path_now() -> dict:
    """The COUNTED and OFF_PATH kernels' counts since reset_counts():
    "launches" by their wrappers (launch_counts), "recorded" the launches
    they recorded into CUDA graphs (kernels/build.py::captured_launches)
    and "runs" on the device, eager and replayed in CUDA graphs, from the
    kernels' own device counters (synchronises)."""
    from immesh_tpu_torch.kernels import graph_cond as gc
    from immesh_tpu_torch.kernels import hash_probe as hp
    from immesh_tpu_torch.kernels import pairs_argmin as pk
    from immesh_tpu_torch.kernels import scatter_drop as sd
    from immesh_tpu_torch.kernels import segment_sum as ss
    from immesh_tpu_torch.kernels.build import captured_launches
    launches, recorded = launch_counts(), captured_launches()
    runs = {"pairs_argmin": pk.runs(), **hp.runs(),
            "scatter_drop": sd.runs(), "segment_sum": ss.runs(),
            COND_KERNEL: gc.runs()}
    return {part: {k: n[k] for k in COUNTED + OFF_PATH}
            for part, n in (("launches", launches), ("recorded", recorded),
                            ("runs", runs))}


def body_runs(graphs) -> list:
    """(Body, its runs since reset_counts()) of every IF node of `graphs`
    (utils/graphs.py's Graph), from the set kernel's per-node taken
    counters (synchronises)."""
    from immesh_tpu_torch.kernels import graph_cond as gc
    bodies = [b for g in graphs for b in g.bodies]
    return list(zip(bodies, gc.taken([b.slot for b in bodies])))


def site_runs(graphs) -> dict:
    """The body runs of `graphs` summed by site (device_if's `what`)."""
    out = {}
    for b, n in body_runs(graphs):
        out[b.what] = out.get(b.what, 0) + n
    return out


def if_nodes(graphs) -> dict:
    """The IF nodes of `graphs` by site, and their bodies' node types
    summed by site; fails if a body holds a node a conditional body may
    not hold (an allocation, a free, an event) or a graph's conditional
    nodes are not its bodies."""
    from immesh_tpu_torch.utils.graphs import graph_nodes
    sites, kinds = {}, {}
    for g in graphs:
        outer = graph_nodes(g.graph).get("conditional", 0)
        if outer != len(g.bodies):
            raise AssertionError(f"a graph holds {outer} conditional nodes "
                                 f"and {len(g.bodies)} recorded bodies")
        for b in g.bodies:
            sites[b.what] = sites.get(b.what, 0) + 1
            k = kinds.setdefault(b.what, {})
            for name, n in b.nodes().items():
                k[name] = k.get(name, 0) + n
    bad = {s: k for s, k in kinds.items()
           if set(k) & {"mem_alloc", "mem_free", "event_record",
                        "wait_event", "host"}}
    if bad:
        raise AssertionError(f"conditional bodies hold forbidden nodes: "
                             f"{bad}")
    return {"nodes": sites, "body_node_types": kinds}


def recorded_launches(g) -> dict:
    """The kernel launches recorded into a captured graph (utils/graphs.py's
    Graph), its IF nodes' bodies included, by kernel."""
    out = dict(g.captured)
    for b in g.bodies:
        for k, n in b.captured.items():
            out[k] = out.get(k, 0) + n
    return out


def summed_nodes(graphs) -> dict:
    """The nodes of `graphs` (utils/graphs.py's Graph) by type, summed."""
    out = {}
    for g in graphs:
        for k, n in g.nodes().items():
            out[k] = out.get(k, 0) + n
    return out


def summed_launches(graphs) -> dict:
    """recorded_launches of `graphs`, summed by kernel."""
    out = {}
    for g in graphs:
        for k, n in recorded_launches(g).items():
            out[k] = out.get(k, 0) + n
    return out


def mesh_counters() -> dict:
    """The mesh half's three counters (mesh/pipeline.py::MeshPipeline),
    summed over the frame trace's ring: counted while the trace is on."""
    from immesh_tpu_torch.utils.timers import trace
    counts = trace.frame_counts()
    return {k: sum(c.get(k, 0) for c in counts)
            for k in ("pose_before_mesh", "lio_over_mesh", "mesh_joins")}


def pipe_graphs(p) -> list:
    """The captured graphs (utils/graphs.py's Graph) of a JointPipeline or
    an ImMeshRuntime: its LIO step's, then its mesh step's."""
    return [g for part in (p.lio, p.mesh)
            if part is not None and part.captured is not None
            for g in part.captured.graphs]


def set_launches(graphs) -> dict:
    """The set kernel's launches recorded into `graphs` by site (the site
    of the launch's first IF node); fails unless they are all the graphs'
    recorded set-kernel launches and each sets the nodes of one site
    (the ESIKF's two halves count as one site): one launch a predicate."""
    sites, first = {}, {}
    for g in graphs:
        for b in g.bodies:
            if b.launch not in first:
                first[b.launch] = b.what
                sites[b.what] = sites.get(b.what, 0) + 1
            elif first[b.launch].split("_")[0] != b.what.split("_")[0]:
                raise AssertionError(f"one set launch sets the IF nodes of "
                                     f"{first[b.launch]} and {b.what}")
    recorded = sum(g.captured.get(COND_KERNEL, 0) for g in graphs)
    if sum(sites.values()) != recorded:
        raise AssertionError(f"the graphs recorded {recorded} set launches, "
                             f"their IF nodes name {sites}")
    return sites


def path_counts(path: str, counts=None, graphs=None,
                kernels=PATH_KERNELS) -> dict:
    """The counts of `kernels` on `path` (path_now(), or a rank's), added
    up in PATH_COUNTS, and of the set kernel where the path captured
    graphs.  Fails if a kernel was never launched there or never ran on
    the device, or if the device counted other runs than the eager
    launches plus, for each of the path's captured graphs (`graphs`,
    utils/graphs.py's Graph: the LIO and mesh steps'; () where the path
    captures none; None where they are not at hand, and then the runs must
    be at least the launches), its replays times the launches recorded
    into it outside its IF nodes and each IF node's body runs (the set
    kernel's taken counts) times the launches recorded into that body.
    The set kernel is recorded, never launched eagerly: its wrapper's count
    is what it recorded, and its runs are the replays times its nodes.
    The OFF_PATH kernels are kept too where the counts hold them (path_now's
    do), and must be 0."""
    src = path_now() if counts is None else counts
    if graphs:
        kernels = (*kernels, COND_KERNEL)
    n = {part: {k: src[part].get(k, 0) for k in kernels}
         for part in ("launches", "recorded", "runs") if part in src}
    off = {part: {k: src[part][k] for k in OFF_PATH if k in src[part]}
           for part in n}
    if any(v for c in off.values() for v in c.values()):
        raise AssertionError(f"{path}: a kernel that no path calls was "
                             f"launched or ran there: {off}")
    bodies = body_runs(graphs) if graphs else []
    for k in kernels:
        launched, ran = n["launches"][k], n["runs"][k]
        by_wrapper = launched if k != COND_KERNEL else n["recorded"][k]
        want = (launched if graphs is None else launched + sum(
            g.replays * g.captured.get(k, 0) for g in graphs) + sum(
                t * b.captured.get(k, 0) for b, t in bodies))
        if by_wrapper == 0 or ran == 0 or ran < want or (
                graphs is not None and ran != want):
            raise AssertionError(
                f"{path}: {k} launched {by_wrapper} times by its wrapper "
                f"and run {ran} times on the device (the launches, the "
                f"graphs' replays and their bodies' runs: {want})")
    n = {part: {**c, **off[part]} for part, c in n.items()}
    old = PATH_COUNTS.get(path, {})
    PATH_COUNTS[path] = {part: {k: old.get(part, {}).get(k, 0) + v
                                for k, v in c.items()}
                         for part, c in n.items()}
    return n


def captured_forms(graphs, what: str) -> dict:
    """The hash_insert launches recorded into the CUDA graphs captured since
    reset_counts(), by the kernel's form: every one must be the cluster
    form (each per-frame insert fits one cluster), and they must be all the
    graphs' recorded inserts."""
    from immesh_tpu_torch.kernels import hash_probe as hp
    forms = dict(hp.captured_paths)
    want = sum(g.captured.get("hash_insert", 0) + sum(
        b.captured.get("hash_insert", 0) for b in g.bodies) for g in graphs)
    if forms != {"grid": 0, "cluster": want}:
        raise AssertionError(f"{what}: the graphs recorded hash_insert "
                             f"launches {forms} by form, expected {want} "
                             f"of the cluster form")
    return forms


def kitti_scans(n: int):
    """Phase 4's simulator and its first n scans at the KITTI point."""
    t0 = time.perf_counter()
    sim = make_sim(kitti_config().preprocess.max_points, 64)
    gt = [sim.frame(k) for k in range(n)]
    log(f"[scans] {n} scans of {kitti_config().preprocess.max_points} rays "
        f"made in {time.perf_counter() - t0:.1f} s (set-up)")
    return sim, gt


class FormCall:
    """A recorded call of a lookup form (kernels/hash_probe.py's
    lookup_planes, lookup_parent, lookup_neighbors): its kind and its
    arguments by name, the tensors copied as the call found them."""

    def __init__(self, kind: str, args: dict):
        self.kind, self.args = kind, args

    @property
    def name(self) -> str:
        return f"hash_lookup_{self.kind}"

    @property
    def lanes(self) -> int:
        return next(iter(self.args.values())).shape[0]

    @property
    def fp(self) -> torch.Tensor:
        return self.args["fp"]

    def label(self) -> str:
        a = self.args
        how = {"planes": lambda: (f"{a['levels']} levels"
                                  + (", near" if a["near"] else "")),
               "parent": lambda: f"level {a['level']}",
               "neighbors": lambda: "27 a slot"}[self.kind]()
        return (f"{self.kind} ({self.lanes} lanes, {how}, "
                f"{self.fp.shape[0]} slots)")

    def run(self, version: str, **over):
        """The call again through lookup_<kind>_<version> ("cuda" or
        "plain"), with the arguments in `over` replaced."""
        from immesh_tpu_torch.kernels import hash_probe as hp
        return getattr(hp, f"lookup_{self.kind}_{version}")(
            **{**self.args, **over})

    def old(self, **over):
        """The composition the form replaced: its plain version with the
        coords-form kernel as the probe loop, the path before the forms."""
        from immesh_tpu_torch.kernels import hash_probe as hp
        plain, hp.lookup_plain = hp.lookup_plain, hp.lookup_cuda
        try:
            return self.run("plain", **over)
        finally:
            hp.lookup_plain = plain

    def keys(self):
        """The (K, 4) keys the plain version probes, and their slots."""
        from immesh_tpu_torch.kernels import hash_probe as hp
        seen, plain = [], hp.lookup_plain

        def rec(coords, fp, max_probe):
            slots = plain(coords, fp, max_probe)
            seen.append((coords, slots))
            return slots

        hp.lookup_plain = rec
        try:
            self.run("plain")
        finally:
            hp.lookup_plain = plain
        (out,) = seen
        return out


def outputs(x) -> list:
    return list(x) if isinstance(x, tuple) else [x]


def record_probes(fn):
    """Run fn() with every HashTable lookup and insert recorded as a tuple
    (the inputs, and the table as the call found it) and every call of a
    lookup form as a FormCall.  Returns (fn's result, the calls).  A call
    under CUDA-graph capture is not recorded: its copies would be captured
    into the graph and repeated at every replay."""
    from immesh_tpu_torch.kernels import hash_probe as hp
    calls, lookup, insert = [], hp.lookup, hp.insert
    forms = {k: getattr(hp, f"lookup_{k}") for k in LOOKUP_FORMS.values()}

    def rec_lookup(coords, fp, max_probe):
        if not torch.cuda.is_current_stream_capturing():
            calls.append(("lookup", coords.clone(), fp.clone(), max_probe))
        return lookup(coords, fp, max_probe)

    def rec_insert(coords, valid, keys, fp, max_probe):
        if not torch.cuda.is_current_stream_capturing():
            calls.append(("insert", coords.clone(), valid.clone(),
                          keys.clone(), fp.clone(), max_probe))
        return insert(coords, valid, keys, fp, max_probe)

    def recorder(kind):
        inner = forms[kind]
        sig = inspect.signature(getattr(hp, f"lookup_{kind}_plain"))

        def rec(*args, **kwargs):
            if not torch.cuda.is_current_stream_capturing():
                bound = sig.bind(*args, **kwargs).arguments
                calls.append(FormCall(kind, {
                    k: v.clone() if torch.is_tensor(v) else v
                    for k, v in bound.items()}))
            return inner(*args, **kwargs)
        return rec

    hp.lookup, hp.insert = rec_lookup, rec_insert
    for kind in forms:
        setattr(hp, f"lookup_{kind}", recorder(kind))
    try:
        out = fn()
    finally:
        hp.lookup, hp.insert = lookup, insert
        for kind, f in forms.items():
            setattr(hp, f"lookup_{kind}", f)
    return out, calls


def split_calls(calls):
    """(the lookup and insert tuples, the FormCalls) of record_probes'
    calls."""
    return ([c for c in calls if not isinstance(c, FormCall)],
            [c for c in calls if isinstance(c, FormCall)])


class Scatter:
    """A recorded set_drop/add_drop call or group: the kind ("set" or
    "add"), whether it was a group, the dsts as the call found them (copies),
    idx, the srcs (copies, or the scalars) and ok."""

    def __init__(self, kind, group, dsts, idx, srcs, ok):
        self.kind, self.group = kind, group
        self.dsts, self.idx, self.srcs, self.ok = dsts, idx, srcs, ok

    def label(self) -> str:
        fields = "+".join(f"{str(d.dtype)[6:]}{list(d.shape[1:])}"
                          for d in self.dsts)
        return f"{self.kind}{' group' if self.group else ''} {fields}"


def record_scatters(fn):
    """Run fn() with every set_drop/add_drop and set_drop_group/
    add_drop_group on the card recorded as a Scatter.  Returns (fn's
    result, the calls).  A replay of the captured LIO step calls no
    wrapper, so its scatters are not among them, and a call under capture
    is not recorded (record_probes)."""
    from immesh_tpu_torch.kernels import scatter_drop as sd
    calls, names = [], ("set_cuda", "add_cuda", "set_group_cuda",
                        "add_group_cuda")
    saved = {n: getattr(sd, n) for n in names}

    def recorder(name):
        inner, group = saved[name], "group" in name

        def rec(dsts, idx, srcs, ok):
            if not torch.cuda.is_current_stream_capturing():
                ds, ss = (dsts, srcs) if group else ((dsts,), (srcs,))
                calls.append(Scatter(
                    name[:3], group, tuple(d.clone() for d in ds),
                    idx.clone(), tuple(x.clone() if torch.is_tensor(x)
                                       else x for x in ss), ok.clone()))
            return inner(dsts, idx, srcs, ok)
        return rec

    for n in names:
        setattr(sd, n, recorder(n))
    try:
        out = fn()
    finally:
        for n, f in saved.items():
            setattr(sd, n, f)
    return out, calls


def probe_rounds(coords, slots, capacity: int, max_probe: int, valid=None,
                 fp=None):
    """Probe rounds each lane ran, read from its result: to the first probe
    that reaches its slot; for a lane without one, to the first empty slot
    of its chain when the lookup's fp is given (an absent key), else
    max_probe (exhausted); 0 for an invalid lane."""
    from immesh_tpu_torch.kernels.hash_probe import _fingerprint, _hash
    mask = capacity - 1
    h0, fq = _hash(coords, mask), _fingerprint(coords)
    if valid is None:
        valid = torch.ones_like(slots, dtype=torch.bool)
    rounds = torch.where(valid, max_probe, 0).long()
    for r in range(max_probe - 1, -1, -1):
        cand = (h0 + r * fq) & mask
        hit = cand == slots
        if fp is not None:
            hit |= (slots < 0) & (fp[cand.long()] == 0)
        rounds = torch.where(valid & hit, r + 1, rounds)
    return rounds


def probe_slots(coords, rounds, capacity: int):
    """The slots the lanes' probe rounds read (probe_rounds' `rounds`):
    round r's slot of every lane that runs more than r rounds."""
    from immesh_tpu_torch.kernels.hash_probe import _fingerprint, _hash
    mask = capacity - 1
    h0, fq = _hash(coords, mask), _fingerprint(coords)
    most = int(rounds.max()) if rounds.numel() else 0
    return torch.cat([h0[:0]] + [((h0 + r * fq) & mask)[rounds > r]
                                 for r in range(most)])


def sectors(idx, elem_bytes: int) -> int:
    """The 32-byte sectors that the elements idx of an array of
    elem_bytes-wide elements lie in, each counted once: what a gather of
    them must move from memory at the least (lanes that share a voxel
    probe the same slots; the tables fit in L2, so more reads cost no
    more memory traffic)."""
    return int(torch.unique(idx.long() * elem_bytes // 32).numel())


def insert_bound_ms(n_lanes: int, coords, rounds, capacity: int,
                    won_slots) -> tuple:
    """Least time of an insert for this data, by bytes over the memory
    rate: each lane's input read once (16 B key, 1 B valid) and output
    written once (4 B slot, 1 B new), each distinct 32-byte sector of the
    key rows its probe rounds read once, and each distinct sector of the
    winners' key rows and fingerprints written once."""
    nbytes = n_lanes * 22 + 32 * (
        sectors(probe_slots(coords, rounds, capacity), 16)
        + sectors(won_slots, 16) + sectors(won_slots, 4))
    return 1e3 * nbytes / PEAK_BYTES_PER_S, "bytes"


def histogram(rounds) -> str:
    h = torch.bincount(rounds.cpu())
    return ", ".join(f"{r}: {int(c)}" for r, c in enumerate(h) if c)


def insert_paths(u: int) -> tuple:
    """The insert kernel's forms that take u lanes: the one insert_path
    gives (the wrapper's), then the cooperative grid if that is another."""
    from immesh_tpu_torch.kernels import hash_probe as hp
    return tuple(dict.fromkeys((hp.insert_path(u), "grid")))


def replay_probes(calls, what: str):
    """Every recorded call again through each kernel and its plain version,
    on copies of the table it found, at the call's max_probe and at
    HASH_SHORT_PROBE: slots, new, keys and fp must be equal, and some insert
    lane must exhaust at HASH_SHORT_PROBE.  Logs the calls and their probe
    rounds; returns each kernel's largest absolute difference over its
    outputs, and each call's probe rounds per lane at its own max_probe."""
    from immesh_tpu_torch.kernels import hash_probe as hp
    err = {"hash_lookup": 0, "hash_insert": 0}
    exhausted, rounds, n_paths = 0, [], {}
    for c in calls:
        for mp in (c[-1], HASH_SHORT_PROBE):
            if c[0] == "lookup":
                name, (_, coords, fp, _) = "hash_lookup", c
                k, p = hp.lookup_cuda(coords, fp, mp), hp.lookup_plain(
                    coords, fp, mp)
                outs = [(k, p)]
                if mp == c[-1]:
                    rounds.append(probe_rounds(coords, p, fp.shape[0], mp,
                                               fp=fp))
            else:
                name, (_, coords, valid, keys, fp, _) = "hash_insert", c
                tp = (keys.clone(), fp.clone())
                ps, pn = hp.insert_plain(coords, valid, *tp, mp)
                outs = []
                for path in insert_paths(coords.shape[0]):
                    tk = (keys.clone(), fp.clone())
                    ks, kn = hp.insert_cuda(coords, valid, *tk, mp, path)
                    outs += [(ks, ps), (kn, pn), *zip(tk, tp)]
                    n_paths[path] = n_paths.get(path, 0) + 1
                if mp == c[-1]:
                    rounds.append(probe_rounds(coords, ps, fp.shape[0], mp,
                                               valid))
                else:
                    exhausted += int((valid & (ps < 0)).sum())
            d = max((int((a.long() - b.long()).abs().max())
                     for a, b in outs if a.numel()), default=0)
            err[name] = max(err[name], d)
            if d:
                raise AssertionError(
                    f"{what}: {name} and its plain version differ by {d} on "
                    f"a recorded call ({coords.shape[0]} lanes, "
                    f"{fp.shape[0]} slots, max_probe {mp})")
    if exhausted == 0:
        raise AssertionError(f"{what}: no insert lane exhausted at "
                             f"max_probe {HASH_SHORT_PROBE}")
    by_kind = {}
    for c, r in zip(calls, rounds):
        by_kind.setdefault(c[0], []).append(r)
    shapes = ", ".join(f"{c[0]} {c[1].shape[0]} into {c[-2].shape[0]}"
                       for c in calls)
    log(f"[hash] {what}: {len(calls)} probe calls ({shapes}), each kernel "
        f"bit-identical to its plain version (slots, new, keys, fp) at the "
        f"call's max_probe and at {HASH_SHORT_PROBE}, each insert on every "
        f"form that takes its lanes ({n_paths} insert runs), where "
        f"{exhausted} "
        f"insert lanes exhaust; probe rounds per lane " + "; ".join(
            f"{k} {{{histogram(torch.cat(r))}}}" for k, r in by_kind.items()))
    return err, rounds


def check_form(c: FormCall, what: str, **over) -> None:
    """A form's kernel against its plain version on one call (its
    arguments replaced by `over`): every output bit for bit."""
    k, p = outputs(c.run("cuda", **over)), outputs(c.run("plain", **over))
    bad = [i for i, (a, b) in enumerate(zip(k, p)) if not same_bits(a, b)]
    if bad:
        raise AssertionError(f"{what}: {c.name} and its plain version "
                             f"differ on output(s) {bad} of a call "
                             f"{c.label()} {over}")


def replay_forms(calls, what: str) -> dict:
    """Every recorded FormCall again through its kernel and its plain
    version, at the call's max_probe and at HASH_SHORT_PROBE, bit for bit
    (check_form).  Logs the calls; returns each form's largest difference
    (0: any other raises)."""
    n = {}
    for c in calls:
        for mp in dict.fromkeys((c.args["max_probe"], HASH_SHORT_PROBE)):
            check_form(c, what, max_probe=mp)
        n[c.name] = n.get(c.name, 0) + 1
    log(f"[hash] {what}: {len(calls)} lookup-form calls ({n}: "
        + "; ".join(sorted({c.label() for c in calls})) + f"), each kernel "
        f"bit-identical to its plain version at the call's max_probe and "
        f"at {HASH_SHORT_PROBE}")
    return dict.fromkeys(n, 0)


def _colliding_key(k2: list) -> list:
    """A key k1 != k2 with k2's fingerprint (reference behaviour 2): the
    second coordinate moved by the inverse of its Weyl constant, so the
    fingerprint's sum moves by 1 between an even value and the next, which
    `| 1` erases."""
    weyl = [x % 2 ** 32 for x in (-1640531527, -1274297907, -1981354251,
                                  1183186591)]
    inv = pow(weyl[1], -1, 2 ** 32)
    even = sum(x % 2 ** 32 * w for x, w in zip(k2, weyl)) % 2 ** 32 % 2 == 0
    k1 = list(k2)
    k1[1] = (k2[1] + (inv if even else -inv)) % 2 ** 32
    k1[1] -= 2 ** 32 * (k1[1] >= 2 ** 31)
    return k1


def random_plane_map(dev, load: float, seed: int):
    """A plane map of the KITTI point's shape (kitti_config's: 2^18 slots,
    4 levels of 3 m down to 0.375 m) holding the level keys of random
    points (a third of `load` of the slots, up to 65,536; 30 % of their
    keys left out), topped up with keys far from them to `load`, random
    plane_valid and subdivided flags; and query points: the points, 1,024
    of them at negative coordinates, 768 on voxel boundaries and quarter
    marks, NaN, ±inf, out of int32's range."""
    from immesh_tpu_torch.kernels import hash_probe as hp
    from immesh_tpu_torch.map.voxel_map import VoxelMap
    cfg = kitti_config().voxel_map
    vm = VoxelMap.create(cfg, device=dev)
    cap, L, size = cfg.capacity, cfg.max_layers, cfg.voxel_size
    g = torch.Generator(device=dev).manual_seed(seed)
    n_pts = min(65536, max(1024, int(load * cap / 3)))
    pts = torch.randn((n_pts, 3), generator=g, device=dev) * 40.0
    keys = torch.unique(torch.cat([hp.voxel_coords(pts, size, lvl)
                                   for lvl in range(L)]), dim=0)
    keys = keys[torch.randperm(keys.shape[0], generator=g,
                               device=dev)[:int(0.7 * keys.shape[0])]]
    n_fill = max(0, int(load * cap) - keys.shape[0])
    fill = torch.randint(2 ** 12, 2 ** 20, (n_fill + n_fill // 8, 4),
                         generator=g, device=dev, dtype=torch.int32)
    fill[:, 3] %= L
    fill = torch.unique(fill, dim=0)[:n_fill]
    keys = torch.cat([keys, fill])
    keys = keys[torch.randperm(keys.shape[0], generator=g, device=dev)]
    vm.table.insert(keys.contiguous(), torch.ones(keys.shape[0],
                                                  dtype=torch.bool,
                                                  device=dev))
    vm.plane_valid.copy_(torch.rand(cap, generator=g, device=dev) < 0.5)
    vm.subdivided.copy_(torch.rand(cap, generator=g, device=dev) < 0.6)
    k = torch.randint(-40, 40, (256, 3), generator=g, device=dev).float()
    edges = torch.cat([k * size, (k + 0.25) * size, (k + 0.75) * size,
                       -pts[:1024].abs(), torch.tensor(
                           [[float("nan"), 0, 0], [float("inf"), 1, 2],
                            [3e38, -3e38, 1e10], [-0.0, 0.0, -0.0]],
                           device=dev)])
    return vm, torch.cat([pts, edges]).contiguous()


def plant_cases(vm, q):
    """Rows that put reference behaviours 2 and 4 in the queries, planted
    into vm: a query whose level-0 key k2 misses with an empty home slot
    meets a colliding key k1 there, planar (the own lookup aliases to that
    slot); and points in the outer quarter of an absent level-0 voxel
    toward a present planar one (the near probe finds it).  Returns the
    queries with the behaviour-4 rows appended, the collision's row and
    slot, and the behaviour-4 rows."""
    from immesh_tpu_torch.kernels import hash_probe as hp
    size, mask = vm.cfg.voxel_size, vm.table.capacity - 1
    c0 = hp.voxel_coords(q, size, 0)
    home = hp._hash(c0, mask)
    free = torch.nonzero(vm.table.fp[home.long()] == 0)[:, 0]
    row = int(free[0])
    slot = int(home[row])
    k1 = torch.tensor(_colliding_key(c0[row].tolist()), dtype=torch.int32,
                      device=q.device)
    vm.table.keys[slot] = k1
    vm.table.fp[slot] = hp._fingerprint(k1)
    vm.plane_valid[slot] = True
    keys = vm.table.keys
    planar = (keys[:, 0] != hp.EMPTY) & (keys[:, 3] == 0) & vm.plane_valid
    beside = keys[planar][:2048].clone()  # a planar voxel's +x neighbour
    beside[:, 0] += 1
    absent = beside[vm.table.lookup(beside.contiguous()) < 0][:256, :3]
    absent = absent.float()
    b4 = torch.stack([(absent[:, 0] + 0.1) * size,
                      (absent[:, 1] + 0.5) * size,
                      (absent[:, 2] + 0.5) * size], -1)
    if b4.shape[0] == 0:
        raise AssertionError("no planar voxel with an absent x-neighbour")
    return torch.cat([q, b4]).contiguous(), row, slot, b4.shape[0]


def random_forms(dev) -> dict:
    """Each lookup form against its plain version on random calls: the
    planes form (near and not) and the parent form (each level, a random
    mask) on random_plane_map at the plane map's load (10 %) and at 90 %,
    at max_probe 32, 4 and 1 (lanes exhaust: the check counts them), with
    reference behaviours 2 and 4 planted (plant_cases) and checked; the
    neighbours form on a mesh voxel table (kitti_config's 2^15 slots) at
    10 % and 90 %, from occupied, empty and negative slots.  Returns each
    form's largest difference (0: any other raises)."""
    from immesh_tpu_torch.kernels import hash_probe as hp
    from immesh_tpu_torch.map.hash import HashTable
    t0 = time.perf_counter()
    notes = []
    for seed, load in ((1, 0.1), (2, 0.9)):
        vm, q = random_plane_map(dev, load, seed)
        q, row, slot, n4 = plant_cases(vm, q)
        cfg = vm.cfg
        g = torch.Generator(device=dev).manual_seed(seed)
        mask = torch.rand(q.shape[0], generator=g, device=dev) < 0.8
        base = dict(voxel_size=cfg.voxel_size, fp=vm.table.fp)
        exhausted = 0
        for mp in (32, 4, 1):
            for near in (True, False):
                c = FormCall("planes", dict(
                    q=q, levels=cfg.max_layers, plane_valid=vm.plane_valid,
                    subdivided=vm.subdivided, max_probe=mp, near=near,
                    **base))
                check_form(c, f"random planes at {load:.0%} load")
                if mp == 32 and near:
                    found, sl = c.run("cuda")
                    own, _ = c.run("cuda", q=q[-n4:], near=False)
                    if not (bool(found[row]) and int(sl[row]) == slot
                            and bool(found[-n4:].all())
                            and not bool(own.any())):
                        raise AssertionError(
                            "random planes: reference behaviour 2 or 4 "
                            "does not show")
            for lvl in range(cfg.max_layers):
                check_form(FormCall("parent", dict(
                    pts=q, level=lvl, subdivided=vm.subdivided, mask=mask,
                    max_probe=mp, **base)),
                    f"random parent at {load:.0%} load")
            keys, _ = FormCall("planes", dict(
                q=q, levels=cfg.max_layers, plane_valid=vm.plane_valid,
                subdivided=vm.subdivided, max_probe=mp, near=True,
                **base)).keys()
            exhausted += int(((hp.lookup_plain(keys, vm.table.fp, mp) < 0)
                              & (hp.lookup_plain(keys, vm.table.fp, 32)
                                 >= 0)).sum())
            check_coords(keys, vm.table.fp, mp,
                         f"random coords at {load:.0%} load", full=mp == 32)
        load_now = float((vm.table.fp != 0).float().mean())
        notes.append(f"{cfg.capacity} slots at {100 * load_now:.1f} % "
                     f"load: {exhausted} planes keys exhausted at max_probe "
                     f"4 and 1")
        if load > 0.5 and exhausted == 0:
            raise AssertionError("random planes: no key exhausted")
        del vm, q, mask
        # the neighbours form on a mesh voxel table at the same load
        mcap = kitti_config().mesh.voxel_capacity
        table = HashTable.create(mcap, 32, device=dev)
        raw = torch.randint(-40, 40, (int(1.3 * load * mcap), 3),
                            generator=g, device=dev, dtype=torch.int32)
        raw = torch.unique(raw, dim=0)[:int(load * mcap)]
        table.insert(torch.cat([raw, torch.zeros_like(raw[:, :1])],
                               1).contiguous(),
                     torch.ones(raw.shape[0], dtype=torch.bool, device=dev))
        slots = torch.randint(-mcap, mcap, (4096,), generator=g, device=dev,
                              dtype=torch.int32)
        for mp in (32, 4, 1):
            c = FormCall("neighbors", dict(
                slots=slots, keys=table.keys, fp=table.fp, max_probe=mp))
            check_form(c, f"random neighbours at {load:.0%} load")
            check_coords(*coords_call(c), f"random neighbour keys at "
                         f"{load:.0%} load", full=mp == 32)
    log(f"[hash] random lookup-form calls: planes (near and not) and parent "
        f"(each level) on plane maps of the KITTI point's shape, "
        + "; ".join(notes) + f", neighbours on {mcap}-slot voxel tables "
        f"at 10 % and 90 %, max_probe 32, 4 and 1, NaN, ±inf and "
        f"out-of-range points, and the coords form on the keys of the "
        f"planes (near) and neighbours calls (check_coords: also at "
        f"max_probe 0, misaligned, n = 1 and replayed in a graph at "
        f"max_probe 32): each kernel bit-identical to its plain "
        f"version; reference behaviour 2 (a planted fingerprint collision "
        f"aliases the lookup) and 4 (an absent own voxel, a present near "
        f"one) hold; {time.perf_counter() - t0:.1f} s")
    return dict.fromkeys(("hash_lookup", *LOOKUP_FORMS), 0)


def form_bound_ms(c: FormCall) -> tuple:
    """Least time of a form's call for this data, by bytes over the memory
    rate: the inputs its lanes read, once (planes: 12 B a point; parent:
    1 B of mask a lane and 12 B a point in the mask; neighbours: 4 B a slot
    and each distinct 32-byte sector of the key rows of its slots), its
    outputs written once (planes 5 B a point, parent 1 B, neighbours 4 B a
    lane), each distinct 32-byte sector of fp that its probe rounds read
    (a parent lane out of the mask runs none), and each distinct sector of
    plane_valid and of subdivided that holds a found slot it reads
    (parent: subdivided, of the mask's lanes).  Returns (ms, "bytes",
    rounds)."""
    keys, slots = c.keys()
    mp, cap = c.args["max_probe"], c.fp.shape[0]
    rounds = probe_rounds(keys, slots, cap, mp, fp=c.fp)
    n = c.lanes
    if c.kind == "parent":
        m = c.args["mask"]
        rounds = torch.where(m, rounds, 0)
        nbytes = n * 2 + 12 * int(m.sum()) + 32 * sectors(
            slots[(slots >= 0) & m], 1)
    elif c.kind == "planes":
        nbytes = n * 17 + 2 * 32 * sectors(slots[slots >= 0], 1)
    else:
        nbytes = n * (4 + 27 * 4) + 32 * sectors(
            c.args["slots"].long() % cap, 16)
    nbytes += 32 * sectors(probe_slots(keys, rounds, cap), 4)
    return 1e3 * nbytes / PEAK_BYTES_PER_S, "bytes", rounds


def capture(fn, dev) -> tuple:
    """fn() captured once into a CUDA graph (keep_graph=True, instantiated)
    after a warm-up on the capture stream: the graph and what the captured
    call returned, which each replay writes again."""
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(stream):
        fn()
    torch.cuda.current_stream(dev).wait_stream(stream)
    graph = torch.cuda.CUDAGraph(keep_graph=True)
    with torch.cuda.graph(graph, stream=stream):
        out = fn()
    graph.instantiate()
    return graph, out


def captured_ms(fn, dev) -> tuple:
    """fn() captured once into a CUDA graph (capture): the graph's replay
    in device ms (device_ms) and its nodes by type
    (utils/graphs.py::graph_nodes)."""
    from immesh_tpu_torch.utils.graphs import graph_nodes
    graph, _ = capture(fn, dev)
    return device_ms(graph.replay), graph_nodes(graph)


def time_form(lib, c: FormCall, what: str) -> dict:
    """Time one recorded form call: device time of its launch (the median
    of 5 batches of 50 behind a spin kernel), one wrapper call, its plain
    version, the composition it replaced (FormCall.old) as one captured
    CUDA graph's replay with that graph's kernel nodes, its bound, and the
    host calls of one wrapper call under torch.profiler (no sync)."""
    from immesh_tpu_torch.kernels import hash_probe as hp
    from immesh_tpu_torch.utils.timers import profile_counts
    a, dev, n = c.args, c.fp.device, c.lanes
    if c.kind == "planes":
        found = torch.empty(n, dtype=torch.bool, device=dev)
        slot = torch.empty(n, dtype=torch.int32, device=dev)
        sizes = hp.level_sizes(a["voxel_size"], a["levels"])

        def launch():
            hp._launch_planes(lib, a["q"], sizes, a["near"], a["fp"],
                              a["plane_valid"], a["subdivided"],
                              a["max_probe"], found, slot)
    elif c.kind == "parent":
        out = torch.empty(n, dtype=torch.bool, device=dev)
        size = float(hp.level_sizes(a["voxel_size"], a["level"] + 1)[-1])

        def launch():
            hp._launch_parent(lib, a["pts"], size, a["level"], a["fp"],
                              a["subdivided"], a["mask"], a["max_probe"],
                              out)
    else:
        out = torch.empty(27 * n, dtype=torch.int32, device=dev)

        def launch():
            hp._launch_neighbors(lib, a["slots"], a["keys"], a["fp"],
                                 a["max_probe"], out)
    _, counts = profile_counts(lambda: c.run("cuda"))
    ms = device_ms(launch)
    wrapper_ms = event_ms(lambda: c.run("cuda"), 50)
    plain_ms = event_ms(lambda: c.run("plain"), 5)
    old_ms, old_nodes = captured_ms(c.old, dev)
    new_ms, new_nodes = captured_ms(lambda: c.run("cuda"), dev)
    bound_ms, bound_by, rounds = form_bound_ms(c)
    log(f"[hash] {what}: {c.name}, {c.label()}, max_probe "
        f"{a['max_probe']}: kernel {1e3 * ms:.2f} us (device time, median "
        f"of 5 x 50 launches), wrapper call {1e3 * wrapper_ms:.2f} us "
        f"(median of 50), plain version {1e3 * plain_ms:.1f} us; the "
        f"composition it replaced, as one captured graph: "
        f"{1e3 * old_ms:.2f} us a replay, {old_nodes['kernel']} kernel "
        f"nodes ({old_nodes}); the form as one captured graph "
        f"{1e3 * new_ms:.2f} us, {new_nodes['kernel']} kernel node(s); bound "
        f"{1e3 * bound_ms:.3f} us ({bound_by}); one wrapper call under "
        f"torch.profiler: {counts['launches']} launches, {counts['syncs']} "
        f"syncs, {counts['copies']} copies; probe rounds per key "
        f"{{{histogram(rounds)}}}")
    if counts["syncs"] != 0:
        raise AssertionError(f"{what}: {c.name} waited on the card")
    return {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "lanes": n,
            "slots": c.fp.shape[0], "old_composition_ms": old_ms,
            "old_composition_kernel_nodes": old_nodes["kernel"],
            "graph_ms": new_ms, "graph_kernel_nodes": new_nodes["kernel"],
            "syncs_per_call": counts["syncs"],
            "profiled_launches_per_call": counts["launches"]}


def coords_call(c: FormCall) -> tuple:
    """(keys, fp, max_probe) of the coords lookup that a form call's plain
    version makes: the reference's HashTable.lookup at that call."""
    keys, _ = c.keys()
    return keys, c.fp, c.args["max_probe"]


def check_coords(keys, fp, max_probe: int, what: str,
                 full: bool = True) -> None:
    """The coords form (lookup_cuda) against lookup_plain bit for bit on one
    key set at `max_probe`; where `full`, also at max_probe 0 and 1, from a
    misaligned row view (the rows copied into a flat buffer from its second
    element), for the first key alone (n = 1) and as a captured CUDA
    graph's second replay."""
    from immesh_tpu_torch.kernels import hash_probe as hp
    cases = [(f"max_probe {max_probe}", keys, max_probe)]
    if full:
        flat = torch.empty(4 * keys.shape[0] + 1, dtype=torch.int32,
                           device=keys.device)
        odd = flat[1:].view(-1, 4)
        odd.copy_(keys)
        cases += [("max_probe 0", keys, 0), ("max_probe 1", keys, 1),
                  ("a misaligned view", odd, max_probe),
                  ("n = 1", keys[:1], max_probe)]
    for label, k, mp in cases:
        if not same_bits(hp.lookup_cuda(k, fp, mp),
                         hp.lookup_plain(k, fp, mp)):
            raise AssertionError(f"{what}: hash_lookup and its plain version "
                                 f"differ ({label}, {k.shape[0]} keys into "
                                 f"{fp.shape[0]} slots)")
    if full:
        graph, out = capture(lambda: hp.lookup_cuda(keys, fp, max_probe),
                             keys.device)
        out.fill_(-7)
        graph.replay()
        graph.replay()
        if not same_bits(out, hp.lookup_plain(keys, fp, max_probe)):
            raise AssertionError(f"{what}: hash_lookup replayed in a CUDA "
                                 f"graph differs from its plain version")


def chain_graph(chain, n_launches: int, outs, want, dev) -> tuple:
    """chain(), whose coords lookups each write one of outs, captured as
    one CUDA graph (capture): the graph, which a replay must leave with
    every out bit for bit `want`, and the device time of one of its
    n_launches inside the replayed chain."""
    graph, _ = capture(chain, dev)
    for o in outs:
        o.fill_(-7)
    graph.replay()
    if not all(same_bits(o, want) for o in outs):
        raise AssertionError("a replayed chain of coords lookups differs "
                             "from the plain version")
    return graph, device_ms(graph.replay, n=10) / n_launches


def coords_graph(lib, keys, fp, max_probe: int) -> dict:
    """COORDS_CHAIN coords-form launches back to back captured as one CUDA
    graph (chain_graph): its dependency edges by kind
    (utils/graphs.py::graph_edges; a programmatic edge is the launch's
    programmatic dependency, kept by the capture), its kernel nodes and
    the device time of a launch inside the replayed chain."""
    from immesh_tpu_torch.kernels import hash_probe as hp
    from immesh_tpu_torch.utils.graphs import graph_edges, graph_nodes
    outs = [torch.empty(keys.shape[0], dtype=torch.int32,
                        device=keys.device) for _ in range(COORDS_CHAIN)]
    graph, ms = chain_graph(
        lambda: [hp._launch_lookup(lib, keys, fp, max_probe, o)
                 for o in outs], COORDS_CHAIN, outs,
        hp.lookup_plain(keys, fp, max_probe), keys.device)
    return {"edges": graph_edges(graph),
            "kernel_nodes": graph_nodes(graph)["kernel"],
            "chain_graph_ms": ms}


def coords_bound_ms(keys, slots, fp, max_probe: int) -> tuple:
    """Least time of a coords lookup for this data, by bytes over the memory
    rate: 16 B a key read and 4 B a slot written once, and each distinct
    32-byte sector of fp that its probe rounds read.  Returns (ms, "bytes",
    rounds)."""
    cap = fp.shape[0]
    rounds = probe_rounds(keys, slots, cap, max_probe, fp=fp)
    nbytes = 20 * keys.shape[0] + 32 * sectors(
        probe_slots(keys, rounds, cap), 4)
    return 1e3 * nbytes / PEAK_BYTES_PER_S, "bytes", rounds


def time_coords(lib, keys, fp, max_probe: int, what: str) -> dict:
    """Time the coords form on one key set: the device time of a launch in a
    chain of 50 back to back (device_ms; each a programmatic dependent of
    the one before), the launch captured alone as a graph and replayed
    (captured_ms), a launch inside a captured chain (coords_graph), one
    wrapper call, the plain version, its bound, and the host calls of one
    wrapper call under torch.profiler (no sync)."""
    from immesh_tpu_torch.kernels import hash_probe as hp
    from immesh_tpu_torch.utils.timers import profile_counts
    dev, n = keys.device, keys.shape[0]
    slot = torch.empty(n, dtype=torch.int32, device=dev)
    _, counts = profile_counts(lambda: hp.lookup_cuda(keys, fp, max_probe))
    ms = device_ms(lambda: hp._launch_lookup(lib, keys, fp, max_probe, slot))
    graph_ms, _ = captured_ms(lambda: hp.lookup_cuda(keys, fp, max_probe),
                              dev)
    chain = coords_graph(lib, keys, fp, max_probe)
    wrapper_ms = event_ms(lambda: hp.lookup_cuda(keys, fp, max_probe), 50)
    plain_ms = event_ms(lambda: hp.lookup_plain(keys, fp, max_probe), 5)
    bound_ms, bound_by, rounds = coords_bound_ms(
        keys, hp.lookup_plain(keys, fp, max_probe), fp, max_probe)
    log(f"[hash] {what}: hash_lookup (coords) at ({n}, 4) into "
        f"{fp.shape[0]} slots, max_probe {max_probe}: kernel "
        f"{1e3 * ms:.2f} us (device time, median of 5 x 50 launches), "
        f"one launch as a captured graph {1e3 * graph_ms:.2f} us a replay, "
        f"a launch in a captured chain of {COORDS_CHAIN} "
        f"{1e3 * chain['chain_graph_ms']:.2f} us (the chain's edges "
        f"{chain['edges']}), wrapper call {1e3 * wrapper_ms:.2f} us (median "
        f"of 50), plain version "
        f"{1e3 * plain_ms:.1f} us, bound {1e3 * bound_ms:.3f} us "
        f"({bound_by}); one wrapper call under torch.profiler: "
        f"{counts['launches']} launches, {counts['syncs']} syncs, "
        f"{counts['copies']} copies; probe rounds per key "
        f"{{{histogram(rounds)}}}")
    if counts["syncs"] != 0:
        raise AssertionError(f"{what}: hash_lookup waited on the card")
    return {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "lanes": n,
            "slots": fp.shape[0], "captured_ms": graph_ms, **chain,
            "syncs_per_call": counts["syncs"],
            "profiled_launches_per_call": counts["launches"]}


def costliest_form(calls, kind: str) -> FormCall:
    """The recorded call of a form with the most lanes (the last of
    them)."""
    return max((c for c in calls if c.kind == kind),
               key=lambda c: c.lanes)


def phase_strided(dev) -> dict:
    """The insert kernel with more lanes than the card holds threads, so
    each thread takes several lanes across the grid barriers: a table of
    twice that many unique keys at ~26 % load, inserted in two overlapping
    batches (10 % of lanes invalid), then looked up, against the plain
    versions on copies of the table."""
    from immesh_tpu_torch.kernels import hash_probe as hp
    from immesh_tpu_torch.map.hash import HashTable

    props = torch.cuda.get_device_properties(dev)
    resident = props.multi_processor_count * props.max_threads_per_multi_processor
    u = 2 * resident
    cap = 1 << (int(u / 0.3) - 1).bit_length()
    g = torch.Generator(device=dev).manual_seed(9)
    raw = torch.randint(-2 ** 20, 2 ** 20, (u + u // 8, 4), generator=g,
                        device=dev, dtype=torch.int32)
    raw[:, 3] &= 3
    keys = torch.unique(raw, dim=0)
    keys = keys[torch.randperm(keys.shape[0], generator=g, device=dev)[:u]]
    if keys.shape[0] < u:
        raise AssertionError("phase 3b: too few unique keys drawn")
    valid = torch.rand(u, generator=g, device=dev) < 0.9
    tk = HashTable.create(cap, 32, device=dev)
    tp = tk.clone()
    err = {"hash_lookup": 0, "hash_insert": 0}
    for lo, hi in ((0, 3 * u // 4), (u // 2, u)):
        c, v = keys[lo:hi].contiguous(), valid[lo:hi].contiguous()
        outs = [*zip(hp.insert_cuda(c, v, tk.keys, tk.fp, 32),
                     hp.insert_plain(c, v, tp.keys, tp.fp, 32)),
                (tk.keys, tp.keys), (tk.fp, tp.fp)]
        err["hash_insert"] = max(err["hash_insert"], max(
            int((a.long() - b.long()).abs().max()) for a, b in outs))
    q = torch.cat([keys, raw[:4096]])
    err["hash_lookup"] = int((hp.lookup_cuda(q, tk.fp, 32).long()
                              - hp.lookup_plain(q, tp.fp, 32).long())
                             .abs().max())
    if any(err.values()):
        raise AssertionError(f"phase 3b: the strided insert or lookup "
                             f"differs from its plain version: {err}")
    load = int((tp.fp != 0).sum())
    log(f"[hash] grid-stride: {u} lanes (twice the {resident} threads "
        f"{props.multi_processor_count} SMs hold) into {cap} slots, two "
        f"overlapping batches, then {q.shape[0]} lookups: both kernels "
        f"bit-identical to their plain versions, table at "
        f"{100 * load / cap:.1f} % load")
    return err


def time_probe(lib, c, rounds, what: str) -> dict:
    """Time one recorded insert: device time of its launch on each form
    that takes its lanes, one wrapper call, the plain version, its bound,
    and the host calls of one wrapper call under torch.profiler (which must
    hold no sync)."""
    from immesh_tpu_torch.kernels import hash_probe as hp
    from immesh_tpu_torch.utils.timers import profile_counts

    dev = c[1].device
    _, cc, v, keys0, fp0, mp = c
    n = cc.shape[0]
    keys, fp = keys0.clone(), fp0.clone()

    def restore():
        keys.copy_(keys0)
        fp.copy_(fp0)

    slot = torch.empty(n, dtype=torch.int32, device=dev)
    new = torch.empty(n, dtype=torch.bool, device=dev)
    flags = torch.empty(mp, dtype=torch.int32, device=dev)  # grid form
    restore()
    _, counts = profile_counts(lambda: hp.insert_cuda(cc, v, keys, fp, mp))
    restore()
    ps, pn = hp.insert_plain(cc, v, keys, fp, mp)
    restore_ms = device_ms(restore)
    forms = {}
    for path in insert_paths(n):
        forms[path] = device_ms(lambda: (restore(), hp._launch_insert(
            lib, cc, v, keys, fp, mp, slot, new, flags, path))) - restore_ms
    path = hp.insert_path(n)
    ms = forms[path]
    wrapper_ms = event_ms(lambda: (restore(), hp.insert_cuda(
        cc, v, keys, fp, mp)), 50) - event_ms(restore, 50)
    plain_ms = event_ms(lambda: (restore(), hp.insert_plain(
        cc, v, keys, fp, mp)), 5) - event_ms(restore, 5)
    bound_ms, bound_by = insert_bound_ms(n, cc, rounds, fp.shape[0], ps[pn])
    note = (f"{int(v.sum())} valid, {int(pn.sum())} new; the wrapper's "
            f"form {path}; device us by form " + ", ".join(
                f"{k} {1e3 * t:.2f}" for k, t in forms.items())
            + f"; each launch behind a {1e3 * restore_ms:.2f} us copy "
            f"of the table, which is subtracted")
    log(f"[hash] {what}: hash_{c[0]} at ({n}, 4) into {c[-2].shape[0]} "
        f"slots, max_probe {mp} ({note}): kernel {1e3 * ms:.2f} us (device "
        f"time, median of 5 x 50 launches), wrapper call "
        f"{1e3 * wrapper_ms:.2f} us (median of 50), plain version "
        f"{1e3 * plain_ms:.1f} us, bound {1e3 * bound_ms:.3f} us "
        f"({bound_by}); one call under torch.profiler: {counts['launches']} "
        f"launches, {counts['syncs']} syncs, {counts['copies']} copies; probe "
        f"rounds per lane {{{histogram(rounds)}}}")
    if counts["syncs"] != 0:
        raise AssertionError(f"{what}: hash_{c[0]} waited on the card")
    return {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by, "lanes": n,
            "slots": c[-2].shape[0], "syncs_per_call": counts["syncs"],
            "profiled_launches_per_call": counts["launches"], "path": path,
            **{f"ms_{k}": t for k, t in forms.items()}}


def costliest(calls, rounds, kind: str):
    """The recorded call of `kind` whose lanes run the most probe rounds,
    and those rounds."""
    return max(((c, r) for c, r in zip(calls, rounds) if c[0] == kind),
               key=lambda cr: int(cr[1].sum()))


# the reference code each lookup kernel of the path replaces: the probe
# loop, and the composition around it that the form took into the launch
LOOKUP_REPLACES = {
    "hash_lookup": ("immesh_tpu/map/hash.py:127", None),
    "hash_lookup_planes": (
        "immesh_tpu/map/hash.py:127",
        "immesh_tpu/lio/association.py:27 (_lookup_with_neighbors), "
        "immesh_tpu/map/voxel_map.py:231, :263 (query_planes, "
        "lookup_planes_stack)"),
    "hash_lookup_parent": ("immesh_tpu/map/hash.py:127",
                           "immesh_tpu/map/voxel_map.py:120-122 (update)"),
    "hash_lookup_neighbors": (
        "immesh_tpu/map/hash.py:127",
        "immesh_tpu/mesh/global_map.py:320-326, :383-388, :452-460"),
    "hash_insert": ("immesh_tpu/map/hash.py:186", None),
}


def phase_hash(dev, gt) -> tuple:
    """Phase 3b.  The KITTI LIO on phase 4's scans up to the map load phase
    4 reaches, its last frame's probes and lookup-form calls recorded and
    replayed (replay_probes, replay_forms); random form calls
    (random_forms); the coords form on the keys of the costliest planes
    and parent calls (check_coords); the grid-stride case (phase_strided);
    0 host syncs a call; the times of the LIO's costliest insert, of its
    planes and parent calls beside the compositions they replaced, and of
    the coords form on their keys (time_coords).  Returns each kernel's
    largest difference from its plain version, and the timed entries by
    kernel."""
    from immesh_tpu_torch.kernels import hash_probe as hp
    from immesh_tpu_torch.lio.pipeline import LioPipeline

    cfg = kitti_config()
    t_phase = time.perf_counter()
    # eager: a replay of the captured step calls no wrapper to record
    lio = LioPipeline(cfg, device=dev, graph=False)
    for f in gt[:-1]:
        lio.step(bundle(f, cfg, dev))
    last = bundle(gt[-1], cfg, dev)
    _, calls = record_probes(lambda: lio.step(last))
    torch.cuda.synchronize()
    load = int(lio.vm.n_voxels())
    what = (f"the KITTI LIO's last frame of phase 4's {len(gt)} scans, plane "
            f"map {load} voxels of {cfg.voxel_map.capacity} slots "
            f"({100 * load / cfg.voxel_map.capacity:.1f} %)")
    probes, forms = split_calls(calls)
    err, rounds = replay_probes(probes, what)
    err.update(replay_forms(forms, what))
    # the coords form on the keys the reference's HashTable.lookup probes
    # at the LIO's costliest planes and parent calls
    coords = {f"lio_{kind}": coords_call(costliest_form(forms, kind))
              for kind in ("planes", "parent")}
    for name, call in coords.items():
        check_coords(*call, f"{what}: the {name} keys")
    log(f"[hash] {what}: the coords form bit-identical to its plain version "
        f"on the keys of the costliest planes and parent calls "
        + ", ".join(f"({c[0].shape[0]}, 4) into {c[1].shape[0]} slots"
                    for c in coords.values())
        + ", at their max_probe, at 0 and 1, from a misaligned view, for "
        f"n = 1 and replayed in a captured graph")
    rand = random_forms(dev)
    strided = phase_strided(dev)
    lib = hp._library()
    time_probe(lib, *costliest(probes, rounds, "insert"),
               "the LIO's costliest insert")
    entries = {f"hash_lookup_{kind}": time_form(
        lib, costliest_form(forms, kind), f"the LIO's costliest {kind} call")
        for kind in ("planes", "parent")}
    entries["hash_lookup"] = {"by_shape": {
        name: time_coords(lib, *call, f"the {name} keys")
        for name, call in coords.items()}}
    log(f"[hash] phase 3b took {time.perf_counter() - t_phase:.1f} s")
    err = {k: max(err.get(k, 0), rand.get(k, 0), strided.get(k, 0))
           for k in hp.KERNELS}
    return err, entries


def phase_hash_path(dev, frames, err, entries) -> list:
    """Phase 4b.  The probe and lookup-form calls of phase 4's recorded
    frames (each frame that compacted: its append at the tables' fullest,
    then the rebuild; and the last frame) replayed as phase 3b's; the last
    frame's costliest insert and neighbours call timed for the `kernels`
    line, and the coords form checked and timed on that call's keys, the
    costliest insert of a compacting frame timed as well.
    Returns the hash kernels' entries of the `kernels` line, with phase
    3b's (`entries`)."""
    from immesh_tpu_torch.kernels import hash_probe as hp
    t_phase = time.perf_counter()
    lib = hp._library()
    for k, calls in frames.items():
        what = f"the KITTI joint frame {k} of phase 4" + (
            " (the last)" if k == max(frames) else " (it compacted)")
        probes, forms = split_calls(calls)
        e, rounds = replay_probes(probes, what)
        e.update(replay_forms(forms, what))
        err = {n: max(err[n], e.get(n, 0)) for n in err}
        t = time_probe(lib, *costliest(probes, rounds, "insert"),
                       f"frame {k}'s costliest insert")
        if k != max(frames):
            continue
        entries["hash_insert"] = t
        entries["hash_lookup_neighbors"] = time_form(
            lib, costliest_form(forms, "neighbors"),
            f"frame {k}'s costliest neighbours call")
        # the coords form on the keys of the same call; its entry reads
        # the largest key set, the LIO planes call's
        call = coords_call(costliest_form(forms, "neighbors"))
        check_coords(*call, f"{what}: the mesh neighbour keys")
        coords = entries["hash_lookup"]
        coords["by_shape"]["mesh_neighbors"] = time_coords(
            lib, *call, f"frame {k}'s mesh neighbour keys")
        coords.update(coords["by_shape"]["lio_planes"])
        # each insert shape of the frame, on every form
        last = t["lanes"]
        t["by_lanes"] = {last: dict(t)}
        for u in sorted({c[1].shape[0] for c in probes
                         if c[0] == "insert"} - {last}):
            cr = [(c, r) for c, r in zip(probes, rounds)
                  if c[0] == "insert" and c[1].shape[0] == u]
            t["by_lanes"][u] = time_probe(
                lib, *costliest(*zip(*cr), "insert"),
                f"frame {k}'s costliest insert of {u} lanes")
    log(f"[hash] phase 4b took {time.perf_counter() - t_phase:.1f} s")
    out = []
    for name in LOOKUP_REPLACES:
        replaces, composition = LOOKUP_REPLACES[name]
        e = {"name": name, "route": "cuda",
             "source": "immesh_tpu_torch/csrc/hash_probe.cu",
             "replaces": replaces, "max_abs_err": err[name],
             "library_ms": None, **entries[name]}
        if composition:
            e["composition"] = composition
        out.append(e)
    return out


# ---------------------------------------------------------------------------
# phase 4: the main path
# ---------------------------------------------------------------------------
def phase_main(dev, sim, gt, warmup: int, kernel_ms: float):
    from immesh_tpu_torch.kernels import pairs_argmin as pk
    from immesh_tpu_torch.runtime.joint import JointPipeline
    from immesh_tpu_torch.utils.timers import trace

    cfg = kitti_config()
    N = cfg.preprocess.max_points
    n_frames = len(gt) - warmup
    frames = [bundle(f, cfg, dev) for f in gt]
    R0, p0 = sim.traj.pose(0.0)

    # the frame trace on (its device spans' event nodes in the frame graph):
    # the compactions are read from its `compact` spans
    trace.clear()
    trace.enable()
    pipe = JointPipeline(cfg, adaptive_mesh_budget=2048, device=dev)
    reset_counts()
    ms, launches, errs, actives = [], [], [], []
    diags, positions, scans, worlds, rows = [], [], [], [], []
    probes = {}  # the probe calls of each compacting frame and of the last
    scatters = {}  # and their set_drop / add_drop calls
    for k, (f, b) in enumerate(zip(gt, frames)):
        before = pk.runs()
        comp_before = pipe.mesh.n_compactions + pipe.lio.n_compactions
        t1 = time.perf_counter()
        ((world, diag), calls), scat = record_scatters(
            lambda: record_probes(lambda: pipe.step(b)))
        torch.cuda.synchronize()
        dt = 1e3 * (time.perf_counter() - t1)
        if (k == len(gt) - 1 or pipe.mesh.n_compactions
                + pipe.lio.n_compactions > comp_before):
            probes[k], scatters[k] = calls, scat
        del calls, scat
        pos = pipe.state.pos.cpu().numpy().astype(np.float64)
        if not (np.isfinite(pos).all()
                and bool(torch.isfinite(pipe.state.rot).all())
                and bool(torch.isfinite(world[b.mask]).all())):
            raise AssertionError(f"frame {k}: non-finite pose or world scan")
        if tuple(world.shape) != (N, 3):
            raise AssertionError(f"frame {k}: world scan shape {world.shape}")
        err = float(np.linalg.norm(R0 @ pos + p0 - f.gt_pos))
        n_act = int(diag["n_active_voxels"])
        fired = pk.runs() - before  # the kernel's runs on the device
        if n_act > 0 and fired == 0:
            raise AssertionError(
                f"frame {k}: {n_act} active voxels but no pairs_argmin run")
        if err > POSE_TOL_M:
            raise AssertionError(
                f"frame {k}: pose {err:.3f} m from ground truth "
                f"(limit {POSE_TOL_M} m)")
        errs.append(err)
        actives.append(n_act)
        launches.append(fired)
        rows.append({"iterations": int(diag["iterations"]),
                     "levels": int(diag["levels"]),
                     "chunks": active_chunks(pipe.mesh.last_active[1],
                                             cfg.mesh.mesh_chunk)})
        positions.append(pos)
        # the mesh step's inputs, for its eager run (eager_mesh_calls)
        worlds.append((world.clone(), b.mask, pipe.state.pos.clone()))
        if k < DIST_EXACT_FRAMES:  # phase 13b meshes these scans again
            scans.append((world.cpu().numpy(), b.mask.cpu().numpy(),
                          pipe.state.pos.cpu().numpy()))
        if k >= warmup:
            ms.append(dt)
            diags.append({key: int(val) for key, val in diag.items()})
        log(f"[main] frame {k:2d}: {dt:8.1f} ms, pose err {err:.3f} m, "
            f"{n_act} active voxels, {fired} pairs_argmin runs, backlog "
            f"{int(diag['drop_deferred'])}")
    trace.disable()
    compact_ms = [r.ms for fr in trace.frames() for r in fr
                  if r.name == "compact"]
    # the frame's two graphs: the LIO's, then the mesh half's on its own
    # stream
    fgraphs = pipe.captured.graphs
    if [g.replays for g in fgraphs] != [len(gt) - 1] * 2:
        raise AssertionError(f"main: {[g.replays for g in fgraphs]} replays "
                             f"of the LIO and mesh graphs in {len(gt)} "
                             f"frames")
    hashes = path_counts("main", graphs=fgraphs)
    forms = captured_forms(fgraphs, "main")
    nodes = summed_nodes(fgraphs)
    recorded = summed_launches(fgraphs)
    sites = check_sites("KITTI JointPipeline (phase 4)", fgraphs, rows, cfg)
    n_chunks = -(-cfg.mesh.active_voxels_per_frame // cfg.mesh.mesh_chunk)
    if sites["if_nodes"]["nodes"] != {**lio_sites(cfg), "chunk": n_chunks} \
            or sites["set_launches"] != {**lio_launches(cfg),
                                         "chunk": n_chunks}:
        raise AssertionError(f"main: the frame graph's IF nodes by site "
                             f"{sites['if_nodes']['nodes']}, set launches "
                             f"{sites['set_launches']}")

    n_tris = int(pipe.store.n_triangles())
    n_pts = int(pipe.mesh.gm.n_points())
    n_comp = pipe.mesh.n_compactions + pipe.lio.n_compactions
    if n_tris <= 0:
        raise AssertionError("no live triangles after the run")
    if n_comp < 1:
        raise AssertionError("no compaction fired during the run")
    ids = pipe.store.tri_ids.reshape(-1, 3)
    ids = ids[(ids >= 0).all(-1)]
    if int(ids.max()) >= n_pts:
        raise AssertionError("a triangle references an unallocated point")

    drops = {}
    for d in diags:
        for key, val in d.items():
            if key == "drop_deferred":
                drops[key] = val          # a backlog level: keep the last
            elif key.startswith("drop_"):
                drops[key] = drops.get(key, 0) + val
    med = statistics.median(ms)
    p90 = float(np.percentile(ms, 90))
    timed_launches = sum(launches[warmup:])
    share = kernel_ms * timed_launches / sum(ms)
    log(f"[main] {n_frames} timed frames: {med:.1f} ms/frame median, "
        f"{p90:.1f} ms p90; pairs_argmin {timed_launches} runs "
        f"(~{100 * share:.2f} % of frame time at the phase-2 kernel time); "
        f"pose err max {max(errs):.3f} m, last {errs[-1]:.3f} m")
    def in_bodies(k):
        return sum(b.captured.get(k, 0) for g in fgraphs for b in g.bodies)

    log("[main] over all " + str(len(gt)) + " frames: " + ", ".join(
        f"{k} {n} wrapper launches and {hashes['runs'][k]} runs on the "
        f"device ({hashes['runs'][k] / len(gt):.1f} a frame; recorded "
        f"{recorded.get(k, 0) - in_bodies(k)} + {in_bodies(k)} in IF "
        f"bodies into the LIO and mesh graphs)"
        for k, n in hashes["launches"].items())
        + f"; hash_insert launches recorded into the graph by form {forms}; "
        f"the set kernel recorded {hashes['recorded'][COND_KERNEL]} times "
        f"(one a predicate: by site {sites['set_launches']}, setting the "
        f"IF nodes {sites['if_nodes']['nodes']}), run "
        f"{hashes['runs'][COND_KERNEL]} times; IF bodies run by site "
        f"{sites['runs']}")
    log(f"[main] live triangles {n_tris}, map points {n_pts}, mesh voxels "
        f"{int(pipe.mesh.gm.vox.occupancy())}, LIO voxels "
        f"{int(pipe.lio.vm.n_voxels())}, compactions {n_comp} "
        f"(mesh {pipe.mesh.n_compactions}, lio {pipe.lio.n_compactions}, "
        f"{sum(compact_ms):.1f} ms in {len(compact_ms)} `compact` spans of "
        f"the frame trace), drops {drops}")
    log(f"[main] the frame ran as two captured CUDA graphs, the LIO step "
        f"and the mesh step on the mesh half's own stream: "
        f"{pipe.captured.replays} replays of {len(gt)} frames (frame 0 "
        f"eager, the warm-up), the graphs' nodes {nodes}; the mesh half's "
        f"counters (the frame trace's) {mesh_counters()}; "
        f"probe, set_drop and add_drop calls outside it recorded (copies "
        f"of the tables and targets they found, taken in every frame's "
        f"time, none inside a capture)")
    mesh_probes, mesh_scatters = eager_mesh_calls(
        cfg, dev, worlds, sorted(probes), pipe.mesh)
    for k in probes:
        probes[k] += mesh_probes[k]
        scatters[k] += mesh_scatters[k]
    log(f"[main] kept for phases 4b and 16: frames {sorted(probes)}, "
        f"{sum(map(len, probes.values()))} probes and "
        f"{sum(map(len, scatters.values()))} scatters")
    return {"gt": gt, "pos": positions, "scans": scans, "R0": R0, "p0": p0,
            "graph_nodes": nodes, "graph_captured": recorded,
            "sites": sites}, probes, scatters


def eager_mesh_calls(cfg, dev, worlds, at, mesh_ref):
    """Phase 4's mesh steps again, eagerly (a MeshPipeline with
    graph=False fed phase 4's world scans, masks and positions, its
    compactions included), with every probe and scatter call of the steps
    of the frames in `at` recorded: a replay of phase 4's captured mesh
    step calls no wrapper to record.  Its map and store must end bit for
    bit as phase 4's (`mesh_ref`).  Returns the calls by frame, (probes,
    scatters)."""
    from immesh_tpu_torch.mesh.pipeline import MeshPipeline
    mesh = MeshPipeline(cfg, device=dev, graph=False)
    probes, scatters = {}, {}
    for k, (w, m, p) in enumerate(worlds):
        if k in at:
            (_, probes[k]), scatters[k] = record_scatters(
                lambda: record_probes(lambda: mesh.step(w, m, p)))
        else:
            mesh.step(w, m, p)
    bad = mesh_differs(mesh, mesh_ref)
    if bad or mesh.n_compactions != mesh_ref.n_compactions:
        raise AssertionError(f"main: the eager mesh run parts from phase "
                             f"4's captured one in {bad} (compactions "
                             f"{mesh.n_compactions}, "
                             f"{mesh_ref.n_compactions})")
    return probes, scatters


# ---------------------------------------------------------------------------
# phase 5: card against CPU on a small input
# ---------------------------------------------------------------------------
def phase_parity(dev, n_frames: int = 6):
    """The KITTI-shaped sequence (IMU-less) and the Avia-shaped one (IMU
    on, extrinsics on), each on the card and on the CPU.  The IMU-on pair
    takes its first IMU_WARM frames one step at a time from the card's
    state, then runs chained (see IMU_WARM)."""
    from immesh_tpu_torch import interop
    from immesh_tpu_torch.runtime.joint import JointPipeline

    cases = []
    cfg = small_config()
    sim = make_sim(cfg.preprocess.max_points, 16)
    cases.append(("kitti-shaped", cfg, sim, 256, 0))
    cfg = small_avia_config()
    cases.append(("avia-shaped, IMU on", cfg, make_avia_sim(cfg), 0,
                  IMU_WARM))
    for name, cfg, sim, budget, warm in cases:
        pipes = {d: JointPipeline(cfg, adaptive_mesh_budget=budget, device=d)
                 for d in (dev, "cpu")}
        a, b = pipes[dev], pipes["cpu"]
        if cfg.imu.imu_en:
            acc, gyr = sim.static_imu(100)
            for p in pipes.values():
                p.static_init(acc, gyr)
        R0, p0 = sim.traj.pose(0.0)
        R_align = R0 @ b.lio.state.rot.numpy().astype(np.float64).T
        gt = [sim.frame(k) for k in range(warm + n_frames)]
        steps = []
        for k, f in enumerate(gt):
            if k <= warm and warm:
                o = interop.from_reference(interop.to_numpy(
                    {"state": a.lio.state, "vm": a.lio.vm, "gm": a.mesh.gm,
                     "store": a.mesh.store}), cfg, device="cpu")
                b.lio.state, b.lio.vm = o["state"], o["vm"]
                b.mesh.gm, b.mesh.store = o["gm"], o["store"]
            diag = {d: p.step(bundle(f, cfg, d))[1] for d, p in pipes.items()}
            dp = float((a.state.pos.cpu() - b.state.pos).abs().max())
            if k < warm:
                errs = [float(np.linalg.norm(
                    R_align @ p.state.pos.cpu().numpy().astype(np.float64)
                    + p0 - f.gt_pos)) for p in (a, b)]
                if dp > IMU_WARM_STEP_TOL_M or max(errs) > IMU_WARM_GT_TOL_M:
                    raise AssertionError(
                        f"{name} frame {k}, one step from the card's state: "
                        f"|Δpos| {dp:.2e} m (limit {IMU_WARM_STEP_TOL_M} m), "
                        f"pose err card {errs[0]:.4f} m, CPU {errs[1]:.4f} m "
                        f"(limit {IMU_WARM_GT_TOL_M} m)")
                steps.append((dp, *errs, int(diag[dev]["n_effective"]),
                              bool(diag[dev]["converged"])))
                if k == warm - 1:
                    log(f"[parity] {name}, frames 0-{k}, each one step from "
                        f"the card's state: card vs CPU |Δpos| ≤ "
                        f"{IMU_WARM_STEP_TOL_M} m, pose err ≤ "
                        f"{IMU_WARM_GT_TOL_M} m — |Δpos|, err card/CPU (card "
                        f"matches, converged): " + ", ".join(
                            f"{x:.2e} m, {e0:.4f}/{e1:.4f} m ({n}, {c})"
                            for x, e0, e1, n, c in steps))
                continue
            na, nb = int(a.store.n_triangles()), int(b.store.n_triangles())
            pa, pb = int(a.mesh.gm.n_points()), int(b.mesh.gm.n_points())
            # ulp-level differences in the world scan (reduction order on
            # the card) re-roll near-cocircular Delaunay diagonals, so
            # triangle counts agree to a few percent, not exactly (ROADMAP
            # queue 3)
            if (dp > 1e-3 or abs(na - nb) > TRI_COUNT_RTOL * max(nb, 1)
                    or abs(pa - pb) > 0.01 * max(pb, 1)):
                raise AssertionError(
                    f"{name} frame {k}: card and CPU disagree: |Δpos| "
                    f"{dp:.2e} m, triangles {na} vs {nb}, points {pa} vs {pb}")
        log(f"[parity] {n_frames} small {name} frames "
            f"({cfg.preprocess.max_points} rays"
            f"{f', from the card state after {warm} frames' if warm else ''})"
            f": card and CPU agree (last |Δpos| {dp:.2e} m, triangles {na} "
            f"vs {nb}, points {pa} vs {pb})")


# ---------------------------------------------------------------------------
# phase 6: the runtime entry point at the Avia operating point
# ---------------------------------------------------------------------------
def avia_config():
    """PRESETS["avia"] unchanged (reference config/avia.yaml): 32,768-point
    scans, IMU on, LiDAR→IMU extrinsic_t (0.04165, 0.02326, −0.0284), a
    0.5 m 2¹⁸-slot plane map, a 2²⁰-point / 2¹⁶-voxel mesh map re-meshing
    up to 512 voxels a frame."""
    from immesh_tpu_torch.config import PRESETS
    return PRESETS["avia"]()


def small_avia_config():
    """The Avia preset cut to 4,096 rays and capacities a CPU runs in
    seconds (phase 5)."""
    base = avia_config()
    return base.replace(
        preprocess=dataclasses.replace(base.preprocess, max_points=4096),
        voxel_map=dataclasses.replace(base.voxel_map, capacity=2 ** 14,
                                      touched_voxels_per_scan=1024),
        lio=dataclasses.replace(base.lio, map_update_points=2048),
        mesh=dataclasses.replace(
            base.mesh, points_capacity=2 ** 16, voxel_capacity=2 ** 12,
            active_voxels_per_frame=128, file_voxels_per_frame=1024))


def make_avia_sim(cfg):
    """The demo's simulator (default indoor scene, circular trajectory,
    IMU at 200 Hz) with the LiDAR mounted at the preset's extrinsics."""
    from immesh_tpu_torch.frontend.sim import LidarImuSimulator
    return LidarImuSimulator(
        n_rays=cfg.preprocess.max_points,
        ext_r=np.reshape(cfg.imu.extrinsic_r, (3, 3)),
        ext_t=cfg.imu.extrinsic_t, seed=0)


def phase_runtime(dev, n_frames: int, warmup: int):
    """ImMeshRuntime.process_frame over warm-up plus n_frames; returns the
    runtime for the audit."""
    import tempfile

    from immesh_tpu_torch import interop
    from immesh_tpu_torch.eval.ate import evaluate_ate, from_rows, load_tum
    from immesh_tpu_torch.eval.mesh_quality import vertex_surface_distance
    from immesh_tpu_torch.kernels import incircle as ik
    from immesh_tpu_torch.runtime.app import ImMeshRuntime
    from immesh_tpu_torch.runtime.export import _leaves, load_ply
    from immesh_tpu_torch.utils.timers import trace

    cfg = avia_config()
    N = cfg.preprocess.max_points
    t0 = time.perf_counter()
    sim = make_avia_sim(cfg)
    static = sim.static_imu(100)  # drawn first, as the demo does
    gt = [sim.frame(k) for k in range(warmup + n_frames)]
    frames = [bundle(f, cfg, dev) for f in gt]
    n_imu = int(frames[0].imu_mask.sum())
    log(f"[runtime] {len(frames)} Avia scans of {N} rays with {n_imu} IMU "
        f"samples in {cfg.imu.max_imu_per_scan} slots made in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")

    log_dir = tempfile.mkdtemp(prefix="immesh_smoke_")
    trace.clear()
    rt = ImMeshRuntime(cfg, log_dir=log_dir, device=dev)
    rt.static_init(*static)
    R0, p0 = sim.traj.pose(0.0)
    # the filter's world frame is gravity-aligned at the initial body pose
    R_align = R0 @ rt.lio.state.rot.cpu().numpy().astype(np.float64).T
    reset_counts()
    ms, lio_ms, mesh_ms, errs = [], [], [], []
    for k, (f, b) in enumerate(zip(gt, frames)):
        t1 = time.perf_counter()
        st = rt.process_frame(b, t=k * sim.scan_T)
        torch.cuda.synchronize()
        dt = 1e3 * (time.perf_counter() - t1)
        # the frame's LIO and mesh device spans (the log directory turned
        # the frame trace on); nan where the frame has none
        lio, mesh = (trace.span_ms(k, n) for n in ("lio", "mesh"))
        lio, mesh = (math.nan if x is None else x for x in (lio, mesh))
        pos = st["pos"].astype(np.float64)
        if not np.isfinite(pos).all():
            raise AssertionError(f"runtime frame {k}: non-finite pose")
        err = float(np.linalg.norm(R_align @ pos + p0 - f.gt_pos))
        if err > AVIA_POSE_TOL_M:
            raise AssertionError(
                f"runtime frame {k}: pose {err:.4f} m from ground truth "
                f"(limit {AVIA_POSE_TOL_M} m)")
        errs.append(err)
        if k >= warmup:
            ms.append(dt)
            lio_ms.append(lio)
            mesh_ms.append(mesh)
        log(f"[runtime] frame {k:2d}: {dt:7.1f} ms (lio {lio:6.1f}, "
            f"mesh {mesh:6.1f} on the device), pose err {err:.4f} m, "
            f"{int(st['n_active_voxels'])} active voxels, "
            f"{int(st['n_effective'])} matches")
    # pairs_argmin's runs on the device: the mesh step is a captured graph
    launches = path_counts("runtime", graphs=pipe_graphs(rt))["runs"][
        "pairs_argmin"]
    if launches == 0:
        raise AssertionError("pairs_argmin was never launched by the runtime")
    if ik.launches != 0:
        raise AssertionError("the incircle kernel ran on the odometry path")

    n_tris = int(rt.mesh.store.n_triangles())
    verts, faces = rt.mesh.extract()
    if n_tris <= 0 or len(faces) != n_tris:
        raise AssertionError(f"live triangles {n_tris}, extracted "
                             f"{len(faces)}")
    vd = vertex_surface_distance(verts @ R_align.T + p0, sim.scene)
    mesh_rms = float(np.sqrt(np.mean(vd ** 2)))
    if not mesh_rms <= AVIA_MESH_RMS_TOL_M:
        raise AssertionError(f"mesh vertex RMS {mesh_rms:.4f} m from the "
                             f"scene (limit {AVIA_MESH_RMS_TOL_M} m)")
    # logs in the reference schemas: TUM `t x y z qx qy qz qw` and the
    # mesh cost rows `frame mesh_ms n_voxels vx_map_ms avg_ms`
    rt.close()
    # ATE: the logged raw filter positions against ground truth,
    # Umeyama-aligned
    gt_rows = [(k * sim.scan_T, *f.gt_pos, 0, 0, 0, 1)
               for k, f in enumerate(gt)]
    ate = evaluate_ate(load_tum(os.path.join(log_dir, "kitti_log.txt")),
                       from_rows(gt_rows))
    traj = np.loadtxt(os.path.join(log_dir, "kitti_log.txt"))
    cost = np.loadtxt(os.path.join(log_dir, "mesh_cost_time.log"))
    n_all = warmup + n_frames
    if traj.shape != (n_all, 8) or cost.shape != (n_all, 5):
        raise AssertionError(f"log shapes {traj.shape}, {cost.shape}")
    if not (np.array_equal(cost[:, 0], np.arange(n_all))
            and np.allclose(np.linalg.norm(traj[:, 4:], axis=1), 1, atol=1e-5)
            and (cost[:, 2] >= 0).all()):
        raise AssertionError("log rows out of schema")
    # PLY and checkpoint round-trips
    ply = os.path.join(log_dir, "mesh.ply")
    v2, f2 = rt.save_mesh(ply)
    v3, f3 = load_ply(ply)
    if not (np.array_equal(v2, v3) and np.array_equal(f2, f3)):
        raise AssertionError("save_mesh does not round-trip through load_ply")
    prefix = os.path.join(log_dir, "ckpt")
    rt.save_state(prefix)
    back = interop.load_reference_checkpoint(prefix, cfg, device=dev)
    for name, obj in (("state", rt.lio.state), ("vm", rt.lio.vm),
                      ("gm", rt.mesh.gm), ("store", rt.mesh.store)):
        a, b = _leaves(obj), _leaves(back[name])
        if len(a) != len(b) or not all(torch.equal(x, y)
                                       for x, y in zip(a, b)):
            raise AssertionError(f"checkpoint of {name} does not restore "
                                 "bit-identical tensors")

    med = statistics.median(ms)
    p90 = float(np.percentile(ms, 90))
    log(f"[runtime] {n_frames} timed frames: {med:.1f} ms/frame median, "
        f"{p90:.1f} ms p90 (lio {np.nanmedian(lio_ms):.1f} ms, mesh "
        f"{np.nanmedian(mesh_ms):.1f} ms median, the frame trace's device "
        f"spans); "
        f"pairs_argmin {launches} runs; pose err max {max(errs):.4f} m, "
        f"last {errs[-1]:.4f} m; ATE {ate['ate_rmse']:.4f} m RMSE over "
        f"{ate['n_pairs']} frames")
    log(f"[runtime] live triangles {n_tris}, mesh vertices {len(verts)}, "
        f"vertex RMS {mesh_rms:.4f} m (p95 {np.percentile(vd, 95):.4f} m) "
        f"from the analytic scene; map points {int(rt.mesh.gm.n_points())}, "
        f"LIO voxels {int(rt.lio.vm.n_voxels())}; logs, PLY and checkpoint "
        f"round-trip")
    return rt


# ---------------------------------------------------------------------------
# phase 7: the incircle oracle audits the runtime's last re-mesh
# ---------------------------------------------------------------------------
def lifted_margins(u, v, lift, w, tri, scale):
    """f64 incircle margin of each triangle (n, 3) of voxel rows (n,) over
    its voxel's other valid points, on the lifted points both Delaunay
    formulations see, in units of scale⁴: max_d −(n̂·(P_d − P_a)) with n̂
    the CCW-oriented lifted normal; positive ⇒ some point lies inside the
    circumcircle."""
    P = np.stack([u, v, lift], -1).astype(np.float64)          # (n, K, 3)
    r = np.arange(len(tri))[:, None]
    Pa, Pb, Pc = (P[r[:, 0], tri[:, i]] for i in range(3))
    nrm = np.cross(Pb - Pa, Pc - Pa)
    nrm *= np.sign(nrm[:, 2:3])
    s = np.einsum("nkc,nc->nk", P - Pa[:, None, :], nrm)
    own = np.zeros_like(w, bool)
    own[r, tri] = True
    s = np.where((w > 0) & ~own, s, np.inf)
    return -s.min(-1) / scale ** 4


def pairs_on_real_voxels(uv, mask, tb, mcfg) -> None:
    """pairs_argmin on the runtime's last re-meshed voxels, in the chunks of
    mesh_chunk the path hands it: W bit-identical to the plain version, the
    device time and bound of each chunk, and the voxels' fill."""
    from immesh_tpu_torch.kernels import pairs_argmin as pk
    from immesh_tpu_torch.mesh.delaunay import pairs_channels

    lib = pk._library()
    A, K = mask.shape
    C = mcfg.mesh_chunk
    ms, bounds = [], []
    for a0 in range(0, A, C):
        ch = pairs_channels(uv[a0:a0 + C], mask[a0:a0 + C],
                            tiebreak=tb[a0:a0 + C], tie_scale=mcfg.tie_scale)
        W = pk.pairs_argmin_cuda(*ch)
        if not torch.equal(W, pk.pairs_argmin_plain(*ch)):
            raise AssertionError(f"pairs_argmin: kernel and plain version "
                                 f"differ on real voxels {a0}..{a0 + C}")
        ms.append(device_ms(lambda: pk._launch(lib, *ch, W), 20, 3))
        bounds.append(pairs_bound_ms(ch[0], ch[1], ch[3], ch[4])[0])
    fill = mask.float().mean(-1)
    log(f"[audit] pairs_argmin on the {A} voxels of the last re-mesh in "
        f"{len(ms)} chunks of {C}: W bit-identical; kernel "
        f"{1e3 * statistics.median(ms):.2f} us median per chunk "
        f"({', '.join(f'{1e3 * x:.2f}' for x in ms)}), bound "
        f"{1e3 * statistics.median(bounds):.2f} us median; fill "
        f"{float(fill.mean()):.3f} mean ({int(mask.sum(-1).float().mean())} "
        f"of K={K} points, {float(fill.min()):.3f}-{float(fill.max()):.3f})")


def phase_audit(dev, rt) -> int:
    """Re-run the runtime's last frame's voxels through delaunay_mask (the
    incircle kernel) and delaunay_pairs on the same inputs; returns the
    incircle launches."""
    from immesh_tpu_torch.kernels import incircle as ik
    from immesh_tpu_torch.mesh.delaunay import (
        _lifted, delaunay_mask, delaunay_pairs, pca_project)
    from immesh_tpu_torch.mesh.triangles import _pos_hash

    mcfg = rt.cfg.mesh
    slots, smask = rt.mesh.last_active
    sel = smask.nonzero().squeeze(-1)
    pull = rt.mesh.gm.pull_neighborhood(slots[sel], smask[sel])
    mask = pull["mask"]
    uv, _, _ = pca_project(pull["pts_sm"], mask)
    tb = _pos_hash(pull["pts"])
    pairs_on_real_voxels(uv, mask, tb, mcfg)
    ik.reset_launches()
    tris, keep = delaunay_mask(uv, mask, tiebreak=tb,
                               tie_scale=mcfg.tie_scale)
    torch.cuda.synchronize()
    launches = ik.launches
    if launches == 0:
        raise AssertionError("the audit never launched the incircle kernel")
    trip, emit = delaunay_pairs(uv, mask, tiebreak=tb,
                                tie_scale=mcfg.tie_scale)
    A, K = mask.shape
    T = tris.shape[0]
    # candidate index of each emitted (i, j, k): sort the triple, then its
    # rank in the lexicographic candidate table
    srt = torch.sort(trip.long(), dim=-1)[0]
    tri_code = (tris[:, 0].long() * K + tris[:, 1]) * K + tris[:, 2]
    code = (srt[..., 0] * K + srt[..., 1]) * K + srt[..., 2]
    idx = torch.searchsorted(tri_code, code.clamp(max=int(tri_code[-1])))
    emitted = torch.zeros((A, T), dtype=torch.bool, device=uv.device)
    rows = torch.arange(A, device=uv.device)[:, None].expand_as(idx)
    emitted[rows[emit], idx[emit]] = True
    differ = emitted != keep
    n_keep, n_emit, n_diff = (int(x.sum()) for x in (keep, emitted, differ))
    if n_emit == 0:
        raise AssertionError("the audit found no triangle to compare")
    worst = 0.0
    if n_diff:
        a_i, t_i = differ.nonzero(as_tuple=True)
        u, v, lift, scale = _lifted(uv, mask, 1e-6, tb, mcfg.tie_scale)
        m = lifted_margins(*(x[a_i].cpu().numpy() for x in (u, v, lift)),
                           mask[a_i].cpu().numpy(),
                           tris[t_i].cpu().numpy(),
                           scale[a_i].cpu().numpy().astype(np.float64))
        worst = float(np.abs(m).max())
        if worst >= AUDIT_TIE:
            raise AssertionError(
                f"audit: {int((np.abs(m) >= AUDIT_TIE).sum())} of {n_diff} "
                f"disagreeing triangles have an incircle margin above tie "
                f"level (worst {worst:.2e}·scale⁴)")
    log(f"[audit] {A} voxels re-meshed on the last runtime frame, "
        f"{T} candidates each: delaunay_mask keeps {n_keep}, delaunay_pairs "
        f"emits {n_emit}, {n_diff} disagree, all at tie level (worst "
        f"margin {worst:.2e}·scale⁴ < {AUDIT_TIE:g}); incircle launches "
        f"{launches}")
    return launches


# ---------------------------------------------------------------------------
# phase 8: the runtime with window BA at the Avia operating point
# ---------------------------------------------------------------------------
def ba_config():
    """PRESETS["avia"] with BaConfig(enabled=True) at its defaults."""
    from immesh_tpu_torch.config import BaConfig
    return avia_config().replace(ba=BaConfig(enabled=True))


def phase_ba(dev, n_frames: int, warmup: int):
    """ImMeshRuntime with BA on over warm-up plus n_frames; returns the
    runtime, the simulator, the frame count and the VIEWER_FRAMES bundles
    after them, the pairs_argmin launches, and the first window (its
    problem on the CPU, the card's solution and the solve's arguments)."""
    from immesh_tpu_torch.dist import window_ba
    from immesh_tpu_torch.eval.ate import evaluate_ate, from_rows
    from immesh_tpu_torch.lio import window
    from immesh_tpu_torch.runtime.app import ImMeshRuntime

    cfg = ba_config()
    bc = cfg.ba
    sim = make_avia_sim(cfg)
    static = sim.static_imu(100)
    n_all = warmup + n_frames
    gt = [sim.frame(k) for k in range(n_all + VIEWER_FRAMES)]
    frames = [bundle(f, cfg, dev) for f in gt]
    rt = ImMeshRuntime(cfg, device=dev)
    rt.static_init(*static)
    R0, p0 = sim.traj.pose(0.0)
    R_align = R0 @ rt.lio.state.rot.cpu().numpy().astype(np.float64).T

    # the first window's problem and the card's solution, and the time of
    # every refine (CUDA events around WindowBA.refine)
    first, refine_ms = [], []
    solve_on_card = window.solve_window

    def capture(prob, **kw):
        sol = solve_on_card(prob, **kw)
        if not first:
            first.append((prob, sol, kw))
        return sol

    refine = rt.ba.refine

    def timed_refine(vm):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        out = refine(vm)
        e1.record()
        torch.cuda.synchronize()
        refine_ms.append(e0.elapsed_time(e1))
        return out

    window.solve_window = capture
    rt.ba.refine = timed_refine
    reset_counts()
    ms_plain, ms_refined, errs, costs, rows = [], [], [], [], []
    for k in range(n_all):
        t1 = time.perf_counter()
        st = rt.process_frame(frames[k], t=k * sim.scan_T)
        torch.cuda.synchronize()
        dt = 1e3 * (time.perf_counter() - t1)
        err = float(np.linalg.norm(R_align @ st["pos"].astype(np.float64)
                                   + p0 - gt[k].gt_pos))
        if not err <= BA_POSE_TOL_M:
            raise AssertionError(
                f"BA frame {k}: pose {err:.4f} m from ground truth (limit "
                f"{BA_POSE_TOL_M} m)")
        errs.append(err)
        rows.append((k * sim.scan_T, *st["pos"], 0, 0, 0, 1))
        if st["ba_cost"] is not None:
            if not np.isfinite(st["ba_cost"]):
                raise AssertionError(f"BA frame {k}: window cost "
                                     f"{st['ba_cost']}")
            costs.append((k, st["ba_cost"]))
        if k >= warmup:
            (ms_plain if st["ba_cost"] is None else ms_refined).append(dt)
        log(f"[ba] frame {k:2d}: {dt:7.1f} ms, pose err {err:.4f} m, "
            f"{len(rt.ba.kf_rot)} keyframes in the window"
            + (f", refined: cost {st['ba_cost']:.4f}"
               if st["ba_cost"] is not None else ""))
    window.solve_window = solve_on_card
    rt.ba.refine = refine
    # pairs_argmin's runs on the device: the mesh step is a captured graph
    launches = path_counts("ba", graphs=pipe_graphs(rt))["runs"][
        "pairs_argmin"]
    if rt.ba.n_refinements < 3:
        raise AssertionError(f"{rt.ba.n_refinements} window refinements "
                             "(at least 3 expected)")
    if launches == 0:
        raise AssertionError("pairs_argmin was never launched with BA on")

    # the first window solved again by the port on the CPU
    prob, sol, kw = first[0]
    ref = window_ba.solve_window(prob.to("cpu"), **kw)
    diffs = {key: float((sol[key].cpu() - ref[key]).abs().max())
             for key in ("rot", "pos", "normal", "d")}
    if not max(diffs.values()) <= BA_SOLVE_TOL:
        raise AssertionError(f"first window: card and CPU solves differ "
                             f"{diffs} (limit {BA_SOLVE_TOL})")
    n_used = int((prob.weight > 0).sum())
    log(f"[ba] first window (K={prob.rot.shape[0]}, M={prob.normal.shape[0]}"
        f", {n_used} weighted points, {bc.iterations} iterations): card vs "
        f"CPU solve max |Δ| " + ", ".join(f"{k} {v:.2e}"
                                          for k, v in diffs.items())
        + f" (limit {BA_SOLVE_TOL}); cost card {float(sol['cost']):.6f}, "
        f"CPU {float(ref['cost']):.6f}")

    gt_rows = [(k * sim.scan_T, *f.gt_pos, 0, 0, 0, 1)
               for k, f in enumerate(gt[:n_all])]
    ate = evaluate_ate(from_rows(rows), from_rows(gt_rows))
    log(f"[ba] {n_frames} timed frames: {statistics.median(ms_plain):.1f} "
        f"ms/frame median without a refinement ({len(ms_plain)} frames), "
        f"{statistics.median(ms_refined):.1f} ms with one "
        f"({len(ms_refined)}: {', '.join(f'{x:.1f}' for x in ms_refined)}); "
        f"refine {statistics.median(refine_ms):.1f} ms median "
        f"({', '.join(f'{x:.1f}' for x in refine_ms)}, CUDA events); "
        f"{rt.ba.n_refinements} refinements on frames "
        f"{[k for k, _ in costs]}; pose err max {max(errs):.4f} m (frame "
        f"{int(np.argmax(errs))}; the JAX reference {BA_REF_POSE_M} m), "
        f"last {errs[-1]:.4f} m; ATE "
        f"{ate['ate_rmse']:.4f} m RMSE; pairs_argmin {launches} runs; "
        f"live triangles {int(rt.mesh.store.n_triangles())}")
    return rt, sim, n_all, frames[n_all:], launches, (prob.to("cpu"), sol, kw)


# ---------------------------------------------------------------------------
# phase 8b: BA against drift, the loc_kick0.2_w5 replay
# ---------------------------------------------------------------------------
def phase_ba_ab(dev):
    """bench.py::run_ba_scenario(kick_mag=0.2, window=5) on the port: a
    clean localization map from 30 frames of 2,048 rays (seed 3), then 40
    frames of 1,024 rays (seed 11) with a handicapped filter, no map
    updates and a 0.2 m position kick every 10 frames; ATE with BA off and
    on."""
    from immesh_tpu_torch import interop
    from immesh_tpu_torch.config import PRESETS, BaConfig, LioConfig
    from immesh_tpu_torch.frontend.sim import LidarImuSimulator
    from immesh_tpu_torch.lio.pipeline import LioPipeline
    from immesh_tpu_torch.runtime.app import ImMeshRuntime

    sim = LidarImuSimulator(n_rays=2048, seed=3)
    R0, p0 = sim.traj.pose(0.0)
    cfg_map = PRESETS["sim"]()
    pipe = LioPipeline(cfg_map, device=dev)
    pipe.static_init(*sim.static_imu(100))
    for k in range(30):
        pipe.step(bundle(sim.frame(k), cfg_map, dev))
    vm_clean = interop.to_numpy({"vm": pipe.vm})

    def run(ba_on):
        sim2 = LidarImuSimulator(n_rays=1024, seed=11)
        cfg = PRESETS["sim"]().replace(
            lio=LioConfig(max_iterations=1, downsample_voxel=2.0,
                          map_update_points=64, update_map=False),
            ba=BaConfig(enabled=ba_on, window_size=5, kf_trans_thresh=0.25,
                        pts_per_keyframe=512, iterations=8, huber_delta=0.3,
                        odo_w_rot=1e2, odo_w_t=1e2))
        rt = ImMeshRuntime(cfg, mesh_enabled=False, device=dev)
        rt.static_init(*sim2.static_imu(100))
        rt.lio.vm = interop.from_reference(vm_clean, cfg, device=dev)["vm"]
        R_align = R0 @ rt.lio.state.rot.cpu().numpy().astype(np.float64).T
        kick = np.random.default_rng(0)
        errs = []
        for k in range(40):
            f = sim2.frame(k)
            if k % 10 == 5:  # recurring disturbance
                st = rt.lio.state
                d = torch.from_numpy(kick.normal(0, 0.2, 3).astype(np.float32))
                rt.lio.state = st.replace(pos=st.pos + d.to(dev))
            rt.process_frame(bundle(f, cfg, dev), t=k * sim2.scan_T)
            est = (R_align @ rt.lio.state.pos.cpu().numpy().astype(np.float64)
                   + p0)
            errs.append(np.linalg.norm(est - f.gt_pos))
        rt.close()
        return (float(np.sqrt(np.mean(np.square(errs)))),
                rt.ba.n_refinements if rt.ba else 0)

    ate_off, _ = run(False)
    ate_on, n_ref = run(True)
    if not ate_on < ate_off:
        raise AssertionError(f"loc_kick0.2_w5: ATE with BA {ate_on:.4f} m, "
                             f"without {ate_off:.4f} m")
    log(f"[ba_ab] loc_kick0.2_w5: ATE {ate_off:.4f} m with BA off → "
        f"{ate_on:.4f} m on ({n_ref} refinements); the JAX reference "
        f"{BA_AB_REF_M[0]} → {BA_AB_REF_M[1]} m (BENCH_DETAIL.json)")


# ---------------------------------------------------------------------------
# phase 9: reinforcement, views, plane map, live viewer, oracle mesh
# ---------------------------------------------------------------------------
def http_get(port: int, path: str) -> bytes:
    import http.client
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=30)
    try:
        conn.request("GET", path)
        r = conn.getresponse()
        body = r.read()
    finally:
        conn.close()
    if r.status != 200:
        raise AssertionError(f"GET {path}: HTTP {r.status}")
    return body


def phase_render(dev, rt, sim, n_before: int, frames):
    """Phase 9 on phase 8's runtime; `frames` run with the live viewer on,
    after the runtime's first n_before frames."""
    import struct
    import tempfile

    from immesh_tpu_torch import interop
    from immesh_tpu_torch.eval.mesh_quality import (
        hole_stats, oracle_boundary_stats, store_faces)
    from immesh_tpu_torch.render.live import _MAGIC
    from immesh_tpu_torch.render.raster import PinholeCam, reinforce_scan
    from immesh_tpu_torch.render.viewer import render_mesh_views
    from immesh_tpu_torch.runtime.export import load_ply, save_plane_map_ply

    # --- reinforcement on the card, against the CPU's rasterization
    n_faces = int(rt.mesh.store.n_triangles())
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    pts, depth = rt.reinforce()
    e1.record()
    torch.cuda.synchronize()
    ms = e0.elapsed_time(e1)
    peak = torch.cuda.max_memory_allocated() - base
    hit = np.isfinite(depth)
    if len(pts) == 0 or not np.isfinite(pts).all():
        raise AssertionError(f"reinforce: {len(pts)} points")
    pos = rt.lio.state.pos.cpu().numpy()
    fwd = rt.lio.state.rot[:, 0].cpu().numpy()
    cam = PinholeCam.looking(pos, pos + fwd, device="cpu")   # reinforce's
    o = interop.from_reference(interop.to_numpy(
        {"gm": rt.mesh.gm, "store": rt.mesh.store}), rt.cfg, device="cpu")
    pts_c, depth_c = reinforce_scan(o["store"], o["gm"], cam, stride=2,
                                    max_depth=80.0)
    hit_c = np.isfinite(depth_c)
    n_flip = int((hit != hit_c).sum())
    both = hit & hit_c
    rel = float(np.max(np.abs(depth[both] - depth_c[both]) / depth_c[both]))
    if n_flip > RASTER_PIXEL_SHARE * depth.size or not rel <= RASTER_RTOL:
        raise AssertionError(
            f"reinforce: card and CPU depth differ: {n_flip} pixels hit on "
            f"one side only, max relative depth difference {rel:.2e}")
    log(f"[render] reinforce at {depth.shape[1]}x{depth.shape[0]} over "
        f"{n_faces} live triangles: {ms:.1f} ms (CUDA events), peak "
        f"{peak / 2 ** 20:.1f} MiB above the {base / 2 ** 20:.1f} MiB held; "
        f"{int(hit.sum())} pixels hit, {len(pts)} points (CPU {len(pts_c)});"
        f" card vs CPU: {n_flip} pixels hit on one side only, max relative "
        f"depth difference {rel:.2e}")

    # --- snapshot views of the extracted mesh from the same camera
    verts, faces = rt.mesh.extract()
    vdepth, shade = render_mesh_views(verts, faces, cam, device=dev)
    vhit = np.isfinite(vdepth)
    vd = vdepth[vhit]
    if (not vhit.any() or (vhit != hit).sum() > RASTER_PIXEL_SHARE * hit.size
            or not ((vd > cam.znear) & (vd < cam.zfar)).all()
            or not ((shade >= 0) & (shade <= 1)).all()):
        raise AssertionError("render_mesh_views: depth does not cover the "
                             "mesh reinforce sees, or out of range")
    log(f"[render] render_mesh_views: {int(vhit.sum())} pixels of finite "
        f"depth ({int((vhit != hit).sum())} differ from reinforce's), "
        f"shade in [0, 1]")

    # --- plane-map PLY
    out_dir = tempfile.mkdtemp(prefix="immesh_smoke_render_")
    ply = os.path.join(out_dir, "planes.ply")
    n_planes = save_plane_map_ply(rt.lio.vm, ply)
    v, f, c = load_ply(ply)
    n_valid = int(rt.lio.vm.n_planes())
    if not (n_planes == n_valid > 0 and len(v) == 4 * n_valid
            and len(f) == 2 * n_valid and len(c) == 4 * n_valid
            and np.isfinite(v).all()):
        raise AssertionError(f"plane map PLY: {n_planes} patches, {len(v)} "
                             f"vertices, {len(f)} faces for {n_valid} planes")
    log(f"[render] plane-map PLY: {n_planes} patches for {n_valid} valid "
        f"planes round-trip through load_ply")

    # --- the live viewer over a few more frames
    url = rt.start_live_viewer(port=0, sync_every=1)
    try:
        port = int(url.rsplit(":", 1)[1].rstrip("/"))
        for k, b in enumerate(frames):
            t1 = time.perf_counter()
            rt.process_frame(b, t=(n_before + k) * sim.scan_T)
            torch.cuda.synchronize()
            log(f"[render] viewer frame {k}: "
                f"{1e3 * (time.perf_counter() - t1):.1f} ms with the sync")
        st = json.loads(http_get(port, "/state?since=0"))
        if not (st["n_triangles"] > 0 and st["changed"]
                and len(st["traj"]) == len(frames)):
            raise AssertionError(f"/state: {st['n_triangles']} triangles, "
                                 f"{len(st['changed'])} regions changed")
        rid = st["changed"][0]
        raw = http_get(port, "/region/" + ",".join(map(str, rid)))
        magic, rx, ry, rz, n = struct.unpack_from("<Iiiii", raw)
        if not (magic == _MAGIC and [rx, ry, rz] == rid and n > 0
                and len(raw) == 20 + 36 * n):
            raise AssertionError(f"/region/{rid}: bad buffer")
        tri = np.frombuffer(raw, "<f4", offset=20).reshape(n, 3, 3)
        raw = http_get(port, "/planes")
        (m,) = struct.unpack_from("<i", raw)
        if not (m > 0 and np.isfinite(tri).all()):
            raise AssertionError(f"/planes: {m} planes")
        html = http_get(port, "/")
        if b"webgl2" not in html:
            raise AssertionError("/ does not serve the viewer")
    finally:
        rt.stop_live_viewer()
    log(f"[render] live viewer at {url}: /state {st['n_triangles']} "
        f"triangles in {st['n_regions']} regions, /region/{rid} {n} "
        f"triangles, /planes {m} patches; server stopped")

    # --- the scipy oracle mesh over the map beside the store
    t1 = time.perf_counter()
    oracle = oracle_boundary_stats(rt.mesh.gm)
    store = hole_stats(store_faces(rt.mesh.store))
    if oracle["n_edges"] == 0:
        raise AssertionError("the oracle mesh is empty")
    log(f"[render] boundary-edge fraction: store "
        f"{store['boundary_fraction']:.4f} ({store['boundary_edges']} of "
        f"{store['n_edges']} edges, {store['nonmanifold_edges']} "
        f"non-manifold), scipy oracle {oracle['boundary_fraction']:.4f} "
        f"({oracle['boundary_edges']} of {oracle['n_edges']}) over ≤ 4,096 "
        f"voxels ({time.perf_counter() - t1:.1f} s)")
    return {"reinforce_ms": ms, "reinforce_peak_bytes": peak}


# ---------------------------------------------------------------------------
# phase 10: the host frontend's native decoder
# ---------------------------------------------------------------------------
def pack_points(layout: str, xyz, t_raw=None, ring=None) -> bytes:
    """Serialise points into `layout`'s strided wire format: the fields
    LAYOUTS names, every other byte 0 (a livox_custommsg point's
    reflectivity and tag are 0: a normal return)."""
    from immesh_tpu_torch.frontend.native import _NP_DTYPES, LAYOUTS
    step, offs, t_off, t_dt, _, ring_off, ring_dt = LAYOUTS[layout]
    n = len(xyz)
    buf = np.zeros((n, step), np.uint8)

    def put(off, vals, dt):
        v = np.ascontiguousarray(vals, dt)
        buf[:, off:off + v.itemsize] = v.view(np.uint8).reshape(n, v.itemsize)

    for off, col in zip(offs, np.asarray(xyz, np.float32).T):
        put(off, col, "<f4")
    if t_raw is not None:
        put(t_off, t_raw, _NP_DTYPES[t_dt])
    if ring is not None and ring_off >= 0:
        put(ring_off, ring, _NP_DTYPES[ring_dt])
    return buf.tobytes()


def host_ms(fn, reps: int) -> float:
    """Median host wall time of `reps` calls of fn, in ms."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append(1e3 * (time.perf_counter() - t0))
    return statistics.median(times)


def phase_frontend():
    """The port's scanpack library, built with the machine's C++ compiler,
    against its NumPy oracle on a KITTI-sized buffer in every layout; the
    IMU ring round trip."""
    from immesh_tpu_torch.frontend import native
    from immesh_tpu_torch.kernels import build

    t0 = time.perf_counter()
    lib = build.build([native.NAME], force=True)[native.NAME]
    build_s = time.perf_counter() - t0
    pcfg = kitti_config().preprocess
    n = 131072
    rng = np.random.default_rng(10)
    xyz = rng.uniform(-120, 120, (n, 3)).astype(np.float32)
    xyz[0::997] = [np.nan, 1.0, 1.0]
    xyz[1::1009] = [0.02, 0.0, 0.0]          # inside the blind radius
    xyz[2::1013] = [pcfg.blind, 0.0, 0.0]    # on its edge
    xyz[3::1019] = [200.0, 0.0, 0.0]         # beyond max_range
    xyz[4::1021] = [pcfg.max_range, 0.0, 0.0]
    xyz[5::1031] = [0.0, np.inf, 0.0]
    times = {}
    for layout in sorted(native.LAYOUTS):
        step, offs, t_off, t_dt, t_sc, ring_off, ring_dt = \
            native.LAYOUTS[layout]
        t_raw = (rng.uniform(0, 0.1, n) / t_sc + 3.0).astype(
            native._NP_DTYPES[t_dt])
        buf = pack_points(layout, xyz, t_raw, rng.integers(0, 64, n))
        raw = np.frombuffer(buf, np.uint8)
        kw = dict(point_step=step, off_xyz=offs, t_off=t_off, t_dtype=t_dt,
                  t_scale=t_sc, ring_off=ring_off, ring_dtype=ring_dt,
                  blind=pcfg.blind, max_range=pcfg.max_range,
                  filter_num=pcfg.point_filter_num, want_ring=True)
        args = (raw, n, step, offs, t_off, t_dt, t_sc, ring_off, ring_dt,
                pcfg.blind, pcfg.max_range, pcfg.point_filter_num, True)
        got = native.decode_filter(buf, n, **kw)
        want = native._decode_filter_numpy(*args)
        for name, a, b in zip(("xyz", "t", "ring"), got, want):
            if a.dtype != b.dtype or a.tobytes() != b.tobytes():
                raise AssertionError(f"scanpack {layout}: {name} differs "
                                     f"from the NumPy oracle")
        if not 0 < len(got[0]) < n:
            raise AssertionError(f"scanpack {layout}: {len(got[0])} points "
                                 "kept")
        times[layout] = (host_ms(lambda: native.decode_filter(buf, n, **kw),
                                 5),
                         host_ms(lambda: native._decode_filter_numpy(*args),
                                 3))
    ring = native.ImuRing(cap=4096)
    stamps = np.arange(3000) * 0.005
    acc = rng.normal(size=(3000, 3)).astype(np.float32)
    gyr = rng.normal(size=(3000, 3)).astype(np.float32)
    if not all(ring.push(s, a, g) for s, a, g in zip(stamps, acc, gyr)):
        raise AssertionError("ImuRing refused a push below its capacity")
    out = [ring.drain_until(t) for t in (4.9975, 9.9975, 20.0)]
    s, a, g = (np.concatenate(x) for x in zip(*out))
    if not (len(ring) == 0 and [len(o[0]) for o in out] == [1000, 1000, 1000]
            and np.array_equal(s, stamps) and np.array_equal(a, acc)
            and np.array_equal(g, gyr)):
        raise AssertionError("ImuRing push/drain does not round-trip")
    log(f"[frontend] {lib} built with the host compiler in {build_s:.1f} s; "
        f"decode of {n} points (planted NaN, inf, blind, edge and "
        f"out-of-range rows) byte-identical to the NumPy oracle in every "
        f"layout; host ms native / NumPy: " + ", ".join(
            f"{k} {a:.2f} / {b:.2f}" for k, (a, b) in times.items())
        + "; ImuRing round-trips 3,000 samples")
    return times


# ---------------------------------------------------------------------------
# phase 11: the sensor-input paths into ImMeshRuntime
# ---------------------------------------------------------------------------
def bundle_of(pts, t_rel, f, cfg, device):
    """A ScanBundle of preprocessed points and, where f is a simulator
    frame, its IMU samples (one zero sample without)."""
    from immesh_tpu_torch.frontend.types import ScanBundle
    if f is None:
        imu = (np.zeros(1, np.float32), np.zeros((1, 3), np.float32),
               np.zeros((1, 3), np.float32))
    else:
        imu = (f.imu_stamps, f.imu_acc, f.imu_gyr)
    return ScanBundle.from_numpy(
        pts, t_rel, *imu, 0.1, cfg.preprocess.max_points,
        cfg.imu.max_imu_per_scan, device=device)


def same_bundle(a, b) -> bool:
    names = ("pts", "t_rel", "mask", "imu_stamps", "imu_acc", "imu_gyr",
             "imu_mask", "scan_duration")
    return all(torch.equal(getattr(a, k).cpu(), getattr(b, k).cpu())
               for k in names)


def phase_replay_kitti(dev, n_frames: int, warmup: int):
    """KITTI .bin scans from the clockwise outdoor simulator read back
    through kitti_sequence → PacketSynchronizer (IMU off) →
    ImMeshRuntime.run on the card; the first PARITY_FRAMES bundles again
    through a CPU synchronizer and runtime."""
    import tempfile

    from immesh_tpu_torch.config import LidarType
    from immesh_tpu_torch.eval.ate import evaluate_ate, from_rows, load_tum
    from immesh_tpu_torch.frontend.preprocess import (
        Preprocessor, kitti_sequence, read_kitti_bin)
    from immesh_tpu_torch.frontend.sync import PacketSynchronizer
    from immesh_tpu_torch.runtime.app import ImMeshRuntime

    base = kitti_config()
    cfg = base.replace(preprocess=dataclasses.replace(
        base.preprocess, lidar_type=LidarType.KITTI64, calib_laser=False))
    N = cfg.preprocess.max_points
    n_all = warmup + n_frames
    t0 = time.perf_counter()
    sim = make_sim(N, 64, clockwise=True)
    out_dir = tempfile.mkdtemp(prefix="immesh_smoke_kitti_")
    vdir = os.path.join(out_dir, "velodyne")
    os.makedirs(vdir)
    gt = []
    for k in range(n_all):
        f = sim.frame(k)
        np.concatenate([f.pts, np.ones((len(f.pts), 1), np.float32)],
                       axis=1).astype(np.float32).tofile(
                           os.path.join(vdir, f"{k:06d}.bin"))
        gt.append(f.gt_pos)
    log(f"[replay] {n_all} KITTI .bin scans of {N} rays written in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")

    sync = PacketSynchronizer(cfg, device=dev)
    rt = ImMeshRuntime(cfg, log_dir=out_dir, device=dev)
    host, frame_ms, counts, firsts = [], [], [], []

    def bundles():
        scans = kitti_sequence(vdir)
        while True:
            t1 = time.perf_counter()
            scan = next(scans, None)
            if scan is None:
                return
            sync.push_scan(scan)
            b = sync.next_bundle()
            torch.cuda.synchronize()
            host.append(1e3 * (time.perf_counter() - t1))
            if len(firsts) < PARITY_FRAMES:
                firsts.append(b)
            t2 = time.perf_counter()
            yield b
            torch.cuda.synchronize()
            frame_ms.append(1e3 * (time.perf_counter() - t2))
            if len(counts) < PARITY_FRAMES:
                counts.append((int(rt.mesh.store.n_triangles()),
                               int(rt.mesh.gm.n_points())))

    reset_counts()
    outs = rt.run(bundles())
    # pairs_argmin's runs on the device: the mesh step is a captured graph
    launches = path_counts("kitti_replay", graphs=pipe_graphs(rt))["runs"][
        "pairs_argmin"]
    rt.close()
    R0, p0 = sim.traj.pose(0.0)
    errs = [float(np.linalg.norm(R0 @ o["pos"].astype(np.float64) + p0 - g))
            for o, g in zip(outs, gt)]
    if len(outs) != n_all or not max(errs) <= POSE_TOL_M:
        raise AssertionError(f"KITTI replay: {len(outs)} frames, pose err "
                             f"max {max(errs):.3f} m (limit {POSE_TOL_M} m)")
    if launches == 0:
        raise AssertionError("pairs_argmin was never launched on the KITTI "
                             "replay")
    gt_rows = [(k * 0.1, *g, 0, 0, 0, 1) for k, g in enumerate(gt)]
    ate = evaluate_ate(load_tum(os.path.join(out_dir, "kitti_log.txt")),
                       from_rows(gt_rows))
    # the host work of one frame, stage by stage, on the last scan
    path = os.path.join(vdir, f"{n_all - 1:06d}.bin")
    pre = Preprocessor(cfg.preprocess)
    scan = read_kitti_bin(path)
    pts, t_rel = pre.process(scan)
    split = {
        "read_kitti_bin": host_ms(lambda: read_kitti_bin(path), 5),
        "Preprocessor.process": host_ms(lambda: pre.process(scan), 5),
        "ScanBundle.from_numpy + upload": host_ms(
            lambda: (bundle_of(pts, t_rel, None, cfg, dev),
                     torch.cuda.synchronize()), 5)}

    # the first bundles through a CPU synchronizer and runtime, chained
    t1 = time.perf_counter()
    sync_c = PacketSynchronizer(cfg, device="cpu")
    rt_c = ImMeshRuntime(cfg, device="cpu")
    for k, scan in zip(range(PARITY_FRAMES), kitti_sequence(vdir)):
        sync_c.push_scan(scan)
        b = sync_c.next_bundle()
        if not same_bundle(b, firsts[k]):
            raise AssertionError(f"KITTI replay bundle {k}: the CPU "
                                 "synchronizer's differs from the card's")
        pos = rt_c.process_frame(b, t=k * 0.1)["pos"]
        dp = float(np.abs(pos - outs[k]["pos"]).max())
        nt, npt = (int(rt_c.mesh.store.n_triangles()),
                   int(rt_c.mesh.gm.n_points()))
        na, pa = counts[k]
        if (dp > 1e-3 or abs(na - nt) > TRI_COUNT_RTOL * max(nt, 1)
                or abs(pa - npt) > 0.01 * max(npt, 1)):
            raise AssertionError(
                f"KITTI replay frame {k}: card and CPU disagree: |Δpos| "
                f"{dp:.2e} m, triangles {na} vs {nt}, points {pa} vs {npt}")
    cpu_s = time.perf_counter() - t1
    med = statistics.median(frame_ms[warmup:])
    log(f"[replay] KITTI .bin → kitti_sequence → PacketSynchronizer → "
        f"ImMeshRuntime.run, {n_frames} timed frames: host read + "
        f"preprocess + sync + upload {statistics.median(host[warmup:]):.1f} "
        f"ms/frame median ({min(host[warmup:]):.1f}-"
        f"{max(host[warmup:]):.1f}), the runtime's frame {med:.1f} ms "
        f"median, p90 {np.percentile(frame_ms[warmup:], 90):.1f} ms; "
        f"pairs_argmin {launches} runs; pose err max {max(errs):.3f} m, "
        f"last {errs[-1]:.3f} m; ATE {ate['ate_rmse']:.4f} m RMSE over "
        f"{ate['n_pairs']} frames; live triangles "
        f"{int(rt.mesh.store.n_triangles())}, map points "
        f"{int(rt.mesh.gm.n_points())}")
    log("[replay] KITTI host ms per frame by stage (median of 5): "
        + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    log(f"[replay] KITTI: the first {PARITY_FRAMES} bundles again through a "
        f"CPU synchronizer (byte-identical bundles) and runtime agree with "
        f"the card (last |Δpos| {dp:.2e} m, triangles {na} vs {nt}, points "
        f"{pa} vs {npt}; {cpu_s:.1f} s on the CPU)")
    return {"launches": launches, "host_ms": statistics.median(
        host[warmup:]), "frame_ms": med}


def phase_replay_avia(dev, n_frames: int, warmup: int, on_frame=None):
    """The Avia preset fed from the wire: each simulator frame serialised
    to livox_custommsg bytes and decoded by decode_raw_buffer, the IMU
    streamed one sample at a time into PacketSynchronizer.push_imu;
    next_bundle() → ImMeshRuntime.process_frame on the card.  `on_frame(k,
    rt)` runs after frame k's timing (phase 12).  The first IMU_WARM
    frames are stepped again on the CPU from the card's state, as phase 5
    does.  Returns the runtime, the simulator and the filter alignment."""
    from immesh_tpu_torch import interop
    from immesh_tpu_torch.frontend.preprocess import decode_raw_buffer
    from immesh_tpu_torch.frontend.sync import PacketSynchronizer
    from immesh_tpu_torch.runtime.app import ImMeshRuntime

    cfg = avia_config()
    N = cfg.preprocess.max_points
    n_all = warmup + n_frames
    t0 = time.perf_counter()
    sim = make_avia_sim(cfg)
    static = sim.static_imu(100)
    gt = [sim.frame(k) for k in range(n_all)]
    # u32 ns offset time, the CustomMsg field; the time round trip through
    # decode_raw_buffer and the preprocessor moves t_rel by ≤ 1 ns plus f32
    # rounding, so poses are held to ground truth, not to phase 6's
    wire = [pack_points("livox_custommsg", f.pts,
                        np.round(f.t_rel.astype(np.float64) * 1e9))
            for f in gt]
    log(f"[replay] {n_all} Avia frames serialised to livox_custommsg "
        f"({len(wire[0]) // len(gt[0].pts)} B/point) in "
        f"{time.perf_counter() - t0:.1f} s (set-up)")

    # Scan stamps accumulate one f32-exact period, so the last IMU sample
    # of frame k (stamp_k + f32(0.1)) and the start of frame k + 1 are the
    # same double: each boundary sample is pushed once (with frame k) and
    # lies in both frames' [stamp, stamp + duration] windows.
    period = float(np.float32(sim.scan_T))
    sync = PacketSynchronizer(cfg, device=dev)
    rt = ImMeshRuntime(cfg, device=dev)
    rt.static_init(*static)
    R0, p0 = sim.traj.pose(0.0)
    R_align = R0 @ rt.lio.state.rot.cpu().numpy().astype(np.float64).T
    host, frame_ms, errs, snaps, card_pos = [], [], [], [], []
    stamp = 0.0
    reset_counts()
    for k, f in enumerate(gt):
        if k < IMU_WARM:
            snaps.append(interop.to_numpy(
                {"state": rt.lio.state, "vm": rt.lio.vm, "gm": rt.mesh.gm,
                 "store": rt.mesh.store}))
        t1 = time.perf_counter()
        for j in range(1 if k else 0, len(f.imu_stamps)):
            sync.push_imu(stamp + float(f.imu_stamps[j]), f.imu_acc[j],
                          f.imu_gyr[j])
        sync.push_scan(decode_raw_buffer(
            wire[k], len(f.pts), "livox_custommsg", cfg.preprocess,
            stamp=stamp, duration=period))
        b = sync.next_bundle()
        torch.cuda.synchronize()
        host.append(1e3 * (time.perf_counter() - t1))
        if b is None:
            raise AssertionError(f"Avia wire frame {k}: no bundle once the "
                                 "IMU covers the scan")
        m = int(b.imu_mask.sum())
        acc = f.imu_acc.copy()
        if k:
            acc[0] = gt[k - 1].imu_acc[-1]   # the boundary sample pushed once
        if not (m == len(f.imu_stamps)
                and np.array_equal(b.imu_stamps[:m].cpu().numpy(),
                                   f.imu_stamps)
                and np.array_equal(b.imu_acc[:m].cpu().numpy(), acc)):
            raise AssertionError(f"Avia wire frame {k}: the bundle's IMU "
                                 "samples are not the stream's")
        t2 = time.perf_counter()
        st = rt.process_frame(b, t=k * sim.scan_T, imu_gap=sync.consume_gap())
        torch.cuda.synchronize()
        frame_ms.append(1e3 * (time.perf_counter() - t2))
        err = float(np.linalg.norm(R_align @ st["pos"].astype(np.float64)
                                   + p0 - f.gt_pos))
        if not err <= AVIA_POSE_TOL_M:
            raise AssertionError(
                f"Avia wire frame {k}: pose {err:.4f} m from ground truth "
                f"(limit {AVIA_POSE_TOL_M} m)")
        errs.append(err)
        if k < IMU_WARM:
            card_pos.append((b, st["pos"]))
        stamp += period
        if on_frame is not None:
            on_frame(k, rt)
    # pairs_argmin's runs on the device: the mesh step is a captured graph
    launches = path_counts("avia_wire", graphs=pipe_graphs(rt))["runs"][
        "pairs_argmin"]
    if launches == 0:
        raise AssertionError("pairs_argmin was never launched on the Avia "
                             "wire path")

    # the host work of one frame, stage by stage, on the last frame; the
    # decode also through the NumPy oracle
    from immesh_tpu_torch.frontend import native
    from immesh_tpu_torch.frontend.preprocess import Preprocessor
    f = gt[-1]
    step, offs, t_off, t_dt, t_sc, ring_off, ring_dt = \
        native.LAYOUTS["livox_custommsg"]
    pc = cfg.preprocess
    raw = np.frombuffer(wire[-1], np.uint8)
    scan = decode_raw_buffer(wire[-1], len(f.pts), "livox_custommsg", pc,
                             stamp=stamp, duration=period)
    pre = Preprocessor(pc)
    pts, t_rel = pre.process(scan)

    def imu_stream():
        s_ = PacketSynchronizer(cfg, device=dev)
        for j in range(len(f.imu_stamps)):
            s_.push_imu(float(f.imu_stamps[j]), f.imu_acc[j], f.imu_gyr[j])

    split = {
        "decode_raw_buffer": host_ms(lambda: decode_raw_buffer(
            wire[-1], len(f.pts), "livox_custommsg", pc), 5),
        "its NumPy oracle": host_ms(lambda: native._decode_filter_numpy(
            raw, len(f.pts), step, offs, t_off, t_dt, t_sc, ring_off,
            ring_dt, pc.blind, pc.max_range, pc.point_filter_num, True), 5),
        f"{len(f.imu_stamps)} push_imu": host_ms(imu_stream, 5),
        "Preprocessor.process": host_ms(lambda: pre.process(scan), 5),
        "ScanBundle.from_numpy + upload": host_ms(
            lambda: (bundle_of(pts, t_rel, f, cfg, dev),
                     torch.cuda.synchronize()), 5)}

    # the first frames again on the CPU, each from the card's state
    t1 = time.perf_counter()
    rt_c = ImMeshRuntime(cfg, device="cpu")
    rt_c.static_init(*static)
    steps = []
    for k, (snap, (b, pos)) in enumerate(zip(snaps, card_pos)):
        o = interop.from_reference(snap, cfg, device="cpu")
        rt_c.lio.state, rt_c.lio.vm = o["state"], o["vm"]
        rt_c.mesh.gm, rt_c.mesh.store = o["gm"], o["store"]
        b_c = dataclasses.replace(b, **{
            f.name: getattr(b, f.name).cpu()
            for f in dataclasses.fields(b)})
        pc = rt_c.process_frame(b_c, t=k * sim.scan_T)["pos"]
        dp = float(np.abs(pc - pos).max())
        e = float(np.linalg.norm(R_align @ pc.astype(np.float64) + p0
                                 - gt[k].gt_pos))
        if dp > IMU_WARM_STEP_TOL_M or e > IMU_WARM_GT_TOL_M:
            raise AssertionError(
                f"Avia wire frame {k}, one step from the card's state: "
                f"|Δpos| {dp:.2e} m (limit {IMU_WARM_STEP_TOL_M} m), CPU "
                f"pose err {e:.4f} m (limit {IMU_WARM_GT_TOL_M} m)")
        steps.append((dp, e))
    cpu_s = time.perf_counter() - t1
    med = statistics.median(frame_ms[warmup:])
    log(f"[replay] Avia livox_custommsg bytes → decode_raw_buffer → "
        f"PacketSynchronizer (IMU streamed per sample) → "
        f"ImMeshRuntime.process_frame, {n_frames} timed frames: host decode "
        f"+ preprocess + sync + upload {statistics.median(host[warmup:]):.1f}"
        f" ms/frame median ({min(host[warmup:]):.1f}-"
        f"{max(host[warmup:]):.1f}), the runtime's frame {med:.1f} ms "
        f"median, p90 {np.percentile(frame_ms[warmup:], 90):.1f} ms; "
        f"pairs_argmin {launches} runs; pose err max {max(errs):.4f} m, "
        f"last {errs[-1]:.4f} m; live triangles "
        f"{int(rt.mesh.store.n_triangles())}")
    log("[replay] Avia host ms per frame by stage (median of 5): "
        + ", ".join(f"{k} {v:.2f}" for k, v in split.items()))
    log(f"[replay] Avia: frames 0-{IMU_WARM - 1} again on the CPU, each one "
        f"step from the card's state: |Δpos|, CPU pose err " + ", ".join(
            f"{d:.2e} m, {e:.4f} m" for d, e in steps)
        + f" (limits {IMU_WARM_STEP_TOL_M}, {IMU_WARM_GT_TOL_M} m; "
        f"{cpu_s:.1f} s on the CPU)")
    return rt, sim, R_align, p0, {"launches": launches,
                                   "host_ms": statistics.median(
                                       host[warmup:]), "frame_ms": med}


# ---------------------------------------------------------------------------
# phase 12: camera frames through texture/ into a coloured mesh
# ---------------------------------------------------------------------------
def color_field(p):
    """The scene's paint: a smooth procedural RGB of world position (N, 3),
    within [38, 218] so neither exposure gate fires on a hit, with a
    ~2 m product-of-sines pattern that gives LK a texture whose period
    stays well above a frame's image motion at every pyramid level."""
    p = np.asarray(p, np.float64)
    low = np.stack([np.sin(p @ [1.3, 0.7, 0.4]),
                    np.sin(p @ [0.5, 0.9, -1.1] + 1.0),
                    np.sin(p @ [0.6, -0.8, 1.7] + 2.0)], -1)
    tex = np.sin(p @ [3.1, 1.1, 1.8]) * np.sin(p @ [-1.2, 2.9, 2.2] + 1.0)
    return 128.0 + 50.0 * low + 40.0 * tex[:, None]


def camera_pose(R_wb, p_wb):
    """World→camera (R_w2c, t_w2c) of the body-mounted camera."""
    R_wc = np.asarray(R_wb, np.float64) @ CAM_R_BC
    c = np.asarray(p_wb, np.float64) + np.asarray(R_wb) @ CAM_T_BC
    R_w2c = R_wc.T
    return R_w2c, -R_w2c @ c


def make_image(sim, cam, R_w2c, t_w2c):
    """Ray-cast the scene from the camera through every pixel centre:
    (H, W, 3) f32 colours (misses black) and (H·W, 3) hit points (NaN on a
    miss), in the simulator's world."""
    H, W = cam.height, cam.width
    u, v = np.meshgrid(np.arange(W), np.arange(H))
    d = np.stack([(u - cam.cx) / cam.fx, (v - cam.cy) / cam.fy,
                  np.ones(u.shape)], -1).reshape(-1, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    c = -R_w2c.T @ t_w2c
    dw = d @ R_w2c                       # rows: R_w2c.T @ d
    rng = sim._raycast(np.broadcast_to(c, dw.shape), dw)
    hit = c + rng[:, None].astype(np.float64) * dw
    hit[~np.isfinite(rng)] = np.nan
    col = np.where(np.isfinite(rng)[:, None], color_field(
        np.nan_to_num(hit)), 0.0)
    return col.reshape(H, W, 3).astype(np.float32), hit


def lk_truth(sim, cam, hit_a, pose_b, pts):
    """The known image motion of features `pts` (N, 2) of image a: each
    feature's scene point projected into camera b.  Returns (uv_b, chosen):
    the chosen features hit a wall or a box (not the floor, whose
    projective shear under the forward camera a translational window does
    not model), stay visible (not occluded) in camera b, see no depth jump
    within their window in image a, and move at most LK_RANGE_PX (the
    tracker's reach: half window × 2^(levels − 1))."""
    H, W = cam.height, cam.width
    R_b, t_b = pose_b
    iu, iv = pts[:, 0].astype(int), pts[:, 1].astype(int)
    X = hit_a[iv * W + iu]
    ok = np.isfinite(X).all(1)
    Xs = np.nan_to_num(X)
    pc = Xs @ R_b.T + t_b
    uv = np.stack([cam.fx * pc[:, 0] / pc[:, 2] + cam.cx,
                   cam.fy * pc[:, 1] / pc[:, 2] + cam.cy], -1)
    c_b = -R_b.T @ t_b
    ray = Xs - c_b
    dist = np.linalg.norm(ray, axis=1)
    r = sim._raycast(np.broadcast_to(c_b, ray.shape),
                     ray / np.maximum(dist, 1e-9)[:, None])
    ok &= (pc[:, 2] > 0.1) & (np.abs(r - dist) < 1e-3 * dist)
    ok &= np.abs(Xs[:, 2]) > 0.01
    ok &= np.linalg.norm(uv - pts, axis=1) <= LK_RANGE_PX
    ok &= ((uv[:, 0] > 20) & (uv[:, 0] < W - 21) & (uv[:, 1] > 20)
           & (uv[:, 1] < H - 21))
    for du, dv in ((-12, 0), (12, 0), (0, -12), (0, 12)):
        n = hit_a[np.clip(iv + dv, 0, H - 1) * W + np.clip(iu + du, 0, W - 1)]
        ok &= np.isfinite(n).all(1) & (
            np.linalg.norm(np.nan_to_num(n) - Xs, axis=1) < 0.05 * dist)
    return uv, ok


class TexturePhase:
    """Phase 12 around phase 11's Avia run: camera frames ray-cast up front
    (set-up), `on_frame` renders each TEX_EVERY-th frame (and the last two)
    into a TexturePipeline from the estimated pose, `finish` checks the
    colours, LK, the card against the CPU, and the coloured PLY."""

    def __init__(self, dev, n_all: int):
        from immesh_tpu_torch.texture.camera import PinholeCamera
        from immesh_tpu_torch.texture.pipeline import TexturePipeline

        if LK_FRAME + 1 >= n_all:
            raise ValueError(f"LK's frames {LK_FRAME}, {LK_FRAME + 1} lie "
                             f"beyond the run's {n_all}")
        self.dev = dev
        cfg = avia_config()
        self.cam = PinholeCamera.create(CAM_F, CAM_F, (CAM_W - 1) / 2,
                                        (CAM_H - 1) / 2, CAM_W, CAM_H)
        self.sim = make_avia_sim(cfg)   # the scene and trajectory only
        # from frame TEX_EVERY on (the first frames re-mesh voxels the
        # forward camera does not see), and LK's pair
        self.lk_pair = (LK_FRAME, LK_FRAME + 1)
        self.frames = sorted(set(range(TEX_EVERY, n_all, TEX_EVERY))
                             | set(self.lk_pair))
        t0 = time.perf_counter()
        self.images, self.hits, self.gt_pose = {}, {}, {}
        for k in self.frames:
            pose = camera_pose(*self.sim.traj.pose((k + 1) * self.sim.scan_T))
            self.images[k], hit = make_image(self.sim, self.cam, *pose)
            if k in self.lk_pair:
                self.hits[k] = hit
            self.gt_pose[k] = pose
        log(f"[texture] {len(self.frames)} {CAM_W}x{CAM_H} frames "
            f"(f = {CAM_F} px, camera forward on the body) ray-cast from "
            f"the ground-truth poses in {time.perf_counter() - t0:.1f} s "
            f"(set-up); rendering frames {self.frames}")
        self.tex = TexturePipeline(cfg, self.cam, device=dev)
        self.render_ms, self.n_rendered = [], []
        self.check = None

    def on_frame(self, k: int, rt) -> None:
        if k not in self.images:
            return
        from immesh_tpu_torch import interop
        rot = rt.lio.state.rot.cpu().numpy().astype(np.float64)
        pos = rt.lio.state.pos.cpu().numpy().astype(np.float64)
        R_w2c, t_w2c = camera_pose(rot, pos)
        img = torch.from_numpy(self.images[k]).to(self.dev)
        t = (k + 1) * self.sim.scan_T
        last = k == self.frames[-1]
        if last:   # the store and candidates before the card's render
            before = interop.to_numpy({"colors": self.tex.colors})
            slots, smask = (x.to("cpu", copy=True)
                            for x in rt.mesh.last_active)
            gm = SimpleNamespace(
                pts=rt.mesh.gm.pts.to("cpu", copy=True),
                vox_pt_idx=rt.mesh.gm.vox_pt_idx.to("cpu", copy=True))
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        n = self.tex.render(rt.mesh, img, R_w2c, t_w2c, t)
        e1.record()
        torch.cuda.synchronize()
        if n <= 0:
            raise AssertionError(f"texture frame {k}: no point rendered")
        self.render_ms.append(e0.elapsed_time(e1))
        self.n_rendered.append(n)
        if last:
            self.check = (before, slots, smask, gm, self.images[k], R_w2c,
                          t_w2c, t, n)

    def finish(self, rt, R_align, p0) -> dict:
        import tempfile

        from immesh_tpu_torch import interop
        from immesh_tpu_torch.runtime.export import load_ply, save_ply
        from immesh_tpu_torch.texture.camera import to_gray
        from immesh_tpu_torch.texture.optical_flow import (
            build_pyramid, lk_track)
        from immesh_tpu_torch.texture.render import render_active_voxels

        # one render_points call again on the CPU from the same store and
        # inputs
        before, slots, smask, gm, img, R_w2c, t_w2c, t, n = self.check
        store_c = interop.from_reference(before, None, device="cpu")["colors"]
        f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)  # noqa: E731
        store_c, n_c = render_active_voxels(
            store_c, gm, slots, smask, torch.from_numpy(img), self.cam,
            f32(R_w2c), f32(t_w2c), t)
        card = interop.to_numpy(self.tex.colors)
        cpu = interop.to_numpy(store_c)
        flips = int((card["n_obs"] != cpu["n_obs"]).sum())
        same = card["n_obs"] == cpu["n_obs"]
        worst = max(float(np.max(np.abs(card[f][same] - cpu[f][same])
                                 / (RENDER_RTOL * np.abs(cpu[f][same])
                                    + 1e-6)))
                    for f in ("rgb", "cov", "obs_dis", "last_obs_t",
                              "first_exp"))
        if flips > RENDER_FLIPS or not worst <= 1.0:
            raise AssertionError(
                f"render_points: card and CPU differ: {flips} gate "
                f"decisions, fields at {worst:.2f}× the tolerance")

        # the colours against the paint; the store is indexed by point id,
        # which a mesh compaction would remap under it (as in the reference)
        if rt.mesh.n_compactions:
            raise AssertionError("a mesh compaction fired during the "
                                 "texture run")
        seen = card["n_obs"] > 0
        pts = rt.mesh.gm.pts.cpu().numpy().astype(np.float64)[seen]
        cols = self.tex.colors.colors_u8().cpu().numpy()[seen]
        err = np.abs(cols - color_field(pts @ R_align.T + p0)).mean(1)
        med_err = float(np.median(err))
        if not (seen.sum() > 0 and med_err <= TEX_COLOR_TOL):
            raise AssertionError(
                f"texture: {int(seen.sum())} coloured points, median "
                f"|colour − paint| {med_err:.2f} (limit {TEX_COLOR_TOL})")

        # LK between the last two frames' grey pyramids, card and CPU
        a, b = self.lk_pair
        grey = {k: to_gray(torch.from_numpy(self.images[k]).to(self.dev))
                for k in self.lk_pair}
        pyr = {k: build_pyramid(grey[k], 3) for k in self.lk_pair}
        u, v = np.meshgrid(np.arange(LK_MARGIN, CAM_W - LK_MARGIN, LK_STEP),
                           np.arange(LK_MARGIN, CAM_H - LK_MARGIN, LK_STEP))
        feats = np.stack([u, v], -1).reshape(-1, 2).astype(np.float32)
        fe = torch.from_numpy(feats).to(self.dev)
        lk_track(pyr[a], pyr[b], fe, win=21, iters=10)      # warm
        lk_ms = event_ms(lambda: lk_track(pyr[a], pyr[b], fe, win=21,
                                          iters=10), 5)
        out, ok = (x.cpu().numpy() for x in lk_track(pyr[a], pyr[b], fe,
                                                     win=21, iters=10))
        pyr_c = {k: [x.cpu() for x in pyr[k]] for k in self.lk_pair}
        out_c, ok_c = (x.numpy() for x in lk_track(
            pyr_c[a], pyr_c[b], torch.from_numpy(feats), win=21, iters=10))
        both = ok & ok_c
        status_flips = int((ok != ok_c).sum())
        d_all = np.abs(out[both] - out_c[both]).max(1)
        d_cpu = float(d_all.max())
        if status_flips > LK_STATUS_FLIPS or not d_cpu <= LK_CPU_TOL_PX:
            raise AssertionError(f"lk_track: card and CPU differ: "
                                 f"{status_flips} statuses, flows by "
                                 f"{d_cpu:.2e} px")
        truth, usable = lk_truth(self.sim, self.cam, self.hits[a],
                                 self.gt_pose[b], feats)
        tracked = usable & ok
        lk_err = np.linalg.norm(out[tracked] - truth[tracked], axis=1)
        motion = np.linalg.norm(truth[usable] - feats[usable], axis=1)
        within = float(np.mean(lk_err <= 1.0)) if len(lk_err) else 0.0
        if not (len(feats) >= 1000 and usable.sum() > 0
                and tracked.sum() >= LK_MIN_TRACKED * usable.sum()
                and np.median(lk_err) <= LK_MEDIAN_TOL_PX
                and within >= LK_WITHIN_1PX):
            raise AssertionError(
                f"lk_track: {int(tracked.sum())} of {int(usable.sum())} "
                f"chosen features tracked, error median "
                f"{np.median(lk_err):.3f} px, {within:.3f} within 1 px "
                f"(limits {LK_MEDIAN_TOL_PX} px, {LK_WITHIN_1PX})")

        # the coloured mesh through PLY
        verts, faces, colors = self.tex.extract_colored(rt.mesh)
        ply = os.path.join(tempfile.mkdtemp(prefix="immesh_smoke_tex_"),
                           "colored.ply")
        save_ply(ply, verts, faces, colors)
        v2, f2, c2 = load_ply(ply)
        if not (len(faces) > 0 and np.array_equal(v2, verts)
                and np.array_equal(f2, faces)
                and np.array_equal(c2, colors)):
            raise AssertionError("the coloured mesh does not round-trip "
                                 "through save_ply / load_ply")
        log(f"[texture] render at {CAM_W}x{CAM_H}: "
            f"{statistics.median(self.render_ms):.2f} ms median per frame "
            f"(CUDA events; {', '.join(f'{x:.2f}' for x in self.render_ms)})"
            f", {min(self.n_rendered)}-{max(self.n_rendered)} points "
            f"rendered per frame; {int(seen.sum())} points coloured, median "
            f"|colour − paint| {med_err:.2f} (p90 "
            f"{np.percentile(err, 90):.2f}; limit {TEX_COLOR_TOL})")
        log(f"[texture] card vs CPU render_points on frame {self.frames[-1]}"
            f" ({n} rendered on the card, {int(n_c)} on the CPU): {flips} "
            f"gate decisions differ (limit {RENDER_FLIPS}), fields within "
            f"{worst:.3f}× rtol {RENDER_RTOL}")
        log(f"[texture] lk_track of {len(feats)} grid features (win 21, 10 "
            f"iterations, 3 levels) from frame {a} to {b}: {lk_ms:.2f} ms "
            f"(CUDA events, median of 5); {int(ok.sum())} tracked; of "
            f"{int(usable.sum())} chosen with a known motion "
            f"({np.median(motion):.1f} px median), {int(tracked.sum())} "
            f"tracked, error median {np.median(lk_err):.3f} px, "
            f"{within:.3f} within 1 px, p95 "
            f"{np.percentile(lk_err, 95):.3f} px; card vs CPU: "
            f"{status_flips} statuses differ, flows within {d_cpu:.2e} px "
            f"(median {np.median(d_all):.1e}, p99 "
            f"{np.percentile(d_all, 99):.1e}; limit {LK_CPU_TOL_PX})")
        log(f"[texture] coloured mesh: {len(verts)} vertices, {len(faces)} "
            f"faces round-trip through save_ply / load_ply")
        return {"render_ms": statistics.median(self.render_ms),
                "lk_ms": lk_ms, "color_err": med_err}


# ---------------------------------------------------------------------------
# phase 13: the multi-rank dist/ path
# ---------------------------------------------------------------------------
def state_digest(state, vm=None) -> str:
    """sha256 of the replicated filter state's bytes (and a plane map's)."""
    import hashlib
    h = hashlib.sha256()
    tensors = [state.rot, state.pos, state.vel, state.bg, state.ba,
               state.grav, state.cov]
    if vm is not None:
        tensors += [vm.table.keys, vm.table.fp] + [
            getattr(vm, f) for f in vm._FIELDS]
    for t in tensors:
        h.update(t.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def exact_mesh_config(cfg):
    """kitti_config with per-frame mesh budgets that phase 4's first scans
    never reach, and compaction off.  An exact sharded-vs-single-device
    comparison needs both appends to drop and defer nothing: past
    max_pts_per_frame an append keeps every step-th row of what it is given,
    and a rank is given only its own slabs, so the kept rows differ; past
    active_voxels_per_frame each side defers other voxels."""
    return cfg.replace(mesh=dataclasses.replace(
        cfg.mesh, max_pts_per_frame=cfg.preprocess.max_points,
        file_voxels_per_frame=16384, active_voxels_per_frame=16384,
        compact_check_every=0))


def last_chunk_parity(smm) -> dict:
    """pairs_argmin against its plain version on the last chunk of a rank's
    last re-mesh that held a point, in the chunks triangulate_voxels cut
    (the rank-local mesh_chunk)."""
    from immesh_tpu_torch.kernels import pairs_argmin as pk
    from immesh_tpu_torch.mesh.delaunay import pairs_channels, pca_project
    from immesh_tpu_torch.mesh.triangles import _pos_hash

    slots, smask = smm.last_active
    mc = smm.gm.cfg
    C = mc.mesh_chunk
    pull = smm.gm.pull_neighborhood(slots, smask)
    pmask = pull["mask"]
    real = [c0 for c0 in range(0, slots.shape[0], C)
            if bool(pmask[c0:c0 + C].any())]
    sl = slice(real[-1], real[-1] + C)
    uv, _, _ = pca_project(pull["pts_sm"][sl], pmask[sl])
    ch = pairs_channels(uv, pmask[sl], tiebreak=_pos_hash(pull["pts"][sl]),
                        tie_scale=mc.tie_scale)
    W = pk.pairs_argmin_cuda(*ch)
    Wp = pk.pairs_argmin_plain(*ch)
    return {"shape": tuple(ch[0].shape), "equal": bool(torch.equal(W, Wp)),
            "chunk": real[-1] // C, "n_real": len(real),
            "max_abs_err": int((W.long() - Wp.long()).abs().max()),
            "fill": float(pmask[sl].float().mean())}


def _frames_of(job, n):
    import pickle
    with open(job["frames"], "rb") as fh:
        rows = pickle.load(fh)[:n]
    return [SimpleNamespace(pts=r[0], t_rel=r[1], imu_stamps=r[2],
                            imu_acc=r[3], imu_gyr=r[4], scan_duration=r[5])
            for r in rows]


def dist_rank(rank: int, world: int, job: dict) -> dict:
    """One rank of phases 13a-13c, in a world that run_world spawned: both
    ranks on the one card, joined over gloo through a DeviceMesh's group."""
    from immesh_tpu_torch.core.ops import div
    from immesh_tpu_torch.dist import comm, multihost
    from immesh_tpu_torch.dist.lio import make_dp_lio_step
    from immesh_tpu_torch.dist.mesh import (
        create_sharded_mesh, gather_mesh, make_sharded_mesh_step)
    from immesh_tpu_torch.dist.sharded_map import (
        create_sharded_map, make_sharded_lio_step)
    from immesh_tpu_torch.dist.window_ba import (
        WindowProblem, make_dist_window_ba)
    from immesh_tpu_torch.kernels import hash_probe as hp
    from immesh_tpu_torch.kernels import pairs_argmin as pk
    from immesh_tpu_torch.kernels import scatter_drop as sd
    from immesh_tpu_torch.kernels import segment_sum as ss
    from immesh_tpu_torch.lio.pipeline import LioPipeline
    from immesh_tpu_torch.map.hash import frame_unique_coords

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    group = multihost.build_mesh("dp", device_type="cuda").get_group("dp")
    cfg = kitti_config()
    frames = _frames_of(job, 3 + DIST_FRAMES)
    out = {}

    # 13a: dp LIO + capacity-sharded mesh
    lio = LioPipeline(cfg, device=dev)  # the single-device initial state
    state, vm = lio.state, lio.vm
    lio_step, shard = make_dp_lio_step(cfg, group)
    smm = create_sharded_mesh(cfg, group, slab_voxels=DIST_SLAB, device=dev)
    mesh_step = make_sharded_mesh_step(cfg, group)
    local = [shard(bundle(f, cfg, dev)) for f in frames]
    rec = {k: [] for k in ("pos", "digest", "ms", "n_tris", "n_part_drop",
                           "n_active", "launches")}
    comm.reset_counts()
    pk.reset_launches()
    hp.reset_launches()
    sd.reset_launches()
    ss.reset_launches()
    for b in local:
        before = pk.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, vm, world_scan, _ = lio_step(state, vm, b)
        smm, n_act, n_tris, n_drop = mesh_step(smm, world_scan, b.mask,
                                               state.pos)
        torch.cuda.synchronize()
        rec["ms"].append(1e3 * (time.perf_counter() - t0))
        rec["launches"].append(pk.launches - before)
        rec["pos"].append(state.pos.cpu().numpy().astype(np.float64))
        rec["digest"].append(state_digest(state, vm))
        rec["n_tris"].append(int(n_tris))
        rec["n_part_drop"].append(int(n_drop))
        rec["n_active"].append(int(n_act))
    b = local[-1]
    cells = frame_unique_coords(
        torch.floor(div(b.pts, cfg.lio.downsample_voxel)).to(torch.int32),
        b.mask, b.pts.shape[0])[2]
    out["dp"] = dict(rec, launches_total=pk.launches,
                     path_counts=path_now(),
                     staged=comm.staged,
                     cells=int(cells),
                     own_tris=int(smm.store.n_triangles()),
                     own_pts=int(smm.gm.pt_count),
                     budgets=(smm.gm.cfg.active_voxels_per_frame,
                              smm.gm.cfg.mesh_chunk))
    if rank == 0:
        out["chunk"] = last_chunk_parity(smm)
    del smm, local

    # 13a, then: the sharded-map LIO step (halo exchange every frame)
    lio = LioPipeline(cfg, device=dev)
    state = lio.state
    svm = create_sharded_map(cfg, group, device=dev)
    slio_step = make_sharded_lio_step(cfg, group)
    comm.reset_counts()
    pos, digests, ms = [], [], []
    for f in frames[:3 + DIST_SHARDED_LIO_FRAMES]:
        b = bundle(f, cfg, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, svm, _, _ = slio_step(state, svm, b)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        pos.append(state.pos.cpu().numpy().astype(np.float64))
        digests.append(state_digest(state))
    out["sharded_lio"] = {"pos": pos, "digest": digests, "ms": ms,
                          "staged": comm.staged,
                          "n_owned": int(svm.n_owned_voxels()),
                          "n_halo": int(svm.is_halo.sum())}
    del svm, lio

    # 13b: phase 4's first scans, meshed at budgets that drop nothing
    ecfg = exact_mesh_config(cfg)
    smm = create_sharded_mesh(ecfg, group, slab_voxels=DIST_SLAB, device=dev)
    mesh_step = make_sharded_mesh_step(ecfg, group)
    drops = []
    for pts, mask, sensor in job["scans"]:
        N = mask.shape[0]
        sl = slice(rank * N // world, (rank + 1) * N // world)
        smm, _, n_tris, n_drop = mesh_step(
            smm, torch.from_numpy(pts[sl]).to(dev),
            torch.from_numpy(mask[sl]).to(dev),
            torch.from_numpy(sensor).to(dev))
        drops.append(int(n_drop))
    g = gather_mesh(smm, group)
    out["exact"] = {"n_tris": int(n_tris), "n_part_drop": drops,
                    "own_tris": int(smm.store.n_triangles())}
    if rank == 0:
        out["exact"].update(pts=g["pts"], tris=g["tris"])
    del smm

    # 13c: phase 8's first window, point factors split over the ranks
    prob_np, kw = job["window"]
    prob = WindowProblem(*(torch.from_numpy(x).to(dev) for x in prob_np))
    solve, shard_problem = make_dist_window_ba(group, **kw)
    sol = solve(shard_problem(prob))
    out["window"] = {k: sol[k].cpu().numpy()
                     for k in ("rot", "pos", "normal", "d")}
    return out


def nccl_rank(rank: int, world: int, job: dict) -> dict:
    """Phase 13d: the dp LIO + sharded mesh steps over NCCL at world 1."""
    import torch.distributed as dist
    from immesh_tpu_torch.dist.lio import make_dp_lio_step
    from immesh_tpu_torch.dist.mesh import (
        create_sharded_mesh, make_sharded_mesh_step)
    from immesh_tpu_torch.kernels import hash_probe as hp
    from immesh_tpu_torch.kernels import pairs_argmin as pk
    from immesh_tpu_torch.kernels import scatter_drop as sd
    from immesh_tpu_torch.kernels import segment_sum as ss
    from immesh_tpu_torch.lio.pipeline import LioPipeline

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = kitti_config()
    lio = LioPipeline(cfg, device=dev)
    state, vm = lio.state, lio.vm
    lio_step, shard = make_dp_lio_step(cfg)
    smm = create_sharded_mesh(cfg, slab_voxels=DIST_SLAB, device=dev)
    mesh_step = make_sharded_mesh_step(cfg)
    pos, ms = [], []
    pk.reset_launches()
    hp.reset_launches()
    sd.reset_launches()
    ss.reset_launches()
    for f in _frames_of(job, NCCL_FRAMES):
        b = shard(bundle(f, cfg, dev))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, vm, world_scan, _ = lio_step(state, vm, b)
        smm, _, n_tris, _ = mesh_step(smm, world_scan, b.mask, state.pos)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.perf_counter() - t0))
        pos.append(state.pos.cpu().numpy().astype(np.float64))
    return {"backend": dist.get_backend(), "pos": pos, "ms": ms,
            "launches": pk.launches,
            "path_counts": path_now(),
            "n_tris": int(n_tris)}


def _tri_position_set(pts, tris) -> set:
    """Triangles keyed by their sorted exact vertex positions."""
    v = np.ascontiguousarray(pts[tris]).view(np.uint32)
    return {tuple(sorted(map(tuple, t.tolist()))) for t in v}


def phase_dist(dev, main_info: dict, window) -> int:
    """Phase 13; returns the pairs_argmin launches of 13a's run, summed over
    its ranks."""
    import pickle
    import tempfile
    from immesh_tpu_torch.dist import multihost
    from immesh_tpu_torch.mesh.pipeline import MeshPipeline

    cfg = kitti_config()
    gt, R0, p0 = main_info["gt"], main_info["R0"], main_info["p0"]
    n_all = 3 + DIST_FRAMES
    prob, sol, kw = window
    with tempfile.TemporaryDirectory(prefix="chip_smoke_dist_") as tmp:
        path = os.path.join(tmp, "frames.pkl")
        with open(path, "wb") as fh:
            pickle.dump([(f.pts, f.t_rel, f.imu_stamps, f.imu_acc, f.imu_gyr,
                          f.scan_duration) for f in gt[:n_all]], fh)
        job = {"frames": path, "scans": main_info["scans"],
               "window": ([x.numpy() for x in prob], kw)}
        t0 = time.perf_counter()
        ranks = multihost.run_world(dist_rank, DIST_WORLD, (job,),
                                    backend="gloo", deadline_s=600)
        t_world = time.perf_counter() - t0
        t0 = time.perf_counter()
        nccl = multihost.run_world(nccl_rank, 1, (job,), backend="nccl",
                                   deadline_s=300)[0]
        t_nccl = time.perf_counter() - t0

    def pose_errs(pos):
        return [float(np.linalg.norm(R0 @ p + p0 - f.gt_pos))
                for p, f in zip(pos, gt)]

    # 13a
    dp = [r["dp"] for r in ranks]
    for k in range(n_all):
        if len({d["digest"][k] for d in dp}) != 1:
            raise AssertionError(f"dist frame {k}: the replicated state and "
                                 "plane map differ between the ranks")
    errs = pose_errs(dp[0]["pos"])
    if max(errs) > POSE_TOL_M:
        k = int(np.argmax(errs))
        raise AssertionError(f"dist frame {k}: pose {errs[k]:.3f} m from "
                             f"ground truth (limit {POSE_TOL_M} m)")
    gap = [float(np.linalg.norm(a - b))
           for a, b in zip(dp[0]["pos"], main_info["pos"])]
    for r, d in enumerate(dp):
        if d["launches_total"] == 0:
            raise AssertionError(f"dist rank {r}: pairs_argmin never launched")
        path_counts("dist", d["path_counts"], graphs=())  # eager
    chunk = ranks[0]["chunk"]
    if not chunk["equal"] or chunk["shape"] != (216, 48):
        raise AssertionError(f"dist: pairs_argmin on rank 0's last real "
                             f"chunk: {chunk}")
    frame_ms = np.max([d["ms"] for d in dp], axis=0)[3:]
    launches = sum(d["launches_total"] for d in dp)
    log(f"[dist] 13a: world {DIST_WORLD} (gloo, both ranks on "
        f"{torch.cuda.get_device_name(0)}, group from a DeviceMesh), dp LIO "
        f"+ sharded mesh at slab {DIST_SLAB}, per-rank budgets (active "
        f"voxels, chunk) {dp[0]['budgets']}; {n_all} frames: replicated state "
        f"and plane map bit-identical on both ranks every frame; pose err "
        f"max {max(errs):.3f} m (limit {POSE_TOL_M} m), last {errs[-1]:.3f} "
        f"m; dp vs single-device (phase 4) max {max(gap):.4f} m (frame "
        f"{int(np.argmax(gap))}), per frame "
        f"{', '.join(f'{g:.4f}' for g in gap)}; downsample cells of the "
        f"last scan's rows per rank (raw points) "
        f"{[d['cells'] for d in dp]} against a budget of "
        f"{cfg.lio.map_update_points // DIST_WORLD} each")
    log(f"[dist] 13a: frame {statistics.median(frame_ms):.1f} ms median "
        f"(slowest rank per frame, {DIST_FRAMES} timed), "
        f"{float(np.percentile(frame_ms, 90)):.1f} ms p90; per rank "
        + "; ".join(f"rank {r}: {statistics.median(d['ms'][3:]):.1f} ms "
                    f"median, pairs_argmin {d['launches_total']} launches, "
                    f"hash and scatter {d['path_counts']}, "
                    f"{d['own_tris']} own triangles, {d['own_pts']} points, "
                    f"{d['staged']} staged transfers"
                    for r, d in enumerate(dp))
        + f"; gathered triangles {dp[0]['n_tris'][-1]}, active voxels "
        f"{dp[0]['n_active'][-1]} on the last frame; n_part_drops per "
        f"frame {dp[0]['n_part_drop']}; set-up + run {t_world:.1f} s")
    log(f"[dist] 13a: pairs_argmin on rank 0's last real chunk "
        f"(chunk {chunk['chunk']} of {chunk['n_real']} with points, shape "
        f"{chunk['shape']}, fill {chunk['fill']:.3f}): W equal to the plain "
        f"version")

    sh = [r["sharded_lio"] for r in ranks]
    n_sh = len(sh[0]["pos"])
    for k in range(n_sh):
        if sh[0]["digest"][k] != sh[1]["digest"][k]:
            raise AssertionError(f"dist sharded-map LIO frame {k}: the "
                                 "replicated state differs between ranks")
    errs_sh = pose_errs(sh[0]["pos"])
    if max(errs_sh) > POSE_TOL_M:
        raise AssertionError(f"dist sharded-map LIO: pose err "
                             f"{max(errs_sh):.3f} m (limit {POSE_TOL_M} m)")
    log(f"[dist] 13a: sharded-map LIO, {n_sh} frames: state bit-identical "
        f"on both ranks, pose err max {max(errs_sh):.3f} m; "
        f"{statistics.median(np.max([x['ms'] for x in sh], 0)[3:]):.1f} ms "
        f"median per frame; owned voxels {[x['n_owned'] for x in sh]}, halo "
        f"entries {[x['n_halo'] for x in sh]}, staged (host) ring transfers "
        f"{[x['staged'] for x in sh]}")

    # 13b
    ex = ranks[0]["exact"]
    ecfg = exact_mesh_config(cfg)
    single = MeshPipeline(ecfg, device=dev)
    for pts, mask, sensor in main_info["scans"]:
        single.step(pts, mask, sensor)
        bad = {k: int(v) for k, v in single.last_drops.items()
               if k.startswith("drop_") and int(v)}
        if bad:
            raise AssertionError(f"dist 13b: the single-device reference "
                                 f"dropped or deferred work: {bad}")
    if any(ex["n_part_drop"]):
        raise AssertionError(f"dist 13b: pre-partition drops "
                             f"{ex['n_part_drop']}")
    t = single.store.tri_ids.reshape(-1, 3).cpu().numpy()
    s_single = _tri_position_set(single.gm.pts.cpu().numpy(),
                                 t[np.all(t >= 0, axis=1)])
    s_shard = _tri_position_set(ex["pts"], ex["tris"])
    if s_shard != s_single:
        raise AssertionError(
            f"dist 13b: sharded mesh and single-device mesh differ: "
            f"{len(s_shard - s_single)} triangles only sharded, "
            f"{len(s_single - s_shard)} only single-device")
    log(f"[dist] 13b: phase 4's first {len(main_info['scans'])} world scans "
        f"meshed at world {DIST_WORLD} (slab {DIST_SLAB}, pre-partitioned "
        f"append) equal a single-device MeshPipeline triangle for triangle "
        f"(exact vertex positions): {len(s_single)} triangles "
        f"({[r['exact']['own_tris'] for r in ranks]} per rank), no drops "
        f"either side")

    # 13c
    wins = [r["window"] for r in ranks]
    dmax = max(float(np.abs(w[k] - sol[k].cpu().numpy()).max())
               for w in wins for k in ("rot", "pos", "d"))
    same = all(np.array_equal(wins[0][k], wins[1][k]) for k in wins[0])
    if not (same and dmax <= DIST_BA_TOL):
        raise AssertionError(f"dist 13c: window BA at world {DIST_WORLD}: "
                             f"max |Δ| {dmax:.2e} from the single-device "
                             f"solve (limit {DIST_BA_TOL}), ranks equal "
                             f"{same}")
    log(f"[dist] 13c: phase 8's first window (K={prob.rot.shape[0]}, "
        f"M={prob.normal.shape[0]}, {prob.pts.shape[1] // DIST_WORLD} "
        f"points per keyframe per rank) solved at world {DIST_WORLD}: equal "
        f"on both ranks, max |Δ| {dmax:.2e} from the card's single-device "
        f"solve (limit {DIST_BA_TOL})")

    # 13d
    errs_n = pose_errs(nccl["pos"])
    path_counts("dist_nccl", nccl["path_counts"], graphs=())  # eager
    if nccl["backend"] != "nccl" or max(errs_n) > POSE_TOL_M \
            or nccl["launches"] == 0:
        raise AssertionError(f"dist 13d: {nccl['backend']}, pose err "
                             f"{max(errs_n):.3f} m, {nccl['launches']} "
                             "pairs_argmin launches")
    log(f"[dist] 13d: world 1 over {nccl['backend']}: {NCCL_FRAMES} frames "
        f"of dp LIO + sharded mesh, pose err max {max(errs_n):.3f} m, "
        f"{statistics.median(nccl['ms'][1:]):.1f} ms median after the "
        f"first, {nccl['launches']} pairs_argmin launches, hash and "
        f"scatter {nccl['path_counts']}, {nccl['n_tris']} "
        f"triangles; set-up + run {t_nccl:.1f} s")

    # 13e
    t0 = time.perf_counter()
    curve = multihost.scaling_curve(cfg, [1, DIST_WORLD],
                                    frames=SCALING_FRAMES, device="cuda")
    for c in curve:
        log(f"[dist] 13e: scaling n={c['n_devices']} ({c['backend']}, "
            f"shared_device={c['shared_device']}): "
            f"{c['frames_per_s']:.2f} frames/s, LIO {c['t_lio_ms']:.1f} ms, "
            f"mesh {c['t_mesh_ms']:.1f} ms, overhead factor vs 1 rank "
            f"{c['overhead_factor_vs_1dev']:.3f}")
    log(f"[dist] 13e: {json.dumps(curve)}; shared_device: both ranks of "
        f"n={DIST_WORLD} share one card, so wall time cannot drop with n "
        f"and overhead_factor_vs_1dev is the metric ({time.perf_counter() - t0:.1f} s)")
    return launches


# ---------------------------------------------------------------------------
# phase 14: the ablation sweep
# ---------------------------------------------------------------------------
def load_tool(name: str):
    """tools/<name>.py, importing this module as chip_smoke."""
    import importlib.util
    sys.modules.setdefault("chip_smoke", sys.modules[__name__])
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools",
                        name + ".py")
    spec = importlib.util.spec_from_file_location(name, path)
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def check_ablate_run(name: str, out: dict, scans, R0, p0) -> None:
    """Phase 14's structural checks on one run: a cut that runs the whole
    frame, or nothing, fails."""
    fr = out["frames"]
    errs = [float(np.linalg.norm(R0 @ f["pos"] + p0 - g.gt_pos))
            for f, g in zip(fr, scans)]
    n_launch = sum(f["launches"] for f in fr)
    checks = {
        "pose": max(errs) <= POSE_TOL_M,
        "launches": (n_launch == 0 if name in ABLATE_NO_KERNEL else
                     all(f["launches"] >= 1 for f in fr if f["active"])
                     and n_launch > 0),
        "triangles": (out["triangles"] > 0) == (name in ("base", "fake_tri3")),
        "map points": ((out["map_points"] == 0)
                       == (name == "lioonly" or name.startswith("app_"))),
    }
    bad = [k for k, ok in checks.items() if not ok]
    if bad:
        raise AssertionError(
            f"ablate {name}: {', '.join(bad)} check failed: pose err max "
            f"{max(errs):.3f} m, pairs_argmin launches per frame "
            f"{[f['launches'] for f in fr]}, active voxels "
            f"{[f['active'] for f in fr]}, {out['triangles']} triangles, "
            f"{out['map_points']} map points")
    out["pose_max"] = max(errs)


def phase_ablate(dev, main_info: dict) -> int:
    """Phase 14; returns the pairs_argmin launches of the chain."""
    import immesh_tpu_torch.mesh.triangles as tri
    from immesh_tpu_torch.kernels import pairs_argmin as pk
    from immesh_tpu_torch.mesh.global_map import GlobalPointMap

    tool = load_tool("torch_ablate_e2e")
    n_all = ABLATE_WARMUP + ABLATE_FRAMES
    scans = main_info["gt"][:n_all]
    R0, p0 = main_info["R0"], main_info["p0"]
    log(f"[ablate] JointPipeline(kitti_config()) (active_voxels_per_frame "
        f"{kitti_config().mesh.active_voxels_per_frame}, as "
        f"tools/ablate_e2e.py and phase 4) on phase 4's first {n_all} "
        f"scans, {ABLATE_WARMUP} warm-up + {ABLATE_FRAMES} timed frames a "
        f"variant, synchronised after every frame")

    pairs_argmin = tri.pairs_argmin
    last = {}

    def recorded(*ch):  # argmin0's inputs and W, as the path's call got them
        last["ch"], last["W"] = ch, pairs_argmin(*ch)
        return last["W"]

    runs = [[] for _ in ABLATE_CHAIN]  # per chain position, one run a pass
    t0 = time.perf_counter()
    reset_counts()
    for _ in range(ABLATE_PASSES):
        for i, name in enumerate(ABLATE_CHAIN):
            tri.pairs_argmin = recorded if name == "argmin0" else pairs_argmin
            try:
                out = tool.run_variant(name, tool.VARIANTS[name],
                                       ABLATE_FRAMES, ABLATE_WARMUP,
                                       device=dev, scans=scans)
            finally:
                tri.pairs_argmin = pairs_argmin
            check_ablate_run(name, out, scans, R0, p0)
            runs[i].append(out)
    launches = pk.launches
    path_counts("ablate")
    t_chain = time.perf_counter() - t0
    rows = []
    for rs in runs:
        row = {k: v for k, v in rs[0].items() if k != "frames"}
        for key in ("ms", "mesh_ms"):
            t = np.min([[f[key] for f in r["frames"][ABLATE_WARMUP:]]
                        for r in rs], axis=0)
            row[key + "_median"] = float(np.median(t))
            row[key + "_p90"] = float(np.percentile(t, 90))
        row["ms_median_per_pass"] = [r["ms_median"] for r in rs]
        row["pose_max"] = max(r["pose_max"] for r in rs)
        rows.append(row)

    ch, W = last["ch"], last["W"]
    Wp = pk.pairs_argmin_plain(*ch)
    if not torch.equal(W, Wp):
        raise AssertionError(f"ablate argmin0: W of the last chunk differs "
                             f"from the plain version at "
                             f"{int((W != Wp).sum())} entries")
    gm = GlobalPointMap.create(kitti_config().mesh, device=dev)
    copy_ms = event_ms(gm.clone, 20)
    n_bytes = sum(t.numel() * t.element_size() for t in (
        gm.pts, gm.pts_smooth, gm.dedup.keys, gm.dedup.fp, gm.vox.keys,
        gm.vox.fp, gm.vox_pt_idx, gm.vox_pts, gm.vox_pts_sm, gm.vox_n,
        gm.vox_new, gm.vox_meshed))
    log(f"[ablate] argmin0's last chunk {tuple(ch[0].shape)} (fill "
        f"{float(ch[3].mean()):.3f}, the unperturbed lift, d_eps 1e-6): W "
        f"equal to the plain version, max |Δ| "
        f"{int((W.long() - Wp.long()).abs().max())}; an append cut's copy of "
        f"the map ({n_bytes / 2 ** 20:.1f} MiB) {copy_ms:.3f} ms a frame "
        f"(median of 20, CUDA events)")

    log(f"[ablate] {smi_line()}; {ABLATE_PASSES} passes of "
        f"{len(ABLATE_CHAIN)} runs in {t_chain:.1f} s; a frame's ms (and its "
        f"mesh step's, synchronised around it) is its least over the passes, "
        f"then median and p90 over the timed frames; Δ against the row above "
        f"(fake_tri3: against base); pose err max over every run "
        f"{max(r['pose_max'] for r in rows):.3f} m")
    log(f"[ablate] {'stage':<12} {'frame ms':>8} {'p90':>7} {'Δ':>7} "
        f"{'mesh ms':>8} {'p90':>7} {'Δ':>7} {'launch/fr':>9} {'Δ':>5} "
        f"{'triangles':>9} {'points':>7}")
    prev = None
    for r in rows:
        ref = rows[-2] if r["variant"] == "fake_tri3" else prev
        d = ("", "", "") if ref is None else (
            f"{r['ms_median'] - ref['ms_median']:+.2f}",
            f"{r['mesh_ms_median'] - ref['mesh_ms_median']:+.2f}",
            f"{r['pairs_launches_per_frame'] - ref['pairs_launches_per_frame']:+.1f}")
        log(f"[ablate] {r['variant']:<12} {r['ms_median']:8.2f} "
            f"{r['ms_p90']:7.2f} {d[0]:>7} {r['mesh_ms_median']:8.2f} "
            f"{r['mesh_ms_p90']:7.2f} {d[1]:>7} "
            f"{r['pairs_launches_per_frame']:9.1f} {d[2]:>5} "
            f"{r['triangles']:9d} {r['map_points']:7d}")
        prev = r
    log(f"[ablate] base first {rows[0]['ms_median']:.2f} ms, base last "
        f"{rows[-2]['ms_median']:.2f} ms; per pass (median of its timed "
        f"frames) first {rows[0]['ms_median_per_pass']}, last "
        f"{rows[-2]['ms_median_per_pass']}; " + json.dumps(rows))
    return launches


# ---------------------------------------------------------------------------
# phase 15: the two stage profilers
# ---------------------------------------------------------------------------
def phase_profile(dev, main_info: dict) -> int:
    """Phase 15; returns the pairs_argmin launches of the phase."""
    import immesh_tpu_torch.mesh.delaunay as dl
    from immesh_tpu_torch.kernels import pairs_argmin as pk

    lio_tool = load_tool("torch_profile_lio")
    stages_tool = load_tool("torch_profile_stages")
    t_phase = time.perf_counter()
    reset_counts()
    smi = smi_line()
    n_lio = PROFILE_WARM + 1
    avia_cfg = avia_config()
    sim = make_avia_sim(avia_cfg)
    static = sim.static_imu(100)  # drawn first, as the demo does
    runs = (("kitti", kitti_config(), main_info["gt"][:n_lio], None),
            ("avia", avia_cfg, [sim.frame(k) for k in range(n_lio)], static))
    for path, cfg, scans, imu in runs:
        out = lio_tool.profile_lio(cfg, scans, dev, PROFILE_WARM,
                                   PROFILE_REPEAT, imu)
        bad = [f"compose {k}" for k, ok in out["compose_matches"].items()
               if not ok] + [f"map after {k}" for k, ok in
                             out["map_unchanged"].items() if not ok] + (
            [] if out["graph_matches"] else ["the captured step"])
        if bad:
            raise AssertionError(f"profile_lio {path}: {', '.join(bad)} "
                                 f"differ")
        log(f"[profile] tools/torch_profile_lio.py --path {path}: frame "
            f"{PROFILE_WARM} after {PROFILE_WARM} warm-up frames, "
            f"{PROFILE_REPEAT} calls a stage back to back and the composed "
            f"step {PROFILE_REPEAT} times, in {lio_tool.ROUNDS} rounds, then "
            f"one call under torch.profiler; {smi}; the stages composed in "
            f"order equal "
            f"lio_step bit for bit (state, world scan, map), the pipeline's "
            f"map bit-identical after every stage")
        for row in lio_tool.table(out):
            log(f"[profile] {path} {row}")
        log(f"[profile] {path} " + json.dumps(out))

    n_st = PROFILE_STAGES_WARMUP + PROFILE_STAGES_FRAMES
    scans = main_info["gt"][:n_st]
    pairs_argmin, last = dl.pairs_argmin, {}

    def recorded(*ch):  # delaunay_pairs_w's chunks, as the path gave them
        last["ch"], last["W"] = ch, pairs_argmin(*ch)
        return last["W"]

    dl.pairs_argmin = recorded
    try:
        out = stages_tool.run_stages(kitti_config(), scans, dev,
                                     PROFILE_STAGES_WARMUP)
    finally:
        dl.pairs_argmin = pairs_argmin
    R0, p0 = main_info["R0"], main_info["p0"]
    errs = [float(np.linalg.norm(R0 @ r["pos"] + p0 - g.gt_pos))
            for r, g in zip(out["frames"], scans)]
    per_frame = [r["pairs_launches"] for r in out["frames"]
                 if r["pairs_launches"]]
    if any(fr["delaunay"] != 2 or sum(fr.values()) != 2 for fr in per_frame):
        raise AssertionError(
            f"profile_stages: pairs_argmin launches per timed frame by "
            f"stage {per_frame}, not 2 in delaunay and 0 elsewhere")
    if max(errs) > POSE_TOL_M:
        raise AssertionError(f"profile_stages: pose {max(errs):.3f} m from "
                             f"ground truth (limit {POSE_TOL_M} m)")
    ch, W = last["ch"], last["W"]
    Wp = pk.pairs_argmin_plain(*ch)
    if not torch.equal(W, Wp):
        raise AssertionError(f"profile_stages delaunay: W of the last chunk "
                             f"differs from the plain version at "
                             f"{int((W != Wp).sum())} entries")
    launches = pk.launches
    path_counts("profile")
    log(f"[profile] tools/torch_profile_stages.py on phase 4's first {n_st} "
        f"scans ({PROFILE_STAGES_WARMUP} warm-up, the last under "
        f"torch.profiler for the counts; {PROFILE_STAGES_FRAMES} timed, "
        f"synchronised before and after every stage); {smi}; pose err max "
        f"{max(errs):.3f} m; delaunay's last chunk {tuple(ch[0].shape)} "
        f"(fill {float(ch[3].mean()):.3f}): W equal to the plain version")
    for row in stages_tool.table(out):
        log(f"[profile] stages {row}")
    out.pop("pipes")
    out["frames"] = [{"ms": r["ms"], "pairs_launches": r["pairs_launches"]}
                     for r in out["frames"]]
    log("[profile] stages " + json.dumps(out))
    log(f"[profile] phase 15 took {time.perf_counter() - t_phase:.1f} s, "
        f"{launches} pairs_argmin launches")
    return launches


# ---------------------------------------------------------------------------
# phase 16a: the IF nodes' set kernel against its plain version
# ---------------------------------------------------------------------------
COND_NODES = 64     # IF nodes of the probe graph, and copies of a site
COND_REPLAYS = 40   # replays on random predicates
# the "any" form's probe spans (misalignment, bytes), laid out one after
# another in one buffer: one byte, unaligned heads and tails, a KITTI
# level's map-update points and a KITTI chunk's rows of the pull mask
COND_SPANS = ((0, 1), (3, 13), (0, 16), (5, 35), (0, 8192), (7, 8193),
              (0, 512 * 48))
# the sites timed: (site, the predicate's bytes): the ESIKF's converged
# byte, a KITTI level's 8,192 map-update points, a KITTI chunk's 512 × 48
# pull-mask rows
COND_SITES = (("esikf", 1), ("level", 8192), ("chunk", 512 * 48))


def probe_step(dev, fn):
    """A CapturedStep whose step is fn(acc, *inputs), `acc` its persistent
    state, written in place."""
    from immesh_tpu_torch.utils.graphs import CapturedStep

    class Probe(CapturedStep):
        def __call__(self, acc, *inputs):
            return self._run((acc,), inputs)

        def _pointers(self, acc):
            return ((acc.data_ptr(),),)

        def _step(self, acc, *inputs):
            return fn(acc, *inputs)

    return Probe(dev)


def cond_probe(dev, n: int):
    """A CapturedStep of n IF nodes: node k adds 1 to acc[k] where pred[k]
    (the set kernel's "read" form, one body kernel each)."""
    from immesh_tpu_torch.utils.graphs import device_if

    def step(acc, pred):
        for k in range(n):
            device_if(pred[k], functools.partial(acc[k].add_, 1), "probe")

    return probe_step(dev, step)


def span_offsets() -> list:
    """Each COND_SPANS span's (offset, bytes) in the probe buffer: 64-byte
    aligned bases, shifted by the span's misalignment."""
    out, base = [], 0
    for mis, n in COND_SPANS:
        out.append((base + mis, n))
        base += -(-(mis + n) // 64) * 64
    return out


def forms_step(acc, flags, buf, A, B):
    """The set kernel's forms as IF sites, each adding 1 to its acc entry
    where its predicate holds: "read" of flags[0:4], "not" of flags[4:8],
    "any" of each span of buf (span_offsets), its bit set (even spans) or
    added (odd) into acc[n_sites + j]; then one "not" predicate of flags[8]
    set by one launch for 3 nodes, and one "any" of the level span for 4,
    with a torch.cholesky_solve between their nodes (the ESIKF's shape).
    The same function on CPU tensors is the plain version."""
    from immesh_tpu_torch.kernels import graph_cond as gc
    from immesh_tpu_torch.utils.graphs import device_if
    spans = span_offsets()
    n_sites = 8 + len(spans) + 3 + gc.MAX_USES
    site = iter(range(n_sites))

    def bump():
        return functools.partial(acc[next(site)].add_, 1)

    for k in range(4):
        device_if(flags[k], bump(), "read")
    for k in range(4, 8):
        device_if(gc.negation(flags[k]), bump(), "not")
    for j, (o, n) in enumerate(spans):
        device_if(gc.any_of(buf[o:o + n], acc[n_sites + j],
                            "set" if j % 2 == 0 else "add"), bump(), "any")
    o, n = spans[4]
    shared = (gc.negation(flags[8], uses=3),
              gc.Pred("any", buf[o:o + n], uses=gc.MAX_USES))
    for p in shared:
        for _ in range(p.uses):
            device_if(p, bump(), "shared")
            torch.cholesky_solve(B, A)  # outside the nodes


def forms_inputs(rng, dev):
    """Random flags and span bytes for forms_step: a span is empty, has
    one true byte (its last, its first or a random one) or is dense."""
    spans = span_offsets()
    buf = np.zeros(spans[-1][0] + spans[-1][1] + 64, bool)
    for o, n in spans:
        mode = rng.integers(5)
        if mode == 1:
            buf[o + n - 1] = True
        elif mode == 2:
            buf[o] = True
        elif mode == 3:
            buf[o + rng.integers(n)] = True
        elif mode == 4:
            buf[o:o + n] = rng.random(n) < 0.3
    flags = rng.random(9) < 0.5
    return torch.tensor(flags, device=dev), torch.tensor(buf, device=dev)


def site_step(site: str, new: bool):
    """COND_NODES copies of one IF site of the path, its body a one-kernel
    add: as the port makes it (`new`: one set launch makes the predicate
    from the site's inputs), or as the parent did (the torch predicate
    nodes, then the set kernel's "read" of the bool they made)."""
    from immesh_tpu_torch.kernels import graph_cond as gc
    from immesh_tpu_torch.utils.graphs import device_if

    def step(acc, x):
        for k in range(COND_NODES):
            body = functools.partial(acc[k].add_, 1)
            if site == "esikf":  # two nodes on `not converged`
                live = gc.negation(x[k], uses=2) if new else ~x[k]
                device_if(live, body, "esikf")
                device_if(live, body, "esikf_step")
            elif site == "level":  # any of the level's mask, counted
                count = acc[COND_NODES + k]
                if new:
                    device_if(gc.any_of(x[k], count, "add"), body, "level")
                else:
                    taken = x[k].any()
                    count.add_(taken.to(torch.int32))
                    device_if(taken, body, "level")
            else:  # any of the chunk's rows of the pull mask
                rows = x[k * 512:(k + 1) * 512]
                device_if(gc.any_of(rows) if new else rows.any(), body,
                          "chunk")

    return step


def time_site(dev, site: str, nbytes: int) -> dict:
    """One IF site's device time, the redesigned launch against the
    parent's composition, each COND_NODES copies captured as one graph and
    replayed: with the predicate false (the site's launches and its
    skipped nodes) and true (the bodies' add kernels too), a site's outer
    kernel nodes, and the bound (the predicate's bytes)."""
    from immesh_tpu_torch.utils.graphs import graph_nodes
    shape = {"esikf": (COND_NODES,), "level": (COND_NODES, nbytes),
             "chunk": (COND_NODES * 512, 48)}[site]
    out = {"bound_ms": 1e3 * nbytes / PEAK_BYTES_PER_S}
    for new in (True, False):
        name = "new" if new else "old"
        acc = torch.zeros(2 * COND_NODES, dtype=torch.int32, device=dev)
        x = torch.zeros(shape, dtype=torch.bool, device=dev)
        if site == "esikf":
            x.fill_(True)  # converged: every body skipped
        step = probe_step(dev, site_step(site, new))
        for _ in range(3):  # warm-up, capture, a replay
            step(acc, x)
        (g,) = step.graphs
        out[f"kernel_nodes_{name}"] = graph_nodes(g.graph)["kernel"] \
            / COND_NODES
        out[f"set_launches_{name}"] = g.captured["graph_cond"] / COND_NODES
        out[f"ms_{name}"] = device_ms(g.graph.replay, n=20) / COND_NODES
        g.inputs[0].copy_(~x if site == "esikf" else x.logical_not())
        out[f"ms_{name}_taken"] = device_ms(g.graph.replay, n=20) \
            / COND_NODES
    return out


def phase_cond(dev) -> dict:
    """Phase 16a: the set kernel against its plain version on the card.
    (1) A graph of COND_NODES "read" IF nodes replayed on COND_REPLAYS
    random predicate vectors (and all-false and all-true), each node's body
    run exactly where the host read says.  (2) Every form (forms_step):
    read, not, any over one byte, unaligned heads and tails, a level's and
    a chunk's bytes, its count set and added, and one launch setting 3 and
    MAX_USES nodes with a cuSOLVER solve between them, replayed on random
    inputs against the same step run on the CPU (the plain versions): the
    bodies and counts equal, the taken counters as the bodies say, one set
    launch a predicate.  (3) Each site of the path (COND_SITES) timed, the
    launch that makes its own predicate against the parent's composition
    (time_site), beside its bound (the predicate's bytes) and the plain
    version (the torch predicate read on the host)."""
    from immesh_tpu_torch.kernels import graph_cond as gc
    t_phase = time.perf_counter()
    reset_counts()
    probe = cond_probe(dev, COND_NODES)
    acc = torch.zeros(COND_NODES, dtype=torch.int32, device=dev)
    want = np.zeros(COND_NODES, np.int64)
    rng = np.random.default_rng(16)
    preds = [rng.random(COND_NODES) < 0.5 for _ in range(COND_REPLAYS)]
    preds += [np.zeros(COND_NODES, bool), np.ones(COND_NODES, bool)]
    for p in preds:
        pred = torch.tensor(p, device=dev)
        probe(acc, pred)
        want += [gc.taken_plain(pred[k]) for k in range(COND_NODES)]
        if not np.array_equal(acc.cpu().numpy(), want):
            raise AssertionError("graph_cond: the IF nodes' bodies ran "
                                 "elsewhere than the host read says")
    (g,) = probe.graphs
    kinds = if_nodes([g])
    taken = [t for _, t in body_runs([g])]
    if taken != list(want - np.array(preds[0], np.int64)) \
            or gc.runs() != COND_NODES * g.replays:
        raise AssertionError(f"graph_cond: taken counts {taken} and "
                             f"{gc.runs()} runs for {g.replays} replays")

    reset_counts()
    n_sites = 8 + len(COND_SPANS) + 3 + gc.MAX_USES
    gen = torch.Generator(device="cpu").manual_seed(17)
    M = torch.randn(18, 18, generator=gen)
    A_cpu = torch.linalg.cholesky(M @ M.T + 18 * torch.eye(18))
    B_cpu = torch.randn(18, 1, generator=gen)
    acc_dev = torch.zeros(n_sites + len(COND_SPANS), dtype=torch.int32,
                          device=dev)
    acc_cpu = acc_dev.cpu()
    forms = probe_step(dev, forms_step)
    after_warmup = None
    for r in range(COND_REPLAYS + 2):
        flags, buf = forms_inputs(rng, dev)
        forms(acc_dev, flags, buf, A_cpu.to(dev), B_cpu.to(dev))
        forms_step(acc_cpu, flags.cpu(), buf.cpu(), A_cpu, B_cpu)
        if not torch.equal(acc_dev.cpu(), acc_cpu):
            raise AssertionError(f"graph_cond: replay {r}: the forms' "
                                 f"bodies and counts {acc_dev.tolist()}, "
                                 f"their plain versions {acc_cpu.tolist()}")
        if r == 0:
            after_warmup = acc_cpu.clone()
    (fg,) = forms.graphs
    ftaken = [t for _, t in body_runs([fg])]
    launches = set_launches([fg])
    n_preds = 8 + len(COND_SPANS) + 2
    if ftaken != (acc_cpu - after_warmup)[:n_sites].tolist() \
            or fg.captured["graph_cond"] != n_preds \
            or gc.runs() != n_preds * fg.replays \
            or len(fg.bodies) != n_sites:
        raise AssertionError(f"graph_cond: the forms' taken counts {ftaken}, "
                             f"{fg.captured['graph_cond']} set launches, "
                             f"{gc.runs()} runs for {fg.replays} replays")

    sites = {site: time_site(dev, site, nbytes)
             for site, nbytes in COND_SITES}
    m = torch.zeros(8192, dtype=torch.bool, device=dev)
    count = torch.zeros((), dtype=torch.int32, device=dev)
    plain_ms = host_ms(lambda: gc.taken_plain(gc.any_of(m, count, "add")),
                       200)
    level = sites["level"]
    log(f"[cond] {smi_line()}; graph_cond: {COND_NODES} read-form IF nodes, "
        f"{len(preds)} replays, every body where the host read says "
        f"(taken counts and set-kernel runs as the replays say); the "
        f"bodies' nodes {kinds['body_node_types']}; every form "
        f"({len(COND_SPANS)} any spans, counts set and added, one launch for "
        f"3 and for {gc.MAX_USES} nodes across a cholesky_solve) equal to the "
        f"same step on the CPU over {fg.replays} replays, one set launch a "
        f"predicate ({launches})")
    for site, t in sites.items():
        log(f"[cond] site {site}: µs a site with its predicate false, the "
            f"launch that makes it {1e3 * t['ms_new']:.3f} "
            f"({t['kernel_nodes_new']:.0f} kernel nodes, "
            f"{t['set_launches_new']:.0f} set launch), the parent's "
            f"composition {1e3 * t['ms_old']:.3f} "
            f"({t['kernel_nodes_old']:.0f} kernel nodes, "
            f"{t['set_launches_old']:.0f} set launches); true (the bodies "
            f"run) {1e3 * t['ms_new_taken']:.3f} and "
            f"{1e3 * t['ms_old_taken']:.3f}; bound {1e3 * t['bound_ms']:.2e} "
            f"µs (bytes)")
    log(f"[cond] the plain version of the level site (the torch predicate "
        f"and count, one host read) {1e3 * plain_ms:.1f} µs; "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"name": COND_KERNEL, "route": "cuda",
            "source": "immesh_tpu_torch/csrc/graph_cond.cu",
            "replaces": "immesh_tpu/lio/esikf.py:90",
            "max_abs_err": 0.0, "ms": level["ms_new"],
            "ms_body_taken": level["ms_new_taken"], "wrapper_ms": None,
            "plain_ms": plain_ms, "bound_ms": level["bound_ms"],
            "bound_by": "bytes", "library_ms": None, "sites": sites,
            "note": "the set kernel of CUDA-graph IF nodes, one launch a "
                    "predicate that makes it (no Pallas kernel: the "
                    "reference's lax.while_loop / lax.cond predicates, "
                    "immesh_tpu/lio/esikf.py:90, "
                    "immesh_tpu/map/voxel_map.py:123, "
                    "immesh_tpu/mesh/triangles.py:196); ms: a refinement "
                    "level's site (any of 8,192 bools, the count added, "
                    "one IF node) with the predicate false"}


# ---------------------------------------------------------------------------
# phase 16: the captured LIO step and the scatter_drop kernel
# ---------------------------------------------------------------------------
def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Equal dtype, shape and bits (NaN payloads and -0.0 included)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def abs_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """Largest |a - b| over the elements (0 when the bits agree)."""
    if same_bits(a, b):
        return 0.0
    d = (a.double() - b.double()).abs().nan_to_num(float("inf"))
    return max(float(d.max()), 1.0)  # bits differ: never report 0


def map_tensors(vm) -> list:
    return [("keys", vm.table.keys), ("fp", vm.table.fp)] + [
        (n, getattr(vm, n)) for n in vm._FIELDS]


def lio_differs(a_state, b_state, a_vm, b_vm, extra=()) -> list:
    """Names of the state fields, plane-map tensors and extra (name, a, b)
    pairs whose bits differ."""
    pairs = [(f.name, getattr(a_state, f.name), getattr(b_state, f.name))
             for f in dataclasses.fields(a_state)]
    pairs += [(n, x, y) for (n, x), (_, y) in zip(map_tensors(a_vm),
                                                  map_tensors(b_vm))]
    return [n for n, x, y in [*pairs, *extra] if not same_bits(x, y)]


def mesh_differs(a, b, extra=()) -> list:
    """Names of the point-map and store tensors of MeshPipelines a and b
    (utils/graphs.py's named_tensors: the hash tables' keys and fp
    included), and of the extra (name, x, y) pairs, whose bits differ."""
    from immesh_tpu_torch.utils.graphs import named_tensors
    pairs = [(n, x, y) for (n, x), (_, y) in zip(
        named_tensors({"gm": a.gm, "store": a.store}),
        named_tensors({"gm": b.gm, "store": b.store}))]
    return [n for n, x, y in [*pairs, *extra] if not same_bits(x, y)]


def compact_mesh_half(mesh, pos) -> None:
    """Compact a MeshPipeline's point map to half its points and voxels
    around pos and remap its store, as MeshPipeline.maybe_compact does past
    its high-water mark."""
    from immesh_tpu_torch.mesh.pipeline import _compact_mesh, _keep_radius_mesh
    gm = mesh.gm
    low_p = max(1, int(gm.n_points()) // 2)
    low_v = max(1, int(gm.vox.occupancy()) // 2)
    _compact_mesh(gm, mesh.store, pos, _keep_radius_mesh(
        gm, pos, low_p, low_v, gm.cfg.local_map_radius))


def compact_half(vm, pos) -> None:
    """Compact the plane map to half its live voxels around pos, as
    LioPipeline.maybe_compact does past its high-water mark."""
    from immesh_tpu_torch.lio.pipeline import _keep_radius_vm
    low = max(1, int(vm.n_voxels()) // 2)
    vm.compact(pos, _keep_radius_vm(vm, pos, low, vm.cfg.local_map_radius))


def active_chunks(smask, chunk: int) -> int:
    """Chunks of the work list with an active voxel: the chunk bodies the
    mesh step runs (an active voxel always pulls its own points)."""
    return sum(bool(smask[c:c + chunk].any())
               for c in range(0, smask.numel(), chunk))


def lio_sites(cfg) -> dict:
    """The IF nodes a captured LIO step holds, by site: two an ESIKF body
    after the first, which runs unconditionally (its normal equations, then
    its step; the solve between them runs outside, lio/esikf.py), and one a
    refinement level."""
    sites = {"esikf": cfg.lio.max_iterations - 1,
             "esikf_step": cfg.lio.max_iterations - 1,
             "level": cfg.voxel_map.max_layers - 1}
    return {k: n for k, n in sites.items() if n > 0}


def lio_launches(cfg) -> dict:
    """The set launches of a captured LIO step by site: one an ESIKF body
    after the first (both its nodes), one a refinement level."""
    return {k: n for k, n in lio_sites(cfg).items() if k != "esikf_step"}


def check_sites(what: str, graphs, rows, cfg) -> dict:
    """The IF nodes' body runs of a captured path (body_runs) against the
    bodies its frames' diag says ran: the ESIKF bodies' two nodes each
    (diag["iterations"] a frame), the refinement levels (diag["levels"])
    and, where the rows
    count them, the chunks with an active voxel, over the replayed frames
    (frame 0 is the eager warm-up).  Returns the runs and the bodies,
    levels and chunks skipped on the device a replayed frame."""
    replayed = rows[1:]
    n = len(replayed)
    # the first ESIKF body runs with no IF node
    iterations = sum(max(r["iterations"] - 1, 0) for r in replayed)
    want = {"esikf": iterations, "esikf_step": iterations,
            "level": sum(r["levels"] for r in replayed)}
    nodes = if_nodes(graphs)
    launches = set_launches(graphs)
    if "chunks" in rows[0]:
        want["chunk"] = sum(r["chunks"] for r in replayed)
    want = {k: v for k, v in want.items() if k in nodes["nodes"]}
    got = site_runs(graphs)
    if {k: got.get(k, 0) for k in want} != want:
        raise AssertionError(f"{what}: the IF nodes' bodies ran {got} times "
                             f"on the device, diag says {want}")
    skipped = {k: (nodes["nodes"][k] * n - want[k]) / n for k in want}
    log(f"[graph] {what}: IF nodes by site {nodes['nodes']}, set launches "
        f"by site {launches} (one a predicate), their bodies' "
        f"node types {nodes['body_node_types']} (no allocation, free or "
        f"event node); bodies run on the device over the {n} replayed "
        f"frames {got}, as diag says (the first ESIKF body runs with no "
        f"node); skipped on the device a frame: "
        + ", ".join(f"{k} {v:.2f}" for k, v in skipped.items()))
    return {"if_nodes": nodes, "set_launches": launches, "runs": got,
            "skipped_a_frame": skipped}


def run_lio_pair(dev, cfg, frames, warmup, compact_at, record_at=(),
                 static=None, runtime=False):
    """Two pipelines from the same start, one eager (graph=False) and one
    captured, stepped in turns over `frames`: LioPipelines, or
    ImMeshRuntimes (LIO and mesh) when `runtime`.  After the frames in
    `compact_at` both compact their plane map to half its voxels.  Every
    frame: state, world scan (LioPipeline) or pose (runtime), diag and
    every plane-map tensor bit for bit, and ESIKF iterations equal.
    Returns per-frame records, the captured pipeline's counts (path_now,
    its steps only), the two pipelines, and the eager pipeline's
    set_drop/add_drop calls and segment_sum calls at the frames in
    `record_at`."""
    from immesh_tpu_torch.lio.pipeline import LioPipeline
    from immesh_tpu_torch.runtime.app import ImMeshRuntime

    def make(graph):
        if runtime:
            p = ImMeshRuntime(cfg, device=dev, graph=graph)
        else:
            p = LioPipeline(cfg, device=dev, graph=graph)
        if static is not None:
            p.static_init(*static)
        return p

    eager, cap = make(False), make(True)
    le, lc = (eager.lio, cap.lio) if runtime else (eager, cap)
    counts = {part: dict.fromkeys(COUNTED, 0)
              for part in ("launches", "recorded", "runs")}
    rows, recorded, sums = [], {}, {}
    for k, b in enumerate(frames):
        def run(p):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if runtime:
                out = p.process_frame(b, t=0.1 * k)
                got = (None, {n: out[n] for n in ("n_effective",
                                                  "iterations", "levels")})
            else:
                got = p.step(b)
            torch.cuda.synchronize()
            return got, 1e3 * (time.perf_counter() - t0)

        if k in record_at:
            (((we, de), ms_e), recorded[k]), sums[k] = record_sums(
                lambda: record_scatters(lambda: run(eager)))
        else:
            (we, de), ms_e = run(eager)
        before = path_now()
        (wc, dc), ms_c = run(cap)
        after = path_now()
        for part, n in counts.items():
            for name in n:
                n[name] += after[part][name] - before[part][name]
        extra = [(f"diag {n}", de[n], dc[n]) for n in de]
        if we is not None:
            extra.append(("world_scan", we, wc))
        if runtime:
            extra += [("triangles", eager.mesh.store.tri_ids,
                       cap.mesh.store.tri_ids)]
        bad = lio_differs(le.state, lc.state, le.vm, lc.vm, extra)
        if bad:
            raise AssertionError(f"graph: frame {k}: the captured step and "
                                 f"the eager step differ in {bad}")
        compacted = k in compact_at
        if compacted:
            for p in (le, lc):
                compact_half(p.vm, p.state.pos)
            bad = lio_differs(le.state, lc.state, le.vm, lc.vm)
            if bad:
                raise AssertionError(f"graph: frame {k}: after the "
                                     f"compaction the maps differ in {bad}")
        rows.append({"ms_eager": ms_e, "ms_graph": ms_c,
                     "compacted": compacted, "iterations":
                     int(de["iterations"]), "levels": int(de["levels"])})
        if runtime:
            rows[-1]["chunks"] = active_chunks(cap.mesh.last_active[1],
                                               cfg.mesh.mesh_chunk)
    if lc.captured.replays != len(frames) - 1:
        raise AssertionError(f"graph: {lc.captured.replays} replays of "
                             f"{len(frames)} frames")
    return rows, counts, (eager, cap), recorded, sums


def graph_summary(name, rows, warmup, cfg) -> dict:
    """Median and p90 ms a step, eager and captured, over the timed
    frames; the frames where a refinement level was skipped and where the
    ESIKF ran all its bodies live."""
    t = rows[warmup:]
    out = {f"{k}_{q}": (statistics.median if q == "median" else
                        lambda v: float(np.percentile(v, 90)))(
                            [r[f"ms_{k}"] for r in t])
           for k in ("eager", "graph") for q in ("median", "p90")}
    out["skipped_level_frames"] = [
        k for k, r in enumerate(rows)
        if r["levels"] < cfg.voxel_map.max_layers - 1]
    out["max_iteration_frames"] = [
        k for k, r in enumerate(rows)
        if r["iterations"] == cfg.lio.max_iterations]
    out["iterations"] = [r["iterations"] for r in rows]
    out["compacted_frames"] = [k for k, r in enumerate(rows)
                               if r["compacted"]]
    log(f"[graph] {name}: {len(rows)} frames ({warmup} warm-up), eager and "
        f"captured bit-identical every frame (plane map compacted after "
        f"frames {out['compacted_frames']}); ms a step eager "
        f"{out['eager_median']:.2f} median / {out['eager_p90']:.2f} p90, "
        f"captured {out['graph_median']:.2f} / {out['graph_p90']:.2f}; "
        f"ESIKF iterations {out['iterations']}, a refinement level skipped "
        f"on frames {out['skipped_level_frames']}, all "
        f"{cfg.lio.max_iterations} bodies live on frames "
        f"{out['max_iteration_frames']}")
    return out


def scatter_bound_ms(c: Scatter) -> tuple:
    """Least time for this call, by bytes over the memory rate: every ok
    flag read once; for each selected lane its target read once and, for
    every field, its src row read and its dst row written (and read, for an
    add)."""
    sel = int(c.ok.sum())
    nbytes = c.ok.numel() + sel * c.idx.element_size()
    for d, x in zip(c.dsts, c.srcs):
        row = d[0].numel() * d.element_size() if d.shape[0] else 0
        nbytes += sel * ((row if torch.is_tensor(x) else 0) + row
                         + (row if c.kind == "add" else 0))
    return 1e3 * nbytes / PEAK_BYTES_PER_S, "bytes"


def scatter_versions(c: Scatter):
    """(kernel, plain version) of the call's kind, both taking (dsts, idx,
    srcs, ok)."""
    from immesh_tpu_torch.kernels import scatter_drop as sd
    if c.group:
        return ((sd.set_group_cuda, sd.set_group_plain) if c.kind == "set"
                else (sd.add_group_cuda, sd.add_group_plain))
    kern, plain = ((sd.set_cuda, sd.set_plain) if c.kind == "set"
                   else (sd.add_cuda, sd.add_plain))
    return (lambda d, i, s, o: kern(d[0], i, s[0], o),
            lambda d, i, s, o: plain(d[0], i, s[0], o))


def check_scatter(c: Scatter, what: str) -> float:
    """The call again through the kernel and its plain version on copies of
    the dsts it found: bit for bit on every field.  Returns the largest
    absolute difference (0)."""
    kern, plain = scatter_versions(c)
    a = [d.clone() for d in c.dsts]
    b = [d.clone() for d in c.dsts]
    kern(a, c.idx, c.srcs, c.ok)
    plain(b, c.idx, c.srcs, c.ok)
    e = max(abs_err(x, y) for x, y in zip(a, b))
    if e:
        raise AssertionError(
            f"{what}: scatter_drop {c.label()} and its plain version differ "
            f"by {e} ({c.ok.numel()} lanes)")
    return e


def replay_scatters(calls, what: str) -> float:
    """Every recorded call and group again through the kernel and its
    plain version (check_scatter).  Returns the largest absolute
    difference (0)."""
    err = max((check_scatter(c, what) for c in calls), default=0.0)
    kinds = {}
    for c in calls:
        kinds[c.label()] = kinds.get(c.label(), 0) + 1
    groups = sum(c.group for c in calls)
    log(f"[graph] scatter_drop on {what}: {len(calls)} recorded calls "
        f"({groups} groups), each bit-identical to its plain version "
        f"({kinds})")
    return err


# random groups: (kind, idx dtype, [(dst dtype, row, src)]) with src
# "tensor", "strided" (a column block of a wider tensor), "agg" (a column
# slice of one (lanes, 11) aggregate, as the moments' add) or a scalar
_F32, _I32, _I64, _B8 = torch.float32, torch.int32, torch.int64, torch.bool
RANDOM_GROUPS = {
    "refit": ("set", _I32, [(_F32, (3,), "tensor"), (_F32, (), "tensor"),
                            (_F32, (3,), "tensor"), (_F32, (6,), "tensor"),
                            (_F32, (), "tensor"), (_F32, (3,), "tensor"),
                            (_B8, (), "tensor"), (_B8, (), "tensor")]),
    "moments": ("add", _I32, [(_F32, (3,), "agg"), (_F32, (6,), "agg"),
                              (_F32, (), "agg"), (_F32, (), "agg")]),
    "mixed": ("set", _I64, [(_F32, (3,), "strided"), (_I32, (), 0),
                            (_B8, (), True), (_I64, (2,), "tensor"),
                            (_I32, (3,), "strided")]),
    "slot_rows": ("set", _I32, [(_I32, (64, 3), "tensor"),
                                (_I32, (), "tensor"), (_B8, (), True)]),
    "pieces": ("set", _I32, [(_F32, (4,), "tensor"), (_F32, (8,), "strided"),
                             (_I64, (2,), "tensor"),
                             (_F32, (48, 4), "tensor")]),
    "single_f32": ("set", _I32, [(_F32, (), "tensor")]),
    "single_f32x3": ("set", _I64, [(_F32, (3,), "tensor")]),
    "single_strided": ("set", _I32, [(_F32, (6,), "strided")]),
    "single_int32": ("set", _I64, [(_I32, (), "tensor")]),
    "single_int32x3": ("set", _I32, [(_I32, (3,), "tensor")]),
    "single_bool": ("set", _I32, [(_B8, (), "tensor")]),
    "single_true": ("set", _I32, [(_B8, (), True)]),
    "single_zero": ("set", _I32, [(_I32, (), 0)]),
    "single_int64": ("set", _I32, [(_I64, (), "tensor")]),
    "single_slot_row": ("set", _I32, [(_F32, (48, 3), "tensor")]),
    "single_add": ("add", _I32, [(_F32, (), "strided")]),
    "single_add_x3": ("add", _I32, [(_F32, (3,), "tensor")]),
    "single_add_x6": ("add", _I64, [(_F32, (6,), "tensor")]),
}
# how each random call selects and targets its lanes
RANDOM_MODES = ("some", "lanes2d", "none", "all", "out_of_range")


def random_scatter(name, mode, g, lanes) -> Scatter:
    """A random call (one field) or group of RANDOM_GROUPS[name] of
    `lanes` lanes into 2 × lanes rows, made with g on its device."""
    kind, idx_dtype, fields = RANDOM_GROUPS[name]
    dev, rows = g.device, 2 * lanes

    def rand(dtype, shape):
        if dtype == torch.bool:
            return torch.rand(shape, generator=g, device=dev) < 0.5
        if dtype.is_floating_point:
            return torch.randn(shape, generator=g, device=dev)
        return torch.randint(-2 ** 30, 2 ** 30, shape, generator=g,
                             device=dev).to(dtype)

    idx = torch.randperm(rows, generator=g, device=dev)[:lanes].to(idx_dtype)
    ok = torch.rand(lanes, generator=g, device=dev) < 0.7
    if mode == "none":
        ok = torch.zeros_like(ok)
    elif mode == "all":
        ok = torch.ones_like(ok)
    elif mode == "out_of_range":
        # every third target from the end, every fifth outside [-rows,
        # rows): read as the reference's mode="drop" does
        lane = torch.arange(lanes, device=dev)
        far = torch.where(lane % 2 == 0, rows + lane, -rows - 1 - lane)
        idx = torch.where(lane % 3 == 0, idx - rows, idx)
        idx = torch.where(lane % 5 == 0, far, idx).to(idx_dtype)
    agg = rand(_F32, (lanes, 11))
    cols = iter([agg[:, 0:3], agg[:, 3:9], agg[:, 9], agg[:, 10]])
    dsts, srcs = [], []
    for dtype, row, src in fields:
        dsts.append(rand(dtype, (rows,) + row))
        if src == "agg":
            srcs.append(next(cols))
        elif src == "strided":
            w = max(1, math.prod(row))
            srcs.append(rand(dtype, (lanes, w + 5))[:, 2:2 + w]
                        .reshape((lanes,) + row))
        elif src == "tensor":
            srcs.append(rand(dtype, (lanes,) + row))
        else:
            srcs.append(src)
    if mode == "lanes2d":
        shape = (lanes // 8, 8)
        idx, ok = idx.reshape(shape), ok.reshape(shape)
        srcs = [x.reshape(shape + x.shape[1:]) if torch.is_tensor(x) else x
                for x in srcs]
    return Scatter(kind, len(fields) > 1, tuple(dsts), idx, tuple(srcs), ok)


def scatter_random(dev) -> float:
    """scatter_drop against its plain version on random calls and groups
    of every dtype and row width the port uses (RANDOM_GROUPS), idx int32
    and int64, scalar, strided and column-slice srcs, 16-byte pieces and
    elements, each selecting its lanes in every RANDOM_MODES way, at the
    path's 1,024 lanes and at twice the threads the card holds (each
    thread takes several lanes; a 48th of that for slot-wide rows)."""
    props = torch.cuda.get_device_properties(dev)
    big = 2 * props.multi_processor_count * \
        props.max_threads_per_multi_processor
    err, n = 0.0, 0
    for lanes in (1024, big):
        g = torch.Generator(device=dev).manual_seed(16 + lanes)
        for name, (_, _, fields) in RANDOM_GROUPS.items():
            # rows of a slot's 144-192 words: a 48th of the lanes
            wide = max(math.prod(row) for _, row, _ in fields) > 16
            n_lanes = max(1024, lanes // 48) if wide else lanes
            for mode in RANDOM_MODES:
                c = random_scatter(name, mode, g, n_lanes)
                err = max(err, check_scatter(
                    c, f"random {name} ({mode}, {n_lanes} lanes)"))
                n += 1
    log(f"[graph] scatter_drop on {n} random calls and groups "
        f"({len(RANDOM_GROUPS)} field sets x {len(RANDOM_MODES)} lane "
        f"selections {RANDOM_MODES} at 1,024 lanes and at {big}, twice the "
        f"threads {props.multi_processor_count} SMs hold; f32 rows of 1, 3, "
        f"4, 6, 8 and 144-192 words, int32, int64 and bool, scalar, strided "
        f"and column-slice srcs, groups of 2 to 8 fields, set and add): "
        f"each bit-identical to its plain version")
    return err


def time_scatter(c: Scatter, what: str) -> dict:
    """Device µs of one launch, one wrapper call and the plain version on a
    recorded call or group, beside its bound; for a group also its fields
    as single launches, one after the other; 0 host syncs a call."""
    from immesh_tpu_torch.kernels import scatter_drop as sd
    from immesh_tpu_torch.utils.timers import profile_counts
    kern, plain = scatter_versions(c)
    dsts = [d.clone() for d in c.dsts]
    lib = sd._library()
    add = c.kind == "add"
    args = (dsts, c.idx, c.srcs, c.ok)
    _, counts = profile_counts(lambda: kern(*args))
    ms = device_ms(lambda: sd.launch_group(lib, *args, add))
    wrapper_ms = event_ms(lambda: kern(*args), 50)
    plain_ms = event_ms(lambda: plain(*args), 20)
    bound_ms, bound_by = scatter_bound_ms(c)
    out = {"ms": ms, "wrapper_ms": wrapper_ms, "plain_ms": plain_ms,
           "bound_ms": bound_ms, "bound_by": bound_by,
           "lanes": c.ok.numel(), "fields": len(dsts),
           "syncs_per_call": counts["syncs"]}
    # a launch that selects no lane: the kernel's floor on this card
    none = torch.zeros_like(c.ok)
    out["no_lane_ms"] = device_ms(lambda: sd.launch_group(
        lib, dsts, c.idx, c.srcs, none, add))
    note = f"; with no lane selected {1e3 * out['no_lane_ms']:.2f} us"
    if len(dsts) > 1:
        out["singles_ms"] = sum(
            device_ms(lambda: sd.launch(lib, d, c.idx, x, c.ok, add))
            for d, x in zip(dsts, c.srcs))
        note += (f"; its {len(dsts)} fields as single launches, the sum of "
                 f"their times, {1e3 * out['singles_ms']:.2f} us")
    log(f"[graph] {what}: scatter_drop {c.label()}, {c.ok.numel()} lanes "
        f"({int(c.ok.sum())} selected) into {dsts[0].shape[0]} rows: kernel "
        f"{1e3 * ms:.2f} us (device time, median of 5 x 50 launches){note}, "
        f"wrapper call {1e3 * wrapper_ms:.2f} us (median of 50), plain "
        f"version {1e3 * plain_ms:.1f} us, bound {1e3 * bound_ms:.4f} us "
        f"({bound_by}); one call under torch.profiler: {counts['launches']} "
        f"launches, {counts['syncs']} syncs, {counts['copies']} copies")
    if counts["syncs"] != 0:
        raise AssertionError(f"{what}: scatter_drop waited on the card")
    return out


def costliest_scatter(calls, group=None):
    """The recorded call that moves the most bytes (its bound); only
    groups, or only single calls, where `group` says so."""
    return max((c for c in calls if group is None or c.group == group),
               key=lambda c: scatter_bound_ms(c)[0])


# ---------------------------------------------------------------------------
# phase 16b: the segmented sum
# ---------------------------------------------------------------------------
# torch.segment_reduce as the library has it: the yardstick of the
# segment_sum kernel (library_ms, parent_ms).  main() puts a trap in its
# place that counts every call on a CUDA tensor; no path may make one
SEGMENT_REDUCE = torch.segment_reduce
SEGMENT_REDUCE_CALLS = []
# the benchmark's call shapes, drawn (sum_synthetic): (what, rows, columns,
# segments, the longest segment, rows dropped) — the kitti-hdl64 revisit
# scan's downsample and the level whose most rows its mask drops
SUM_SHAPES = (("downsample, revisit-like", 131072, 4, 8192, 3229, 32212),
              ("level, revisit-like", 8192, 11, 4096, 60, 5920))


def trap_segment_reduce() -> None:
    """torch.segment_reduce counted into SEGMENT_REDUCE_CALLS wherever it
    gets a CUDA tensor (and still computed)."""
    def trap(data, *args, **kwargs):
        if data.is_cuda:
            SEGMENT_REDUCE_CALLS.append(tuple(data.shape))
        return SEGMENT_REDUCE(data, *args, **kwargs)
    torch.segment_reduce = trap


class SumCall:
    """A recorded segment_sum kernel call (kernels/segment_sum.py::sum_cuda):
    what made it, and values, order and offsets as the call got them
    (copies), with its rows read, rows dropped and longest segment."""

    def __init__(self, what, values, order, offsets):
        self.what, self.values = what, values
        self.order, self.offsets = order, offsets
        lens = offsets[1:] - offsets[:-1]
        self.rows_read = int(offsets[-1] - offsets[0])
        self.rows_dropped = values.shape[0] - self.rows_read
        self.longest = int(lens.max()) if lens.numel() else 0

    def label(self) -> str:
        return (f"{self.what} {tuple(self.values.shape)} into "
                f"{self.offsets.shape[0] - 1}")


def record_sums(fn):
    """Run fn() with every segment_sum kernel call on the card recorded as a
    SumCall, named in call order within fn as the LIO step makes them: the
    first (4 columns) "downsample", each later one (11 columns) "level l".
    Returns (fn's result, the calls).  A call under capture is not recorded
    (record_probes)."""
    from immesh_tpu_torch.kernels import segment_sum as ss
    calls, inner = [], ss.sum_cuda

    def rec(values, order, offsets):
        if not torch.cuda.is_current_stream_capturing():
            levels = sum(c.what.startswith("level") for c in calls)
            what = ("downsample" if values[0].numel() == 4
                    else f"level {levels}")
            calls.append(SumCall(what, values.clone(), order.clone(),
                                 offsets.clone()))
        return inner(values, order, offsets)

    ss.sum_cuda = rec
    try:
        out = fn()
    finally:
        ss.sum_cuda = inner
    return out, calls


def sum_synthetic(dev, what, n, cols, S, longest, dropped, seed) -> SumCall:
    """A call at one of SUM_SHAPES: n rows of `cols` f32 columns, one
    segment `longest` rows long, `dropped` rows of id S (the callers'
    discarded id), the rest uniform over [0, S); order and offsets as
    core/ops.py::segment_sum makes them."""
    g = torch.Generator(device=dev).manual_seed(seed)
    seg = torch.randint(1, S, (n,), generator=g, device=dev)
    seg[:longest] = 0
    seg[longest:longest + dropped] = S
    seg = seg[torch.randperm(n, generator=g, device=dev)]
    values = 50 * torch.randn((n, cols), generator=g, device=dev)
    order = torch.argsort(seg, stable=True)
    offsets = torch.searchsorted(seg[order], torch.arange(S + 1, device=dev))
    return SumCall(what, values, order, offsets)


def parent_sum(c: SumCall):
    """The composition the kernel replaced, as the parent ran it: the rows
    gathered in order and torch.segment_reduce over one more segment, the
    callers' discarded one (every row from offsets[S] on), sliced off."""
    n = torch.full((1,), c.values.shape[0], dtype=torch.int64,
                   device=c.offsets.device)
    offs = torch.cat([c.offsets, n])
    return SEGMENT_REDUCE(c.values[c.order], "sum", offsets=offs, axis=0,
                          unsafe=True)[:-1]


def library_sum(c: SumCall):
    """torch.segment_reduce on the same order and offsets: the one library
    call that computes this sum (the discarded rows not read)."""
    return SEGMENT_REDUCE(c.values[c.order], "sum", offsets=c.offsets,
                          axis=0, unsafe=True)


def check_sum(c: SumCall, what: str) -> float:
    """The kernel on the call, bit for bit against the parent's composition
    on the card and the plain version on the CPU.  Returns 0."""
    from immesh_tpu_torch.kernels import segment_sum as ss
    got = ss.sum_cuda(c.values, c.order, c.offsets)
    plain = ss.sum_plain(c.values.cpu(), c.order.cpu(), c.offsets.cpu())
    for name, want in (("the parent's composition", parent_sum(c)),
                       ("the plain version on the CPU", plain)):
        if not same_bits(got.cpu(), want.cpu()):
            raise AssertionError(
                f"{what}: segment_sum {c.label()} differs from {name} by "
                f"{abs_err(got.cpu(), want.cpu())}")
    return 0.0


def sum_bound_ms(c: SumCall) -> tuple:
    """Least time for the call, by bytes over the memory rate: the offsets
    read once, each kept row's order entry and columns read once, the
    sums written once."""
    S = c.offsets.shape[0] - 1
    row = c.values[0].numel() * 4
    nbytes = 8 * (S + 1) + c.rows_read * (8 + row) + S * row
    return 1e3 * nbytes / PEAK_BYTES_PER_S, "bytes"


def time_sum(c: SumCall, what: str, full: bool = False) -> dict:
    """Device µs of one launch on a call, beside its bound, the library's
    call on the same rows and the parent's composition; with `full` also a
    wrapper call, the plain version on the card and the syncs of one call
    (0; the profiler's event list holds torch's kernels, not this one)."""
    from immesh_tpu_torch.kernels import segment_sum as ss
    from immesh_tpu_torch.utils.timers import profile_counts
    lib = ss._library()
    v2 = ss.rows2d(c.values)
    out = torch.empty((c.offsets.shape[0] - 1, v2.shape[1]),
                      device=c.values.device)
    bound_ms, bound_by = sum_bound_ms(c)
    e = {"ms": device_ms(lambda: ss.launch(lib, v2, c.order, c.offsets,
                                           out)),
         "library_ms": device_ms(lambda: library_sum(c)),
         "parent_ms": device_ms(lambda: parent_sum(c)),
         "bound_ms": bound_ms, "bound_by": bound_by,
         "rows": c.values.shape[0], "columns": v2.shape[1],
         "segments": out.shape[0], "rows_read": c.rows_read,
         "rows_dropped": c.rows_dropped, "longest_segment": c.longest}
    note = ""
    if full:
        _, counts = profile_counts(
            lambda: ss.sum_cuda(c.values, c.order, c.offsets))
        e["wrapper_ms"] = event_ms(
            lambda: ss.sum_cuda(c.values, c.order, c.offsets), 50)
        e["plain_ms"] = event_ms(
            lambda: ss.sum_plain(c.values, c.order, c.offsets), 20)
        e["syncs_per_call"] = counts["syncs"]
        note = (f", wrapper call {1e3 * e['wrapper_ms']:.2f} us, plain "
                f"version {1e3 * e['plain_ms']:.1f} us; one call under "
                f"torch.profiler: {counts['syncs']} syncs, "
                f"{counts['copies']} copies")
        if counts["syncs"] != 0:
            raise AssertionError(f"{what}: segment_sum waited on the card")
    log(f"[segsum] {what}: {c.label()}, {c.rows_read} rows read, "
        f"{c.rows_dropped} dropped, longest segment {c.longest}: kernel "
        f"{1e3 * e['ms']:.2f} us (device time, median of 5 x 50 launches), "
        f"the library's segment_reduce on the same rows "
        f"{1e3 * e['library_ms']:.2f} us, the parent's composition "
        f"{1e3 * e['parent_ms']:.2f} us, bound {1e3 * bound_ms:.3f} us "
        f"({bound_by}){note}")
    return e


def phase_segment_sum(dev, main_info) -> dict:
    """Phase 16b.  The segment_sum kernel on every call phase 16's eager
    KITTI LioPipeline and Avia ImMeshRuntime made on their recorded frames
    and at the benchmark's shapes (SUM_SHAPES), bit for bit against the
    parent's composition and the plain version on the CPU; each distinct
    call shape timed beside its bound, the library's call and the parent's
    composition; the costliest call of the KITTI path timed in full for the
    `kernels` line."""
    t_phase = time.perf_counter()
    smi = smi_line()
    calls = {"kitti": main_info.pop("sums_kitti"),
             "avia": main_info.pop("sums_avia")}
    synthetic = [sum_synthetic(dev, *shape, seed=11 + i)
                 for i, shape in enumerate(SUM_SHAPES)]
    n = 0
    for path, by_frame in calls.items():
        for k, cs in sorted(by_frame.items()):
            for c in cs:
                n += 1
                check_sum(c, f"{path} frame {k}")
    for c in synthetic:
        check_sum(c, "the benchmark's shapes")
    frames = ", ".join(f"{p} frames {sorted(f)}" for p, f in calls.items())
    log(f"[segsum] {smi}; {n} recorded calls ({frames}) "
        f"and {len(synthetic)} at the benchmark's shapes, each bit for bit "
        f"the parent's composition and the plain version on the CPU")
    by_shape, drops = {}, {}
    for path, by_frame in calls.items():
        last = by_frame[max(by_frame)]
        for c in last:
            by_shape[f"{path} {c.label()}"] = time_sum(
                c, f"{path}'s last recorded frame")
        for cs in by_frame.values():
            for c in cs:
                d = drops.setdefault(f"{path} {c.what}", [0, 0, 0])
                d[0] += 1
                d[1] += c.rows_read
                d[2] += c.rows_dropped
    for c in synthetic:
        by_shape[c.label()] = time_sum(c, "the benchmark's shape")
    top = max(calls["kitti"][max(calls["kitti"])],
              key=lambda c: sum_bound_ms(c)[0])
    entry = time_sum(top, "the KITTI path's costliest call", full=True)
    log(f"[segsum] calls, rows read and rows dropped by caller over the "
        f"recorded frames: {drops}; phase 16b took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"name": "segment_sum", "route": "cuda",
            "source": "immesh_tpu_torch/csrc/segment_sum.cu",
            "replaces": "immesh_tpu/lio/downsample.py:31",
            "max_abs_err": 0.0, **entry, "call": top.label(),
            "by_shape": by_shape,
            "calls_rows_read_dropped": {k: dict(zip(
                ("calls", "rows_read", "rows_dropped"), v))
                for k, v in drops.items()}}


def phase_graph(dev, main_info, scatters) -> dict:
    """Phase 16.  The KITTI LioPipeline and the Avia ImMeshRuntime eager
    and captured from the same start, bit for bit every frame (run_lio_pair),
    with the masked form's dead work; one captured step's syncs and
    launches under torch.profiler; then scatter_drop against its plain
    version on every recorded call (phase 4's compacting frames and last
    frame, the eager KITTI run's compacting frames and last frame) and on
    random calls, 0 syncs a call, and the last frame's costliest call timed
    for the `kernels` line."""
    from immesh_tpu_torch.utils.timers import profile_counts
    t_phase = time.perf_counter()
    smi = smi_line()
    cfg = kitti_config()
    gt = main_info["gt"]
    frames = [bundle(f, cfg, dev) for f in gt]
    last = len(frames) - 1
    reset_counts()
    rows, counts, (eager, cap), lio_calls, main_info["sums_kitti"] = \
        run_lio_pair(dev, cfg, frames, 3, GRAPH_COMPACT_AT,
                     record_at=(*GRAPH_COMPACT_AT, last))
    (graph,) = cap.captured.graphs
    path_counts("graph_kitti", counts, graphs=[graph], kernels=LIO_KERNELS)
    sites = check_sites("KITTI LioPipeline", [graph], rows, cfg)
    if sites["if_nodes"]["nodes"] != lio_sites(cfg) \
            or sites["set_launches"] != lio_launches(cfg):
        raise AssertionError(f"graph: the KITTI LIO graph's IF nodes "
                             f"{sites['if_nodes']['nodes']}, set launches "
                             f"{sites['set_launches']}")
    forms = captured_forms([graph], "graph")
    nodes = graph.nodes()
    # phase 17 holds the two-graph frame's LIO graph to this one
    main_info["lio_graph_nodes"] = nodes
    main_info["lio_graph_captured"] = recorded_launches(graph)
    kitti = graph_summary("KITTI LioPipeline", rows, 3, cfg)
    R0, p0 = main_info["R0"], main_info["p0"]
    err = float(np.linalg.norm(R0 @ cap.state.pos.cpu().numpy() + p0
                               - gt[-1].gt_pos))
    if err > POSE_TOL_M:
        raise AssertionError(f"graph: KITTI pose {err:.3f} m from ground "
                             f"truth (limit {POSE_TOL_M} m)")
    b = frames[-1]
    prof = {}
    for name, p in (("eager", eager), ("captured", cap)):
        _, prof[name] = profile_counts(lambda: p.advance(b))
    if prof["captured"]["syncs"] != 0:
        raise AssertionError(f"graph: the captured KITTI step waited on the "
                             f"card: {prof['captured']}")
    log(f"[graph] KITTI: {smi}; one step under torch.profiler (the last "
        f"frame again): eager {prof['eager']}, captured {prof['captured']}; "
        f"the graph's nodes {nodes}; per frame "
        f"{counts['runs']['scatter_drop'] / len(frames):.2f} scatter_drop "
        f"and {counts['runs']['hash_insert'] / len(frames):.2f} hash_insert "
        f"runs on the device on the captured path ({counts}; the inserts "
        f"recorded into the graph by form {forms}); pose err {err:.3f} m")
    log(f"[graph] KITTI: the LIO graph's kernel nodes {nodes['kernel']} "
        f"({nodes.get('conditional', 0)} IF nodes), device busy "
        f"{prof['captured']['busy_ms']:.3f} ms and "
        f"{prof['captured']['syncs']} syncs a captured step "
        f"(torch.profiler); runs a frame on the device: " + ", ".join(
            f"{k} {counts['runs'][k] / len(frames):.2f}"
            for k in (*LIO_KERNELS, COND_KERNEL)))
    del eager, cap

    acfg = avia_config()
    sim = make_avia_sim(acfg)
    static = sim.static_imu(100)  # drawn first, as the demo does
    aframes = [bundle(sim.frame(k), acfg, dev)
               for k in range(3 + GRAPH_AVIA_FRAMES)]
    reset_counts()
    arows, acounts, (aeager, acap), _, main_info["sums_avia"] = run_lio_pair(
        dev, acfg, aframes, 3, (GRAPH_AVIA_COMPACT_AT,),
        record_at=(GRAPH_AVIA_COMPACT_AT, len(aframes) - 1), static=static,
        runtime=True)
    path_counts("graph_avia", acounts, graphs=pipe_graphs(acap))
    captured_forms(pipe_graphs(acap), "graph: Avia")
    asites = check_sites("Avia ImMeshRuntime", pipe_graphs(acap), arows,
                         acfg)
    (alio,) = acap.lio.captured.graphs
    if if_nodes([alio])["nodes"] != lio_sites(acfg) \
            or set_launches([alio]) != lio_launches(acfg):
        raise AssertionError(f"graph: the Avia LIO graph's IF nodes "
                             f"{if_nodes([alio])['nodes']}, set launches "
                             f"{set_launches([alio])}")
    avia = graph_summary("Avia ImMeshRuntime (LIO and mesh)", arows, 3, acfg)
    _, aprof = profile_counts(lambda: acap.lio.advance(aframes[-1]))
    if aprof["syncs"] != 0:
        raise AssertionError(f"graph: the captured Avia step waited on the "
                             f"card: {aprof}")
    log(f"[graph] Avia: one captured LIO step under torch.profiler: "
        f"{aprof}")
    del aeager, acap

    err = replay_scatters([c for k in sorted(scatters)
                           for c in scatters[k]],
                          f"phase 4's frames {sorted(scatters)}")
    err = max(err, replay_scatters(
        [c for k in sorted(lio_calls) for c in lio_calls[k]],
        f"the eager KITTI LIO's frames {sorted(lio_calls)}"))
    err = max(err, scatter_random(dev))
    entry = time_scatter(costliest_scatter(scatters[max(scatters)]),
                         f"phase 4's last frame's costliest call")
    entry["slot_row_set"] = time_scatter(
        costliest_scatter(scatters[max(scatters)], group=False),
        "phase 4's last frame's costliest single call (a slot-row set)")
    entry["lio_group"] = time_scatter(
        costliest_scatter(lio_calls[last], group=True),
        "the KITTI LIO's costliest group (its last frame)")
    log(f"[graph] phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return {"name": "scatter_drop", "route": "cuda",
            "source": "immesh_tpu_torch/csrc/scatter_drop.cu",
            "replaces": "immesh_tpu/map/voxel_map.py:180",
            "max_abs_err": err, "library_ms": None, **entry,
            "graph": {"kitti": kitti, "avia": avia,
                      "kitti_profiled": prof, "avia_profiled": aprof,
                      "if_kitti": sites, "if_avia": asites}}


# ---------------------------------------------------------------------------
# phase 17: the captured frame and mesh step against the eager ones
# ---------------------------------------------------------------------------
def run_frames(pipes: dict, frames, compact_at, mesh_compact_at,
               counted: str):
    """Pipelines (`pipes`, {name: JointPipeline or ImMeshRuntime}, made from
    the same start) stepped in turns over `frames`; the first is the
    reference.  Every frame: each other pipeline's point map, store, work
    list, active count, every drop counter, filter state and plane map bit
    for bit as the reference's, both maps' compaction counts equal.  After
    the frames in `compact_at` all compact their plane map to half, after
    those in `mesh_compact_at` their mesh map.  Returns per-frame rows (ms
    a frame of each pipeline, the frame's diag counts of pipeline
    `counted`: ESIKF iterations, levels, the chunks with an active voxel;
    compactions) and the counts (path_now) of `counted`'s steps alone."""
    import immesh_tpu_torch.runtime.joint as joint
    names = list(pipes)
    ref = pipes[names[0]]
    runtime = not isinstance(ref, joint.JointPipeline)
    chunk = ref.cfg.mesh.mesh_chunk
    counts = {part: dict.fromkeys(COUNTED, 0)
              for part in ("launches", "recorded", "runs")}

    def run(p, k, b):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        if runtime:
            out = p.process_frame(b, t=0.1 * k)
            diag = dict(p.mesh.last_drops,
                        **{n: out[n] for n in ("n_active_voxels",
                                               "iterations", "levels")})
        else:
            _, diag = p.step(b)
        torch.cuda.synchronize()
        return diag, 1e3 * (time.perf_counter() - t0)

    def differs(k, what):
        comp = {n: (p.lio.n_compactions, p.mesh.n_compactions)
                for n, p in pipes.items()}
        for n in names[1:]:
            p = pipes[n]
            slots = [(x, y, z) for x, y, z in zip(
                ("slots", "smask"), ref.mesh.last_active,
                p.mesh.last_active)]
            bad = mesh_differs(ref.mesh, p.mesh, slots) + lio_differs(
                ref.lio.state, p.lio.state, ref.lio.vm, p.lio.vm)
            if bad or comp[n] != comp[names[0]]:
                raise AssertionError(f"mesh graph: frame {k}: {what} {n} and "
                                     f"{names[0]} differ in {bad}, "
                                     f"compactions {comp}")
        return comp[counted]

    rows = []
    for k, b in enumerate(frames):
        diags, ms = {}, {}
        for n, p in pipes.items():
            if n == counted:
                before = path_now()
            diags[n], ms[n] = run(p, k, b)
            if n == counted:
                after = path_now()
                for part, c in counts.items():
                    for name in c:
                        c[name] += after[part][name] - before[part][name]
        for n in names[1:]:
            bad = [x for x in diags[n]
                   if not same_bits(diags[names[0]][x], diags[n][x])]
            if bad:
                raise AssertionError(f"mesh graph: frame {k}: {n}'s diag "
                                     f"{bad}")
        comp = differs(k, "after the step,")
        if k in compact_at or k in mesh_compact_at:
            for p in pipes.values():
                if k in compact_at:
                    compact_half(p.lio.vm, p.lio.state.pos)
                if k in mesh_compact_at:
                    compact_mesh_half(p.mesh, p.lio.state.pos)
            differs(k, "after the forced compaction,")
        d = diags[counted]
        rows.append({"ms": ms, "compactions": comp,
                     "iterations": int(d["iterations"]),
                     "levels": int(d["levels"]),
                     "chunks": active_chunks(
                         pipes[counted].mesh.last_active[1], chunk)})
    for n, p in pipes.items():
        reps = sum(g.replays for g in pipe_graphs(p))
        want = sum(len(frames) - 1 for part in (p.lio, p.mesh)
                   if part.captured is not None)
        if reps != want:
            raise AssertionError(f"mesh graph: {n}: {reps} replays of "
                                 f"{len(frames)} frames, expected {want}")
    return rows, counts


def ms_summary(rows, warmup, name) -> dict:
    """Median and p90 ms a frame of pipeline `name` over the timed frames."""
    t = [r["ms"][name] for r in rows[warmup:]]
    return {"median": statistics.median(t),
            "p90": float(np.percentile(t, 90))}


def chunk_sites(name, rows, graphs) -> dict:
    """The chunk IF nodes of `graphs` (a mesh graph or a frame graph): the
    chunk bodies run on the device (the set kernel's taken counts) against
    the chunks with an active voxel over the replayed frames, and the
    chunks skipped a replayed frame."""
    n_chunks = if_nodes(graphs)["nodes"]["chunk"]
    ran, want = site_runs(graphs)["chunk"], sum(r["chunks"] for r in rows[1:])
    if ran != want:
        raise AssertionError(f"mesh graph: {name}: {ran} chunk bodies ran on "
                             f"the device, {want} chunks had an active voxel")
    return {"chunk_nodes": n_chunks, "chunk_runs": ran,
            "chunks_skipped_a_frame": (n_chunks * (len(rows) - 1) - ran)
            / (len(rows) - 1)}


def frame_split(rows, warmup, name, steps) -> dict:
    """The frame's wall time (host clock, synchronised), the device span of
    its graph replays (CUDA events around each replay of `steps`'
    CapturedSteps, recorded since their first replay) and the time outside
    them, median over the timed frames: frame k ≥ 1 is replay k − 1 of
    each step."""
    spans = []
    for step in steps:
        ev = step.replay_events
        spans.append([s.elapsed_time(e) for s, e in ev])
    wall = [r["ms"][name] for r in rows]
    inside = [sum(sp[k - 1] for sp in spans) for k in range(1, len(rows))]
    t = range(max(warmup, 1), len(rows))
    return {"wall_median": statistics.median(wall[k] for k in t),
            "graphs_median": statistics.median(inside[k - 1] for k in t),
            "outside_median": statistics.median(wall[k] - inside[k - 1]
                                                for k in t),
            "graphs_p90": float(np.percentile([inside[k - 1] for k in t],
                                              90))}


def pose_only(pipe, frames) -> dict:
    """A JointPipeline stepped over `frames` with the pose read alone, as a
    replay or a live run without the benchmark's polls: ms a frame (wall,
    the host clock, no synchronize but the pose read) median over the
    frames after the first 3, and the share of frames whose LIO step was
    launched while the previous mesh half still ran (lio_over_mesh, found
    as the pipeline counts it: one query of the last half's event)."""
    over, ms = 0, []
    for b in frames:
        done = pipe.mesh.done
        over += done is not None and not done.query()
        t0 = time.perf_counter()
        pipe.step(b)
        pipe.state.pos.cpu()
        ms.append(1e3 * (time.perf_counter() - t0))
    torch.cuda.synchronize()
    return {"median": statistics.median(ms[3:]),
            "lio_over_mesh_share": over / (len(frames) - 1)}


def phase_mesh_graph(dev, main_info) -> dict:
    """Phase 17.  The KITTI JointPipeline (phase 4's 3 + 40 scans) two
    ways from the same start, in turns (run_frames): eager (graph=False,
    serial) and the frame's two captured graphs with
    the mesh half on its own stream (the default on the card), the plane
    maps compacted to half after GRAPH_COMPACT_AT and the mesh maps on
    their own; then the same two from a new start with the pose read alone
    (pose_only), bit for bit at the end; then the Avia ImMeshRuntime (3 +
    30 frames) with its mesh step eager and captured (both maps forced
    after GRAPH_AVIA_COMPACT_AT).  The two graphs' kernel, memcpy, memset
    and conditional nodes and recorded launches equal to phase 4's, the
    LIO graph's to phase 16's; IF nodes and set launches by site; the
    bodies run on the device against diag; 0 syncs in a captured frame or
    mesh step; ms a frame each way and the frame split: wall, the frame's
    device span from the LIO replay's start to the mesh replay's end, the
    time outside it, and the two graphs' device-busy time replayed alone
    under torch.profiler."""
    import immesh_tpu_torch.runtime.joint as joint
    from immesh_tpu_torch.mesh.pipeline import MeshPipeline
    from immesh_tpu_torch.runtime.app import ImMeshRuntime
    from immesh_tpu_torch.utils.timers import profile_counts
    t_phase = time.perf_counter()
    smi = smi_line()
    cfg = kitti_config()
    gt = main_info["gt"]
    frames = [bundle(f, cfg, dev) for f in gt]

    def make_joint(graph=True):
        return joint.JointPipeline(cfg, adaptive_mesh_budget=2048,
                                   device=dev, graph=graph)

    pipes = {"eager": make_joint(graph=False), "pipelined": make_joint()}
    piped = pipes["pipelined"]
    piped.captured.replay_events = []
    reset_counts()
    # the plane map compacted by force (it stays below its high-water
    # mark), the mesh map on its own (twice in phase 4)
    rows, counts = run_frames(pipes, frames, GRAPH_COMPACT_AT, (),
                              "pipelined")
    fgraphs = piped.captured.graphs
    lg, mg = fgraphs
    path_counts("mesh_graph_kitti", counts, graphs=fgraphs)
    forms = captured_forms(fgraphs, "mesh graph")
    log(f"[mesh graph] KITTI: per frame (the pipelined frame) "
        + ", ".join(f"{counts['runs'][k] / len(frames):.2f} {k}"
                    for k in COUNTED)
        + f" runs on the device ({counts}); the inserts recorded into the "
        f"two graphs by form {forms}")
    same = ("kernel", "memcpy", "memset", "conditional")
    nodes, lnodes = summed_nodes(fgraphs), lg.nodes()
    if [nodes.get(k, 0) for k in same] != [
            main_info["graph_nodes"].get(k, 0) for k in same] \
            or summed_launches(fgraphs) != main_info["graph_captured"]:
        raise AssertionError(
            f"mesh graph: the KITTI frame's graphs hold {nodes} nodes and "
            f"{summed_launches(fgraphs)} kernel launches, phase 4's "
            f"(recorders on) {main_info['graph_nodes']} and "
            f"{main_info['graph_captured']}")
    if [lnodes.get(k, 0) for k in same] != [
            main_info["lio_graph_nodes"].get(k, 0) for k in same] \
            or recorded_launches(lg) != main_info["lio_graph_captured"]:
        raise AssertionError(
            f"mesh graph: the frame's LIO graph holds {lnodes} nodes and "
            f"{recorded_launches(lg)} launches, phase 16's "
            f"{main_info['lio_graph_nodes']} and "
            f"{main_info['lio_graph_captured']}")
    sites = check_sites("KITTI JointPipeline, two graphs", fgraphs, rows,
                        cfg)
    mc = cfg.mesh
    n_chunks = -(-mc.active_voxels_per_frame // mc.mesh_chunk)
    if sites["if_nodes"]["nodes"] != {**lio_sites(cfg), "chunk": n_chunks} \
            or sites["set_launches"] != {**lio_launches(cfg),
                                         "chunk": n_chunks}:
        raise AssertionError(f"mesh graph: IF nodes and set launches by "
                             f"site: {sites}")
    kitti = {k: ms_summary(rows, 3, k) for k in pipes}
    kitti.update(chunk_sites("KITTI JointPipeline", rows, [mg]))
    comp = [r["compactions"] for r in rows]
    kitti["mesh_compaction_frames"] = [
        k for k in range(1, len(rows)) if comp[k][1] > comp[k - 1][1]]
    if not kitti["mesh_compaction_frames"]:
        raise AssertionError("mesh graph: the KITTI mesh map never "
                             "compacted on its own")
    kitti["split"] = frame_split(rows, 3, "pipelined", [piped.captured])
    piped.captured.replay_events = None
    kitti["nodes"], kitti["sites"] = nodes, sites
    R0, p0 = main_info["R0"], main_info["p0"]
    err = float(np.linalg.norm(R0 @ piped.lio.state.pos.cpu().numpy() + p0
                               - gt[-1].gt_pos))
    if err > POSE_TOL_M:
        raise AssertionError(f"mesh graph: KITTI pose {err:.3f} m from "
                             f"ground truth (limit {POSE_TOL_M} m)")
    # one frame of each (the last scan again, no poll pending: the polls
    # only copy) under torch.profiler, and the two graphs replayed alone
    # (their static inputs: the last frame again): their device-busy time
    prof = {}
    for n, p in pipes.items():
        p.lio._occ_pending = p.mesh._occ_pending = None
        _, prof[n] = profile_counts(lambda: p.step(frames[-1]))
    if prof["pipelined"]["syncs"] != 0:
        raise AssertionError(f"mesh graph: the pipelined frame waited on "
                             f"the card: {prof['pipelined']}")
    torch.cuda.synchronize()
    _, prof["graphs_replay"] = profile_counts(
        lambda: [g.graph.replay() for g in fgraphs])
    kitti["profiled"] = prof
    del pipes, piped
    # the pose alone, each way from a new start, bit for bit at the end
    pose = {"eager": make_joint(graph=False), "pipelined": make_joint()}
    kitti["pose_only"] = {n: pose_only(p, frames) for n, p in pose.items()}
    bad = mesh_differs(pose["eager"].mesh, pose["pipelined"].mesh) \
        + lio_differs(pose["eager"].lio.state, pose["pipelined"].lio.state,
                      pose["eager"].lio.vm, pose["pipelined"].lio.vm)
    if bad or pose["eager"].mesh.n_compactions \
            != pose["pipelined"].mesh.n_compactions:
        raise AssertionError(f"mesh graph: the pose-only runs differ in "
                             f"{bad}")
    del pose
    sp, po = kitti["split"], kitti["pose_only"]
    log(f"[mesh graph] KITTI: {smi}; {len(rows)} frames (3 warm-up), the "
        f"pipelined and eager frames bit-identical every frame; ms a frame "
        f"median / p90: " + ", ".join(
            f"{n} {kitti[n]['median']:.2f} / {kitti[n]['p90']:.2f}"
            for n in ("eager", "pipelined"))
        + f"; compactions of the mesh map after frames "
        f"{kitti['mesh_compaction_frames']}; the two graphs' nodes {nodes} "
        f"(phase 4's); {kitti['chunk_nodes']} chunk IF nodes, "
        f"{kitti['chunk_runs']} chunk bodies run on the device as the "
        f"chunks with an active voxel say, "
        f"{kitti['chunks_skipped_a_frame']:.2f} skipped a replayed frame; "
        f"pose err {err:.3f} m")
    log(f"[mesh graph] KITTI frame split (medians over the timed frames, "
        f"ms, each frame synchronised): wall {sp['wall_median']:.3f}, the "
        f"frame's device span (the LIO replay's start to the mesh replay's "
        f"end) {sp['graphs_median']:.3f} (p90 {sp['graphs_p90']:.3f}), "
        f"outside it {sp['outside_median']:.3f}; the two graphs replayed "
        f"alone under torch.profiler: {prof['graphs_replay']}; one frame "
        f"with no poll pending under torch.profiler: " + ", ".join(
            f"{n} {prof[n]}" for n in ("eager", "pipelined")))
    log(f"[mesh graph] KITTI pose-only loop ({len(frames)} frames from a "
        f"new start, ms a frame median over the last {len(frames) - 3}): "
        f"eager {po['eager']['median']:.3f}, pipelined "
        f"{po['pipelined']['median']:.3f}; lio_over_mesh in "
        f"{100 * po['pipelined']['lio_over_mesh_share']:.1f} % of the "
        f"pipelined frames (eager "
        f"{100 * po['eager']['lio_over_mesh_share']:.1f} %); the two "
        f"bit-identical at the end")

    acfg = avia_config()
    sim = make_avia_sim(acfg)
    static = sim.static_imu(100)  # drawn first, as the demo does
    aframes = [bundle(sim.frame(k), acfg, dev)
               for k in range(3 + GRAPH_AVIA_FRAMES)]

    def make_runtime():
        rt = ImMeshRuntime(acfg, device=dev)
        rt.static_init(*static)
        return rt

    aeager, acap = make_runtime(), make_runtime()
    aeager.mesh = MeshPipeline(acfg, device=dev, graph=False)
    reset_counts()
    arows, acounts = run_frames({"eager_mesh": aeager, "captured": acap},
                                aframes, (GRAPH_AVIA_COMPACT_AT,),
                                (GRAPH_AVIA_COMPACT_AT,), "captured")
    path_counts("mesh_graph_avia", acounts, graphs=pipe_graphs(acap))
    captured_forms(pipe_graphs(aeager) + pipe_graphs(acap), "mesh graph: Avia")
    (amg,) = acap.mesh.captured.graphs
    avia = {k: ms_summary(arows, 3, k) for k in ("eager_mesh", "captured")}
    avia.update(chunk_sites("Avia ImMeshRuntime", arows, [amg]))
    avia["if_nodes"] = if_nodes([amg])
    avia["set_launches"] = set_launches([amg])
    avia["nodes"] = amg.nodes()
    world = acap.lio.state.transform_points(aframes[-1].pts)
    mframe = (world, aframes[-1].mask, acap.lio.state.pos)
    aprof = {}
    for n, p in (("eager", aeager), ("captured", acap)):
        p.mesh._occ_pending = None  # the poll only copies
        _, aprof[n] = profile_counts(lambda: p.mesh.step(*mframe))
    if aprof["captured"]["syncs"] != 0:
        raise AssertionError(f"mesh graph: Avia: the captured mesh step "
                             f"waited on the card: {aprof['captured']}")
    avia["profiled"] = aprof
    log(f"[mesh graph] Avia ImMeshRuntime: {len(arows)} frames (3 warm-up), "
        f"eager and captured mesh step bit-identical every frame; ms a frame "
        f"with the mesh eager {avia['eager_mesh']['median']:.2f} median / "
        f"{avia['eager_mesh']['p90']:.2f} p90, captured "
        f"{avia['captured']['median']:.2f} / {avia['captured']['p90']:.2f}; "
        f"the mesh graph's IF nodes {avia['if_nodes']['nodes']}, set "
        f"launches {avia['set_launches']}, {avia['chunk_runs']} chunk bodies "
        f"run on the device as the chunks with an active voxel say, "
        f"{avia['chunks_skipped_a_frame']:.2f} skipped a replayed frame; "
        f"the graph's nodes {avia['nodes']}; one mesh step under "
        f"torch.profiler: eager {aprof['eager']}, captured "
        f"{aprof['captured']}; phase 17 took "
        f"{time.perf_counter() - t_phase:.1f} s")
    return {"kitti": kitti, "avia": avia}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--frames", type=int, default=40,
                    help="timed main-path frames after 3 warm-up frames")
    args = ap.parse_args()

    if not torch.cuda.is_available():
        log("chip_smoke: torch.cuda.is_available() is False — this script "
            "runs only on a GPU")
        return 2
    dev = torch.device("cuda", 0)
    driver = subprocess.run(
        ["nvidia-smi", "--query-gpu=driver_version", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.split()[0]
    cond = hasattr(torch.cuda.CUDAGraph, "begin_capture_to_if_node")
    log(f"[device] {smi_line()}; torch {torch.__version__}, CUDA runtime "
        f"{torch.version.cuda}, driver {driver}, "
        f"{torch.cuda.device_count()} device(s); CUDA-graph conditional "
        f"nodes in torch (CUDAGraph.begin_capture_to_if_node): "
        f"{'present' if cond else 'absent'}; the captured steps' IF nodes "
        f"are made by csrc/graph_cond.cu through the CUDA runtime")

    from immesh_tpu_torch.kernels import build
    from immesh_tpu_torch.kernels import graph_cond as gc
    trap_segment_reduce()
    t0 = time.perf_counter()
    libs = build.build(KERNELS, force=True)
    versions = gc.check_versions(gc._library())
    log(f"[build] {', '.join(libs.values())} built in "
        f"{time.perf_counter() - t0:.1f} s; CUDA driver and graph_cond's "
        f"runtime {versions} (conditional nodes need {gc.MIN_VERSION})")

    pairs = phase_kernels(dev)
    incircle = phase_incircle(dev)
    phase_ints(dev)
    sim, gt = kitti_scans(3 + args.frames)
    hash_err, hash_entries = phase_hash(dev, gt)
    main_info, probes, scatters = phase_main(dev, sim, gt, 3, pairs["ms"])
    hashes = phase_hash_path(dev, probes, hash_err, hash_entries)
    del probes
    phase_parity(dev)
    rt = phase_runtime(dev, AVIA_FRAMES, 3)
    incircle["launches"] = phase_audit(dev, rt)
    del rt
    rt, sim, n_before, frames, _, window = phase_ba(dev, BA_FRAMES, 3)
    phase_ba_ab(dev)
    phase_render(dev, rt, sim, n_before, frames)
    del rt
    phase_frontend()
    phase_replay_kitti(dev, REPLAY_FRAMES, 3)
    tex = TexturePhase(dev, AVIA_FRAMES + 3)
    rt, _, R_align, p0, _ = phase_replay_avia(dev, AVIA_FRAMES, 3,
                                                 on_frame=tex.on_frame)
    tex.finish(rt, R_align, p0)
    del rt
    phase_dist(dev, main_info, window)
    phase_ablate(dev, main_info)
    phase_profile(dev, main_info)
    cond = phase_cond(dev)
    scatter = phase_graph(dev, main_info, scatters)
    del scatters
    segsum = phase_segment_sum(dev, main_info)
    pairs["mesh_graph"] = phase_mesh_graph(dev, main_info)

    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    for e in (pairs, *hashes, scatter, segsum, cond):  # the main path's, then
        # each other's.  launches: by the wrapper (eager; the set kernel's,
        # which runs only in graphs: those it recorded); device_runs: the
        # kernel's own device counter, eager and replayed in the captured
        # LIO and mesh graphs
        part = "recorded" if e["name"] == COND_KERNEL else "launches"
        e["launches"] = PATH_COUNTS["main"][part][e["name"]]
        e["device_runs"] = PATH_COUNTS["main"]["runs"][e["name"]]
        e["device_runs_per_frame"] = e["device_runs"] / len(gt)
        for path, n in PATH_COUNTS.items():
            if path != "main" and e["name"] in n["runs"]:
                e[f"launches_{path}"] = n[part][e["name"]]
                e[f"device_runs_{path}"] = n["runs"][e["name"]]
    print(smi_line())
    print(json.dumps({"kernels": [
        {**{k: e[k] for k in keys}, **{k: x for k, x in e.items()
                                        if k not in keys}}
        for e in (pairs, incircle, *hashes, scatter, segsum, cond)]}))
    if SEGMENT_REDUCE_CALLS:
        raise AssertionError(f"torch.segment_reduce ran on CUDA tensors "
                             f"{len(SEGMENT_REDUCE_CALLS)} times outside "
                             f"the yardstick: {SEGMENT_REDUCE_CALLS[:5]}")
    log("[segsum] no path called torch.segment_reduce on a CUDA tensor")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
