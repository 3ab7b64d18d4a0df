// Batched probes of the open-addressing spatial hash table for Hopper
// (sm_90a): lookup and find-or-insert.
//
// Replaces the reference's two on-device probe loops, the lax.while_loops of
// immesh_tpu/map/hash.py's HashTable.lookup (:127) and HashTable.insert
// (:186).  Both walk the double-hashing sequence
//
//   cand_r = (_hash(key) + r * _fingerprint(key)) & (capacity - 1),
//   r = 0 .. max_probe - 1
//
// in wrapping 32-bit arithmetic.  The hash and the fingerprint are computed
// here in uint32, which gives the bits of the plain version's wrapping int32
// multiplies and sums; the left shift is taken on the unsigned value (a
// signed << that overflows is undefined in C++) and (c2 >> 7) stays an
// arithmetic shift of the signed coordinate, as torch's and XLA's are.
//
// The lookup: each lane runs its own probe loop over fp, which a lookup never
// changes.  A lane stops at the first slot whose fingerprint equals its own
// (found) or is 0 (absent, -1).  Lanes are independent and a lane that is
// done never changes its slot again, so this is exactly the batched loop's
// result.  Fingerprints only, as in the reference: a collision inside a
// chain aliases the lookup.  It comes in four launch forms, each taking its
// input as its caller holds it and returning what the caller's torch code
// returned (kernels/hash_probe.py keeps that code as each form's plain
// version):
//   * hash_lookup_kernel (the coords form): (n, 4) int32 keys -> slots, a
//     thread a key: HashTable.lookup's kernel and the probe loop of the
//     compositions the forms replaced (no path of the port calls it since
//     the other forms took its callers).  At its callers' sizes (8,192 to
//     65,536 keys) its work is two or three dependent L2 round trips a key
//     and most of a launch is the launch itself and the grid's ramp, so:
//       - it is launched as a programmatic dependent of the stream's
//         previous kernel (cudaLaunchKernelEx with
//         cudaLaunchAttributeProgrammaticStreamSerialization): its blocks
//         may be scheduled while that kernel drains.  Nothing touches global
//         memory before griddepcontrol.wait (the run counter, the key rows,
//         fp and the slot written included: slot may reuse memory the
//         previous kernel still reads), which returns once that kernel has
//         completed and its writes are visible, and is a no-op in a launch
//         without the attribute.  A thread releases its own dependents
//         (griddepcontrol.launch_dependents) once its first loads are
//         issued.  The result is the same bits either way;
//       - the further rounds run through finish_chain, as in every form;
//   * hash_lookup_planes_kernel: (n, 3) f32 points -> (found, slot) of the
//     plane map's level descent, a thread a point.  It makes the point's
//     keys itself (floor(p / size_l) at each of the L levels, the near
//     voxel's too when kP = 2), issues all kP * L first-round fp loads before
//     it compares any (they are independent), then runs each chain's further
//     rounds, reads plane_valid and subdivided of the found slots together,
//     and walks the descent and the near probe's take merge in registers.
//     The f32 arithmetic is the plain version's, op for op and each op
//     rounded alone (-fmad=false): qs = x / s as one IEEE division (torch
//     divides by a device scalar, core/ops.py::div), frac = (qs - floor(qs))
//     - 0.5, shift = sign(frac) * s where |frac| > 0.25, then q + shift;
//     the f32 -> int32 cast is cvt.rzi (saturating, NaN -> 0), as torch's
//     cast is on the card.  The divisors are the f32s torch.full((),
//     voxel_size / 2**l) holds, made on the host and passed by value, so a
//     graph replay reads nothing on the host;
//   * hash_lookup_parent_kernel: (n, 3) points and a mask -> mask & (the
//     point's voxel at level l is present and subdivided), the refinement
//     levels' parent probe of VoxelMap.update_levels;
//   * hash_lookup_neighbors_kernel: (A,) slots of a voxel table -> the slots
//     of their 3x3x3 neighbourhoods, (A * 27,) in _OFFS order with the key's
//     4th column 0, a thread an output lane: each of a slot's 27 lanes reads
//     its key row with one 16-byte load (the lanes of a warp that share a
//     row share its transaction) and makes its key in registers.  A thread
//     a slot, its 27 chains in one thread, ran at 1,024 slots no faster than
//     the torch composition it replaced: 16 blocks on 132 SMs, and a
//     thread waits on its slowest chain.
//
// The insert: the reference's round-synchronous find-or-insert of unique
// keys.  In round r every unresolved lane reads `keys` as round r - 1 left
// them; a full-key match takes that slot; among the lanes that attempt one
// empty slot the lowest lane id wins and writes keys and fp in place; the
// loop ends when no lane is unresolved or after max_probe rounds.  A per-lane
// atomicCAS loop (first to arrive wins) would give another slot layout, so
// the rounds are kept, in one launch a call with no host read, each round
// two barriers: (A) read keys and claim, | (B) winner check and key write,
// gather the open flag, | exit test.  The result is defined by the rounds,
// not by the thread mapping, so both forms below give the same bits:
//   * hash_insert_cluster_kernel, for u <= kClusterMaxLanes (16,384, every
//     per-frame insert of the LIO and mesh steps): one thread block of up to
//     1,024 threads, or one thread-block cluster of 2, 4 or 8 such blocks
//     (cudaLaunchKernelEx with a cluster dimension), each thread owning up
//     to two lanes for the whole call; the barriers are __syncthreads() and
//     cluster.sync(), never a grid barrier.  A lane's key, slot and state
//     stay in the registers of the one thread that owns it in every phase.
//     The round's open flag is __syncthreads_or in the one-block form; in
//     a cluster every warp with an open lane raises it in each block's
//     shared memory over distributed shared memory (two words used by
//     parity, each cleared a round before its next use), so each block
//     reads its own copy after the barrier.  A thread issues the loads of
//     its lanes together and reads a key row as one 16-byte load.
//   * hash_insert_kernel, for larger u (a compaction's rebuild, 131,072
//     lanes): one cooperative launch (cudaLaunchCooperativeKernel), lanes
//     taken grid-stride by a grid of as many blocks as can be resident at
//     once, two grid.sync() a round.  Its per-lane state lives in the `new`
//     output's bytes until the last pass turns it into the flag, and the
//     round flags in a (max_probe,) scratch.
// Both:
//   * The claim tournament runs on fp itself, with no scratch to allocate or
//     restore: an attempted slot is empty (keys[s][0] == EMPTY and fp[s] == 0,
//     as every insert writes both), so each attempting lane i does
//     atomicMin(&fp[s], INT_MIN + i) in phase A; in phase B the lane that
//     reads its own value back is the lowest and writes keys[s]; its
//     fingerprint goes into fp[s] in the next round's phase A (or after the
//     loop), when no lane reads fp and none claims s, because s no longer
//     reads as empty.  Slots start at -1 (invalid lanes, exhaustion).
//   * Data written by other blocks during the launch (keys, fp, the round
//     flags) is read with ld.global.cg, from L2, never from a stale L1 line.
//   * The host-side queries a launch needs (cooperative launch support, the
//     resident blocks, the clusters that fit) are made once per device and
//     cached.

// Thread 0 of block 0 of each kernel adds one to its device counter in
// g_runs (kRunLookup ... kRunNeighbors): the kernels' runs on the device,
// eager or replayed in a CUDA graph, read back by hash_probe_runs.
//
// Cost: all are bound by memory latency, not by bytes or operations: every
// probe round is one dependent random 32-byte sector per lane (fp for a
// lookup, the 16-byte key row for an insert), and the insert adds an atomic
// per attempt and two barriers a round: a block's or a cluster's at the
// step's sizes, where a grid barrier cost more than the work.  At the plane
// map's ~10 % load nearly every lane resolves in one or two rounds.  So the
// lookup forms keep the work that fed and drained a lookup (the keys, the
// descent, the neighbourhood) in the thread that probes, one launch where
// the torch code took dozens.

#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int32_t kEmpty = 0x7FFFFFFF;
constexpr int kThreads = 256;
// the cluster form: blocks of up to kClusterThreads threads, each thread up
// to kLanesPerThread lanes, clusters of up to kMaxCluster blocks
constexpr int kClusterThreads = 1024;
constexpr int kLanesPerThread = 2;
constexpr int kLanesPerBlock = kClusterThreads * kLanesPerThread;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kClusterMaxLanes = kMaxCluster * kLanesPerBlock;
constexpr int kMaxDevices = 64;
// the planes form: at most kMaxLevels levels (VoxelMapConfig.max_layers:
// 2 in the avia, nclt and ntu presets, 4 in KITTI's)
constexpr int kMaxLevels = 4;
// the offsets of a neighbourhood (the neighbours form)
constexpr int kNeighbors = 27;

// runs of each kernel on the current device since the last
// hash_probe_reset_runs, in kernels/hash_probe.py's `launches` order
enum { kRunLookup, kRunInsert, kRunPlanes, kRunParent, kRunNeighbors, kRunKinds };
__device__ unsigned long long g_runs[kRunKinds];

// the planes form's divisors, by value in the kernel's parameters
struct Divisors {
  float s[kMaxLevels];
};

// per-lane insert state, kept in the `new` output until the last pass
enum : uint8_t { kOpen = 0, kAttempt = 1, kDone = 2, kWonPending = 3, kWon = 4 };

struct Key {
  int32_t c0, c1, c2, c3;
};

__device__ __forceinline__ Key load_key(const int32_t* __restrict__ coords,
                                        int i) {
  const int32_t* c = coords + 4 * static_cast<int64_t>(i);
  return {__ldg(c), __ldg(c + 1), __ldg(c + 2), __ldg(c + 3)};
}

// a key row as one 16-byte load (the row must be 16-byte aligned)
__device__ __forceinline__ Key load_key16(const int32_t* __restrict__ rows,
                                          int64_t i) {
  const int4 v = __ldg(reinterpret_cast<const int4*>(rows) + i);
  return {v.x, v.y, v.z, v.w};
}

// map/hash.py::_hash without the mask (same primes, wrapping products)
__device__ __forceinline__ uint32_t slot_hash(const Key& k) {
  return (static_cast<uint32_t>(k.c0) * 73856093u) ^
         (static_cast<uint32_t>(k.c1) * 19349669u) ^
         (static_cast<uint32_t>(k.c2) * 83492791u) ^
         (static_cast<uint32_t>(k.c3) * 3145739u);
}

// map/hash.py::_fingerprint: odd, hence never 0 (an empty slot's value)
__device__ __forceinline__ uint32_t fingerprint(const Key& k) {
  uint32_t h = static_cast<uint32_t>(k.c0) * static_cast<uint32_t>(-1640531527) +
               static_cast<uint32_t>(k.c1) * static_cast<uint32_t>(-1274297907) +
               static_cast<uint32_t>(k.c2) * static_cast<uint32_t>(-1981354251) +
               static_cast<uint32_t>(k.c3) * 1183186591u;
  h ^= (static_cast<uint32_t>(k.c0) << 13) ^ static_cast<uint32_t>(k.c2 >> 7);
  return h | 1u;
}

// The rest of a chain whose round r holds f at cand: the slot, or -1 when
// an empty slot comes first or the chain reaches max_probe.
__device__ __forceinline__ int32_t finish_chain(const int32_t* __restrict__ fp,
                                                uint32_t h0, uint32_t fpq,
                                                uint32_t mask, int max_probe,
                                                int r, uint32_t cand,
                                                int32_t f) {
  while (true) {
    if (f == static_cast<int32_t>(fpq))  // fpq is odd: a match is never empty
      return static_cast<int32_t>(cand);
    if (f == 0 || ++r >= max_probe) return -1;  // empty before a match: absent
    cand = (h0 + static_cast<uint32_t>(r) * fpq) & mask;
    f = __ldg(fp + cand);
  }
}

// A key's first probe: its home slot and fingerprint.
struct Probe {
  uint32_t h0, fpq;
};

__device__ __forceinline__ Probe probe_of(const Key& k, uint32_t mask) {
  return {slot_hash(k) & mask, fingerprint(k)};
}

// The key of world point p at the level whose voxel edge is the f32 s:
// floor(p / s) with one IEEE division, cast as torch casts on the card.
__device__ __forceinline__ Key voxel_key(const float p[3], float s, int level) {
  return {__float2int_rz(floorf(__fdiv_rn(p[0], s))),
          __float2int_rz(floorf(__fdiv_rn(p[1], s))),
          __float2int_rz(floorf(__fdiv_rn(p[2], s))), level};
}

// Programmatic dependent launch (PTX griddepcontrol, sm_90): wait until the
// grid this one depends on has completed and its writes are visible (a no-op
// in a launch without the programmatic attribute), and let this grid's own
// dependents be scheduled.
__device__ __forceinline__ void grid_dependency_wait() {
  asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
}

__global__ void __launch_bounds__(kThreads)
hash_lookup_kernel(const int32_t* __restrict__ coords,
                   const int32_t* __restrict__ fp, int n, uint32_t mask,
                   int max_probe, int32_t* __restrict__ slot) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  grid_dependency_wait();
  if (i == 0) atomicAdd(&g_runs[kRunLookup], 1ULL);
  if (i >= n) return;  // an exited thread counts as released
  const Key k = load_key(coords, i);
  const Probe pr = probe_of(k, mask);
  const int32_t f = max_probe > 0 ? __ldg(fp + pr.h0) : 0;
  launch_dependents();
  slot[i] = max_probe > 0 ? finish_chain(fp, pr.h0, pr.fpq, mask, max_probe, 0,
                                         pr.h0, f)
                          : -1;
}

// kP = 2: _lookup_with_neighbors (own voxel, then the near voxel, the near
// one taken where the own descent found no plane); kP = 1: the descent of
// lookup_planes_stack / query_planes alone.  kL levels.
template <int kP, int kL>
__global__ void __launch_bounds__(kThreads)
hash_lookup_planes_kernel(const float* __restrict__ q, int n,
                          const Divisors edge, const int32_t* __restrict__ fp,
                          uint32_t mask, const uint8_t* __restrict__ plane_valid,
                          const uint8_t* __restrict__ subdivided, int max_probe,
                          uint8_t* __restrict__ found_out,
                          int32_t* __restrict__ slot_out) {
  constexpr int kK = kP * kL;
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_runs[kRunPlanes], 1ULL);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float p[kP][3];
#pragma unroll
  for (int d = 0; d < 3; ++d) p[0][d] = __ldg(q + 3 * static_cast<int64_t>(i) + d);
  if constexpr (kP == 2) {
    const float s = edge.s[0];
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const float qs = __fdiv_rn(p[0][d], s);
      const float frac = __fsub_rn(__fsub_rn(qs, floorf(qs)), 0.5f);
      const float sgn = frac > 0.0f ? 1.0f : (frac < 0.0f ? -1.0f : 0.0f);
      const float shift = __fmul_rn(fabsf(frac) > 0.25f ? sgn : 0.0f, s);
      p[1][d] = __fadd_rn(p[0][d], shift);
    }
  }
  // every key's first round before any comparison
  Probe pr[kK];
  int32_t f[kK];
#pragma unroll
  for (int j = 0; j < kK; ++j)
    pr[j] = probe_of(voxel_key(p[j / kL], edge.s[j % kL], j % kL), mask);
  if (max_probe > 0) {
#pragma unroll
    for (int j = 0; j < kK; ++j) f[j] = __ldg(fp + pr[j].h0);
  }
  int32_t s[kK];
#pragma unroll
  for (int j = 0; j < kK; ++j)
    s[j] = max_probe > 0 ? finish_chain(fp, pr[j].h0, pr[j].fpq, mask,
                                        max_probe, 0, pr[j].h0, f[j])
                         : -1;
  // the found slots' flags, loaded together
  bool pv[kK], sub[kK];
#pragma unroll
  for (int j = 0; j < kK; ++j) {
    pv[j] = s[j] >= 0 && __ldg(plane_valid + s[j]) != 0;
    sub[j] = s[j] >= 0 && __ldg(subdivided + s[j]) != 0;
  }
  // the descent: the coarsest planar level under present, subdivided parents
  bool found[kP];
  int32_t slot[kP];
#pragma unroll
  for (int k = 0; k < kP; ++k) {
    bool fnd = false, descend = true;
    int32_t sl = 0;
#pragma unroll
    for (int l = 0; l < kL; ++l) {
      const int j = k * kL + l;
      const bool present = descend && s[j] >= 0;
      const bool use = present && pv[j] && !fnd;
      if (use) sl = s[j];
      fnd = fnd || use;
      descend = present && sub[j];
    }
    found[k] = fnd;
    slot[k] = sl;
  }
  bool take = false;
  if constexpr (kP == 2) take = !found[0] && found[1];
  found_out[i] = (found[0] || take) ? 1 : 0;
  slot_out[i] = take ? slot[kP - 1] : slot[0];
}

// out = mask & (the key of p at `level` is present and subdivided).
__global__ void __launch_bounds__(kThreads)
hash_lookup_parent_kernel(const float* __restrict__ pts, int n, float size,
                          int level, const int32_t* __restrict__ fp,
                          uint32_t mask, const uint8_t* __restrict__ subdivided,
                          const uint8_t* __restrict__ in_mask, int max_probe,
                          uint8_t* __restrict__ out) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_runs[kRunParent], 1ULL);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  bool keep = false;
  if (__ldg(in_mask + i) != 0 && max_probe > 0) {  // else false, as m & ...
    float p[3];
#pragma unroll
    for (int d = 0; d < 3; ++d) p[d] = __ldg(pts + 3 * static_cast<int64_t>(i) + d);
    const Probe pr = probe_of(voxel_key(p, size, level), mask);
    const int32_t s = finish_chain(fp, pr.h0, pr.fpq, mask, max_probe, 0,
                                   pr.h0, __ldg(fp + pr.h0));
    keep = s >= 0 && __ldg(subdivided + s) != 0;
  }
  out[i] = keep ? 1 : 0;
}

// out[27 a + j] = the slot of keys[slots[a]] + (_OFFS[j], 0) with the 4th
// column 0, _OFFS[j] = (j / 9 - 1, j / 3 % 3 - 1, j % 3 - 1), a thread an
// output lane.  slots index keys as torch does (a negative slot counts from
// the end).
__global__ void __launch_bounds__(kThreads)
hash_lookup_neighbors_kernel(const int32_t* __restrict__ slots, int a_n,
                             const int32_t* __restrict__ keys,
                             const int32_t* __restrict__ fp, uint32_t mask,
                             int max_probe, int32_t* __restrict__ out) {
  if (blockIdx.x == 0 && threadIdx.x == 0)
    atomicAdd(&g_runs[kRunNeighbors], 1ULL);
  const int64_t t = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (t >= static_cast<int64_t>(a_n) * kNeighbors) return;
  const int a = static_cast<int>(t / kNeighbors);
  const int j = static_cast<int>(t - static_cast<int64_t>(a) * kNeighbors);
  int64_t sl = __ldg(slots + a);
  if (sl < 0) sl += static_cast<int64_t>(mask) + 1;
  const Key row = load_key16(keys, sl);
  const Key k = {
      static_cast<int32_t>(static_cast<uint32_t>(row.c0) + (j / 9 - 1)),
      static_cast<int32_t>(static_cast<uint32_t>(row.c1) + (j / 3 % 3 - 1)),
      static_cast<int32_t>(static_cast<uint32_t>(row.c2) + (j % 3 - 1)), 0};
  const Probe pr = probe_of(k, mask);
  out[t] = max_probe > 0 ? finish_chain(fp, pr.h0, pr.fpq, mask, max_probe, 0,
                                        pr.h0, __ldg(fp + pr.h0))
                         : -1;
}

__global__ void __launch_bounds__(kThreads)
hash_insert_kernel(const int32_t* __restrict__ coords,
                   const uint8_t* __restrict__ valid, int u, int32_t* keys,
                   int32_t* fp, uint32_t mask, int max_probe,
                   int32_t* __restrict__ slot, uint8_t* __restrict__ state,
                   int32_t* open_flag) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_runs[kRunInsert], 1ULL);
  cg::grid_group grid = cg::this_grid();
  const int stride = gridDim.x * blockDim.x;
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  // every phase maps lane i to the same thread, so state[i] and slot[i] are
  // private to it; the round flags are zeroed before the first barrier
  for (int i = tid; i < u; i += stride) {
    state[i] = valid[i] ? kOpen : kDone;
    slot[i] = -1;
  }
  for (int r = tid; r < max_probe; r += stride) open_flag[r] = 0;

  for (int r = 0; r < max_probe; ++r) {
    // (A) read keys as the last round left them; match, or claim an empty slot
    for (int i = tid; i < u; i += stride) {
      const uint8_t s = state[i];
      if (s == kWonPending) {  // last round's winner: its fingerprint now
        fp[slot[i]] = static_cast<int32_t>(fingerprint(load_key(coords, i)));
        state[i] = kWon;
        continue;
      }
      if (s != kOpen) continue;
      const Key k = load_key(coords, i);
      const uint32_t cand =
          ((slot_hash(k) & mask) + static_cast<uint32_t>(r) * fingerprint(k)) & mask;
      const int32_t* row = keys + 4 * static_cast<int64_t>(cand);
      const int32_t k0 = __ldcg(row);
      if (k0 == k.c0 && __ldcg(row + 1) == k.c1 && __ldcg(row + 2) == k.c2 &&
          __ldcg(row + 3) == k.c3) {
        slot[i] = static_cast<int32_t>(cand);
        state[i] = kDone;
      } else if (k0 == kEmpty) {
        atomicMin(fp + cand, INT_MIN + i);
        state[i] = kAttempt;
      }
    }
    grid.sync();
    // (B) the lowest claimant of each slot writes its key; count the open
    bool open = false;
    for (int i = tid; i < u; i += stride) {
      const uint8_t s = state[i];
      if (s == kAttempt) {
        const Key k = load_key(coords, i);
        const uint32_t cand =
            ((slot_hash(k) & mask) + static_cast<uint32_t>(r) * fingerprint(k)) & mask;
        if (__ldcg(fp + cand) == INT_MIN + i) {
          int32_t* row = keys + 4 * static_cast<int64_t>(cand);
          row[0] = k.c0;
          row[1] = k.c1;
          row[2] = k.c2;
          row[3] = k.c3;
          slot[i] = static_cast<int32_t>(cand);
          state[i] = kWonPending;
        } else {
          state[i] = kOpen;
          open = true;
        }
      } else if (s == kOpen) {
        open = true;
      }
    }
    if (open) open_flag[r] = 1;
    grid.sync();
    if (__ldcg(open_flag + r) == 0) break;  // every thread reads the same value
  }
  // the last winners' fingerprints, and state -> the `new` flag
  for (int i = tid; i < u; i += stride) {
    const uint8_t s = state[i];
    if (s == kWonPending)
      fp[slot[i]] = static_cast<int32_t>(fingerprint(load_key(coords, i)));
    state[i] = (s == kWonPending || s == kWon) ? 1 : 0;
  }
}

// One block (kCluster false) or one cluster of gridDim.x blocks: lanes
// [b * per_block, (b + 1) * per_block) to block b, lane lo + t + j * blockDim
// to thread t (j < kLanesPerThread).  The same rounds as hash_insert_kernel;
// a thread issues the loads of all its lanes before it uses any, and reads
// a key row as one 16-byte load (rows are only written in phase B).
template <bool kCluster>
__global__ void __launch_bounds__(kClusterThreads)
hash_insert_cluster_kernel(const int32_t* __restrict__ coords,
                           const uint8_t* __restrict__ valid, int u,
                           int32_t* keys, int32_t* fp, uint32_t mask,
                           int max_probe, int per_block,
                           int32_t* __restrict__ slot_out,
                           uint8_t* __restrict__ new_out) {
  // this block's copy of a round's open flag, by parity (cluster form)
  __shared__ int s_open[2];
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_runs[kRunInsert], 1ULL);
  const int lo = blockIdx.x * per_block;
  const int hi = min(u, lo + per_block);
  Key key[kLanesPerThread];
  uint32_t h0[kLanesPerThread], fq[kLanesPerThread], cand[kLanesPerThread];
  int32_t slot[kLanesPerThread];
  uint8_t st[kLanesPerThread];
  bool has[kLanesPerThread];
#pragma unroll
  for (int j = 0; j < kLanesPerThread; ++j) {
    const int i = lo + threadIdx.x + j * blockDim.x;
    has[j] = i < hi;
    slot[j] = -1;
    cand[j] = 0;
    st[j] = kDone;
    if (has[j]) {
      key[j] = load_key(coords, i);
      h0[j] = slot_hash(key[j]) & mask;
      fq[j] = fingerprint(key[j]);
      st[j] = valid[i] ? kOpen : kDone;
    }
  }
  if constexpr (kCluster) {
    if (threadIdx.x < 2) s_open[threadIdx.x] = 0;
    cg::this_cluster().sync();  // every block started, the flags cleared
  }

  for (int r = 0; r < max_probe; ++r) {
    // (A) read keys as the last round left them; match, or claim an empty slot
    int4 row[kLanesPerThread];
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      if (st[j] == kOpen) {
        cand[j] = (h0[j] + static_cast<uint32_t>(r) * fq[j]) & mask;
        row[j] = __ldcg(reinterpret_cast<const int4*>(keys) + cand[j]);
      }
    }
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      const int i = lo + threadIdx.x + j * blockDim.x;
      if (st[j] == kWonPending) {  // last round's winner: its fingerprint now
        fp[slot[j]] = static_cast<int32_t>(fq[j]);
        st[j] = kWon;
      } else if (st[j] == kOpen) {
        if (row[j].x == key[j].c0 && row[j].y == key[j].c1 &&
            row[j].z == key[j].c2 && row[j].w == key[j].c3) {
          slot[j] = static_cast<int32_t>(cand[j]);
          st[j] = kDone;
        } else if (row[j].x == kEmpty) {
          atomicMin(fp + cand[j], INT_MIN + i);
          st[j] = kAttempt;
        }
      }
    }
    if constexpr (kCluster) cg::this_cluster().sync(); else __syncthreads();
    // (B) the lowest claimant of each slot writes its key; gather the open
    int32_t claim[kLanesPerThread];
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j)
      if (st[j] == kAttempt) claim[j] = __ldcg(fp + cand[j]);
    bool open = false;
#pragma unroll
    for (int j = 0; j < kLanesPerThread; ++j) {
      const int i = lo + threadIdx.x + j * blockDim.x;
      if (st[j] == kAttempt) {
        if (claim[j] == INT_MIN + i) {
          *reinterpret_cast<int4*>(keys + 4 * static_cast<int64_t>(cand[j])) =
              make_int4(key[j].c0, key[j].c1, key[j].c2, key[j].c3);
          slot[j] = static_cast<int32_t>(cand[j]);
          st[j] = kWonPending;
        } else {
          st[j] = kOpen;
          open = true;
        }
      } else if (st[j] == kOpen) {
        open = true;
      }
    }
    if constexpr (kCluster) {
      // a warp with an open lane raises the flag in every block's shared
      // memory; each block clears its flag of round r + 1, last read before
      // this round's first barrier and next raised after its second
      cg::cluster_group cluster = cg::this_cluster();
      const int lane = threadIdx.x & 31;
      if (threadIdx.x == 0) s_open[(r + 1) & 1] = 0;
      if (__any_sync(0xffffffffu, open) &&
          lane < static_cast<int>(cluster.num_blocks()))
        cluster.map_shared_rank(s_open, lane)[r & 1] = 1;
      cluster.sync();
      if (*reinterpret_cast<volatile int*>(s_open + (r & 1)) == 0) break;
    } else {
      if (!__syncthreads_or(open)) break;  // every thread gets the same value
    }
  }
  // the last winners' fingerprints, and the outputs
#pragma unroll
  for (int j = 0; j < kLanesPerThread; ++j) {
    if (!has[j]) continue;
    const int i = lo + threadIdx.x + j * blockDim.x;
    if (st[j] == kWonPending) fp[slot[j]] = static_cast<int32_t>(fq[j]);
    slot_out[i] = slot[j];
    new_out[i] = (st[j] == kWonPending || st[j] == kWon) ? 1 : 0;
  }
  // every write into another block's shared memory was made before the
  // last cluster barrier, so a block may leave now
}

// per device, cached at first use: blocks of hash_insert_kernel resident at
// once (0: not yet known), and whether a cluster of 2^k blocks of
// hash_insert_cluster_kernel fits (0 unknown, 1 yes)
int g_resident[kMaxDevices];
int g_cluster_fits[kMaxDevices][4];

int current_device(int* dev) {
  cudaError_t err = cudaGetDevice(dev);
  if (err == cudaSuccess && (*dev < 0 || *dev >= kMaxDevices))
    err = cudaErrorInvalidDevice;
  return static_cast<int>(err);
}

// blocks of hash_insert_kernel that can be resident on device dev at once
int resident_blocks(int dev, int* out) {
  if (g_resident[dev] > 0) {
    *out = g_resident[dev];
    return 0;
  }
  int coop = 0, sms = 0, per_sm = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hash_insert_kernel, kThreads, 0);
  if (err == cudaSuccess && per_sm * sms <= 0) err = cudaErrorInvalidConfiguration;
  if (err == cudaSuccess) g_resident[dev] = per_sm * sms;
  *out = per_sm * sms;
  return static_cast<int>(err);
}

// one cluster of `blocks` blocks: refused unless the device can hold one
int launch_cluster(int dev, int blocks, int per_block, const int32_t* coords,
                   const uint8_t* valid, int u, int32_t* keys, int32_t* fp,
                   uint32_t mask, int max_probe, int32_t* slot,
                   uint8_t* new_flag, cudaStream_t stream) {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = blocks;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  int k = 0;
  while ((2 << k) <= blocks) ++k;  // blocks = 2^k
  if (!g_cluster_fits[dev][k]) {
    int clusters = 0;
    cudaError_t err = cudaOccupancyMaxActiveClusters(
        &clusters, hash_insert_cluster_kernel<true>, &cfg);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (clusters < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    g_cluster_fits[dev][k] = 1;
  }
  cudaError_t e = cudaLaunchKernelEx(&cfg, hash_insert_cluster_kernel<true>,
                                     coords, valid, u, keys, fp, mask,
                                     max_probe, per_block, slot, new_flag);
  cudaError_t last = cudaGetLastError();  // clears the launch's error, if any
  return static_cast<int>(e != cudaSuccess ? e : last);
}

}  // namespace

namespace {

template <int kP, int kL>
cudaError_t launch_planes(const float* q, int n, const Divisors& edge,
                          const int32_t* fp, uint32_t mask,
                          const uint8_t* plane_valid,
                          const uint8_t* subdivided, int max_probe,
                          uint8_t* found, int32_t* slot, cudaStream_t s) {
  hash_lookup_planes_kernel<kP, kL><<<(n + kThreads - 1) / kThreads, kThreads,
                                      0, s>>>(q, n, edge, fp, mask, plane_valid,
                                              subdivided, max_probe, found,
                                              slot);
  return cudaGetLastError();
}

template <int kP>
cudaError_t launch_planes_levels(int levels, const float* q, int n,
                                 const Divisors& edge, const int32_t* fp,
                                 uint32_t mask, const uint8_t* plane_valid,
                                 const uint8_t* subdivided, int max_probe,
                                 uint8_t* found, int32_t* slot,
                                 cudaStream_t s) {
  switch (levels) {
#define IMMESH_PLANES_CASE(L)                                                \
  case L:                                                                    \
    return launch_planes<kP, L>(q, n, edge, fp, mask, plane_valid, subdivided, \
                                max_probe, found, slot, s);
    IMMESH_PLANES_CASE(1)
    IMMESH_PLANES_CASE(2)
    IMMESH_PLANES_CASE(3)
    IMMESH_PLANES_CASE(4)
#undef IMMESH_PLANES_CASE
    default:
      return cudaErrorInvalidValue;
  }
}

bool table_ok(int capacity, int max_probe) {
  return capacity > 0 && (capacity & (capacity - 1)) == 0 && max_probe >= 0;
}

}  // namespace

// coords (n, 4) int32, fp (capacity,) int32 -> slot (n,) int32, launched
// as a programmatic dependent of the stream's previous kernel.
extern "C" int hash_lookup_launch(const int32_t* coords, const int32_t* fp,
                                  int n, int capacity, int max_probe,
                                  int32_t* slot, void* stream) {
  if (n < 0 || !table_ok(capacity, max_probe))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.gridDim = dim3((n + kThreads - 1) / kThreads);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, hash_lookup_kernel, coords, fp, n,
                                     static_cast<uint32_t>(capacity - 1),
                                     max_probe, slot);
  cudaError_t last = cudaGetLastError();  // clears the launch's error, if any
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// The planes form's largest level count.
extern "C" int hash_lookup_planes_max_levels() { return kMaxLevels; }

// q (n, 3) f32 points, sizes[levels] the host's f32 voxel edge of each level,
// fp (capacity,) int32, plane_valid and subdivided (capacity,) bool ->
// found (n,) bool, slot (n,) int32.  near 1: own and near voxel; 0: own.
extern "C" int hash_lookup_planes_launch(const float* q, int n,
                                         const float* sizes, int levels,
                                         int near, const int32_t* fp,
                                         int capacity,
                                         const uint8_t* plane_valid,
                                         const uint8_t* subdivided,
                                         int max_probe, uint8_t* found,
                                         int32_t* slot, void* stream) {
  if (n < 0 || !table_ok(capacity, max_probe) || levels < 1 ||
      levels > kMaxLevels || (near != 0 && near != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Divisors edge = {};
  for (int l = 0; l < levels; ++l) edge.s[l] = sizes[l];
  const uint32_t mask = static_cast<uint32_t>(capacity - 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      near ? launch_planes_levels<2>(levels, q, n, edge, fp, mask, plane_valid,
                                     subdivided, max_probe, found, slot, s)
           : launch_planes_levels<1>(levels, q, n, edge, fp, mask, plane_valid,
                                     subdivided, max_probe, found, slot, s));
}

// pts (n, 3) f32, size the f32 voxel edge of `level`, fp (capacity,) int32,
// subdivided (capacity,) bool, mask (n,) bool -> out (n,) bool.
extern "C" int hash_lookup_parent_launch(const float* pts, int n, float size,
                                         int level, const int32_t* fp,
                                         int capacity,
                                         const uint8_t* subdivided,
                                         const uint8_t* mask, int max_probe,
                                         uint8_t* out, void* stream) {
  if (n < 0 || !table_ok(capacity, max_probe))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  hash_lookup_parent_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                              static_cast<cudaStream_t>(stream)>>>(
      pts, n, size, level, fp, static_cast<uint32_t>(capacity - 1),
      subdivided, mask, max_probe, out);
  return static_cast<int>(cudaGetLastError());
}

// slots (a,) int32 into keys (capacity, 4) int32 (16-byte aligned), fp
// (capacity,) int32 -> out (a * 27,) int32.
extern "C" int hash_lookup_neighbors_launch(const int32_t* slots, int a,
                                            const int32_t* keys,
                                            const int32_t* fp, int capacity,
                                            int max_probe, int32_t* out,
                                            void* stream) {
  if (a < 0 || !table_ok(capacity, max_probe))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a == 0) return 0;
  const int64_t lanes = static_cast<int64_t>(a) * kNeighbors;
  hash_lookup_neighbors_kernel<<<static_cast<unsigned>((lanes + kThreads - 1) /
                                                       kThreads),
                                 kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(
      slots, a, keys, fp, static_cast<uint32_t>(capacity - 1), max_probe, out);
  return static_cast<int>(cudaGetLastError());
}

// The largest u the cluster form takes (path 1); larger inserts take the
// cooperative form (path 0).
extern "C" int hash_insert_cluster_max_lanes() { return kClusterMaxLanes; }

// coords (u, 4) int32, valid (u,) bool, keys (capacity, 4) and fp
// (capacity,) int32 updated in place -> slot (u,) int32, new (u,) bool.
// path 1: one block (u <= kLanesPerBlock) or one cluster of 2, 4 or 8
// blocks (u <= kClusterMaxLanes, else cudaErrorInvalidValue); path 0: the
// cooperative grid, with open_flag a (max_probe,) int32 scratch.
extern "C" int hash_insert_launch(const int32_t* coords, const uint8_t* valid,
                                  int u, int32_t* keys, int32_t* fp,
                                  int capacity, int max_probe, int32_t* slot,
                                  uint8_t* new_flag, int32_t* open_flag,
                                  int path, void* stream) {
  if (u < 0 || capacity <= 0 || (capacity & (capacity - 1)) != 0 ||
      max_probe < 0 || (path != 0 && path != 1) ||
      (path == 1 && u > kClusterMaxLanes) ||
      (path == 0 && max_probe > 0 && open_flag == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (u == 0) return 0;
  int dev = 0;
  int err = current_device(&dev);
  if (err != 0) return err;
  uint32_t mask = static_cast<uint32_t>(capacity - 1);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (path == 1) {
    int blocks = 1;
    while (blocks * kLanesPerBlock < u) blocks *= 2;
    if (blocks == 1) {
      const int per_thread = (u + kClusterThreads - 1) / kClusterThreads;
      int threads = (u + per_thread - 1) / per_thread;
      threads = (threads + 31) / 32 * 32;
      hash_insert_cluster_kernel<false><<<1, threads, 0, s>>>(
          coords, valid, u, keys, fp, mask, max_probe, u, slot, new_flag);
      return static_cast<int>(cudaGetLastError());
    }
    return launch_cluster(dev, blocks, (u + blocks - 1) / blocks, coords,
                          valid, u, keys, fp, mask, max_probe, slot, new_flag,
                          s);
  }
  int resident = 0;
  err = resident_blocks(dev, &resident);
  if (err != 0) return err;
  int blocks = (u + kThreads - 1) / kThreads;
  if (blocks > resident) blocks = resident;
  void* args[] = {&coords, &valid, &u, &keys, &fp, &mask, &max_probe,
                  &slot, &new_flag, &open_flag};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(hash_insert_kernel), dim3(blocks),
      dim3(kThreads), args, 0, s);
  cudaError_t last = cudaGetLastError();  // clears the launch's error, if any
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// out[0 .. kRunKinds): the lookup (the coords form), insert, planes, parent
// and neighbours kernels' runs on the current device since the last reset.
// Synchronous; returns the CUDA error.
extern "C" int hash_probe_runs(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_runs, sizeof(g_runs)));
}

// The number of run counters (kernels/hash_probe.py checks its own).
extern "C" int hash_probe_run_kinds() { return kRunKinds; }

// Every counter of the current device to 0.  Synchronous; returns the CUDA
// error.
extern "C" int hash_probe_reset_runs() {
  const unsigned long long zero[kRunKinds] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_runs, zero, sizeof(zero)));
}
