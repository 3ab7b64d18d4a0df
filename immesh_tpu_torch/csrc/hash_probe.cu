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
// hash_lookup_kernel: one thread a lane, each running its own probe loop over
// fp, which a lookup never changes.  A lane stops at the first slot whose
// fingerprint equals its own (found) or is 0 (absent, -1).  Lanes are
// independent and a lane that is done never changes its slot again, so this
// is exactly the batched loop's result.  Fingerprints only, as in the
// reference: a collision inside a chain aliases the lookup.
//
// hash_insert_kernel: the reference's round-synchronous find-or-insert of
// unique keys.  In round r every unresolved lane reads `keys` as round r - 1
// left them; a full-key match takes that slot; among the lanes that attempt
// one empty slot the lowest lane id wins and writes keys and fp in place; the
// loop ends when no lane is unresolved or after max_probe rounds.  A per-lane
// atomicCAS loop (first to arrive wins) would give another slot layout, so
// the rounds are kept, as
//   * one cooperative launch (cudaLaunchCooperativeKernel), lanes taken
//     grid-stride by a grid of as many blocks as can be resident at once,
//     two grid.sync() a round: (A) read keys and claim, | (B) winner check
//     and key write, count unresolved lanes, | exit test.  One launch a call
//     and no host read at all; the alternative, up to max_probe launches of
//     a round kernel that each return at once when a device counter reads
//     zero, pays a launch and its host time for every round up to max_probe
//     instead of one grid barrier for every round actually run.
//   * The claim tournament runs on fp itself, with no scratch to allocate or
//     restore: an attempted slot is empty (keys[s][0] == EMPTY and fp[s] == 0,
//     as every insert writes both), so each attempting lane i does
//     atomicMin(&fp[s], INT_MIN + i) in phase A; in phase B the lane that
//     reads its own value back is the lowest and writes keys[s]; its
//     fingerprint goes into fp[s] in the next round's phase A (or after the
//     loop), when no lane reads fp and none claims s, because s no longer
//     reads as empty.
//   * Per-lane state lives in the `new` output's bytes until the last pass
//     turns it into the flag; slots start at -1 (invalid lanes, exhaustion).
//   * Data written by other blocks during the launch (keys, fp, the round
//     flags) is read with ld.global.cg, from L2, never from a stale L1 line.
//
// Thread 0 of block 0 of either kernel adds one to its device counter,
// g_runs[0] (lookup) or g_runs[1] (insert): the kernels' runs on the device,
// eager or replayed in a CUDA graph, read back by hash_probe_runs.
//
// Cost: both are bound by memory latency, not by bytes or operations: every
// probe round is one dependent random 32-byte sector per lane (fp for a
// lookup, the 16-byte key row for an insert), and the insert adds an atomic
// per attempt and two grid barriers a round.  At the plane map's ~10 % load
// nearly every lane resolves in one or two rounds.

#include <climits>
#include <cstdint>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int32_t kEmpty = 0x7FFFFFFF;
constexpr int kThreads = 256;

// runs of the lookup (0) and insert (1) kernels on the current device since
// the last hash_probe_reset_runs
__device__ unsigned long long g_runs[2];

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

__global__ void __launch_bounds__(kThreads)
hash_lookup_kernel(const int32_t* __restrict__ coords,
                   const int32_t* __restrict__ fp, int n, uint32_t mask,
                   int max_probe, int32_t* __restrict__ slot) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_runs[0], 1ULL);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const Key k = load_key(coords, i);
  const uint32_t h0 = slot_hash(k) & mask;
  const uint32_t fpq = fingerprint(k);
  int32_t out = -1;
  for (int r = 0; r < max_probe; ++r) {
    const uint32_t cand = (h0 + static_cast<uint32_t>(r) * fpq) & mask;
    const int32_t f = __ldg(fp + cand);
    if (f == static_cast<int32_t>(fpq)) {  // fpq is odd: a match is never empty
      out = static_cast<int32_t>(cand);
      break;
    }
    if (f == 0) break;  // an empty slot before a match: absent
  }
  slot[i] = out;
}

__global__ void __launch_bounds__(kThreads)
hash_insert_kernel(const int32_t* __restrict__ coords,
                   const uint8_t* __restrict__ valid, int u, int32_t* keys,
                   int32_t* fp, uint32_t mask, int max_probe,
                   int32_t* __restrict__ slot, uint8_t* __restrict__ state,
                   int32_t* open_flag) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_runs[1], 1ULL);
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

// blocks of hash_insert_kernel that can be resident on the current device
// at once (host-side queries, a few microseconds)
int resident_blocks(int* out) {
  int dev = 0, coop = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (err == cudaSuccess && !coop) err = cudaErrorNotSupported;
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, hash_insert_kernel, kThreads, 0);
  if (err == cudaSuccess && per_sm * sms <= 0) err = cudaErrorInvalidConfiguration;
  *out = per_sm * sms;
  return static_cast<int>(err);
}

}  // namespace

// coords (n, 4) int32, fp (capacity,) int32 -> slot (n,) int32.
extern "C" int hash_lookup_launch(const int32_t* coords, const int32_t* fp,
                                  int n, int capacity, int max_probe,
                                  int32_t* slot, void* stream) {
  if (n < 0 || capacity <= 0 || (capacity & (capacity - 1)) != 0 || max_probe < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  hash_lookup_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      coords, fp, n, static_cast<uint32_t>(capacity - 1), max_probe, slot);
  return static_cast<int>(cudaGetLastError());
}

// coords (u, 4) int32, valid (u,) bool, keys (capacity, 4) and fp
// (capacity,) int32 updated in place -> slot (u,) int32, new (u,) bool;
// open_flag is (max_probe,) int32 scratch.
extern "C" int hash_insert_launch(const int32_t* coords, const uint8_t* valid,
                                  int u, int32_t* keys, int32_t* fp,
                                  int capacity, int max_probe, int32_t* slot,
                                  uint8_t* new_flag, int32_t* open_flag,
                                  void* stream) {
  if (u < 0 || capacity <= 0 || (capacity & (capacity - 1)) != 0 || max_probe < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (u == 0) return 0;
  int resident = 0;
  int err = resident_blocks(&resident);
  if (err != 0) return err;
  int blocks = (u + kThreads - 1) / kThreads;
  if (blocks > resident) blocks = resident;
  uint32_t mask = static_cast<uint32_t>(capacity - 1);
  void* args[] = {&coords, &valid, &u, &keys, &fp, &mask, &max_probe,
                  &slot, &new_flag, &open_flag};
  cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(hash_insert_kernel), dim3(blocks),
      dim3(kThreads), args, 0, static_cast<cudaStream_t>(stream));
  cudaError_t last = cudaGetLastError();  // clears the launch's error, if any
  return static_cast<int>(e != cudaSuccess ? e : last);
}

// out[0], out[1]: the lookup and insert kernels' runs on the current device
// since the last reset.  Synchronous; returns the CUDA error.
extern "C" int hash_probe_runs(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_runs, sizeof(g_runs)));
}

// Both counters of the current device to 0.  Synchronous; returns the CUDA
// error.
extern "C" int hash_probe_reset_runs() {
  const unsigned long long zero[2] = {0, 0};
  return static_cast<int>(cudaMemcpyToSymbol(g_runs, zero, sizeof(zero)));
}
