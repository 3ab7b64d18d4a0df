// Segmented sum for Hopper (sm_90a):
//
//   out[s, c] = Σ values[order[j], c]   for j in [offsets[s], offsets[s + 1]),
//
// each column added one row at a time in j order, from +0.0.
//
// The counterpart of the reference's `jax.ops.segment_sum` in the scan
// downsample and the map update's levels (immesh_tpu/lio/downsample.py:31,
// immesh_tpu/map/voxel_map.py:164) and in window BA and the dp LIO
// (immesh_tpu/dist/window_ba.py:127-133, immesh_tpu/dist/lio.py:143): an
// XLA scatter-add, not a Pallas kernel.  core/ops.py::segment_sum sorts the
// rows by segment id (a stable argsort, so a segment's rows keep their
// input order) and finds the offsets by a search of the sorted ids; this
// kernel then reads each segment's rows through `order` (the gather is
// fused in) and writes its sum.  Rows whose id lies outside [0, S) sit
// before offsets[0] or after offsets[S] and are never read: they are
// dropped, as jax.ops.segment_sum drops them.  No host read, no
// allocation, so the call is captured into a CUDA graph (and into an IF
// node's body) as one node.
//
// Bits: a segment's sum is the sequential one, the order of a sequential
// scatter-add and of ATen's segment_reduce kernel that this replaced on the
// card, so the result is the same on every run and equals the CPU's.  No
// atomics, no contraction (-fmad=false).
//
// Cost: bound by bytes, about 1 µs a call at the scan's size (131,072 rows
// of 16 B and their 8 B order entries over 3.35 TB/s); ATen's kernel gave
// each (segment, column) one thread that loaded its rows one at a time
// from device memory, ~40 ns a row, so it ran as long as its longest
// segment — usually the discarded one its callers then sliced off.  Here
// the serial chain stays (the bits depend on it) but takes its rows from
// shared memory, 4 a 16-byte load, while the next tile's loads are in
// flight.  On an H100 a 3,229-row segment alone takes ~21 µs, ~6.6 ns a
// row: ~3 ns of dependent adds and the tile's gather latency, which add up
// rather than overlap (a 4-stage cp.async ring, one shared load a row, ran
// slower).
//
// Mapping: one warp a segment, kWarps a block; grid.y takes the columns
// 32 at a time.  The warp walks its segment in tiles of kTile = 32·kR rows:
//   * lane t gathers the tile's rows t, t + 32, ...: their order entries
//     (coalesced 8-byte loads) and their columns (one float4 a 4 columns
//     where the rows are 16-byte aligned and contiguous, else one float a
//     column); a row past the segment's end reads nothing and holds +0.0;
//   * the tile goes to the warp's slice of shared memory, column-major with
//     a pitch of kTile + 4 floats (16-byte aligned, no bank conflict either
//     way);
//   * lanes c < C add their column down the tile, 4 rows a 16-byte shared
//     load.  The tile's rows past the segment's end are +0.0, and
//     x + (+0.0) = x for every x the sum can hold (it starts at +0.0, and a
//     round-to-nearest sum is −0.0 only when both terms are), so the padding
//     leaves the bits unchanged;
//   * software pipeline: while a tile is summed, the next tile's rows are in
//     flight in registers and the order entries of the tile after it too.
// thread 0 of block (0, 0) adds one to the device counter g_runs a launch:
// the runs of the kernel on the device, eager or replayed in a CUDA graph,
// read back by segment_sum_runs.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kColsPerBlock = 32;  // columns a block sums; more go along y

// runs of the kernel on the current device since the last
// segment_sum_reset_runs
__device__ unsigned long long g_runs;

struct Args {
  const float* values;     // row r, column c at values[r * s_row + c * s_col]
  const int64_t* order;    // (N,) rows in segment order
  const int64_t* offsets;  // (S + 1,) each segment's first position
  float* out;              // (S, cols), contiguous
  int64_t s_row;           // values' strides, in elements
  int64_t s_col;
  int64_t segments;        // S
  int32_t cols;            // C
  int32_t vec;             // 1: a row's columns read 4 at a time (float4)
};

// this lane's order entries of the tile that starts at `first`: -1 past
// the segment's end
template <int kR>
__device__ __forceinline__ void load_rows(const Args& a, int64_t first,
                                          int64_t end, int lane,
                                          int64_t (&rows)[kR]) {
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const int64_t j = first + lane + 32 * i;
    rows[i] = j < end ? __ldg(a.order + j) : -1;
  }
}

// this lane's rows of a tile, columns c0 .. c0 + kC − 1: +0.0 for a row of
// -1 and for a column past the last
template <int kC, int kR>
__device__ __forceinline__ void load_values(const Args& a, int c0, int ncols,
                                            const int64_t (&rows)[kR],
                                            float (&v)[kR][kC]) {
#pragma unroll
  for (int i = 0; i < kR; ++i) {
    const bool live = rows[i] >= 0;
    const float* row =
        a.values + (live ? rows[i] : 0) * a.s_row + c0 * a.s_col;
    if (a.vec) {
#pragma unroll
      for (int c = 0; c < kC; c += 4) {
        float4 q = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (live && c < ncols) q = __ldg(reinterpret_cast<const float4*>(row + c));
        v[i][c] = q.x;
        v[i][c + 1] = q.y;
        v[i][c + 2] = q.z;
        v[i][c + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < kC; ++c)
        v[i][c] = live && c < ncols ? __ldg(row + c * a.s_col) : 0.0f;
    }
  }
}

template <int kC, int kR>
__global__ void __launch_bounds__(kThreads)
segment_sum_kernel(const __grid_constant__ Args a) {
  constexpr int kTile = 32 * kR;
  constexpr int kPitch = kTile + 4;
  __shared__ __align__(16) float tile[kWarps][kC][kPitch];
  if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x == 0)
    atomicAdd(&g_runs, 1ULL);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int64_t s = static_cast<int64_t>(blockIdx.x) * kWarps + warp;
  if (s >= a.segments) return;  // the whole warp
  const int c0 = blockIdx.y * kColsPerBlock;
  const int ncols = min(a.cols - c0, kC);
  const int64_t begin = __ldg(a.offsets + s);
  const int64_t end = __ldg(a.offsets + s + 1);
  float(*t)[kPitch] = tile[warp];

  int64_t rows[kR];
  float v[kR][kC];
  load_rows<kR>(a, begin, end, lane, rows);
  load_values<kC, kR>(a, c0, ncols, rows, v);
  load_rows<kR>(a, begin + kTile, end, lane, rows);
  float acc = 0.0f;
  for (int64_t base = begin; base < end; base += kTile) {
    // this tile into shared memory (the last chain has read the slice)
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kR; ++i)
#pragma unroll
      for (int c = 0; c < kC; ++c) t[c][lane + 32 * i] = v[i][c];
    __syncwarp();
    // the next tile's rows in flight, and the order of the one after it
    load_values<kC, kR>(a, c0, ncols, rows, v);
    load_rows<kR>(a, base + 2 * kTile, end, lane, rows);
    if (lane < ncols) {
      const int64_t left = end - base;
      const int n = left < kTile ? static_cast<int>(left) : kTile;
      const float* col = t[lane];
#pragma unroll 8
      for (int r = 0; r < n; r += 4) {
        const float4 q = *reinterpret_cast<const float4*>(col + r);
        acc = __fadd_rn(acc, q.x);
        acc = __fadd_rn(acc, q.y);
        acc = __fadd_rn(acc, q.z);
        acc = __fadd_rn(acc, q.w);
      }
    }
  }
  if (lane < ncols) a.out[s * a.cols + c0 + lane] = acc;
}

template <int kC, int kR>
int launch(const Args& a, cudaStream_t stream) {
  const dim3 grid(
      static_cast<unsigned>((a.segments + kWarps - 1) / kWarps),
      static_cast<unsigned>((a.cols + kColsPerBlock - 1) / kColsPerBlock));
  segment_sum_kernel<kC, kR><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// out (segments, cols) f32, contiguous: the sum of each segment's rows of
// values (row r, column c at values[r * s_row + c * s_col], f32), its rows
// at order[offsets[s]] .. order[offsets[s + 1] − 1] (int64 both).  Returns
// the CUDA error of the launch, cudaErrorInvalidValue for arguments it does
// not take; launches nothing when segments or cols is 0.
extern "C" int segment_sum_launch(const float* values, long long s_row,
                                  long long s_col, int cols,
                                  const long long* order,
                                  const long long* offsets,
                                  long long segments, float* out,
                                  void* stream) {
  if (cols < 0 || segments < 0 ||
      (segments + kWarps - 1) / kWarps > INT32_MAX ||
      (cols + kColsPerBlock - 1) / kColsPerBlock > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  if (segments == 0 || cols == 0) return 0;
  Args a;
  a.values = values;
  a.order = reinterpret_cast<const int64_t*>(order);
  a.offsets = reinterpret_cast<const int64_t*>(offsets);
  a.out = out;
  a.s_row = s_row;
  a.s_col = s_col;
  a.segments = segments;
  a.cols = cols;
  a.vec = s_col == 1 && cols % 4 == 0 && s_row % 4 == 0 &&
          (reinterpret_cast<uintptr_t>(values) & 15) == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cols <= 4) return launch<4, 4>(a, s);
  if (cols <= 8) return launch<8, 2>(a, s);
  if (cols <= 16) return launch<16, 1>(a, s);
  return launch<32, 1>(a, s);
}

// *out: the kernel's runs on the current device since the last reset.
// Synchronous; returns the CUDA error.
extern "C" int segment_sum_runs(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_runs, sizeof(g_runs)));
}

// The current device's counter to 0.  Synchronous; returns the CUDA error.
extern "C" int segment_sum_reset_runs() {
  const unsigned long long zero = 0;
  return static_cast<int>(cudaMemcpyToSymbol(g_runs, &zero, sizeof(zero)));
}
