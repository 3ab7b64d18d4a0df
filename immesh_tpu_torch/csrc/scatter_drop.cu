// Drop-mode masked scatter for Hopper (sm_90a), one launch for a group of
// fields that share their lanes:
//
//   set:  dst_f[idx[l]]  = src_f[l]   for every field f, every lane l with ok[l]
//   add:  dst_f[idx[l]] += src_f[l]   (f32 only)
//
// The counterpart of the XLA scatters the reference compiles into its step,
// `dst.at[jnp.where(ok, idx, cap)].set(src, mode="drop")` and `.add(...)`
// (immesh_tpu/map/voxel_map.py:180-183 and :212 on, and every other map
// write of the LIO and mesh steps).  Where the reference writes several
// fields through one (idx, ok) — the voxel map's four moments, its eight
// plane fields, the mesh map's slot rows — the port writes them in one
// launch: the per-launch floor was the kernel's whole cost.  No host read,
// no allocation, so the call is captured into a CUDA graph as one node.
//
// Layout: every dst is (rows, row_elems_f) elements of elem_bytes_f each,
// contiguous, all with one `rows`; idx and ok are the lanes (int32 or int64,
// and bool); src_f is a (lanes, row_elems_f) strided view, or one scalar
// given by its bits.  The fields travel by value in one kernel-parameter
// struct (Group): a graph bakes the parameters in, and nothing is read from
// device memory to find the fields.
//
// Mapping: a group of `width` threads (a power of two up to a warp) a lane,
// grid-stride over the lanes, so a launch of any size takes a grid of at
// most the blocks the card holds at once.
//   * Each thread reads the lane's ok and idx once (a broadcast within the
//     group) and resolves the target once: a negative one from the end
//     (t + rows), one that still lies outside [0, rows) dropped, as the
//     reference's mode="drop" drops its index `cap`.
//   * A field's row moves in pieces: 16 bytes (uint4) where the row bytes,
//     dst, src and src's lane stride are 16-byte aligned and src's row is
//     contiguous, else one element of the field's size; the group's threads
//     take the pieces of every field side by side.  Each thread issues its
//     src loads of every field before the lane's ok/idx are known, and
//     stores after, so the loads of a lane are in flight together.
//   * set moves bits, whatever the dtype: the bits of index_put.
//   * add is a plain read-add-write (float4 or f32): the selected targets are
//     distinct at every call site, so no two threads touch one element, and
//     one f32 add a target gives the bits of index_add_ (no atomics, no
//     order to fix).
//   * No 64-bit division: the lane of a thread is a shift.
//   * thread 0 of block 0 adds one to the device counter g_runs a launch: the
//     runs of the kernel on the device, eager or replayed in a CUDA graph,
//     read back by scatter_drop_runs.
//
// Cost: bound by bytes (each lane's ok read once, each selected lane's idx,
// src rows and dst rows once); at the step's sizes (about 10^3-10^4 lanes of
// 1-8 fields of 1-6 words, 192 for the mesh map's slot rows) a launch is
// about a microsecond of memory latency and the launch itself, far above
// that bound, which is why the fields go together.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxFields = 8;

// runs of the kernel on the current device since the last
// scatter_drop_reset_runs
__device__ unsigned long long g_runs;

struct Field {
  void* dst;
  const void* src;        // nullptr: every lane writes scalar_bits
  int64_t s_lane;         // src strides, in elements
  int64_t s_elem;
  uint64_t scalar_bits;   // the low elem_bytes bytes, little-endian
  int32_t elem_bytes;     // 1, 2, 4 or 8
  int32_t pieces;         // pieces a row moves in
  int32_t vec;            // 1: a piece is 16 bytes, else one element
  int32_t row_bytes;
};

struct Group {
  Field f[kMaxFields];
  const void* idx;
  const uint8_t* ok;
  int64_t lanes;
  int64_t rows;
  int32_t n;              // fields
  int32_t max_pieces;     // most pieces of one field's row
  int32_t shift;          // log2 of the threads a lane
};

// a piece of field f's src row for lane l (or its scalar)
__device__ __forceinline__ uint4 load_src(const Field& f, int64_t l, int c) {
  uint4 v = make_uint4(0, 0, 0, 0);
  if (f.src == nullptr) {
    v.x = static_cast<uint32_t>(f.scalar_bits);
    v.y = static_cast<uint32_t>(f.scalar_bits >> 32);
    return v;
  }
  const char* base = static_cast<const char*>(f.src);
  if (f.vec) {
    return __ldg(reinterpret_cast<const uint4*>(base + l * f.s_lane *
                                                           f.elem_bytes) +
                 c);
  }
  const int64_t e = l * f.s_lane + static_cast<int64_t>(c) * f.s_elem;
  switch (f.elem_bytes) {
    case 1:
      v.x = __ldg(reinterpret_cast<const uint8_t*>(base) + e);
      break;
    case 2:
      v.x = __ldg(reinterpret_cast<const uint16_t*>(base) + e);
      break;
    case 4:
      v.x = __ldg(reinterpret_cast<const uint32_t*>(base) + e);
      break;
    default: {
      const unsigned long long w =
          __ldg(reinterpret_cast<const unsigned long long*>(base) + e);
      v.x = static_cast<uint32_t>(w);
      v.y = static_cast<uint32_t>(w >> 32);
    }
  }
  return v;
}

// write (set) or add a piece into field f's row t
template <bool kAdd>
__device__ __forceinline__ void store_dst(const Field& f, int64_t t, int c,
                                          uint4 v) {
  char* row = static_cast<char*>(f.dst) + t * f.row_bytes;
  if (f.vec) {
    uint4* p = reinterpret_cast<uint4*>(row) + c;
    if constexpr (kAdd) {
      const float4 d = *reinterpret_cast<const float4*>(p);
      float4 s;
      s.x = d.x + __uint_as_float(v.x);
      s.y = d.y + __uint_as_float(v.y);
      s.z = d.z + __uint_as_float(v.z);
      s.w = d.w + __uint_as_float(v.w);
      *reinterpret_cast<float4*>(p) = s;
    } else {
      *p = v;
    }
    return;
  }
  if constexpr (kAdd) {  // f32 only
    float* p = reinterpret_cast<float*>(row) + c;
    *p = *p + __uint_as_float(v.x);
    return;
  }
  switch (f.elem_bytes) {
    case 1:
      reinterpret_cast<uint8_t*>(row)[c] = static_cast<uint8_t>(v.x);
      break;
    case 2:
      reinterpret_cast<uint16_t*>(row)[c] = static_cast<uint16_t>(v.x);
      break;
    case 4:
      reinterpret_cast<uint32_t*>(row)[c] = v.x;
      break;
    default:
      reinterpret_cast<unsigned long long*>(row)[c] =
          static_cast<unsigned long long>(v.x) |
          (static_cast<unsigned long long>(v.y) << 32);
  }
}

template <typename I, bool kAdd>
__global__ void __launch_bounds__(kThreads)
scatter_group_kernel(const __grid_constant__ Group g) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_runs, 1ULL);
  const int width = 1 << g.shift;
  const int sub = threadIdx.x & (width - 1);
  const int64_t first =
      (static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x) >> g.shift;
  const int64_t stride = (static_cast<int64_t>(gridDim.x) * blockDim.x) >>
                         g.shift;
  const I* idx = static_cast<const I*>(g.idx);
  for (int64_t l = first; l < g.lanes; l += stride) {
    const bool sel = g.ok[l] != 0;
    const int64_t raw = static_cast<int64_t>(idx[l]);
    for (int base = 0; base < g.max_pieces; base += width) {
      const int c = base + sub;
      uint4 v[kMaxFields];
#pragma unroll
      for (int k = 0; k < kMaxFields; ++k)
        if (k < g.n && c < g.f[k].pieces) v[k] = load_src(g.f[k], l, c);
      const int64_t t = raw < 0 ? raw + g.rows : raw;  // from the end
      if (!sel || t < 0 || t >= g.rows) break;         // mode="drop"
#pragma unroll
      for (int k = 0; k < kMaxFields; ++k)
        if (k < g.n && c < g.f[k].pieces) store_dst<kAdd>(g.f[k], t, c, v[k]);
    }
  }
}

}  // namespace

// One launch for n fields (1 .. 8) that share idx (lanes,) of idx_bytes (4
// or 8) and ok (lanes,) bool.  Field k: dst[k] (rows, row_elems[k]) of
// elem_bytes[k] (1, 2, 4 or 8; 4 = f32 for add), src element (l, e) at
// src[k] + l * src_lane_stride[k] + e * src_elem_stride[k] (in elements),
// or scalar_bits[k] where src[k] is null (set only).  max_blocks caps the
// grid.  Returns the CUDA error of the launch, cudaErrorInvalidValue for
// arguments it does not take; launches nothing when lanes is 0 or every
// row is empty.
extern "C" int scatter_drop_group_launch(
    int n, void* const* dst, const long long* row_elems,
    const int* elem_bytes, const void* const* src,
    const long long* src_lane_stride, const long long* src_elem_stride,
    const unsigned long long* scalar_bits, long long rows, const void* idx,
    int idx_bytes, const void* ok, long long lanes, int add, int max_blocks,
    void* stream) {
  if (n < 1 || n > kMaxFields || rows < 0 || lanes < 0 ||
      (idx_bytes != 4 && idx_bytes != 8) || max_blocks <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Group g;
  std::memset(&g, 0, sizeof(g));
  int64_t max_pieces = 0;
  for (int k = 0; k < n; ++k) {
    const int eb = elem_bytes[k];
    const int64_t re = row_elems[k];
    if ((eb != 1 && eb != 2 && eb != 4 && eb != 8) || re < 0 ||
        (add && (eb != 4 || src[k] == nullptr)) || re * eb > INT32_MAX)
      return static_cast<int>(cudaErrorInvalidValue);
    Field& f = g.f[k];
    f.dst = dst[k];
    f.src = src[k];
    f.s_lane = src_lane_stride[k];
    f.s_elem = src_elem_stride[k];
    f.scalar_bits = scalar_bits[k];
    f.elem_bytes = eb;
    f.row_bytes = static_cast<int32_t>(re * eb);
    const auto aligned = [](const void* p) {
      return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
    };
    f.vec = src[k] != nullptr && f.row_bytes % 16 == 0 && re > 0 &&
            (f.s_elem == 1 || re == 1) && (f.s_lane * eb) % 16 == 0 &&
            aligned(dst[k]) && aligned(src[k]);
    f.pieces = static_cast<int32_t>(f.vec ? f.row_bytes / 16 : re);
    if (f.pieces > max_pieces) max_pieces = f.pieces;
  }
  if (lanes == 0 || max_pieces == 0) return 0;
  int shift = 0;
  while ((1 << shift) < max_pieces && shift < 5) ++shift;
  g.idx = idx;
  g.ok = static_cast<const uint8_t*>(ok);
  g.lanes = lanes;
  g.rows = rows;
  g.n = n;
  g.max_pieces = static_cast<int32_t>(max_pieces);
  g.shift = shift;
  int64_t blocks = ((lanes << shift) + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid(static_cast<unsigned>(blocks));
  if (idx_bytes == 4) {
    if (add)
      scatter_group_kernel<int32_t, true><<<grid, kThreads, 0, s>>>(g);
    else
      scatter_group_kernel<int32_t, false><<<grid, kThreads, 0, s>>>(g);
  } else {
    if (add)
      scatter_group_kernel<int64_t, true><<<grid, kThreads, 0, s>>>(g);
    else
      scatter_group_kernel<int64_t, false><<<grid, kThreads, 0, s>>>(g);
  }
  return static_cast<int>(cudaGetLastError());
}

// *out: the kernel's runs on the current device since the last reset.
// Synchronous; returns the CUDA error.
extern "C" int scatter_drop_runs(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_runs, sizeof(g_runs)));
}

// The current device's counter to 0.  Synchronous; returns the CUDA error.
extern "C" int scatter_drop_reset_runs() {
  const unsigned long long zero = 0;
  return static_cast<int>(cudaMemcpyToSymbol(g_runs, &zero, sizeof(zero)));
}
