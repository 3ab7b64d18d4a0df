// Drop-mode masked scatter for Hopper (sm_90a):
//
//   set:  dst[idx[l]]  = src[l]   for every lane l with ok[l]
//   add:  dst[idx[l]] += src[l]   (f32 only)
//
// The counterpart of the XLA scatters the reference compiles into its step,
// `dst.at[jnp.where(ok, idx, cap)].set(src, mode="drop")` and `.add(...)`
// (immesh_tpu/map/voxel_map.py:180-183 and :212 on, and every other map
// write of the LIO and mesh steps).  The port ran each as nonzero → index_put,
// and the nonzero reads the count of selected lanes back on the host: a
// device sync at every call, and a capture of the step as a CUDA graph
// impossible.  This kernel is one launch with no host read and no allocation.
//
// Layout: dst is (rows, row_elems) elements of elem_bytes each, contiguous;
// idx and ok are the lanes (int32 or int64, and bool); src is a (lanes,
// row_elems) strided view, or one scalar given by its bits.  One thread per
// (lane, element), grid-stride over lanes × row_elems, so a launch of any size
// takes a grid of at most the blocks the card holds at once.
//   * set moves each element as an unsigned word of its size (1, 2, 4 or 8
//     bytes): the bits of index_put, whatever the dtype.
//   * add is a plain read-add-write: the selected targets are distinct at
//     every call site, so no two threads touch one element, and one f32 add a
//     target gives the bits of index_add_ (no atomics, no order to fix).
//   * a selected lane's target is read as the reference's mode="drop" reads
//     it: a negative one from the end (t + rows), and one that still lies
//     outside [0, rows) dropped, as the reference drops its index `cap`.
//   * thread 0 of block 0 adds one to the device counter g_runs: the runs of
//     the kernel on the device, eager or replayed in a CUDA graph, read back
//     by scatter_drop_runs.
//
// Cost: bound by bytes (each lane's idx, ok and src row read once, each
// selected row written once); at the step's sizes (up to ~10^4 lanes of 1-6
// words, 144 for the mesh map's slot rows) a launch is a few microseconds of
// latency, far above that bound.

#include <cstdint>
#include <cstring>

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

// runs of the kernel (set and add) on the current device since the last
// scatter_drop_reset_runs
__device__ unsigned long long g_runs;

template <typename T, typename I, bool kAdd>
__global__ void __launch_bounds__(kThreads)
scatter_drop_kernel(T* __restrict__ dst, int64_t rows, int64_t row_elems,
                    const I* __restrict__ idx, const uint8_t* __restrict__ ok,
                    int64_t lanes, const T* __restrict__ src, int64_t s_lane,
                    int64_t s_elem, T scalar, bool use_scalar) {
  if (blockIdx.x == 0 && threadIdx.x == 0) atomicAdd(&g_runs, 1ULL);
  const int64_t total = lanes * row_elems;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t w = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       w < total; w += stride) {
    const int64_t l = w / row_elems;
    if (!ok[l]) continue;
    int64_t t = static_cast<int64_t>(idx[l]);
    if (t < 0) t += rows;              // from the end, as the reference
    if (t < 0 || t >= rows) continue;  // mode="drop"
    const int64_t e = w - l * row_elems;
    const T v = use_scalar ? scalar : src[l * s_lane + e * s_elem];
    T* p = dst + t * row_elems + e;
    if constexpr (kAdd) {
      *p = *p + v;
    } else {
      *p = v;
    }
  }
}

template <typename T, typename I, bool kAdd>
int launch(void* dst, int64_t rows, int64_t row_elems, const void* idx,
           const void* ok, int64_t lanes, const void* src, int64_t s_lane,
           int64_t s_elem, uint64_t scalar_bits, bool use_scalar,
           int max_blocks, cudaStream_t stream) {
  T scalar;
  std::memcpy(&scalar, &scalar_bits, sizeof(T));  // the low bytes, little-endian
  const int64_t total = lanes * row_elems;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > max_blocks) blocks = max_blocks;
  scatter_drop_kernel<T, I, kAdd><<<static_cast<unsigned>(blocks), kThreads, 0,
                                    stream>>>(
      static_cast<T*>(dst), rows, row_elems, static_cast<const I*>(idx),
      static_cast<const uint8_t*>(ok), lanes, static_cast<const T*>(src),
      s_lane, s_elem, scalar, use_scalar);
  return static_cast<int>(cudaGetLastError());
}

template <typename I>
int launch_idx(int elem_bytes, int add, void* dst, int64_t rows,
               int64_t row_elems, const void* idx, const void* ok,
               int64_t lanes, const void* src, int64_t s_lane, int64_t s_elem,
               uint64_t scalar_bits, bool use_scalar, int max_blocks,
               cudaStream_t stream) {
#define SCATTER_DROP_ARGS                                                   \
  dst, rows, row_elems, idx, ok, lanes, src, s_lane, s_elem, scalar_bits,   \
      use_scalar, max_blocks, stream
  if (add) return launch<float, I, true>(SCATTER_DROP_ARGS);
  switch (elem_bytes) {
    case 1: return launch<uint8_t, I, false>(SCATTER_DROP_ARGS);
    case 2: return launch<uint16_t, I, false>(SCATTER_DROP_ARGS);
    case 4: return launch<uint32_t, I, false>(SCATTER_DROP_ARGS);
    default: return launch<uint64_t, I, false>(SCATTER_DROP_ARGS);
  }
#undef SCATTER_DROP_ARGS
}

}  // namespace

// dst (rows, row_elems) of elem_bytes (1, 2, 4 or 8; 4 = f32 for add),
// idx (lanes,) of idx_bytes (4 or 8), ok (lanes,) bool, src element (l, e)
// at src + l * src_lane_stride + e * src_elem_stride (in elements), or the
// scalar's bits when use_scalar; max_blocks caps the grid.  Returns the CUDA
// error of the launch, cudaErrorInvalidValue for arguments it does not take;
// launches nothing when lanes * row_elems is 0.
extern "C" int scatter_drop_launch(void* dst, long long rows,
                                   long long row_elems, int elem_bytes,
                                   const void* idx, int idx_bytes,
                                   const void* ok, long long lanes,
                                   const void* src, long long src_lane_stride,
                                   long long src_elem_stride,
                                   unsigned long long scalar_bits,
                                   int use_scalar, int add, int max_blocks,
                                   void* stream) {
  const bool sized = elem_bytes == 1 || elem_bytes == 2 || elem_bytes == 4 ||
                     elem_bytes == 8;
  if (rows < 0 || row_elems < 0 || lanes < 0 || !sized ||
      (idx_bytes != 4 && idx_bytes != 8) || (add && elem_bytes != 4) ||
      max_blocks <= 0 || (!use_scalar && src == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (lanes == 0 || row_elems == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (idx_bytes == 4)
    return launch_idx<int32_t>(elem_bytes, add, dst, rows, row_elems, idx, ok,
                               lanes, src, src_lane_stride, src_elem_stride,
                               scalar_bits, use_scalar != 0, max_blocks, s);
  return launch_idx<int64_t>(elem_bytes, add, dst, rows, row_elems, idx, ok,
                             lanes, src, src_lane_stride, src_elem_stride,
                             scalar_bits, use_scalar != 0, max_blocks, s);
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
