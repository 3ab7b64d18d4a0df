// Edge-neighbor Delaunay argmin for Hopper (sm_90a).
//
// Replaces immesh_tpu/mesh/delaunay.py::_pairs_kernel (the Pallas TPU
// kernel launched by _pairs_argmin_tpu).  For every voxel a and directed
// pair i->j it writes
//
//   W[a,i,j] = first argmin over valid k with d > eps of Np / d, or -1,
//   d  = (p_j - p_i) x (p_k - p_i)
//   Np = (L_k - L_i)*|p_j - p_i|^2 - ((p_k - p_i).(p_j - p_i))*(L_j - L_i)
//
// with L the perturbed paraboloid lift.  Rows with i invalid are all -1, and
// a NaN ratio in a row's k-sweep gives -1, as jnp.min propagates NaN there.
//
// Arithmetic follows the Pallas kernel's formula and operation order
// (immesh_tpu/mesh/delaunay.py:351-358) with explicit round-to-nearest
// intrinsics and IEEE division; the file is also built with -fmad=false and
// without --use_fast_math, so no multiply-add is contracted and the result
// is bit-identical to the plain PyTorch version in kernels/pairs_argmin.py.
//
// Cost: it is bound by FP32 arithmetic, not memory.  At the main path's
// shape (A, K) = (512, 48) one launch runs up to A*K^3 ~ 56.6 M inner
// iterations, each with one IEEE divide, against ~5 MB of I/O (four (A, K)
// f32 inputs in, the (A, K, K) int32 table out); only voxels about half
// full of valid points bring the arithmetic down to the I/O's ~1.5 us.
// Design: one block per voxel; the voxel's K <= 128 points are staged in
// shared memory (every thread of a warp reads the same k, a broadcast), and
// threads stride over the K^2 (i, j) pairs, each running the k-sweep with a
// strict-< running minimum.  Tensor cores (wgmma), TMA and register tiling
// of the k-sweep are left to later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 128;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
pairs_argmin_kernel(const float* __restrict__ u, const float* __restrict__ v,
                    const float* __restrict__ lift,
                    const float* __restrict__ valid,
                    const float* __restrict__ d_eps, int K,
                    int* __restrict__ W) {
  __shared__ float su[kMaxK];
  __shared__ float sv[kMaxK];
  __shared__ float sl[kMaxK];
  __shared__ int sw[kMaxK];

  const int a = blockIdx.x;
  const size_t base = static_cast<size_t>(a) * K;
  for (int t = threadIdx.x; t < K; t += blockDim.x) {
    su[t] = u[base + t];
    sv[t] = v[base + t];
    sl[t] = lift[base + t];
    sw[t] = valid[base + t] > 0.0f;
  }
  __syncthreads();

  const float eps = d_eps[a];
  const float big = 3.4e38f;
  int* out = W + static_cast<size_t>(a) * K * K;
  for (int p = threadIdx.x; p < K * K; p += blockDim.x) {
    const int i = p / K;
    const int j = p - i * K;
    int res = -1;
    if (sw[i] && sw[j]) {
      const float ui = su[i], vi = sv[i], li = sl[i];
      const float du_j = __fsub_rn(su[j], ui);
      const float dv_j = __fsub_rn(sv[j], vi);
      const float dl_j = __fsub_rn(sl[j], li);
      const float e2 = __fadd_rn(__fmul_rn(du_j, du_j), __fmul_rn(dv_j, dv_j));
      float best = big;
      int bk = -1;
      bool nan = false;
      for (int k = 0; k < K; ++k) {
        if (!sw[k]) continue;
        const float du_k = __fsub_rn(su[k], ui);
        const float dv_k = __fsub_rn(sv[k], vi);
        const float d = __fsub_rn(__fmul_rn(du_j, dv_k), __fmul_rn(dv_j, du_k));
        if (!(d > eps)) continue;
        const float dl_k = __fsub_rn(sl[k], li);
        const float mp = __fadd_rn(__fmul_rn(du_k, du_j), __fmul_rn(dv_k, dv_j));
        const float np = __fsub_rn(__fmul_rn(dl_k, e2), __fmul_rn(mp, dl_j));
        const float r = __fdiv_rn(np, d);
        if (r < best) {
          best = r;
          bk = k;
        } else if (r != r) {
          nan = true;
        }
      }
      res = nan ? -1 : bk;
    }
    out[p] = res;
  }
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int pairs_argmin_launch(const float* u, const float* v,
                                   const float* lift, const float* valid,
                                   const float* d_eps, int A, int K, int* W,
                                   void* stream) {
  if (A < 0 || K <= 0 || K > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  if (A == 0) return 0;
  pairs_argmin_kernel<<<A, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      u, v, lift, valid, d_eps, K, W);
  return static_cast<int>(cudaGetLastError());
}
