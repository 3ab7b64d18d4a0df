// Delaunay incircle min-score for Hopper (sm_90a).
//
// Replaces immesh_tpu/mesh/delaunay.py::_incircle_kernel (the Pallas TPU
// kernel at :44, launched by _incircle_min_scores).  For every voxel a and
// every candidate triangle t = (ia, ib, ic) of the shared (T, 3) table it
// builds the CCW-oriented lifted plane through the three vertices and writes
//
//   out[a,t] = min_k (nx*u_k*w_k + ny*v_k*w_k + nz*L_k*w_k - off*w_k)
//
// with L the perturbed paraboloid lift and w the 1/0 validity, or -inf when
// a vertex is masked or |2*area| <= min_area[a].  A NaN score anywhere in the
// sweep gives NaN, as jnp.min propagates it; the caller's keep test
// (min >= -eps) is then false, as in the reference.
//
// Arithmetic follows a fixed, written-down operation order with explicit
// round-to-nearest intrinsics, and the file is built with -fmad=false and
// without --use_fast_math, so no multiply-add is contracted and the result
// equals the plain PyTorch version in kernels/incircle.py value for value:
//
//   e1 = b - a, e2 = c - a                       (u, v and L components)
//   area2 = e1u*e2v - e1v*e2u,  ccw = sign(area2)
//   nx = (e1v*e2l - e1l*e2v)*ccw,  ny = (e1l*e2u - e1u*e2l)*ccw,
//   nz = area2*ccw,  off = (nx*ua + ny*va) + nz*la
//   s_k = ((nx*uw_k + ny*vw_k) + nz*lw_k) - off*w_k,   uw_k = u_k*w_k, ...
//
// Cost on an H100: 14 f32 operations per (a, t) to gather the vertices and
// test the gates, 15 more to build the plane of a candidate that passes
// them, and 8 per (a, t, valid k) in its sweep (four products, three sums,
// one compare), against the (A, T) f32 output written once.  At (A, K) =
// (512, 48) with ~80 % valid points, T = C(48, 3) = 17,296: ~1.6 GFLOP
// (~24 us at 67 TFLOP/s) against 35 MB of output (~11 us at 3.35 TB/s), so
// the operations bound it; chip_smoke.py recounts both from its inputs.
// The sweep runs over all K points (a masked point scores exactly 0, as in
// the reference), so a warp with any live candidate does the full K.
//
// Design: one block per (voxel, tile of 256 candidates); the voxel's
// K <= 128 points (and their w-folded products) are staged in shared
// memory, read by the whole warp at the same k (a broadcast); one thread
// per candidate gathers its vertices, builds the plane and, when the
// candidate is not gated, runs the k-sweep with a strict-< running minimum
// and a NaN flag.  No (A, T, K) tensor and no padding of T exist.  Tensor
// cores and register tiling are later work.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 128;
constexpr int kThreads = 256;

__device__ __forceinline__ float sign_of(float x) {
  // jnp.sign: +1, -1, 0 (and NaN for NaN, which the area gate catches)
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : (x == 0.0f ? 0.0f : x));
}

__global__ void __launch_bounds__(kThreads)
incircle_kernel(const float* __restrict__ u, const float* __restrict__ v,
                const float* __restrict__ lift, const float* __restrict__ w,
                const float* __restrict__ min_area,
                const int* __restrict__ tris, int K, int T,
                float* __restrict__ out) {
  __shared__ float su[kMaxK], sv[kMaxK], sl[kMaxK], sw[kMaxK];
  __shared__ float suw[kMaxK], svw[kMaxK], slw[kMaxK];

  const int a = blockIdx.x;
  const size_t base = static_cast<size_t>(a) * K;
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const float uk = u[base + k], vk = v[base + k], lk = lift[base + k];
    const float wk = w[base + k];
    su[k] = uk;
    sv[k] = vk;
    sl[k] = lk;
    sw[k] = wk;
    suw[k] = __fmul_rn(uk, wk);
    svw[k] = __fmul_rn(vk, wk);
    slw[k] = __fmul_rn(lk, wk);
  }
  __syncthreads();

  const int t = blockIdx.y * kThreads + threadIdx.x;
  if (t >= T) return;
  const int ia = tris[3 * t], ib = tris[3 * t + 1], ic = tris[3 * t + 2];
  const float ua = su[ia], va = sv[ia], la = sl[ia];
  const float e1u = __fsub_rn(su[ib], ua);
  const float e1v = __fsub_rn(sv[ib], va);
  const float e1l = __fsub_rn(sl[ib], la);
  const float e2u = __fsub_rn(su[ic], ua);
  const float e2v = __fsub_rn(sv[ic], va);
  const float e2l = __fsub_rn(sl[ic], la);
  const float area2 = __fsub_rn(__fmul_rn(e1u, e2v), __fmul_rn(e1v, e2u));

  float res = -INFINITY;
  const bool ok = sw[ia] > 0.0f && sw[ib] > 0.0f && sw[ic] > 0.0f &&
                  fabsf(area2) > min_area[a];
  if (ok) {
    const float ccw = sign_of(area2);
    const float nx = __fmul_rn(
        __fsub_rn(__fmul_rn(e1v, e2l), __fmul_rn(e1l, e2v)), ccw);
    const float ny = __fmul_rn(
        __fsub_rn(__fmul_rn(e1l, e2u), __fmul_rn(e1u, e2l)), ccw);
    const float nz = __fmul_rn(area2, ccw);
    const float off = __fadd_rn(
        __fadd_rn(__fmul_rn(nx, ua), __fmul_rn(ny, va)), __fmul_rn(nz, la));
    float best = INFINITY;
    bool nan = false;
    for (int k = 0; k < K; ++k) {
      const float s = __fsub_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(nx, suw[k]), __fmul_rn(ny, svw[k])),
                    __fmul_rn(nz, slw[k])),
          __fmul_rn(off, sw[k]));
      if (s < best) {
        best = s;
      } else if (s != s) {
        nan = true;
      }
    }
    res = nan ? __int_as_float(0x7fc00000) : best;
  }
  out[static_cast<size_t>(a) * T + t] = res;
}

}  // namespace

// Plain C entry point, loaded with ctypes.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int incircle_launch(const float* u, const float* v,
                               const float* lift, const float* w,
                               const float* min_area, const int* tris, int A,
                               int K, int T, float* out, void* stream) {
  if (A < 0 || T < 0 || K <= 0 || K > kMaxK)
    return static_cast<int>(cudaErrorInvalidValue);
  if (A == 0 || T == 0) return 0;
  const dim3 grid(A, (T + kThreads - 1) / kThreads);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  incircle_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      u, v, lift, w, min_area, tris, K, T, out);
  return static_cast<int>(cudaGetLastError());
}
