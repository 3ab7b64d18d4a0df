// Delaunay incircle min-score for Hopper (sm_90a).
//
// Replaces immesh_tpu/mesh/delaunay.py::_incircle_kernel (the Pallas TPU
// kernel at :44, launched by _incircle_min_scores).  For every voxel a and
// every candidate triangle t = (ia, ib, ic) of the shared (T, 3) table it
// builds the CCW-oriented lifted plane through the three vertices and writes
//
//   out[a,t] = min_k (nx*u_k*w_k + ny*v_k*w_k + nz*L_k*w_k - off*w_k)
//
// with L the perturbed paraboloid lift and w the validity, 1.0 or 0.0 (the
// wrapper rejects any other value), or -inf when a vertex is masked or
// |2*area| <= min_area[a].  A NaN score anywhere in the
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
// The minimum is over all K points, masked ones included: they score
// exactly +-0 (or NaN), and the minimum sees them as the reference does.
//
// Cost on an H100: 14 f32 operations per (a, t) to gather the vertices and
// test the gates, 15 more to build the plane of a candidate that passes
// them, and 8 per (a, t, k) of its sweep (four products, three sums, one
// minimum), against the (A, T) f32 output written once.  At (A, K) =
// (512, 48) with ~80 % valid points, T = C(48, 3) = 17,296: ~1.6 GFLOP
// (~24 us at 67 TFLOP/s) against 35 MB of output (~11 us at 3.35 TB/s), so
// the operations bound it; chip_smoke.py recounts both from its inputs.
// Without FMA (it would change the rounding) the sweep is one instruction
// per operation, so its issue alone takes about twice the bound; shared
// loads, gated lanes idle in sweeping warps and masked points swept one by
// one would add to it.
//
// Design:
//  * One block per (voxel, tile of kTile = 1,024 candidates).  Each thread
//    gates kPer = 4 consecutive candidates; their vertex indices (three
//    16-byte loads) are requested before the voxel is staged, so the two
//    loads overlap.  Gated candidates write -inf to a shared result tile
//    at once; the planes of the live ones are compacted, in candidate
//    order, into a shared queue (warp scan + warp offsets), so every lane
//    of a sweeping warp is live except in the queue's last warp.
//  * The sweep is register-tiled: each thread takes kSweep = 2 queue
//    entries, so one 16-byte broadcast load of a point feeds 8 products.
//  * Masked points are folded, not swept.  A point with w = 1 scores
//    ((nx*u + ny*v) + nz*L) - off exactly (x*1 = x), seven operations, and
//    a point with w = 0 scores exactly +-0 when its coordinates and the
//    plane are finite, NaN otherwise; so the sweep runs over the valid
//    points, compacted in shared memory, and the masked ones enter as one
//    min with 0 (or NaN).  The minimum is the same value as the sweep over
//    all K points, +-0 comparing equal as in the plain version's amin.
//  * The running minimum is PTX min.NaN.f32: the least value, and NaN once
//    any score is NaN, as jnp.min and the plain version's amin give.
//  * The result tile goes to device memory contiguously, 16 bytes a thread
//    where the tile is aligned.

#include <cstdint>

#include <cuda_runtime.h>

namespace {

constexpr int kMaxK = 128;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPer = 4;                  // candidates gated per thread
constexpr int kTile = kThreads * kPer;   // candidates per block
constexpr int kSweep = 2;                // candidates swept per thread
static_assert(3 * kPer % 4 == 0, "vertex indices load as whole int4s");

__device__ __forceinline__ float sign_of(float x) {
  // jnp.sign: +1, -1, 0 (and NaN for NaN, which the area gate catches)
  return x > 0.0f ? 1.0f : (x < 0.0f ? -1.0f : (x == 0.0f ? 0.0f : x));
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ bool finite4(float4 p) {
  return isfinite(p.x) && isfinite(p.y) && isfinite(p.z) && isfinite(p.w);
}

// The min score of kSweep planes over the n valid points of spw: w = 1, so
// u*w = u and off*w = off exactly and s_k = ((nx*u_k + ny*v_k) + nz*L_k) - off.
__device__ __forceinline__ void sweep(const float4* spw, int n,
                                      const float4* plane, float* best) {
#pragma unroll
  for (int r = 0; r < kSweep; ++r) best[r] = INFINITY;
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const float4 p = spw[k];
#pragma unroll
    for (int r = 0; r < kSweep; ++r) {
      const float4 q = plane[r];
      const float s = __fsub_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(q.x, p.x), __fmul_rn(q.y, p.y)),
                    __fmul_rn(q.z, p.z)),
          q.w);
      best[r] = min_nan(best[r], s);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
incircle_kernel(const float* __restrict__ u, const float* __restrict__ v,
                const float* __restrict__ lift, const float* __restrict__ w,
                const float* __restrict__ min_area,
                const int* __restrict__ tris, int K, int T,
                float* __restrict__ out) {
  __shared__ float4 spt[kMaxK];   // {u, v, L, w}: the vertices
  __shared__ float4 spw[kMaxK];   // the valid points, compacted in order
  __shared__ float4 sq[kTile];    // live planes {nx, ny, nz, off}
  __shared__ short sqt[kTile];    // their place in the tile
  __shared__ __align__(16) float sres[kTile];
  __shared__ int swarp[kWarps];
  __shared__ int sfinite[kWarps];

  const int a = blockIdx.x;
  const int t0 = blockIdx.y * kTile;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  // this thread's kPer consecutive candidates: vertex indices first, so
  // their load overlaps the staging of the voxel
  int tri[3 * kPer];
  {
    const int* src = tris + 3 * (static_cast<size_t>(t0) + kPer * tid);
    const bool whole = t0 + kPer * (tid + 1) <= T;
    if (whole && (reinterpret_cast<uintptr_t>(src) & 15u) == 0) {
#pragma unroll
      for (int x = 0; x < 3 * kPer / 4; ++x) {
        const int4 q = reinterpret_cast<const int4*>(src)[x];
        tri[4 * x] = q.x;
        tri[4 * x + 1] = q.y;
        tri[4 * x + 2] = q.z;
        tri[4 * x + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int x = 0; x < 3 * kPer; ++x)
        tri[x] = t0 + kPer * tid + x / 3 < T ? src[x] : 0;
    }
  }

  // stage the voxel: every point by index, and the valid ones compacted in
  // order.  Masked points score exactly +-0 against a finite plane, or NaN
  // when their coordinates or the plane are not finite.
  const size_t base = static_cast<size_t>(a) * K;
  float4 p = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (tid < K) p = make_float4(u[base + tid], v[base + tid],
                               lift[base + tid], w[base + tid]);
  const float amin = min_area[a];
  const bool one = tid < K && p.w > 0.0f;
  const unsigned bal = __ballot_sync(0xffffffffu, one);
  const bool wm = __all_sync(
      0xffffffffu, tid >= K || one ||
                       (isfinite(p.x) && isfinite(p.y) && isfinite(p.z)));
  if (lane == 0) {
    swarp[warp] = __popc(bal);
    sfinite[warp] = wm;
  }
  if (tid < K) spt[tid] = p;
  __syncthreads();
  int pos = __popc(bal & ((1u << lane) - 1u)), n = 0;
  bool masked_finite = true;
  for (int q = 0; q < kWarps; ++q) {
    pos += q < warp ? swarp[q] : 0;
    n += swarp[q];
    masked_finite = masked_finite && sfinite[q];
  }
  if (one) spw[pos] = p;
  __syncthreads();

  // gates and planes
  float4 pl[kPer];
  int live = 0;  // bit r: candidate r passes the gates
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    const int l = kPer * tid + r;
    if (t0 + l >= T) continue;
    const float4 pa = spt[tri[3 * r]], pb = spt[tri[3 * r + 1]],
                 pc = spt[tri[3 * r + 2]];
    const float e1u = __fsub_rn(pb.x, pa.x);
    const float e1v = __fsub_rn(pb.y, pa.y);
    const float e1l = __fsub_rn(pb.z, pa.z);
    const float e2u = __fsub_rn(pc.x, pa.x);
    const float e2v = __fsub_rn(pc.y, pa.y);
    const float e2l = __fsub_rn(pc.z, pa.z);
    const float area2 = __fsub_rn(__fmul_rn(e1u, e2v), __fmul_rn(e1v, e2u));
    if (pa.w > 0.0f && pb.w > 0.0f && pc.w > 0.0f && fabsf(area2) > amin) {
      const float ccw = sign_of(area2);
      const float nx = __fmul_rn(
          __fsub_rn(__fmul_rn(e1v, e2l), __fmul_rn(e1l, e2v)), ccw);
      const float ny = __fmul_rn(
          __fsub_rn(__fmul_rn(e1l, e2u), __fmul_rn(e1u, e2l)), ccw);
      const float nz = __fmul_rn(area2, ccw);
      const float off = __fadd_rn(
          __fadd_rn(__fmul_rn(nx, pa.x), __fmul_rn(ny, pa.y)),
          __fmul_rn(nz, pa.z));
      pl[r] = make_float4(nx, ny, nz, off);
      live |= 1 << r;
    } else {
      sres[l] = -INFINITY;
    }
  }

  // compact the live planes, in candidate order: warp-inclusive scan of the
  // per-thread counts, then the warps' offsets
  const int cnt = __popc(live);
  int incl = cnt;
#pragma unroll
  for (int s = 1; s < 32; s <<= 1) {
    const int x = __shfl_up_sync(0xffffffffu, incl, s);
    if (lane >= s) incl += x;
  }
  if (lane == 31) swarp[warp] = incl;
  __syncthreads();
  int e = incl - cnt, nq = 0;
  for (int q = 0; q < kWarps; ++q) {
    e += q < warp ? swarp[q] : 0;
    nq += swarp[q];
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
    if (live & (1 << r)) {
      sq[e] = pl[r];
      sqt[e] = static_cast<short>(kPer * tid + r);
      ++e;
    }
  }
  __syncthreads();

  // register-tiled sweep: kSweep consecutive queue entries a thread
  for (int q0 = kSweep * tid; q0 < nq; q0 += kSweep * kThreads) {
    float4 plane[kSweep];
    float best[kSweep];
#pragma unroll
    for (int r = 0; r < kSweep; ++r) plane[r] = sq[q0 + r];  // past nq: unused
    sweep(spw, n, plane, best);
    if (n < K) {
      // the K - n masked points
#pragma unroll
      for (int r = 0; r < kSweep; ++r)
        best[r] = masked_finite && finite4(plane[r])
                      ? min_nan(best[r], 0.0f)
                      : __int_as_float(0x7fc00000);
    }
#pragma unroll
    for (int r = 0; r < kSweep; ++r)
      if (q0 + r < nq) sres[sqt[q0 + r]] = best[r];
  }
  __syncthreads();

  const int nt = min(kTile, T - t0);
  float* dst = out + static_cast<size_t>(a) * T + t0;
  if ((reinterpret_cast<uintptr_t>(dst) & 15u) == 0 && (nt & 3) == 0) {
    for (int q = tid; q < nt / 4; q += kThreads)
      reinterpret_cast<float4*>(dst)[q] =
          reinterpret_cast<const float4*>(sres)[q];
  } else {
    for (int q = tid; q < nt; q += kThreads) dst[q] = sres[q];
  }
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
  const dim3 grid(A, (T + kTile - 1) / kTile);
  if (grid.y > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  incircle_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      u, v, lift, w, min_area, tris, K, T, out);
  return static_cast<int>(cudaGetLastError());
}
