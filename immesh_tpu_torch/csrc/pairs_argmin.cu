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
// with L the perturbed paraboloid lift.  Rows and columns of invalid points
// are all -1, and a NaN ratio in a row's k-sweep gives -1, as jnp.min
// propagates NaN there.
//
// Arithmetic follows the Pallas kernel's formula and operation order
// (immesh_tpu/mesh/delaunay.py:351-358) with explicit round-to-nearest
// intrinsics and IEEE division; the file is also built with -fmad=false and
// without --use_fast_math, so no multiply-add is contracted and the result
// is bit-identical to the plain PyTorch version in kernels/pairs_argmin.py.
//
// Cost: it is bound by instruction issue, not by memory.  A voxel with n
// valid points needs n^2 edge setups and n^3 side tests against ~5 MB of
// I/O at (A, K) = (512, 48), nearly all of it the (A, K, K) int32 table.
// Main-path voxels leave part of K invalid, so a sweep over all K^3 triples
// wastes most of its steps; a correctly rounded __fdiv_rn is a reciprocal
// on the quarter-rate unit plus a checked refinement, and a warp runs it
// whenever any of its lanes needs it, so a divide per left k would bound
// the kernel; with both gone, what remains is issue, compares and selects
// running at half the FP32 rate on Hopper.
//
// Design:
//  * Compaction.  Each block stages its voxel's valid points in shared
//    memory in ascending original order (ballot + popc over the 4 warps;
//    K <= 128 = one thread per point), each as one float4 {u, v, L, original
//    index}.  i, j and k sweep the n valid points only.  An invalid k never
//    wins and skipping it keeps the order of the rest, so the first-minimum
//    over ascending original k, and W, are unchanged.
//  * Grid.  A block owns R consecutive rows i of one voxel, grid
//    (A, ceil(K / R)), R in {2, 4, 8} the largest that still gives ~8 blocks
//    per SM: 1,536 blocks at (64, 48) (R = 2) and 3,072 at (512, 48)
//    (R = 8).  Its threads take consecutive (valid i, valid j) pairs of
//    those rows, so every lane is live but in the last warp, and every k is
//    a broadcast 16-byte shared load.
//  * Divides.  sweep_certified (below) finds each row's first minimum with
//    one divide in the common case: a divide-free guess, then a branch-free
//    pass that proves every other k out with one exact FMA test; only the
//    k it cannot prove out (near-ties) are divided.  Voxels with a
//    non-finite or huge coordinate, or eps < 0, take sweep_every_divide,
//    the plain version's sweep as written.  Both give the strict-< first
//    minimum over ascending k and the NaN rule, so W is bit-identical
//    either way.
//  * Stores.  The block's (R, K) slice of W is built in shared memory,
//    pre-filled with -1 (invalid rows and columns), and written to device
//    memory contiguously, 16 bytes a thread where the slice is aligned.
//
// Counts: block (0, 0) adds one to the device counter g_runs, the kernel's
// runs on the device, eager or replayed in a CUDA graph, read back by
// pairs_argmin_runs.  The arithmetic above does not read it.
//
// Built with -DPAIRS_ARGMIN_BRANCH_COUNTS, the library also counts the k
// that sweep_certified resolves exactly and the ties it settles by the
// smaller k, and exports pairs_argmin_branch_counts to read them; the card
// tests use that build to show both branches run on planted ties.

#include <cstdint>

#include <cuda_runtime.h>

#ifdef PAIRS_ARGMIN_BRANCH_COUNTS
// [0]: k resolved exactly in sweep_certified; [1]: of those, ties taken
__device__ unsigned long long g_branch_counts[2];
#define COUNT_BRANCH(x) atomicAdd(&g_branch_counts[x], 1ull)
#else
#define COUNT_BRANCH(x) ((void)0)
#endif

// runs of the kernel on the current device since the last
// pairs_argmin_reset_runs
__device__ unsigned long long g_runs;

namespace {

constexpr int kMaxK = 128;
constexpr int kThreads = 128;  // one thread per point at kMaxK; 4 warps
constexpr int kWarps = kThreads / 32;
constexpr int kMaxRows = 8;    // rows i of one voxel per block, at most
constexpr int kFillBlocks = 1056;  // 8 blocks per SM on 132 SMs
// |u|, |v|, |L| below 2^16 keep Np (< 2^53) and d (< 2^35) finite
constexpr float kSafe = 65536.0f;
constexpr float kBig = 3.4e38f;
constexpr float kTiny = 7.8886091e-31f;  // 2^-100: absolute slack of the bounds

// d and Np of the triple (i, j, k), in the Pallas kernel's operation order
__device__ __forceinline__ void side_and_num(
    float4 pk, float ui, float vi, float li, float du_j, float dv_j,
    float dl_j, float e2, float& d, float& np) {
  const float du_k = __fsub_rn(pk.x, ui);
  const float dv_k = __fsub_rn(pk.y, vi);
  d = __fsub_rn(__fmul_rn(du_j, dv_k), __fmul_rn(dv_j, du_k));
  const float dl_k = __fsub_rn(pk.z, li);
  const float mp = __fadd_rn(__fmul_rn(du_k, du_j), __fmul_rn(dv_k, dv_j));
  np = __fsub_rn(__fmul_rn(dl_k, e2), __fmul_rn(mp, dl_j));
}

// Bit x - k0 where k0 <= x < k0 + 32, else none
__device__ __forceinline__ unsigned chunk_bit(int x, int k0) {
  return x >= k0 && x < k0 + 32 ? 1u << (x - k0) : 0u;
}

// The plain version's sweep as written: an IEEE divide for every k, a
// strict-< running minimum from kBig and a NaN flag.  Returns a compacted
// index or -1.
__device__ int sweep_every_divide(const float4* spt, int n, float ui,
                                  float vi, float li, float du_j, float dv_j,
                                  float dl_j, float e2, float eps) {
  float best = kBig;
  int bk = -1;
  bool nan = false;
  for (int k = 0; k < n; ++k) {
    float d, np;
    side_and_num(spt[k], ui, vi, li, du_j, dv_j, dl_j, e2, d, np);
    const bool left = d > eps;
    const float r = __fdiv_rn(np, left ? d : 1.0f);
    if (left && r < best) {
      best = r;
      bk = k;
    }
    nan |= left && r != r;
  }
  return nan ? -1 : bk;
}

// The same result with one divide per row in the common case, for voxels
// whose points are finite with |u|, |v|, |L| < kSafe (umax, vmax, lmax
// bound them) and eps >= 0: there d > eps is positive and finite, Np
// finite, and no ratio is NaN.
//
// For a fixed row (i, j), d and Np are affine in the point k:
//   d  ~ da  = -dv_j*u_k + du_j*v_k + g,
//   Np ~ npa = e2*L_k + cu*u_k + cv*v_k + c0,
// two and three FMAs.  Against the kernel's rounded d and Np they err by
// at most 7 and 12 units of 2^-24 of md = 2(|dv_j| umax + |du_j| vmax) and
// mn = 2(e2 lmax + |dl_j|(|du_j| umax + |dv_j| vmax)); ed and en below are
// 16 and 32 units, plus an absolute 2^-100 for underflow.
//
// Derivation (u = 2^-24, O(u^2) dropped; du_j, dv_j, dl_j, e2 are the same
// rounded floats in both forms, and each rounding errs by u of its exact
// result, or by 2^-149 on underflow, which 2^-100 covers).  Against
//   D = du_j (v_k - v_i) - dv_j (u_k - u_i),
//   N = (L_k - L_i) e2 - ((u_k - u_i) du_j + (v_k - v_i) dv_j) dl_j,
// where |u_k - u_i| <= 2 umax and so on:
//  * d rounds du_k, dv_k (u each, carried through the products), the two
//    products (u each) and the difference (u of at most md):
//    |d - D| <= 2u md + u md = 3u md.
//  * da: g rounds two products and a difference, u md in all; the FMAs
//    round results of at most md and 1.5 md: |da - D| <= 3.5u md.  So
//    |da - d| <= 6.5u md < 7u md.
//  * Np: dl_k and its product with e2 err by 2u of 2 e2 lmax; mp by 3u of
//    P = 2(|du_j| umax + |dv_j| vmax), its product with dl_j by one u
//    more; the difference by u of mn = 2 e2 lmax + |dl_j| P:
//    |Np - N| <= 4u e2 lmax + 4u |dl_j| P + u mn <= 5u mn.
//  * npa: cu u_k + cv v_k carry u |dl_j| P / 2 <= 0.5u mn from rounding cu
//    and cv; c0 carries u |dl_j| P (its inner sum) + u e2 lmax + u mn / 2
//    (its FMA) <= 2u mn; the three FMAs round results of at most mn,
//    1.5 mn and 2 mn: 4.5u mn.  |npa - N| <= 7u mn, so
//    |npa - Np| <= 12u mn.
// md, mn, ed and en are themselves computed in float (a few u low at
// most), which the margins of 16/7 and 32/12 absorb.  Then:
//  1. A sweep of da, npa keeps the k of the least npa/da by
//     cross-multiplied comparisons: a guess k_b, divided exactly once.
//  2. A second sweep, branch-free, proves each other k out (the ones it
//     cannot are flagged in a bitmask): either da <= eps - 2 ed
//     (so d <= eps: not left), or x = RN(s*da - npa) < -mg, with s the
//     float after best and mg >= (|s| ed + en)(1 + 2^-23).  Then
//     s*da - npa < -mg / (1 + u), and s*d - Np differs from it by at most
//     |s| 7u md + 12u mn < |s| ed + en, so s*d - Np < 0 exactly: Np/d > s,
//     its rounded ratio is >= s > best and k can neither win nor tie.
//     da <= eps_lo likewise gives d <= eps.  k = i and k = j have d = 0
//     exactly.
//     Every k not proved out is computed exactly, divided, and taken if
//     r < best, or r == best at a smaller k: the first minimum over
//     ascending k, as the strict-< sweep finds it.
__device__ int sweep_certified(const float4* spt, int n, int ic, int jc,
                               float ui, float vi, float li, float du_j,
                               float dv_j, float dl_j, float e2, float eps,
                               float umax, float vmax, float lmax) {
  const float g = __fsub_rn(__fmul_rn(dv_j, ui), __fmul_rn(du_j, vi));
  const float cu = -__fmul_rn(dl_j, du_j);
  const float cv = -__fmul_rn(dl_j, dv_j);
  const float c0 = __fmaf_rn(
      dl_j, __fmaf_rn(du_j, ui, __fmul_rn(dv_j, vi)), -__fmul_rn(e2, li));
  const float md = 2.0f * (fabsf(dv_j) * umax + fabsf(du_j) * vmax);
  const float mn =
      2.0f * (e2 * lmax + fabsf(dl_j) * (fabsf(du_j) * umax + fabsf(dv_j) * vmax));
  const float ed = 0x1p-20f * md + 0x1p-23f * fabsf(eps) + kTiny;
  const float en = 0x1p-19f * mn + kTiny;
  const float eps_lo = eps - 2.0f * ed;

  float nb = 1.0f, db = 0.0f;  // the first left k always replaces this
  int bk = -1;
#pragma unroll 4
  for (int k = 0; k < n; ++k) {
    const float4 pk = spt[k];
    const float da = __fmaf_rn(du_j, pk.y, __fmaf_rn(-dv_j, pk.x, g));
    const float npa = __fmaf_rn(
        e2, pk.z, __fmaf_rn(cu, pk.x, __fmaf_rn(cv, pk.y, c0)));
    if (da > eps && npa * db < nb * da) {
      nb = npa;
      db = da;
      bk = k;
    }
  }
  float best = kBig;
  if (bk >= 0) {
    float d, np;
    side_and_num(spt[bk], ui, vi, li, du_j, dv_j, dl_j, e2, d, np);
    if (d > eps)
      best = __fdiv_rn(np, d);
    else
      bk = -1;
  }
  float s = nextafterf(best, INFINITY);
  float mg = ((fabsf(s) * ed) + en) * (1.0f + 0x1p-20f);
  // 32 k at a time: a bit for each k not proved out, then the set bits
  // resolved exactly in ascending order
  for (int k0 = 0; k0 < n; k0 += 32) {
    const int kn = min(32, n - k0);
    unsigned need = 0;
#pragma unroll 4
    for (int q = 0; q < kn; ++q) {
      const float4 pk = spt[k0 + q];
      const float da = __fmaf_rn(du_j, pk.y, __fmaf_rn(-dv_j, pk.x, g));
      const float npa = __fmaf_rn(
          e2, pk.z, __fmaf_rn(cu, pk.x, __fmaf_rn(cv, pk.y, c0)));
      const bool out = da <= eps_lo || __fmaf_rn(s, da, -npa) < -mg;
      need |= static_cast<unsigned>(!out) << q;
    }
    need &= ~(chunk_bit(bk, k0) | chunk_bit(ic, k0) | chunk_bit(jc, k0));
    while (need) {
      const int k = k0 + __ffs(need) - 1;
      need &= need - 1;
      float d, np;
      side_and_num(spt[k], ui, vi, li, du_j, dv_j, dl_j, e2, d, np);
      COUNT_BRANCH(0);
      if (d > eps) {
        const float r = __fdiv_rn(np, d);
        if (r == best && k < bk) COUNT_BRANCH(1);
        if (r < best || (r == best && k < bk)) {
          best = r;
          bk = k;
          s = nextafterf(best, INFINITY);
          mg = ((fabsf(s) * ed) + en) * (1.0f + 0x1p-20f);
        }
      }
    }
  }
  return best < kBig ? bk : -1;
}

// Maxima of non-negative floats (or NaN) by their bits, which order as the
// values do, with NaN above +inf: a NaN coordinate makes the maximum NaN
__device__ __forceinline__ float bits_max(float x, float y) {
  return __int_as_float(max(__float_as_int(x), __float_as_int(y)));
}

__device__ __forceinline__ void warp_max(float x, float* sred, int lane,
                                         int warp) {
  const int m = __reduce_max_sync(0xffffffffu, __float_as_int(x));
  if (lane == 0) sred[warp] = __int_as_float(m);
}

__global__ void __launch_bounds__(kThreads)
pairs_argmin_kernel(const float* __restrict__ u, const float* __restrict__ v,
                    const float* __restrict__ lift,
                    const float* __restrict__ valid,
                    const float* __restrict__ d_eps, int K, int R,
                    int* __restrict__ W) {
  __shared__ float4 spt[kMaxK];  // valid points {u, v, L, index bits}
  __shared__ __align__(16) int stile[kMaxRows * kMaxK];
  __shared__ int swarp[kWarps];
  __shared__ float smax[3][kWarps];
  __shared__ int srange[2];

  const int a = blockIdx.x;
  const int i0 = blockIdx.y * R;
  const int rows = min(R, K - i0);
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const size_t base = static_cast<size_t>(a) * K;
  if (a == 0 && blockIdx.y == 0 && t == 0) atomicAdd(&g_runs, 1ULL);

  // one round of loads, then an order-preserving compaction of the valid
  // points and the voxel's largest |u|, |v|, |L|
  bool ok = false;
  float pu = 0.0f, pv = 0.0f, pl = 0.0f;
  if (t < K) {
    ok = valid[base + t] > 0.0f;
    pu = u[base + t];
    pv = v[base + t];
    pl = lift[base + t];
  }
  const float eps = d_eps[a];
  const unsigned bal = __ballot_sync(0xffffffffu, ok);
  if (lane == 0) swarp[warp] = __popc(bal);
  warp_max(ok ? fabsf(pu) : 0.0f, smax[0], lane, warp);
  warp_max(ok ? fabsf(pv) : 0.0f, smax[1], lane, warp);
  warp_max(ok ? fabsf(pl) : 0.0f, smax[2], lane, warp);
  for (int p = t; p < rows * K; p += kThreads) stile[p] = -1;
  __syncthreads();
  int pos = __popc(bal & ((1u << lane) - 1u)), n = 0;
  float umax = 0.0f, vmax = 0.0f, lmax = 0.0f;
  for (int w = 0; w < kWarps; ++w) {
    pos += w < warp ? swarp[w] : 0;
    n += swarp[w];
    umax = bits_max(umax, smax[0][w]);
    vmax = bits_max(vmax, smax[1][w]);
    lmax = bits_max(lmax, smax[2][w]);
  }
  // pos = number of valid points before t, so the block's rows are the
  // compacted range [pos(i0), pos(i0 + rows))
  if (ok) spt[pos] = make_float4(pu, pv, pl, __int_as_float(t));
  if (t == i0) srange[0] = pos;
  if (t == i0 + rows) srange[1] = pos;
  __syncthreads();
  // NaN fails every < test, so a NaN coordinate or eps is not safe
  const bool safe = umax < kSafe && vmax < kSafe && lmax < kSafe &&
                    eps >= 0.0f;
  const int lo = srange[0];
  const int hi = i0 + rows < K ? srange[1] : n;

  // consecutive threads take consecutive (i, j) of the block's valid rows
  for (int f = t; f < (hi - lo) * n; f += kThreads) {
    const int ic = lo + f / n, jc = f % n;
    const float4 pi = spt[ic];
    const float4 pj = spt[jc];
    const float du_j = __fsub_rn(pj.x, pi.x);
    const float dv_j = __fsub_rn(pj.y, pi.y);
    const float dl_j = __fsub_rn(pj.z, pi.z);
    const float e2 = __fadd_rn(__fmul_rn(du_j, du_j), __fmul_rn(dv_j, dv_j));
    const int kc =
        safe ? sweep_certified(spt, n, ic, jc, pi.x, pi.y, pi.z, du_j, dv_j,
                               dl_j, e2, eps, umax, vmax, lmax)
             : sweep_every_divide(spt, n, pi.x, pi.y, pi.z, du_j, dv_j, dl_j,
                                  e2, eps);
    stile[(__float_as_int(pi.w) - i0) * K + __float_as_int(pj.w)] =
        kc < 0 ? -1 : __float_as_int(spt[kc].w);
  }
  __syncthreads();

  // W[a, i0:i0+rows, :] is one contiguous run of rows*K ints
  int* out = W + (base + i0) * K;
  const int cnt = rows * K;
  if ((reinterpret_cast<uintptr_t>(out) & 15u) == 0 && (cnt & 3) == 0) {
    const int4* src = reinterpret_cast<const int4*>(stile);
    int4* dst = reinterpret_cast<int4*>(out);
    for (int p = t; p < cnt / 4; p += kThreads) dst[p] = src[p];
  } else {
    for (int p = t; p < cnt; p += kThreads) out[p] = stile[p];
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
  // the most rows per block that still gives kFillBlocks blocks, so few
  // voxels (A = 64) spread over every SM and many (A = 512) amortise the
  // staging
  int R = kMaxRows;
  while (R > 2 && static_cast<long long>(A) * ((K + R - 1) / R) < kFillBlocks)
    R /= 2;
  const dim3 grid(A, (K + R - 1) / R);
  pairs_argmin_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      u, v, lift, valid, d_eps, K, R, W);
  return static_cast<int>(cudaGetLastError());
}

// *out: the kernel's runs on the current device since the last reset.
// Synchronises.
extern "C" int pairs_argmin_runs(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_runs, sizeof(g_runs)));
}

// Zeroes the run counter on the current device.  Synchronises.
extern "C" int pairs_argmin_reset_runs() {
  const unsigned long long zero = 0;
  return static_cast<int>(cudaMemcpyToSymbol(g_runs, &zero, sizeof(zero)));
}

#ifdef PAIRS_ARGMIN_BRANCH_COUNTS
// Copies the two branch counts to host memory and zeroes them; synchronises.
extern "C" int pairs_argmin_branch_counts(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_branch_counts,
                                         sizeof(g_branch_counts));
  const unsigned long long zero[2] = {0, 0};
  if (err == cudaSuccess)
    err = cudaMemcpyToSymbol(g_branch_counts, zero, sizeof(zero));
  return static_cast<int>(err);
}
#endif
