// CUDA-graph IF conditional nodes for the captured LIO and mesh steps.
//
// The reference's step skips work on the device at three places: the ESIKF
// lax.while_loop stops at convergence (immesh_tpu/lio/esikf.py:51-90), an
// empty refinement level is skipped under lax.cond
// (immesh_tpu/map/voxel_map.py:109-127), and an empty mesh chunk under
// lax.cond inside lax.map (immesh_tpu/mesh/triangles.py:185-200, :353).
// Their counterpart in a captured CUDA graph is an IF node whose body graph
// runs when a device predicate holds (utils/graphs.py::device_if).  This
// file holds both halves of one:
//
//   * set_conditional_kernel: one launch a site.  It makes the site's
//     predicate from the site's own inputs and sets the conditional handle
//     of every IF node that depends on it (up to kMaxHandles, passed by
//     value), so a site costs one kernel node whatever its predicate and
//     however many nodes share it.  Its forms (SetParams::form):
//       - kRead: the value of one device bool (one thread);
//       - kNot:  its negation (one thread) — the ESIKF body's "not yet
//         converged", read from the carry's `converged` byte;
//       - kAny:  any of n bytes (a contiguous bool tensor, one block: 16-byte
//         loads where aligned, single bytes at the ends, __syncthreads_or)
//         — the refinement level's "the level mask has a point" over the
//         map-update points, and the mesh chunk's "its pull mask has a
//         point" over a row range of the (A, K) mask, read in place.
//     kAny may also write the taken bit into an int32 (`count`): set it
//     (count_op kCountSet) or add it (kCountAdd) — the refinement levels'
//     count that diag["levels"] reports, made in the same launch.  The
//     kernel is launched on the captured stream before its first node, so
//     every replay sets the handles from that replay's data; a handle keeps
//     its value until the graph's next launch resets it, so a node may run
//     after other work (the ESIKF's Cholesky solve between its two nodes).
//     It replaces no Pallas kernel (the TPU evaluates the lax.cond
//     predicate inside XLA's program); its plain version is the same
//     predicate made by torch and read on the host, which the eager step
//     does (kernels/graph_cond.py::Pred.value).  Bound: the predicate's
//     bytes read once.  It also counts its own runs (g_runs) and, for each
//     node it sets, the runs whose predicate held (g_taken[slot + i]): the
//     bodies that ran on the device, which the chip checks hold every body
//     kernel's device runs to.
//   * graph_cond_set, graph_cond_if_begin / graph_cond_if_end: the graph
//     surgery, plain C for ctypes, on the stream torch.cuda.graph is
//     capturing: read the capturing graph, make the handles (default 0,
//     assigned at every launch of the graph) and launch the set kernel;
//     later, for each handle, add an IF node of one body after the stream's
//     dependencies, move the stream's capture dependencies onto the node,
//     and capture a body stream into the node's body graph until
//     graph_cond_if_end.
//
// The conditional-node API (handles, cudaGraphAddNode with conditional
// parameters, cudaStreamBeginCaptureToGraph, cudaGraphSetConditional) needs
// a CUDA 12.3 runtime and driver; graph_cond_versions reports both, and the
// Python side refuses older ones.  Written against the CUDA 12 graph API
// (its cudaStreamGetCaptureInfo and cudaGraphAddNode take no edge data).

#include <cstdint>

#include <cuda_runtime.h>

#if !defined(CUDART_VERSION) || CUDART_VERSION < 12030
#error "graph_cond.cu needs the CUDA 12.3 conditional-node API"
#endif
#if CUDART_VERSION >= 13000
#error "graph_cond.cu is written against the CUDA 12 graph API"
#endif

namespace {

// one taken counter a node; utils/graphs.py hands out the slots
constexpr int kMaxSlots = 1 << 16;
// the IF nodes one launch may set
constexpr int kMaxHandles = 4;
constexpr int kAnyThreads = 256;

enum Form : int { kRead = 0, kNot = 1, kAny = 2 };
enum CountOp : int { kCountNone = 0, kCountSet = 1, kCountAdd = 2 };

// runs of the set kernel on the current device, and per slot the runs whose
// predicate held, since the last graph_cond_reset_runs
__device__ unsigned long long g_runs;
__device__ unsigned long long g_taken[kMaxSlots];

// one launch's parameters, by value: a graph bakes them in
struct SetParams {
  cudaGraphConditionalHandle handles[kMaxHandles];
  const unsigned char* x;  // the predicate's bytes
  long long n;             // kAny: the bytes; otherwise 1
  int* count;              // kAny: the int32 the taken bit goes into, or null
  int form;
  int count_op;
  int n_handles;
  int slot;                // handle i's taken counter is slot + i
};

__global__ void set_conditional_kernel(SetParams p) {
  bool taken;
  if (p.form == kAny) {
    const unsigned char* x = p.x;
    const long long n = p.n;
    unsigned int any = 0;
    const long long head = min(
        n, static_cast<long long>((16 - (reinterpret_cast<uintptr_t>(x) & 15))
                                  & 15));
    const long long words = (n - head) / 16;
    const uint4* v = reinterpret_cast<const uint4*>(x + head);
    for (long long i = threadIdx.x; i < words; i += blockDim.x) {
      const uint4 w = v[i];
      any |= w.x | w.y | w.z | w.w;
    }
    for (long long i = threadIdx.x; i < head; i += blockDim.x) any |= x[i];
    for (long long i = head + 16 * words + threadIdx.x; i < n;
         i += blockDim.x)
      any |= x[i];
    taken = __syncthreads_or(any != 0) != 0;
    if (threadIdx.x != 0) return;
  } else {
    taken = (*p.x != 0) != (p.form == kNot);
  }
  for (int i = 0; i < p.n_handles; ++i)
    cudaGraphSetConditional(p.handles[i], taken ? 1u : 0u);
  if (p.count_op == kCountSet) *p.count = taken ? 1 : 0;
  if (p.count_op == kCountAdd) *p.count += taken ? 1 : 0;
  atomicAdd(&g_runs, 1ULL);
  if (taken)
    for (int i = 0; i < p.n_handles; ++i) atomicAdd(&g_taken[p.slot + i], 1ULL);
}

int capture_info(cudaStream_t s, cudaGraph_t* graph,
                 const cudaGraphNode_t** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
  const cudaError_t err =
      cudaStreamGetCaptureInfo(s, &status, nullptr, graph, deps, n_deps);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (status != cudaStreamCaptureStatusActive)
    return static_cast<int>(cudaErrorStreamCaptureImplicit);
  return 0;
}

}  // namespace

// The driver's and this library's runtime versions (1000 * major + 10 *
// minor).  Returns the CUDA error.
extern "C" int graph_cond_versions(int* driver, int* runtime) {
  cudaError_t err = cudaDriverGetVersion(driver);
  if (err == cudaSuccess) err = cudaRuntimeGetVersion(runtime);
  return static_cast<int>(err);
}

// The largest slot + 1, and the most IF nodes one launch sets.
extern "C" int graph_cond_max_slots() { return kMaxSlots; }
extern "C" int graph_cond_max_handles() { return kMaxHandles; }

// Under stream capture on `stream`: make n_handles conditional handles in
// the capturing graph and launch the set kernel that sets them all from
// one predicate: `form` (0 read, 1 not, 2 any) over the n bytes at x, the
// taken bit set (count_op 1) or added (2) into the int32 at count; handle
// i's taken runs are counted in slot + i.  handles[i] receive the handles.
// Returns the CUDA error of the first step that failed
// (cudaErrorStreamCaptureImplicit if `stream` is not capturing,
// cudaErrorInvalidValue for arguments out of range).
extern "C" int graph_cond_set(void* stream, int form, const void* x,
                              long long n, void* count, int count_op,
                              int slot, int n_handles,
                              unsigned long long* handles) {
  if (n_handles < 1 || n_handles > kMaxHandles || slot < 0 ||
      slot > kMaxSlots - n_handles || form < kRead || form > kAny ||
      count_op < kCountNone || count_op > kCountAdd || n < 1 ||
      (form != kAny && (n != 1 || count_op != kCountNone)) ||
      (count_op != kCountNone && count == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  const int err = capture_info(s, &graph, &deps, &n_deps);
  if (err != 0) return err;

  SetParams p = {};
  for (int i = 0; i < n_handles; ++i) {
    const cudaError_t e = cudaGraphConditionalHandleCreate(
        &p.handles[i], graph, 0, cudaGraphCondAssignDefault);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  p.x = static_cast<const unsigned char*>(x);
  p.n = n;
  p.count = static_cast<int*>(count);
  p.form = form;
  p.count_op = count_op;
  p.n_handles = n_handles;
  p.slot = slot;
  long long threads = 1;
  if (form == kAny) {
    const long long words = (n + 15) / 16;
    threads = (words + 31) / 32 * 32;
    if (threads > kAnyThreads) threads = kAnyThreads;
  }
  set_conditional_kernel<<<1, static_cast<unsigned>(threads), 0, s>>>(p);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  for (int i = 0; i < n_handles; ++i) handles[i] = p.handles[i];
  return 0;
}

// Under stream capture on `stream`: add an IF node on `handle` (made by
// graph_cond_set in this capture) after the stream's dependencies, make the
// node the stream's only capture dependency, and begin capturing
// `body_stream` into the node's body graph, which *body_graph receives.
// Returns the CUDA error of the first step that failed.
extern "C" int graph_cond_if_begin(void* stream, unsigned long long handle,
                                   void* body_stream, void** body_graph) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  const int err = capture_info(s, &graph, &deps, &n_deps);
  if (err != 0) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node = nullptr;
  cudaError_t e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                          cudaStreamSetCaptureDependencies);
  if (e != cudaSuccess) return static_cast<int>(e);

  cudaGraph_t body = params.conditional.phGraph_out[0];
  e = cudaStreamBeginCaptureToGraph(static_cast<cudaStream_t>(body_stream),
                                    body, nullptr, nullptr, 0,
                                    cudaStreamCaptureModeRelaxed);
  if (e != cudaSuccess) return static_cast<int>(e);
  *body_graph = body;
  return 0;
}

// End the capture graph_cond_if_begin began on `body_stream`; it must have
// captured into `body_graph`.  Returns the CUDA error
// (cudaErrorStreamCaptureUnmatched if the capture ended in another graph).
extern "C" int graph_cond_if_end(void* body_stream, void* body_graph) {
  cudaGraph_t g = nullptr;
  const cudaError_t e =
      cudaStreamEndCapture(static_cast<cudaStream_t>(body_stream), &g);
  if (e != cudaSuccess) return static_cast<int>(e);
  if (g != static_cast<cudaGraph_t>(body_graph))
    return static_cast<int>(cudaErrorStreamCaptureUnmatched);
  return 0;
}

// *out: the set kernel's runs on the current device since the last reset.
// Synchronous; returns the CUDA error.
extern "C" int graph_cond_runs(unsigned long long* out) {
  return static_cast<int>(cudaMemcpyFromSymbol(out, g_runs, sizeof(g_runs)));
}

// out[i]: the runs of slot first + i whose predicate held, i < n.
// Synchronous; returns the CUDA error.
extern "C" int graph_cond_taken(unsigned long long* out, int first, int n) {
  if (first < 0 || n < 0 || first + n > kMaxSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_taken, sizeof(unsigned long long) * n,
      sizeof(unsigned long long) * first));
}

// The current device's counters to 0.  Synchronous; returns the CUDA error.
extern "C" int graph_cond_reset_runs() {
  static const unsigned long long zeros[kMaxSlots] = {};
  const unsigned long long zero = 0;
  cudaError_t e = cudaMemcpyToSymbol(g_runs, &zero, sizeof(zero));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_taken, zeros, sizeof(zeros));
  return static_cast<int>(e);
}
