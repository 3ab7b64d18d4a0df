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
//   * set_conditional_kernel: one thread reads the predicate (one device
//     bool) and sets the node's conditional handle.  It is launched on the
//     captured stream just before its node, so every replay sets the handle
//     from that replay's predicate.  It replaces no Pallas kernel (the TPU
//     evaluates the lax.cond predicate inside XLA's program); its plain
//     version is the host read bool(pred) that the eager step makes.  Bound:
//     one byte read, one conditional set — far below a launch's floor, which
//     is all it costs.  It also counts its own runs (g_runs) and, per node,
//     the runs whose predicate held (g_taken[slot]): the bodies that ran on
//     the device, which the chip checks hold every body kernel's device runs
//     to.
//   * graph_cond_if_begin / graph_cond_if_end: the graph surgery, plain C
//     for ctypes, on the stream torch.cuda.graph is capturing: read the
//     capturing graph and its dependencies, make a handle (default 0,
//     assigned at every launch of the graph), launch the set kernel, add an
//     IF node of one body after it, move the stream's capture dependencies
//     onto the node, and capture a body stream into the node's body graph
//     until graph_cond_if_end.
//
// The conditional-node API (handles, cudaGraphAddNode with conditional
// parameters, cudaStreamBeginCaptureToGraph, cudaGraphSetConditional) needs
// a CUDA 12.3 runtime and driver; graph_cond_versions reports both, and the
// Python side refuses older ones.  Written against the CUDA 12 graph API
// (its cudaStreamGetCaptureInfo and cudaGraphAddNode take no edge data).

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

// runs of the set kernel on the current device, and per slot the runs whose
// predicate held, since the last graph_cond_reset_runs
__device__ unsigned long long g_runs;
__device__ unsigned long long g_taken[kMaxSlots];

__global__ void set_conditional_kernel(cudaGraphConditionalHandle handle,
                                       const bool* pred, int slot) {
  const bool taken = *pred;
  cudaGraphSetConditional(handle, taken ? 1u : 0u);
  atomicAdd(&g_runs, 1ULL);
  if (taken) atomicAdd(&g_taken[slot], 1ULL);
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

// The largest slot + 1.
extern "C" int graph_cond_max_slots() { return kMaxSlots; }

// Under stream capture on `stream`: launch the set kernel on `pred` (a
// device bool) for `slot`, add an IF node after it, make the node the
// stream's only capture dependency, and begin capturing `body_stream` into
// the node's body graph.  *body_graph and *handle receive the body graph
// and the conditional handle.  Returns the CUDA error of the first step
// that failed (cudaErrorStreamCaptureImplicit if `stream` is not capturing,
// cudaErrorInvalidValue for a slot out of range).
extern "C" int graph_cond_if_begin(void* stream, const void* pred, int slot,
                                   void* body_stream, void** body_graph,
                                   unsigned long long* handle) {
  if (slot < 0 || slot >= kMaxSlots)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaGraph_t graph = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t n_deps = 0;
  int err = capture_info(s, &graph, &deps, &n_deps);
  if (err != 0) return err;

  cudaGraphConditionalHandle h = 0;
  cudaError_t e = cudaGraphConditionalHandleCreate(&h, graph, 0,
                                                   cudaGraphCondAssignDefault);
  if (e != cudaSuccess) return static_cast<int>(e);
  set_conditional_kernel<<<1, 1, 0, s>>>(h, static_cast<const bool*>(pred),
                                         slot);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);

  // the set kernel's node is now the stream's dependency
  err = capture_info(s, &graph, &deps, &n_deps);
  if (err != 0) return err;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = h;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node = nullptr;
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
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
  *handle = h;
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
