// Conditional nodes in a CUDA graph that PyTorch is capturing: the port's
// counterpart of lax.cond (utils/device.py device_cond).
//
// Replaces no TPU kernel.  The JAX package's tier ladders are lax.cond
// inside one jitted program (qldpc_fault_tolerance_tpu/ops/bp.py
// bp_decode_two_phase, decoders/bp_decoders.py decode_device); a branch not
// taken runs nothing.  The torch this port runs against has no
// conditional-node capture of its own, so this file builds one from the CUDA
// runtime: graph_if_begin adds an IF node behind the capturing stream's
// current work, captures into that same graph a one-thread kernel that sets
// the node's condition from a device byte (or its negation) at each replay,
// and starts capturing a second stream into the node's body graph; the
// caller's ops then run on that stream until graph_if_end (one stream per
// nesting depth, graph_stream_create).  Nested calls nest: a body stream
// that is capturing is a capturing stream like any other.  Nothing here
// synchronises or allocates device memory.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void set_condition_kernel(cudaGraphConditionalHandle handle,
                                     const uint8_t* __restrict__ pred,
                                     int negate) {
  const unsigned int value = *pred != 0 ? 1u : 0u;
  cudaGraphSetConditional(handle, negate ? 1u - value : value);
}

// the graph `stream` is capturing into, with its current dependencies
cudaError_t capture_info(cudaStream_t stream, cudaGraph_t* graph,
                         const cudaGraphNode_t** deps, size_t* n_deps) {
  cudaStreamCaptureStatus status;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaStreamGetCaptureInfo(stream, &status, nullptr, graph,
                                           deps, nullptr, n_deps);
#else
  cudaError_t e =
      cudaStreamGetCaptureInfo(stream, &status, nullptr, graph, deps, n_deps);
#endif
  if (e != cudaSuccess) return e;
  return status == cudaStreamCaptureStatusActive
             ? cudaSuccess
             : cudaErrorStreamCaptureImplicit;
}

}  // namespace

// Adds to the graph `stream` is capturing an IF node whose body runs when
// the byte at `pred` is nonzero (zero with `negate`) at replay, and starts
// capturing `body` into that body.  `body` must not be capturing.
extern "C" int graph_if_begin(void* stream, void* body, const void* pred,
                              int negate) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaGraph_t graph;
  const cudaGraphNode_t* deps;
  size_t n_deps;
  cudaError_t e = capture_info(s, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphConditionalHandle handle;
  e = cudaGraphConditionalHandleCreate(&handle, graph, 0, 0);
  if (e != cudaSuccess) return (int)e;
  set_condition_kernel<<<1, 1, 0, s>>>(handle, (const uint8_t*)pred, negate);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  e = capture_info(s, &graph, &deps, &n_deps);
  if (e != cudaSuccess) return (int)e;
  cudaGraphNodeParams params = {};
  params.type = cudaGraphNodeTypeConditional;
  params.conditional.handle = handle;
  params.conditional.type = cudaGraphCondTypeIf;
  params.conditional.size = 1;
  cudaGraphNode_t node;
#if CUDART_VERSION >= 13000
  e = cudaGraphAddNode(&node, graph, deps, nullptr, n_deps, &params);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(s, &node, nullptr, 1,
                                          cudaStreamSetCaptureDependencies);
#else
  e = cudaGraphAddNode(&node, graph, deps, n_deps, &params);
  if (e != cudaSuccess) return (int)e;
  e = cudaStreamUpdateCaptureDependencies(s, &node, 1,
                                          cudaStreamSetCaptureDependencies);
#endif
  if (e != cudaSuccess) return (int)e;
  return (int)cudaStreamBeginCaptureToGraph(
      (cudaStream_t)body, params.conditional.phGraph_out[0], nullptr, nullptr,
      0, cudaStreamCaptureModeRelaxed);
}

// Ends the capture of an IF node's body begun by graph_if_begin; `nodes`
// receives the body graph's node count (a nested IF node counts as one).
extern "C" int graph_if_end(void* body, unsigned long long* nodes) {
  cudaGraph_t graph;
  cudaError_t e = cudaStreamEndCapture((cudaStream_t)body, &graph);
  if (e != cudaSuccess) return (int)e;
  size_t n = 0;
  e = cudaGraphGetNodes(graph, nullptr, &n);
  *nodes = n;
  return (int)e;
}

// A stream of its own for IF bodies: a stream from PyTorch's pool may be the
// very stream whose capture the body nests in.
extern "C" int graph_stream_create(void** stream) {
  return (int)cudaStreamCreateWithFlags((cudaStream_t*)stream,
                                        cudaStreamNonBlocking);
}

// The node count of a captured graph's top level.
extern "C" int graph_node_count(void* graph, unsigned long long* nodes) {
  size_t n = 0;
  const cudaError_t e = cudaGraphGetNodes((cudaGraph_t)graph, nullptr, &n);
  *nodes = n;
  return (int)e;
}
