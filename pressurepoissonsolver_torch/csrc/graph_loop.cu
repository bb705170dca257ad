// Device-side loops for CUDA graphs, for Hopper (sm_90a): the guard kernel
// of a WHILE node and host functions that compose captured graphs into one
// executable graph with (nested) WHILE nodes.
//
// It is the counterpart of the condition of the reference's
// ``jax.lax.while_loop`` (pressurepoissonsolver_tpu/krylov.py:213, the inner
// BiCGStab; solver.py:477, the refinement's outer loop): XLA keeps the loop
// and its stop test on the device, and so does a WHILE node, whose body runs
// again for as long as the node's condition handle holds a nonzero value.
//
// The guard kernel ``pps_set_conditional`` (one thread) copies a loop's own
// stop flag (a 0-d torch.bool of the loop state, written by the body's last
// captured piece) into the handle with ``cudaGraphSetConditional`` and adds
// the value to the loop's run counter, so that the counter ends as the number
// of body executions.  One guard node sits ahead of each WHILE node (a loop
// whose flag is false after its init runs no step) and one ends its body.
//
// A body holds child-graph nodes (clones of graphs torch captured, over
// static buffers whose addresses persist), guard kernel nodes and nested
// WHILE nodes; the caller keeps every captured graph and buffer alive for as
// long as the executable graph.  What bounds the guard is the cost of a
// graph node (a launch of one thread on the device, a few microseconds), not
// bytes: it reads one flag and updates one 8-byte counter.
//
// The stamp kernels are graph instrumentation too (utils/profiling.py,
// ``device_spans``).  ``pps_stamp`` (one thread) takes the next slot of a
// device buffer with ``atomicAdd`` and writes the span's id and
// ``%globaltimer`` there, or, past the buffer's capacity, only counts
// itself; launched on a stream that torch is capturing, it becomes a kernel
// node of the piece, so stream order places its time between the nodes
// before and after it, inside WHILE bodies too.  ``pps_stamp_clock`` is the
// same kernel under another name: its record in a profiler trace pairs the
// device's clock with the trace's.  ``pps_timer_probe`` reads the timer
// back to back, to measure how often it ticks.  ``pps_graph_count_nodes``
// counts the device nodes (kernel, memcpy, memset) of a captured graph, child
// graphs included.
//
// Every function returns its cudaError_t (0 on success); the Python wrapper
// raises on any other value with pps_graph_error_string.  The library links
// the CUDA runtime statically; graph, node and stream handles are driver
// objects of the primary context, which torch's runtime uses too.

#include <cuda_runtime.h>

#include <vector>

extern "C" __global__ void pps_set_conditional(cudaGraphConditionalHandle handle,
                                               const bool* go, long long* runs) {
  const unsigned int value = *go ? 1u : 0u;
  cudaGraphSetConditional(handle, value);
  *runs += value;
}

__device__ __forceinline__ unsigned long long global_timer() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

// One entry of a stamp buffer: ``buf[2 i]`` the id, ``buf[2 i + 1]`` the
// time in ns; ``*cursor`` ends as the number of stamps taken, kept or not.
__device__ __forceinline__ void stamp(unsigned long long id, unsigned long long* buf,
                                      unsigned long long* cursor, unsigned long long cap) {
  const unsigned long long i = atomicAdd(cursor, 1ULL);
  if (i < cap) {
    buf[2 * i] = id;
    buf[2 * i + 1] = global_timer();
  }
}

extern "C" __global__ void pps_stamp(unsigned long long id, unsigned long long* buf,
                                     unsigned long long* cursor, unsigned long long cap) {
  stamp(id, buf, cursor, cap);
}

extern "C" __global__ void pps_stamp_clock(unsigned long long id, unsigned long long* buf,
                                           unsigned long long* cursor,
                                           unsigned long long cap) {
  stamp(id, buf, cursor, cap);
}

extern "C" __global__ void pps_timer_probe(unsigned long long* out, int reads) {
  for (int i = 0; i < reads; ++i) out[i] = global_timer();
}

namespace {

cudaError_t count_nodes(cudaGraph_t g, long long* counts) {
  size_t n = 0;
  cudaError_t err = cudaGraphGetNodes(g, nullptr, &n);
  if (err != cudaSuccess || n == 0) return err;
  std::vector<cudaGraphNode_t> nodes(n);
  err = cudaGraphGetNodes(g, nodes.data(), &n);
  if (err != cudaSuccess) return err;
  for (size_t i = 0; i < n; ++i) {
    cudaGraphNodeType type;
    err = cudaGraphNodeGetType(nodes[i], &type);
    if (err != cudaSuccess) return err;
    if (type == cudaGraphNodeTypeKernel) {
      counts[0] += 1;
    } else if (type == cudaGraphNodeTypeMemcpy) {
      counts[1] += 1;
    } else if (type == cudaGraphNodeTypeMemset) {
      counts[2] += 1;
    } else if (type == cudaGraphNodeTypeGraph) {
      cudaGraph_t child;
      err = cudaGraphChildGraphNodeGetGraph(nodes[i], &child);
      if (err != cudaSuccess) return err;
      err = count_nodes(child, counts);
      if (err != cudaSuccess) return err;
    }
  }
  return cudaSuccess;
}

cudaError_t add_guard(cudaGraph_t graph, const cudaGraphNode_t* deps, size_t ndeps,
                      cudaGraphConditionalHandle handle, const bool* go,
                      long long* runs, cudaGraphNode_t* node) {
  void* args[] = {&handle, &go, &runs};
  cudaKernelNodeParams p = {};
  p.func = reinterpret_cast<void*>(pps_set_conditional);
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, deps, ndeps, &p);
}

// A WHILE loop in ``g`` after ``ndeps`` nodes ``deps``: a guard node that
// sets a new handle from ``*go`` (and adds it to ``*runs``), then the WHILE
// node on that handle.  Out: the WHILE node, its (empty) body graph and the
// handle, which the body's closing guard sets.
cudaError_t add_while(cudaGraph_t g, const cudaGraphNode_t* deps, size_t ndeps,
                      const bool* go, long long* runs, cudaGraphNode_t* node,
                      cudaGraph_t* body, cudaGraphConditionalHandle* handle) {
  cudaGraphConditionalHandle h;
  cudaError_t err = cudaGraphConditionalHandleCreate(&h, g, 0, cudaGraphCondAssignDefault);
  if (err != cudaSuccess) return err;
  cudaGraphNode_t guard;
  err = add_guard(g, deps, ndeps, h, go, runs, &guard);
  if (err != cudaSuccess) return err;
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = h;
  p.conditional.type = cudaGraphCondTypeWhile;
  p.conditional.size = 1;
  err = cudaGraphAddNode(node, g, &guard, 1, &p);
  if (err != cudaSuccess) return err;
  *body = p.conditional.phGraph_out[0];
  *handle = h;
  return cudaSuccess;
}

}  // namespace

extern "C" {

const char* pps_graph_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int pps_graph_driver_version(int* version) {
  return cudaDriverGetVersion(version);
}

int pps_graph_runtime_version(int* version) {
  return cudaRuntimeGetVersion(version);
}

int pps_graph_create(void** graph) {
  return cudaGraphCreate(reinterpret_cast<cudaGraph_t*>(graph), 0);
}

// A memset node zeroing ``count`` 8-byte counters at ``dst``, after ``dep``
// (null: a root node).
int pps_graph_add_zero(void* graph, void* dep, long long* dst, int count, void** node) {
  cudaMemsetParams p = {};
  p.dst = dst;
  p.pitch = 0;
  p.value = 0;
  p.elementSize = 4;
  p.width = 2 * static_cast<size_t>(count);
  p.height = 1;
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  return cudaGraphAddMemsetNode(reinterpret_cast<cudaGraphNode_t*>(node),
                                static_cast<cudaGraph_t>(graph), d ? &d : nullptr,
                                d ? 1 : 0, &p);
}

// A child-graph node holding a clone of ``child`` (a captured graph), after
// ``dep`` (null: a root node).
int pps_graph_add_child(void* graph, void* dep, void* child, void** node) {
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  return cudaGraphAddChildGraphNode(reinterpret_cast<cudaGraphNode_t*>(node),
                                    static_cast<cudaGraph_t>(graph), d ? &d : nullptr,
                                    d ? 1 : 0, static_cast<cudaGraph_t>(child));
}

// A WHILE loop in ``graph`` after ``dep`` (null: a root node); see
// add_while.  Out: the WHILE node, its (empty) body graph and the handle.
int pps_graph_add_while(void* graph, void* dep, const bool* go, long long* runs,
                        void** node, void** body, unsigned long long* handle) {
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  cudaGraphConditionalHandle h;
  cudaError_t err = add_while(static_cast<cudaGraph_t>(graph), d ? &d : nullptr, d ? 1 : 0,
                              go, runs, reinterpret_cast<cudaGraphNode_t*>(node),
                              reinterpret_cast<cudaGraph_t*>(body), &h);
  *handle = h;
  return err;
}

// A WHILE loop appended to the graph that ``stream`` is capturing, after
// the stream's capture
// dependencies: the entry guard, the WHILE node, and in its body a
// child-graph node holding a clone of ``child`` (the loop's pass, captured
// on its own over static buffers) and the closing guard.  The WHILE node
// becomes the stream's only capture dependency, so that what is captured
// next runs after the loop.  Out: the WHILE node and its body graph.  The
// captured graph replays, but the CUDA driver refuses to clone it into a
// child-graph node (cudaErrorNotSupported), which is how the Python side
// composes pieces; so a loop inside a piece cuts the piece instead
// (utils/graphs.py, PieceLoop), and this function serves the card test
// that shows the refusal.
int pps_capture_add_while(void* stream, void* child, const bool* go, long long* runs,
                          void** node, void** body) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaStreamCaptureStatus status;
  cudaGraph_t g = nullptr;
  const cudaGraphNode_t* deps = nullptr;
  size_t ndeps = 0;
#if CUDART_VERSION >= 13000
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &g, &deps, nullptr, &ndeps);
#else
  cudaError_t err = cudaStreamGetCaptureInfo(s, &status, nullptr, &g, &deps, &ndeps);
#endif
  if (err != cudaSuccess) return err;
  if (status != cudaStreamCaptureStatusActive) return cudaErrorStreamCaptureImplicit;
  cudaGraphNode_t w;
  cudaGraph_t b;
  cudaGraphConditionalHandle h;
  err = add_while(g, deps, ndeps, go, runs, &w, &b, &h);
  if (err != cudaSuccess) return err;
  cudaGraphNode_t pass, guard;
  err = cudaGraphAddChildGraphNode(&pass, b, nullptr, 0, static_cast<cudaGraph_t>(child));
  if (err != cudaSuccess) return err;
  err = add_guard(b, &pass, 1, h, go, runs, &guard);
  if (err != cudaSuccess) return err;
#if CUDART_VERSION >= 13000
  err = cudaStreamUpdateCaptureDependencies(s, &w, nullptr, 1, cudaStreamSetCaptureDependencies);
#else
  err = cudaStreamUpdateCaptureDependencies(s, &w, 1, cudaStreamSetCaptureDependencies);
#endif
  if (err != cudaSuccess) return err;
  *node = w;
  *body = b;
  return cudaSuccess;
}

// The closing guard of a WHILE body: sets ``handle`` from ``*go`` after
// ``dep`` (null: the body's only node, for an empty body).
int pps_graph_add_guard(void* graph, void* dep, unsigned long long handle, const bool* go,
                        long long* runs, void** node) {
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  return add_guard(static_cast<cudaGraph_t>(graph), d ? &d : nullptr, d ? 1 : 0, handle, go,
                   runs, reinterpret_cast<cudaGraphNode_t*>(node));
}

// A stamp (``clock``: the clock stamp) on ``stream``, eager or captured.
// cudaLaunchKernel returns this launch's own error, not one an earlier call
// left behind.
int pps_stamp_launch(unsigned long long id, unsigned long long* buf,
                     unsigned long long* cursor, unsigned long long cap, int clock,
                     void* stream) {
  void* args[] = {&id, &buf, &cursor, &cap};
  const void* fn = clock ? reinterpret_cast<const void*>(pps_stamp_clock)
                         : reinterpret_cast<const void*>(pps_stamp);
  return cudaLaunchKernel(fn, dim3(1), dim3(1), args, 0, static_cast<cudaStream_t>(stream));
}

// ``reads`` back-to-back reads of the timer into ``out`` on ``stream``.
int pps_timer_probe_launch(unsigned long long* out, int reads, void* stream) {
  void* args[] = {&out, &reads};
  return cudaLaunchKernel(reinterpret_cast<const void*>(pps_timer_probe), dim3(1), dim3(1),
                          args, 0, static_cast<cudaStream_t>(stream));
}

// The kernel, memcpy and memset nodes of ``graph`` and of the child graphs
// it holds, added to ``counts[0..2]``.
int pps_graph_count_nodes(void* graph, long long* counts) {
  return count_nodes(static_cast<cudaGraph_t>(graph), counts);
}

int pps_graph_instantiate(void* graph, void** exec) {
  return cudaGraphInstantiate(reinterpret_cast<cudaGraphExec_t*>(exec),
                              static_cast<cudaGraph_t>(graph), 0);
}

int pps_graph_launch(void* exec, void* stream) {
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                         static_cast<cudaStream_t>(stream));
}

int pps_graph_destroy(void* graph, void* exec) {
  cudaError_t err = cudaSuccess;
  if (exec) err = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph) {
    cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (err == cudaSuccess) err = e2;
  }
  return err;
}

}  // extern "C"
