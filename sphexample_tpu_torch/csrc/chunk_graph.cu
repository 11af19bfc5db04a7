// The graph of a chunk of steps (core/step.py:make_chunk_body): the host
// side of a CUDA graph with conditional (IF) nodes, for NVIDIA Hopper
// (sm_90a).  Built by ops/_build.py with nvcc into a shared library with a
// plain C interface and bound with ctypes (core/step.py).
//
// Counterpart of the control flow of one JAX device program: the
// ``lax.while_loop`` of sphexample_tpu/core/step.py:make_chunk_body and the
// ``lax.cond`` of the lazy rebuild inside each step.  One step is captured
// by PyTorch, once, into three graphs (its head up to the rebuild decision,
// the rebuild, its tail); this file composes them, the same step n times:
//
//   head -> [IF live: step] -> [IF live: step] -> ...      (n IF nodes)
//   step = step_head -> [IF rebuild: rebuild] -> step_tail
//
// Nothing in a step depends on its place in the chunk: it reads and writes
// the chunk's fixed buffers, and its temporaries die inside it.  Each IF
// node has its own conditional handle, set by a one-thread kernel node
// (set_if_kernel) from a device flag that the pieces write: ``live``
// (total_time <= t_out, written by the chunk's head and by the step's tail)
// and ``rebuild`` (dx_acc >= h, written by the step's head).  A skipped body
// runs nothing, so the buffers it would write keep their values.  The pieces
// enter as child graph nodes, which copy them; PyTorch keeps the memory they
// address (its graph pool) alive while their graphs live.
//
// Everything here runs on the host while the graph is built, except
// set_if_kernel, which runs inside it.  No call synchronises.

#include <cuda_runtime.h>

namespace {

__global__ void set_if_kernel(cudaGraphConditionalHandle handle, const bool* flag) {
    cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

// *node = child(piece) after *node (null: a root node)
cudaError_t add_child(cudaGraph_t g, cudaGraphNode_t* node, cudaGraph_t piece) {
    cudaGraphNode_t dep = *node;
    return cudaGraphAddChildGraphNode(node, g, dep ? &dep : nullptr, dep ? 1 : 0,
                                      piece);
}

// [set handle from *flag] -> [IF handle] after *dep: *dep becomes the IF
// node, *body its (empty) body graph
cudaError_t add_if(cudaGraph_t g, cudaGraphNode_t* dep, const bool* flag,
                   cudaGraph_t* body) {
    cudaGraphConditionalHandle handle;
    cudaError_t err = cudaGraphConditionalHandleCreate(&handle, g, 0,
                                                       cudaGraphCondAssignDefault);
    if (err != cudaSuccess) return err;
    void* args[] = {&handle, &flag};
    cudaKernelNodeParams kp = {};
    kp.func = reinterpret_cast<void*>(set_if_kernel);
    kp.gridDim = dim3(1);
    kp.blockDim = dim3(1);
    kp.kernelParams = args;
    cudaGraphNode_t set;
    err = cudaGraphAddKernelNode(&set, g, dep, *dep ? 1 : 0, &kp);
    if (err != cudaSuccess) return err;
    cudaGraphNodeParams np = {};
    np.type = cudaGraphNodeTypeConditional;
    np.conditional.handle = handle;
    np.conditional.type = cudaGraphCondTypeIf;
    np.conditional.size = 1;
    err = cudaGraphAddNode(dep, g, &set, 1, &np);
    if (err != cudaSuccess) return err;
    *body = np.conditional.phGraph_out[0];
    return cudaSuccess;
}

}  // namespace

extern "C" {

// Build and instantiate the chunk graph of ``n_steps`` guarded steps from
// PyTorch's captured pieces (cudaGraph_t): ``head`` once, then ``n_steps``
// times the step ``step_head``, ``rebuild_body``, ``step_tail``.  ``live``
// and ``rebuild`` are device bools.  On success *graph_out / *exec_out hold
// the graph and its executable (free them with sph_chunk_graph_destroy).
// Returns 0 or a cudaError_t code.
int sph_chunk_graph_build(int n_steps, void* head, void* step_head, void* rebuild_body,
                          void* step_tail, const bool* live, const bool* rebuild,
                          void** graph_out, void** exec_out) {
    *graph_out = nullptr;
    *exec_out = nullptr;
    cudaGraph_t g;
    cudaError_t err = cudaGraphCreate(&g, 0);
    if (err != cudaSuccess) return err;
    cudaGraphNode_t tail = nullptr;
    err = add_child(g, &tail, static_cast<cudaGraph_t>(head));
    for (int k = 0; k < n_steps && err == cudaSuccess; ++k) {
        cudaGraph_t step, branch;
        err = add_if(g, &tail, live, &step);
        if (err != cudaSuccess) break;
        cudaGraphNode_t s = nullptr;
        err = add_child(step, &s, static_cast<cudaGraph_t>(step_head));
        if (err == cudaSuccess) err = add_if(step, &s, rebuild, &branch);
        cudaGraphNode_t b = nullptr;
        if (err == cudaSuccess)
            err = add_child(branch, &b, static_cast<cudaGraph_t>(rebuild_body));
        if (err == cudaSuccess)
            err = add_child(step, &s, static_cast<cudaGraph_t>(step_tail));
    }
    cudaGraphExec_t exec = nullptr;
    if (err == cudaSuccess) err = cudaGraphInstantiate(&exec, g, 0);
    if (err != cudaSuccess) {
        cudaGraphDestroy(g);
        return err;
    }
    *graph_out = g;
    *exec_out = exec;
    return cudaSuccess;
}

// Launch the instantiated chunk graph on ``stream``.
int sph_chunk_graph_launch(void* exec, void* stream) {
    return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                           static_cast<cudaStream_t>(stream));
}

// Upload the executable to the device ahead of its first launch.
int sph_chunk_graph_upload(void* exec, void* stream) {
    return cudaGraphUpload(static_cast<cudaGraphExec_t>(exec),
                           static_cast<cudaStream_t>(stream));
}

// The node count of a graph, its nested graphs not included.
int sph_chunk_graph_nodes(void* graph, int* nodes_out) {
    size_t n = 0;
    cudaError_t err = cudaGraphGetNodes(static_cast<cudaGraph_t>(graph), nullptr, &n);
    *nodes_out = static_cast<int>(n);
    return err;
}

int sph_chunk_graph_destroy(void* graph, void* exec) {
    cudaError_t e1 = exec ? cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec))
                          : cudaSuccess;
    cudaError_t e2 = graph ? cudaGraphDestroy(static_cast<cudaGraph_t>(graph))
                           : cudaSuccess;
    return e1 != cudaSuccess ? e1 : e2;
}

const char* sph_chunk_graph_error_string(int err) {
    return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
