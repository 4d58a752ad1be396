// The solve loops' device-side exit: one CUDA graph per solve, its check
// windows under conditional WHILE nodes.
//
// The counterpart of the JAX package's `lax.while_loop` (reluqp_tpu/core/
// iteration.py `solve_loop`, `run_refined_phases`; reluqp_tpu/core/
// batched.py `_run_refined`) and of the `lax.scan` body of its loop-path
// MPC rollouts (reluqp_tpu/models/mpc.py `_rollout_impl`,
// `_scenario_rollout_impl`). It is not a port of a Pallas kernel: the
// windows' own kernels (K1, K4, K5 and the residual products) are captured
// by PyTorch as they run; this file only joins those captures into one graph
// whose control flow the card decides.
//
// A program is a chain of nodes in one graph:
//   * a child-graph node per captured piece (a check window, the start state,
//     the result bundle), cloned from the raw cudaGraph_t of a
//     torch.cuda.CUDAGraph(keep_graph=True);
//   * a loop: gl_flag_kernel reads the int32 flag the pieces before it wrote
//     and sets the loop's conditional handle, then a conditional WHILE node
//     whose body is the window's child graph followed by gl_flag_kernel
//     again (the window wrote the flag anew; the kernel also adds one to the
//     loop's body count);
//   * a conditional IF node the same way, its body run at most once (the
//     max_iter % check_interval tail window).
// The body counts are doubles the host reads with the solve's result, so
// that launch counters kept on the host count every body execution.
//
// What bounds it: nothing of the arithmetic. The flag kernel is one thread;
// a conditional node costs the card a few microseconds to evaluate, in place
// of a host round trip (graph launch, bundle copy, synchronisation) per
// window.
//
// Plain C interface, built with nvcc into a shared library and called with
// ctypes. Every entry returns a cudaError_t (0 on success).

#include <cuda_runtime.h>

namespace {

__global__ void gl_flag_kernel(cudaGraphConditionalHandle handle,
                               const int* flag, double* count, int set) {
    if (count != nullptr) *count += 1.0;
    if (set) cudaGraphSetConditional(handle, *flag != 0 ? 1u : 0u);
}

cudaError_t add_node(cudaGraphNode_t* out, cudaGraph_t graph, void* dep,
                     cudaGraphNodeParams* params) {
    cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
    return cudaGraphAddNode(out, graph, dep ? &d : nullptr, dep ? 1 : 0,
                            params);
}

}  // namespace

extern "C" {

int gl_graph_create(void** out) {
    cudaGraph_t g = nullptr;
    cudaError_t e = cudaGraphCreate(&g, 0);
    *out = g;
    return e;
}

int gl_graph_destroy(void* graph) {
    return cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
}

// A child-graph node running a clone of `child` after `dep` (or first).
int gl_add_child(void* graph, void* dep, void* child, void** out) {
    cudaGraphNode_t node = nullptr;
    cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
    cudaError_t e = cudaGraphAddChildGraphNode(
        &node, static_cast<cudaGraph_t>(graph), dep ? &d : nullptr,
        dep ? 1 : 0, static_cast<cudaGraph_t>(child));
    *out = node;
    return e;
}

// A conditional handle for a node of `graph`, 0 at every launch until a
// flag kernel sets it.
int gl_handle(void* graph, unsigned long long* out) {
    cudaGraphConditionalHandle h = 0;
    cudaError_t e = cudaGraphConditionalHandleCreate(
        &h, static_cast<cudaGraph_t>(graph), 0, cudaGraphCondAssignDefault);
    *out = static_cast<unsigned long long>(h);
    return e;
}

// gl_flag_kernel after `dep`: sets `handle` from *flag when `set`, adds one
// to *count when `count` is not null.
int gl_add_flag(void* graph, void* dep, unsigned long long handle,
                void* flag, void* count, int set, void** out) {
    cudaGraphConditionalHandle h = handle;
    const int* f = static_cast<const int*>(flag);
    double* c = static_cast<double*>(count);
    void* args[] = {&h, &f, &c, &set};
    cudaGraphNodeParams p = {};
    p.type = cudaGraphNodeTypeKernel;
    p.kernel.func = reinterpret_cast<void*>(gl_flag_kernel);
    p.kernel.gridDim = dim3(1);
    p.kernel.blockDim = dim3(1);
    p.kernel.sharedMemBytes = 0;
    p.kernel.kernelParams = args;
    p.kernel.extra = nullptr;
    cudaGraphNode_t node = nullptr;
    cudaError_t e = add_node(&node, static_cast<cudaGraph_t>(graph), dep, &p);
    *out = node;
    return e;
}

// A conditional node on `handle` after `dep`: a WHILE node (`loop` != 0) or
// an IF node; `body` receives the graph its body is built in.
int gl_add_cond(void* graph, void* dep, unsigned long long handle, int loop,
                void** body, void** out) {
    cudaGraphNodeParams p = {};
    p.type = cudaGraphNodeTypeConditional;
    p.conditional.handle = handle;
    p.conditional.type = loop ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
    p.conditional.size = 1;
    cudaGraphNode_t node = nullptr;
    cudaError_t e = add_node(&node, static_cast<cudaGraph_t>(graph), dep, &p);
    *body = e == cudaSuccess ? p.conditional.phGraph_out[0] : nullptr;
    *out = node;
    return e;
}

int gl_instantiate(void* graph, void** exec) {
    cudaGraphExec_t x = nullptr;
    cudaError_t e = cudaGraphInstantiate(&x, static_cast<cudaGraph_t>(graph),
                                         0);
    *exec = x;
    return e;
}

int gl_launch(void* exec, void* stream) {
    cudaError_t e = cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                    static_cast<cudaStream_t>(stream));
    return e != cudaSuccess ? e : cudaGetLastError();
}

int gl_exec_destroy(void* exec) {
    return cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
}

const char* gl_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
