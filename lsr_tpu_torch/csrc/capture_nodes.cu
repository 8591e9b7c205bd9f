// The nodes of the CUDA graph that a stream is capturing into, counted by
// type.  utils/trace.py's stages call it at their start and end while a
// frame is captured with tracing on, so each stage knows the kernel,
// memcpy and memset nodes it added to the graph: exact per replay, where a
// profiler's trace has to be matched to the stage afterwards.
//
// Not a kernel and no pallas_call's counterpart: host code that reads the
// graph under construction (cudaStreamGetCaptureInfo allows every
// operation on it but node removal and destruction while the capture
// runs).  It launches nothing and adds no node, so a traced graph differs
// from an untraced one only by the stages' event-record nodes.

#include <cuda_runtime.h>

#include <vector>

// counts[t] = the graph's nodes of cudaGraphNodeType t, for t < n_types
// (every other slot set to 0); a type at or above n_types counts in
// counts[n_types - 1].  Returns a cudaError_t: cudaErrorIllegalState where
// the stream is not capturing.
extern "C" int lsr_capture_nodes(cudaStream_t stream, int* counts,
                                 int n_types) {
    if (n_types <= 0) return (int)cudaErrorInvalidValue;
    cudaStreamCaptureStatus status;
    cudaGraph_t graph = nullptr;
    cudaError_t err = cudaStreamGetCaptureInfo(stream, &status, nullptr,
                                               &graph);
    if (err != cudaSuccess) return (int)err;
    if (status != cudaStreamCaptureStatusActive || graph == nullptr)
        return (int)cudaErrorIllegalState;
    size_t n = 0;
    err = cudaGraphGetNodes(graph, nullptr, &n);
    if (err != cudaSuccess) return (int)err;
    std::vector<cudaGraphNode_t> nodes(n);
    if (n) {
        err = cudaGraphGetNodes(graph, nodes.data(), &n);
        if (err != cudaSuccess) return (int)err;
    }
    for (int t = 0; t < n_types; ++t) counts[t] = 0;
    for (size_t i = 0; i < n; ++i) {
        cudaGraphNodeType t;
        err = cudaGraphNodeGetType(nodes[i], &t);
        if (err != cudaSuccess) return (int)err;
        const int k = (int)t;
        counts[k >= 0 && k < n_types ? k : n_types - 1] += 1;
    }
    return (int)cudaSuccess;
}
