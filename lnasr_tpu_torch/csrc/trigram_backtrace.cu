// Exact trigram Viterbi backtrace for Hopper (sm_90a): the state path
// through the (T-1, H*V*S) int32 backpointers that trigram_forward.cu
// wrote, from the final argmax it left in `last`.
//
// Replaces the reverse lax.scan of lnasr_tpu/models/decoder.py:1567-1571
// (one gather a frame inside the jitted decode), and the port's frame
// loop of one torch gather a frame (ops/trigram.py:
// trigram_backtrace_plain), whose path it equals bitwise: a masked frame's
// backpointers point to themselves, so the walk needs no mask.
//
// What bounds it: T - 1 dependent loads, each one int32 of a 1.3 MB
// backpointer frame that has long left L2 at V = 200 (511 frames, 664 MB),
// so the walk costs T times the latency of a device-memory load, ~0.5 us;
// its bytes (T ints in, T out) take nothing at 3.35 TB/s. One thread
// walks: there is nothing to spread, and one launch replaces the T - 1
// gathers the host queued.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void trigram_backtrace_kernel(const int* __restrict__ bts, const int* __restrict__ last,
                                         int T, long long n_states, int* __restrict__ path) {
    int s = *last;
    path[T - 1] = s;
    for (int t = T - 2; t >= 0; --t) {
        s = bts[(size_t)t * n_states + s];
        path[t] = s;
    }
}

}  // namespace

extern "C" int trigram_backtrace_launch(const int* bts, const int* last, int T, long long n_states,
                                        int* path, void* stream) {
    if (T < 1 || n_states < 1) return (int)cudaErrorInvalidValue;
    trigram_backtrace_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(bts, last, T, n_states, path);
    return (int)cudaGetLastError();
}

extern "C" const char* trigram_backtrace_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
