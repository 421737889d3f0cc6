// Exact trigram Viterbi backtrace for Hopper (sm_90a): the state path
// through the (T-1, H*V*S) int32 backpointers that trigram_forward.cu
// wrote, from the final argmax it left in `last`, for one utterance or
// for each of a batch's.
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
// walks an utterance: there is nothing to spread within one, and one launch
// replaces the T - 1 gathers the host queued.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

// One utterance (BATCH false: the single decode's code) or a thread an
// utterance of a batch, each walking its own (T-1, n_states) pointers from
// its own final state: B dependent chains side by side, each the latency of
// T - 1 loads, so a batch's walk takes about one utterance's time. A masked
// frame's pointers point to themselves, so no utterance needs its mask.
template <bool BATCH>
__global__ void trigram_backtrace_kernel(const int* __restrict__ bts, const int* __restrict__ last,
                                         int B, int T, long long n_states, int* __restrict__ path) {
    int b = 0;
    if (BATCH) {
        b = blockIdx.x * blockDim.x + threadIdx.x;
        if (b >= B) return;
        bts += (size_t)b * (T - 1) * n_states;
        path += (size_t)b * T;
    }
    int s = last[b];
    path[T - 1] = s;
    for (int t = T - 2; t >= 0; --t) {
        s = bts[(size_t)t * n_states + s];
        path[t] = s;
    }
}

}  // namespace

// bts (B, T-1, n_states), last (B,) -> path (B, T), B >= 1.
extern "C" int trigram_backtrace_launch(const int* bts, const int* last, int B, int T,
                                        long long n_states, int* path, void* stream) {
    if (B < 1 || T < 1 || n_states < 1) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    if (B == 1)
        trigram_backtrace_kernel<false><<<1, 1, 0, st>>>(bts, last, B, T, n_states, path);
    else
        trigram_backtrace_kernel<true><<<(B + 31) / 32, 32, 0, st>>>(bts, last, B, T, n_states,
                                                                   path);
    return (int)cudaGetLastError();
}

extern "C" const char* trigram_backtrace_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
