// Batched small-N Viterbi for Hopper (sm_90a): forward max-plus trellis
// with first-index argmax backpointers, then the backtrace, in one kernel.
//
// Replaces lnasr_tpu/ops/trellis_pallas.py:viterbi_pallas (_viterbi_kernel).
// The TPU kernel put states on sublanes and 128 utterances on lanes; here
// one warp owns one utterance and lane j owns state j (N <= 32), several
// warps to a block. Per step, lane j takes cand_i = v[i] + A[i, j] with
// v[i] broadcast by __shfl_sync, keeps the max and the FIRST i reaching it
// (strict > from i = 0, as jnp.argmax), then v[j] = max + log_b[b, t, j].
// Those are the same two fp32 adds in the same order as
// lnasr_tpu/ops/trellis.py:viterbi_scan, and max is exact, so scores and
// paths are bitwise equal to the scan (no --use_fast_math; there is no
// multiply for the compiler to contract). A column that is all -inf gives
// -inf and backpointer 0.
//
// Backpointers go to a (B, T, N) int8 scratch buffer the wrapper
// allocates. The backtrace then walks it from the last frame: the warp
// stages 32 frames of backpointers in shared memory with one coalesced
// read and lane 0 follows the chain there, so each frame costs a
// shared-memory load instead of a device-memory round trip.
//
// What bounds it on an H100: at the serving shape (B=64, T=999, N=5) it
// reads 1.3 MB of emissions and writes 0.26 MB of path, well under 1 us at
// 3.35 TB/s, and does 2*N*N operations per utterance-frame, far below the
// fp32 peak. Neither is the limit: the trellis is a chain of T-1 = 998
// dependent steps (and the backtrace another 998), so its time is the
// latency of one step times T. The design keeps each step to N shuffles
// and a compare chain in registers, prefetches the emissions of the next
// STEPS frames while computing the current ones, so no step waits on
// device memory, and gives each utterance its own warp so utterances run
// side by side.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;     // utterances per block
constexpr int STEPS = 16;    // emissions prefetched per group of frames
constexpr int CHUNK = 32;    // backtrace frames staged per shared-memory load
constexpr unsigned FULL = 0xffffffffu;

template <int NMAX>
__global__ void __launch_bounds__(WARPS * 32)
viterbi_kernel(const float* __restrict__ log_pi,   // (N,)
               const float* __restrict__ log_a,    // (N, N)
               const float* __restrict__ log_b,    // (B, T, N)
               int B, int T, int N,
               int8_t* __restrict__ bp,            // (B, T, N) scratch
               int* __restrict__ path,             // (B, T)
               float* __restrict__ score)          // (B,)
{
    __shared__ int8_t stage[WARPS][CHUNK * 32];
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int b = blockIdx.x * WARPS + warp;
    if (b >= B) return;  // warp-uniform
    const bool on = lane < N;
    const float NEG_INF = -INFINITY;

    float a[NMAX];  // column j = lane of the transition matrix
#pragma unroll
    for (int i = 0; i < NMAX; ++i) a[i] = (on && i < N) ? log_a[i * N + lane] : NEG_INF;

    const float* lb = log_b + (size_t)b * T * N;
    int8_t* bpb = bp + (size_t)b * T * N;
    float v = on ? log_pi[lane] + lb[lane] : NEG_INF;

    float cur[STEPS], nxt[STEPS];
#pragma unroll
    for (int k = 0; k < STEPS; ++k) {
        int t = 1 + k;
        cur[k] = (on && t < T) ? lb[(size_t)t * N + lane] : 0.0f;
    }
    for (int t0 = 1; t0 < T; t0 += STEPS) {
#pragma unroll
        for (int k = 0; k < STEPS; ++k) {
            int t = t0 + STEPS + k;
            nxt[k] = (on && t < T) ? lb[(size_t)t * N + lane] : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < STEPS; ++k) {
            const int t = t0 + k;
            if (t >= T) break;  // uniform across the warp
            float best = __shfl_sync(FULL, v, 0) + a[0];
            int arg = 0;
#pragma unroll
            for (int i = 1; i < NMAX; ++i) {
                if (i >= N) break;
                float c = __shfl_sync(FULL, v, i) + a[i];
                if (c > best) { best = c; arg = i; }
            }
            if (on) {
                v = best + cur[k];
                bpb[(size_t)t * N + lane] = (int8_t)arg;
            }
        }
#pragma unroll
        for (int k = 0; k < STEPS; ++k) cur[k] = nxt[k];
    }

    // final state: first argmax of v; score: its max
    float bv = v;
    int bi = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        float ov = __shfl_xor_sync(FULL, bv, off);
        int oi = __shfl_xor_sync(FULL, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
    }
    int* pb = path + (size_t)b * T;
    int state = bi;
    if (lane == 0) {
        score[b] = bv;
        pb[T - 1] = state;
    }
    __syncwarp();  // backpointer stores of every lane visible to the warp

    // backtrace: path[t-1] = bp[t][path[t]] for t = T-1 .. 1
    int8_t* st = stage[warp];
    for (int hi = T - 1; hi >= 1; hi -= CHUNK) {
        const int lo = hi - CHUNK + 1 > 1 ? hi - CHUNK + 1 : 1;
        const int count = (hi - lo + 1) * N;
        const int8_t* src = bpb + (size_t)lo * N;
        for (int i = lane; i < count; i += 32) st[i] = src[i];
        __syncwarp();
        if (lane == 0) {
            for (int t = hi; t >= lo; --t) {
                state = st[(t - lo) * N + state];
                pb[t - 1] = state;
            }
        }
        __syncwarp();
    }
}

}  // namespace

extern "C" int viterbi_launch(const float* log_pi, const float* log_a, const float* log_b,
                              int B, int T, int N, int8_t* bp, int* path, float* score,
                              void* stream) {
    if (N < 1 || N > 32) return (int)cudaErrorInvalidValue;
    dim3 grid((B + WARPS - 1) / WARPS);
    dim3 block(WARPS * 32);
    cudaStream_t s = (cudaStream_t)stream;
    if (N <= 8)
        viterbi_kernel<8><<<grid, block, 0, s>>>(log_pi, log_a, log_b, B, T, N, bp, path, score);
    else if (N <= 16)
        viterbi_kernel<16><<<grid, block, 0, s>>>(log_pi, log_a, log_b, B, T, N, bp, path, score);
    else
        viterbi_kernel<32><<<grid, block, 0, s>>>(log_pi, log_a, log_b, B, T, N, bp, path, score);
    return (int)cudaGetLastError();
}

extern "C" const char* viterbi_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
