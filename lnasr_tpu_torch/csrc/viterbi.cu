// Batched small-N Viterbi for Hopper (sm_90a): forward max-plus trellis
// with first-index argmax backpointers, then the backtrace, in one kernel.
//
// Replaces lnasr_tpu/ops/trellis_pallas.py:viterbi_pallas (_viterbi_kernel).
// The TPU kernel put states on sublanes and 128 utterances on lanes; here
// one warp (one block) owns one utterance and lane j owns state j (N <= 32).
// Per step, lane j takes cand_i = v[i] + A[i, j] with v[i] broadcast by
// __shfl_sync, and picks the max and the FIRST i reaching it with a
// balanced tree over (value, index) pairs: of two neighbouring ranges the
// higher one wins only when strictly larger, so exact ties keep the lower
// index (jnp.argmax's rule). Then v[j] = max + log_b[b, t, j]. Those are the
// same two fp32 adds in the same order as lnasr_tpu/ops/trellis.py:
// viterbi_scan, and max is exact, so scores and paths are bitwise equal to
// the scan (no --use_fast_math; there is no multiply for the compiler to
// contract). A column that is all -inf gives -inf and backpointer 0. For
// N <= 8 (the serving step's N = 5) N is a template argument: the step is
// N shuffles, N adds and a tree of depth ceil(log2 N). N <= 16 and <= 32
// run the same step over 16 or 32 candidates, the states past N at -inf.
//
// Backpointers stay in shared memory for the whole utterance where T * N
// bytes fit (ops/viterbi.py:viterbi_smem_ok), else in a (B, T, N) int8
// scratch buffer in device memory. The backtrace composes maps instead of
// walking T - 1 dependent loads: T - 1 steps are cut into chunks of K = 32;
// (1) the lanes walk every chunk from each of its N end states at once,
// several walks a lane interleaved, and record each chunk's start state per
// end state; (2) lane 0 composes the chunk maps from the last frame back,
// one load a chunk; (3) the lanes walk the chunks again in parallel from
// their now known end states and write the path. Index-following only, so
// exact; the dependent depth is about 2K + T/K loads (95 at T = 999)
// instead of T - 1.
//
// What bounds it on an H100: at the serving shape (B=64, T=999, N=5) it
// reads 1.3 MB of emissions and writes 0.26 MB of path, well under 1 us at
// 3.35 TB/s, and does 2*N*N operations per utterance-frame, far below the
// fp32 peak. Neither is the limit: the trellis is a chain of T-1 = 998
// dependent steps, so its time is the latency of one step times T. The
// emissions of the next STEPS frames are prefetched into registers while
// the current ones are used, so no step waits on device memory, and each
// utterance has its own block, so 64 utterances take 64 SMs.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int STEPS = 16;    // emissions prefetched per group of frames
constexpr int K = 32;        // backtrace chunk (ops/viterbi.py:BACKTRACE_CHUNK)
constexpr int WALKS = 8;     // chunk walks interleaved per lane
constexpr unsigned FULL = 0xffffffffu;

// first-index argmax of c[LO..HI) as a balanced tree; ties keep the lower
template <int LO, int HI, int NMAX>
__device__ __forceinline__ void tree_argmax(const float (&c)[NMAX], float& bv, int& bi) {
    if constexpr (HI - LO == 1) {
        bv = c[LO];
        bi = LO;
    } else {
        constexpr int MID = LO + (HI - LO + 1) / 2;
        float lv, rv;
        int li, ri;
        tree_argmax<LO, MID>(c, lv, li);
        tree_argmax<MID, HI>(c, rv, ri);
        const bool right = rv > lv;
        bv = right ? rv : lv;
        bi = right ? ri : li;
    }
}

// NMAX: candidates a step (= N when EXACT); SMEM: backpointers in shared memory
template <int NMAX, bool EXACT, bool SMEM>
__global__ void __launch_bounds__(32)
viterbi_kernel(const float* __restrict__ log_pi,   // (N,)
               const float* __restrict__ log_a,    // (N, N)
               const float* __restrict__ log_b,    // (B, T, N)
               int T, int n_rt,
               int8_t* __restrict__ bp_global,     // (B, T, N) scratch (global route)
               int* __restrict__ path,             // (B, T)
               float* __restrict__ score)          // (B,)
{
    extern __shared__ int8_t smem[];
    const int N = EXACT ? NMAX : n_rt;
    const int lane = threadIdx.x;
    const int b = blockIdx.x;
    const bool on = lane < N;
    const float NEG_INF = -INFINITY;
    const int n_chunks = (T - 1 + K - 1) / K;
    int8_t* bp = SMEM ? smem : bp_global + (size_t)b * T * N;
    int8_t* maps = SMEM ? smem + (size_t)T * N : smem;  // (n_chunks, N) start states
    int8_t* ends = maps + (size_t)n_chunks * N;          // (n_chunks,) end states

    float a[NMAX];  // column j = lane of the transition matrix
#pragma unroll
    for (int i = 0; i < NMAX; ++i) a[i] = (on && i < N) ? log_a[i * N + lane] : NEG_INF;

    const float* lb = log_b + (size_t)b * T * N;
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
            float c[NMAX];
#pragma unroll
            for (int i = 0; i < NMAX; ++i) c[i] = __shfl_sync(FULL, v, i) + a[i];
            float best;
            int arg;
            tree_argmax<0, NMAX>(c, best, arg);
            if (on) {
                v = best + cur[k];
                bp[(size_t)t * N + lane] = (int8_t)arg;
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
    if (lane == 0) {
        score[b] = bv;
        pb[T - 1] = bi;
    }
    __syncwarp();  // backpointer stores of every lane visible to the warp

    // (1) chunk c covers steps (c K, min((c + 1) K, T - 1)]: from each end
    //     state e at its top step, follow its K backpointers to the state at
    //     frame c K; WALKS walks a lane at once
    const int n_walks = n_chunks * N;
    for (int w0 = 0; w0 < n_walks; w0 += 32 * WALKS) {
        int s[WALKS], top[WALKS], low[WALKS];
#pragma unroll
        for (int q = 0; q < WALKS; ++q) {
            const int w = w0 + lane + 32 * q;
            const int c = w / N;
            s[q] = w - c * N;
            top[q] = w < n_walks ? min((c + 1) * K, T - 1) : 0;
            low[q] = c * K + 1;
        }
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
#pragma unroll
            for (int q = 0; q < WALKS; ++q) {
                const int t = top[q] - k;
                if (t >= low[q]) s[q] = bp[(size_t)t * N + s[q]];
            }
        }
#pragma unroll
        for (int q = 0; q < WALKS; ++q) {
            const int w = w0 + lane + 32 * q;
            if (w < n_walks) maps[w] = (int8_t)s[q];
        }
    }
    __syncwarp();
    // (2) each chunk's end state, from the last frame back
    if (lane == 0 && n_chunks > 0) {
        int e = bi;
        ends[n_chunks - 1] = (int8_t)e;
        for (int c = n_chunks - 1; c > 0; --c) {
            e = maps[c * N + e];
            ends[c - 1] = (int8_t)e;
        }
    }
    __syncwarp();
    // (3) the path, the chunks walked again in parallel from their end states
    for (int c0 = 0; c0 < n_chunks; c0 += 32 * WALKS) {
        int s[WALKS], top[WALKS], low[WALKS];
#pragma unroll
        for (int q = 0; q < WALKS; ++q) {
            const int c = c0 + lane + 32 * q;
            s[q] = c < n_chunks ? ends[c] : 0;
            top[q] = c < n_chunks ? min((c + 1) * K, T - 1) : 0;
            low[q] = c * K + 1;
        }
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
#pragma unroll
            for (int q = 0; q < WALKS; ++q) {
                const int t = top[q] - k;
                if (t >= low[q]) {
                    s[q] = bp[(size_t)t * N + s[q]];
                    pb[t - 1] = s[q];
                }
            }
        }
    }
}

size_t smem_bytes(int T, int N, bool on_chip) {
    const size_t n_chunks = (size_t)(T - 1 + K - 1) / K;
    return (on_chip ? (size_t)T * N : 0) + n_chunks * (N + 1);
}

template <int NMAX, bool EXACT, bool SMEM>
int launch(const float* log_pi, const float* log_a, const float* log_b, int B, int T, int N,
           int8_t* bp, int* path, float* score, cudaStream_t s) {
    const size_t smem = smem_bytes(T, N, SMEM);
    cudaError_t err = cudaFuncSetAttribute(viterbi_kernel<NMAX, EXACT, SMEM>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    viterbi_kernel<NMAX, EXACT, SMEM><<<B, 32, smem, s>>>(log_pi, log_a, log_b, T, N, bp, path,
                                                          score);
    return (int)cudaGetLastError();
}

template <bool SMEM>
int launch_route(const float* log_pi, const float* log_a, const float* log_b, int B, int T, int N,
                 int8_t* bp, int* path, float* score, cudaStream_t s) {
#define EXACT_N(n) \
    case n: return launch<n, true, SMEM>(log_pi, log_a, log_b, B, T, N, bp, path, score, s);
    switch (N) {
        EXACT_N(1) EXACT_N(2) EXACT_N(3) EXACT_N(4) EXACT_N(5) EXACT_N(6) EXACT_N(7) EXACT_N(8)
        default: break;
    }
#undef EXACT_N
    if (N <= 16) return launch<16, false, SMEM>(log_pi, log_a, log_b, B, T, N, bp, path, score, s);
    return launch<32, false, SMEM>(log_pi, log_a, log_b, B, T, N, bp, path, score, s);
}

}  // namespace

// on_chip: backpointers in shared memory (the caller's capacity rule,
// ops/viterbi.py:viterbi_smem_ok); else in bp, a (B, T, N) int8 scratch
extern "C" int viterbi_launch(const float* log_pi, const float* log_a, const float* log_b,
                              int B, int T, int N, int on_chip, int8_t* bp, int* path,
                              float* score, void* stream) {
    if (N < 1 || N > 32 || (!on_chip && bp == nullptr)) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    return on_chip ? launch_route<true>(log_pi, log_a, log_b, B, T, N, bp, path, score, s)
                   : launch_route<false>(log_pi, log_a, log_b, B, T, N, bp, path, score, s);
}

extern "C" const char* viterbi_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
