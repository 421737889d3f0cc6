// Batched Viterbi over a dense graph of N > 32 states for Hopper (sm_90a):
// max-plus trellis with first-index argmax backpointers, optional frame
// mask and termination weights, then the backtrace, in one kernel.
//
// Replaces lnasr_tpu/ops/trellis_pallas.py:viterbi_pallas_dense
// (_viterbi_dense_kernel). The TPU kernel stored every frame's max row and
// recovered the path by exact-equality replay, because an argmax over the
// N x N candidates cost it more than the add, and it mapped -inf to a
// finite NEG so that its MXU relayout (0 * -inf) made no NaNs. Neither
// holds here: thread j keeps the running max and the FIRST i reaching it
// (strict > from i = 0, as torch.max and jnp.argmax) and writes an int16
// backpointer per (t, j); -inf stays -inf. The adds are the scan's
// (v[i] + A[i, j], then + log_b[t, j]) in the scan's order and max is
// exact, so paths and scores are bitwise those of
// lnasr_tpu_torch/ops/trellis.py:viterbi_scan (no --use_fast_math; there
// is no multiply to contract). Masked frames are identity steps whose
// backpointers point to themselves, as in the scan.
//
// Layout: one block per utterance, thread j = state j (strided past
// 1024). v lives in shared memory, double-buffered by frame parity; every
// thread reads v[i] as a broadcast and A[i, j] with its neighbours, so
// both reads are conflict-free / coalesced. A is staged in shared memory
// when it fits beside the rest (N <= ~230: 128 KB at the recognizer's
// N = 179); above that (N = 256 is 256 KB, more than a block's 227 KB) it
// is read through L1/L2 on every frame.
//
// What bounds it on an H100: at the recognizer's shape (N = 179, T = 510)
// it moves 0.5 MB (emissions, A, backpointers, path) and does
// 2 N^2 T = 33 M max/add operations: 0.15 us of bytes, 0.5 us of fp32
// peak. Neither is the limit: the T - 1 frames depend on each other and a
// block of ~200 threads runs each frame's N-long compare chain serially,
// so the time is ~T * N * (a shared-memory add/compare) plus one barrier
// per frame. Each frame's emissions are loaded before the chain so the
// load is hidden behind it; the backtrace stages 32 frames of
// backpointers in shared memory with one coalesced read and thread 0
// walks the chain there.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 32;             // backtrace frames staged per load
constexpr int MAX_THREADS = 1024;
constexpr int SMEM_LIMIT = 232448;    // a block's shared memory on sm_90

__device__ __forceinline__ void argmax_merge(float& bv, int& bi, float ov, int oi) {
    if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
}

__global__ void viterbi_dense_kernel(const float* __restrict__ log_pi,    // (N,)
                                     const float* __restrict__ log_a,     // (N, N)
                                     const float* __restrict__ log_b,     // (B, T, N)
                                     const uint8_t* __restrict__ mask,    // (B, T) or null
                                     const float* __restrict__ log_final, // (N,) or null
                                     int T, int N, int a_in_smem,
                                     int16_t* __restrict__ bp,            // (B, T, N) scratch
                                     int* __restrict__ path,              // (B, T)
                                     float* __restrict__ score)           // (B,)
{
    extern __shared__ __align__(16) unsigned char smem[];
    float* v = reinterpret_cast<float*>(smem);                  // [2][N]
    int16_t* stage = reinterpret_cast<int16_t*>(v + 2 * N);    // [CHUNK][N]
    float* sa = reinterpret_cast<float*>(stage + ((CHUNK * N + 7) & ~7));  // [N][N]
    __shared__ float red_v[MAX_THREADS / 32];
    __shared__ int red_i[MAX_THREADS / 32];
    __shared__ int state_sh;

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int nth = blockDim.x;
    const float* lb = log_b + (size_t)b * T * N;
    const uint8_t* mk = mask ? mask + (size_t)b * T : nullptr;
    int16_t* bpb = bp + (size_t)b * T * N;

    if (a_in_smem) {
        for (int k = tid; k < N * N; k += nth) sa[k] = log_a[k];
    }
    const float* A = a_in_smem ? sa : log_a;
    for (int j = tid; j < N; j += nth) v[j] = log_pi[j] + lb[j];
    __syncthreads();

    int cur = 0;
    for (int t = 1; t < T; ++t) {
        const float* vc = v + cur * N;
        float* vn = v + (cur ^ 1) * N;
        const float* lbt = lb + (size_t)t * N;
        int16_t* bpt = bpb + (size_t)t * N;
        if (mk == nullptr || mk[t]) {
            for (int j = tid; j < N; j += nth) {
                const float e = lbt[j];  // issued before the chain, used after it
                float best = vc[0] + A[j];
                int arg = 0;
                int i = 1;
                for (; i + 3 < N; i += 4) {
                    const float c0 = vc[i] + A[(size_t)i * N + j];
                    const float c1 = vc[i + 1] + A[(size_t)(i + 1) * N + j];
                    const float c2 = vc[i + 2] + A[(size_t)(i + 2) * N + j];
                    const float c3 = vc[i + 3] + A[(size_t)(i + 3) * N + j];
                    if (c0 > best) { best = c0; arg = i; }
                    if (c1 > best) { best = c1; arg = i + 1; }
                    if (c2 > best) { best = c2; arg = i + 2; }
                    if (c3 > best) { best = c3; arg = i + 3; }
                }
                for (; i < N; ++i) {
                    const float c = vc[i] + A[(size_t)i * N + j];
                    if (c > best) { best = c; arg = i; }
                }
                vn[j] = best + e;
                bpt[j] = (int16_t)arg;
            }
        } else {  // masked frame: identity step, self backpointers
            for (int j = tid; j < N; j += nth) {
                vn[j] = vc[j];
                bpt[j] = (int16_t)j;
            }
        }
        __syncthreads();
        cur ^= 1;
    }

    // termination: first argmax of v (+ log_final); score is its value
    const float* vc = v + cur * N;
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int j = tid; j < N; j += nth) {
        const float x = log_final ? vc[j] + log_final[j] : vc[j];
        argmax_merge(bv, bi, x, j);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        argmax_merge(bv, bi, ov, oi);
    }
    if ((tid & 31) == 0) { red_v[tid >> 5] = bv; red_i[tid >> 5] = bi; }
    __syncthreads();
    if (tid == 0) {
        for (int w = 1; w < nth / 32; ++w) argmax_merge(bv, bi, red_v[w], red_i[w]);
        if (bi >= N) bi = 0;  // every candidate NaN: cannot happen on real graphs
        score[b] = bv;
        path[(size_t)b * T + T - 1] = bi;
        state_sh = bi;
    }
    __syncthreads();

    // backtrace: path[t-1] = bp[t][path[t]] for t = T-1 .. 1
    int* pb = path + (size_t)b * T;
    int state = state_sh;
    for (int hi = T - 1; hi >= 1; hi -= CHUNK) {
        const int lo = hi - CHUNK + 1 > 1 ? hi - CHUNK + 1 : 1;
        const int count = (hi - lo + 1) * N;
        const int16_t* src = bpb + (size_t)lo * N;
        for (int k = tid; k < count; k += nth) stage[k] = src[k];
        __syncthreads();
        if (tid == 0) {
            for (int t = hi; t >= lo; --t) {
                state = stage[(t - lo) * N + state];
                pb[t - 1] = state;
            }
        }
        __syncthreads();
    }
}

// Mirrored by lnasr_tpu_torch/ops/viterbi_dense.py:smem_bytes (capacity rule).
size_t smem_bytes(int N, int a_in_smem) {
    size_t base = (size_t)2 * N * sizeof(float) + (size_t)((CHUNK * N + 7) & ~7) * sizeof(int16_t);
    return base + (a_in_smem ? (size_t)N * N * sizeof(float) : 0);
}

// Whether log_a is staged in shared memory at this N. Mirrored by
// lnasr_tpu_torch/ops/viterbi_dense.py (capacity rule).
int a_fits_smem(int N) {
    return smem_bytes(N, 1) + 1024 <= (size_t)SMEM_LIMIT ? 1 : 0;
}

}  // namespace

extern "C" int viterbi_dense_launch(const float* log_pi, const float* log_a, const float* log_b,
                                    const uint8_t* mask, const float* log_final,
                                    int B, int T, int N, int16_t* bp, int* path, float* score,
                                    void* stream) {
    if (N < 1 || N > 32767 || T < 1 || B < 1) return (int)cudaErrorInvalidValue;
    const int a_in_smem = a_fits_smem(N);
    const size_t smem = smem_bytes(N, a_in_smem);
    if (smem + 1024 > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(viterbi_dense_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    int threads = ((N + 31) / 32) * 32;
    if (threads > MAX_THREADS) threads = MAX_THREADS;
    viterbi_dense_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(
        log_pi, log_a, log_b, mask, log_final, T, N, a_in_smem, bp, path, score);
    return (int)cudaGetLastError();
}

extern "C" const char* viterbi_dense_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
