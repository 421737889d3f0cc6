// Factored word-graph Viterbi backtrace for Hopper (sm_90a): the decoded
// path in v*S+s grid ids and its score, re-derived from the stored grids
// of factored_forward.cu.
//
// Replaces the backtrace half of lnasr_tpu/ops/factored_pallas.py:
// factored_decode_pallas (_bwd_kernel). No backpointers were stored, so
// each step replays the forward's argmax rules exactly on the stored
// (bitwise) grid values: the first s maximizing grid[t-1][w, s] +
// inner_a[w, s, j] within the word; at local state j = 0 the first source
// word maximizing exit[v] + hop[v, w] (or the rank-1 argmax over
// exit + from_w, and over exit + sil_from for the silence word), taken
// only when strictly better than the within-word candidate; masked frames
// point to themselves. Termination is the first maximum of
// grid[T-1] + final over flat v*S+s ids. These are the rules of
// lnasr_tpu_torch/models/decoder.py:factored_trellis_scan, so the path and
// score are bitwise those of the scan. Hop kind "none" (loop-free graphs)
// is taken here too, where the JAX package fell back to an XLA scan.
//
// What bounds it on an H100: it reads at most the 16 MB of grids once
// (V = 1000, S = 8, T = 510), ~5 us at 3.35 TB/s, and computes little. In
// practice it is a latency chain: T - 1 dependent steps, each needing the
// previous state. The design keeps a step short: one block per utterance,
// the within-word
// argmax is one warp's S-wide shuffle reduction, and the V-wide hop
// argmax (the expensive part: one hop column and V exit scores) runs with
// the whole block only at steps where the path sits at a word's first
// state, the only place the reference's rule can take the hop.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HOP_NONE = 0;
constexpr int HOP_DENSE = 1;
constexpr int HOP_RANK1 = 2;
constexpr int THREADS = 512;

struct Args {
    const float* grids;     // (T, V, S)
    const float* inner_a;   // (V, S, S)
    const int* exit_idx;    // (V,)
    const float* hop_t;     // (V, V) transposed: hop_t[w, v] = hop[v, w]
    const float* from_w;    // (V,)
    const float* uni;       // (V,)
    const float* sil_from;  // (V,)
    const float* final_grid;  // (V, S)
    const uint8_t* mask;    // (T,) or null
    int* path;              // (T,)
    float* score;           // ()
    int hop_kind, sil_idx, T, V, S;
};

__device__ __forceinline__ void argmax_merge(float& bv, int& bi, float ov, int oi) {
    if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
}

__device__ __forceinline__ void warp_argmax(float& bv, int& bi) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        argmax_merge(bv, bi, ov, oi);
    }
}

// First argmax over the whole block; every thread gets the result.
__device__ __forceinline__ void block_argmax(float& bv, int& bi, float* rv, int* ri) {
    warp_argmax(bv, bi);
    const int warp = threadIdx.x >> 5;
    __syncthreads();
    if ((threadIdx.x & 31) == 0) { rv[warp] = bv; ri[warp] = bi; }
    __syncthreads();
    bv = rv[0];
    bi = ri[0];
    for (int w = 1; w < (int)(blockDim.x >> 5); ++w) argmax_merge(bv, bi, rv[w], ri[w]);
}

__global__ void __launch_bounds__(THREADS) factored_backtrace_kernel(Args p) {
    __shared__ float rv[THREADS / 32];
    __shared__ int ri[THREADS / 32];
    __shared__ int state_sh;
    const int tid = threadIdx.x, nth = blockDim.x;
    const int V = p.V, S = p.S, T = p.T;
    const size_t frame = (size_t)V * S;
    const int BIG = 0x7fffffff;

    // termination over flat v*S+s ids
    float bv = -INFINITY;
    int bi = BIG;
    const float* last = p.grids + (size_t)(T - 1) * frame;
    for (int k = tid; k < (int)frame; k += nth) argmax_merge(bv, bi, last[k] + p.final_grid[k], k);
    block_argmax(bv, bi, rv, ri);
    int state = bi < (int)frame ? bi : 0;
    if (tid == 0) {
        p.score[0] = bv;
        p.path[T - 1] = state;
    }
    __syncthreads();  // rv is rewritten by the first step

    for (int t = T - 1; t >= 1; --t) {
        if (p.mask != nullptr && !p.mask[t]) {  // identity step: self backpointer
            if (tid == 0) p.path[t - 1] = state;
            continue;
        }
        const float* vprev = p.grids + (size_t)(t - 1) * frame;
        const int w = state / S, j = state - w * S;
        int pred = 0;
        if (tid < 32) {  // within-word first argmax over s (warp 0)
            float mv = -INFINITY;
            int ms = BIG;
            for (int s = tid; s < S; s += 32)
                argmax_merge(mv, ms, vprev[(size_t)w * S + s] + p.inner_a[((size_t)w * S + s) * S + j], s);
            warp_argmax(mv, ms);
            if (ms >= S) ms = 0;
            pred = w * S + ms;
            if (tid == 0) { rv[0] = mv; state_sh = pred; }
        }
        if (p.hop_kind != HOP_NONE && j == 0) {  // uniform across the block
            __syncthreads();
            const float m = rv[0];
            float hv = -INFINITY;
            int hi = BIG;
            const bool sil = p.hop_kind == HOP_RANK1 && w == p.sil_idx;
            const float* add = p.hop_kind == HOP_DENSE ? p.hop_t + (size_t)w * V
                               : (sil ? p.sil_from : p.from_w);
            for (int v = tid; v < V; v += nth)
                argmax_merge(hv, hi, vprev[(size_t)v * S + p.exit_idx[v]] + add[v], v);
            block_argmax(hv, hi, rv, ri);
            if (p.hop_kind == HOP_RANK1 && !sil) hv = hv + p.uni[w];
            if (tid == 0) {
                if (hi < V && hv > m) pred = hi * S + p.exit_idx[hi];
                state_sh = pred;
            }
        }
        __syncthreads();
        state = state_sh;
        if (tid == 0) p.path[t - 1] = state;
        __syncthreads();  // state_sh / rv are rewritten next step
    }
}

}  // namespace

extern "C" int factored_backtrace_launch(const float* grids, const float* inner_a, const int* exit_idx,
                                         int hop_kind, const float* hop_t, const float* from_w,
                                         const float* uni, const float* sil_from, int sil_idx,
                                         const float* final_grid, const uint8_t* mask, int T, int V,
                                         int S, int* path, float* score, void* stream) {
    if (T < 1 || V < 1 || S < 1) return (int)cudaErrorInvalidValue;
    Args a{grids, inner_a, exit_idx, hop_t, from_w, uni, sil_from, final_grid, mask, path, score,
           hop_kind, sil_idx, T, V, S};
    factored_backtrace_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

extern "C" const char* factored_backtrace_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
