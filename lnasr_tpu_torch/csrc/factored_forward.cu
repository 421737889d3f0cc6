// Factored word-graph Viterbi forward for Hopper (sm_90a): every frame's
// (V, S) trellis grid, written to device memory for the backtrace
// (factored_backtrace.cu).
//
// Replaces lnasr_tpu/ops/factored_pallas.py:_forward_raw (_fwd_kernel).
// One frame, for words v and local states j:
//   within[v, j] = max_s grid[v, s] + inner_a[v, s, j]
//   exit[v]      = grid[v, exit_idx[v]]
//   entry[w]     = max_v exit[v] + hop[v, w]                    (dense hop)
//                | max_v(exit + from_w) + uni[w], silence: max_v(exit + sil_from)  (rank-1)
//   grid         = max(within, entry at j = 0) + log_b[t]; masked frames keep it.
// Only maxima are needed here (the backtrace re-derives the argmaxes), and
// max is exact and order-free, so the grids are bitwise those of
// lnasr_tpu_torch/models/decoder.py:factored_trellis_scan at every state,
// -inf included (the TPU's finite NEG existed only for its MXU relayout).
//
// What bounds it on an H100: at V = 1000, S = 8, T = 510 the dense hop
// is V^2 = 1 M adds + maxes per frame, 1.08 G operations in all (16 us at
// 67 TFLOP/s fp32), and it moves ~37 MB (emissions in, grids out; 11 us
// at 3.35 TB/s). The hop matrix (4 MB) fits L2 but no block's 227 KB of
// shared memory, where the TPU kept it whole in 13 MB of VMEM, and frames
// depend on each other. A single block re-reading the hop from L2 every
// frame would stream 2 GB through one SM. So the design spreads the
// destination words over the card: block k owns ceil(V / SMs) words (8 at
// V = 1000), keeps its hop columns (32 KB), its inner blocks and its grid
// rows in shared memory for the whole utterance, and the V^2 work of a
// frame runs on all SMs at once. The one thing a block needs from the
// others is the previous frame's V exit scores: owners write them to a
// double-buffered (2, V) exchange array, and a cooperative launch's grid
// barrier (one per frame) orders the write before every read. The
// barrier, not the arithmetic, is what each frame waits on. Hop kind
// "none" (loop-free graphs) has no cross-word term and skips it.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int HOP_NONE = 0;
constexpr int HOP_DENSE = 1;
constexpr int HOP_RANK1 = 2;
constexpr int SMEM_LIMIT = 232448;  // a block's shared memory on sm_90
constexpr int MAX_THREADS = 1024;   // one thread per (word, state) cell of a block

struct Args {
    const float* pi_grid;   // (V, S)
    const float* inner_a;   // (V, S, S)
    const int* exit_idx;    // (V,)
    const float* hop_t;     // (V, V) transposed: hop_t[w, v] = hop[v, w]
    const float* from_w;    // (V,) rank-1 rows
    const float* uni;       // (V,)
    const float* sil_from;  // (V,)
    const float* log_b;     // (T, V, S)
    const uint8_t* mask;    // (T,) or null
    float* grids;           // (T, V, S)
    float* exits;           // (2, V) exchange
    int hop_kind, sil_idx, T, V, S, wpb;
};

__device__ __forceinline__ float block_max(float x, float* red) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
    const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[warp] = x;
    __syncthreads();
    float r = red[0];
    for (int w = 1; w < nw; ++w) r = fmaxf(r, red[w]);
    return r;
}

// The launch bounds hold registers to 64 per thread, so that a block of
// up to 1024 threads fits the SM's 64 K registers.
__global__ void __launch_bounds__(MAX_THREADS) factored_forward_kernel(Args p) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float red[32];
    cg::grid_group grid = cg::this_grid();

    const int V = p.V, S = p.S, T = p.T;
    const int w0 = blockIdx.x * p.wpb;
    const int nw = min(p.wpb, V - w0);  // >= 1: the launcher sizes the grid
    const int cells = nw * S;
    const int tid = threadIdx.x, nth = blockDim.x;
    const int hk = p.hop_kind;

    float* g = reinterpret_cast<float*>(smem);       // [wpb * S] this block's rows
    float* ia = g + p.wpb * S;                       // [wpb * S * S]
    float* ent = ia + p.wpb * S * S;                 // [wpb]
    float* ex = ent + p.wpb;                         // [V] exits of the previous frame
    int* eidx = reinterpret_cast<int*>(ex + V);      // [wpb]
    float* hs = reinterpret_cast<float*>(eidx + p.wpb);  // [wpb * V] hop columns (dense)

    for (int k = tid; k < cells * S; k += nth) ia[k] = p.inner_a[(size_t)w0 * S * S + k];
    for (int k = tid; k < nw; k += nth) eidx[k] = p.exit_idx[w0 + k];
    if (hk == HOP_DENSE) {
        for (int k = tid; k < nw * V; k += nth) hs[k] = p.hop_t[(size_t)w0 * V + k];
    }
    const size_t row0 = (size_t)w0 * S;
    const size_t frame = (size_t)V * S;
    for (int k = tid; k < cells; k += nth) {
        const float x = p.pi_grid[row0 + k] + p.log_b[row0 + k];
        g[k] = x;
        p.grids[row0 + k] = x;
    }
    __syncthreads();
    if (hk != HOP_NONE) {
        for (int k = tid; k < nw; k += nth) p.exits[w0 + k] = g[k * S + eidx[k]];
        grid.sync();
    }

    for (int t = 1; t < T; ++t) {
        const bool valid = p.mask == nullptr || p.mask[t];
        float* out = p.grids + (size_t)t * frame + row0;
        if (!valid) {  // identity step: the grid carries over unchanged
            for (int k = tid; k < cells; k += nth) out[k] = g[k];
            if (hk != HOP_NONE) {
                for (int k = tid; k < nw; k += nth)
                    p.exits[(t & 1) * V + w0 + k] = g[k * S + eidx[k]];
                grid.sync();
            }
            continue;
        }
        // emissions of this frame, issued before the hop reduction
        const int k_own = tid < cells ? tid : -1;
        const float e = k_own >= 0 ? p.log_b[(size_t)t * frame + row0 + k_own] : 0.0f;

        if (hk != HOP_NONE) {
            const float* prev = p.exits + ((t - 1) & 1) * V;
            for (int v = tid; v < V; v += nth) ex[v] = __ldcg(prev + v);  // L2: written by other SMs
            __syncthreads();
            if (hk == HOP_DENSE) {
                // one warp per destination word, lanes over source words
                const int warp = tid >> 5, lane = tid & 31, nwarps = nth >> 5;
                for (int w = warp; w < nw; w += nwarps) {
                    const float* col = hs + (size_t)w * V;
                    float m = -INFINITY;
                    for (int v = lane; v < V; v += 32) m = fmaxf(m, ex[v] + col[v]);
#pragma unroll
                    for (int off = 16; off > 0; off >>= 1)
                        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
                    if (lane == 0) ent[w] = m;
                }
            } else {
                float m1 = -INFINITY, m2 = -INFINITY;
                for (int v = tid; v < V; v += nth) {
                    m1 = fmaxf(m1, ex[v] + p.from_w[v]);
                    m2 = fmaxf(m2, ex[v] + p.sil_from[v]);
                }
                m1 = block_max(m1, red);
                m2 = block_max(m2, red);
                for (int w = tid; w < nw; w += nth)
                    ent[w] = (w0 + w == p.sil_idx) ? m2 : m1 + p.uni[w0 + w];
            }
            __syncthreads();
        }

        float nv = 0.0f;
        if (k_own >= 0) {
            const int w = k_own / S, j = k_own - w * S;
            const float* gr = g + w * S;
            const float* a = ia + (size_t)w * S * S + j;
            float m = gr[0] + a[0];
            for (int s = 1; s < S; ++s) m = fmaxf(m, gr[s] + a[(size_t)s * S]);
            if (hk != HOP_NONE && j == 0 && ent[w] > m) m = ent[w];
            nv = m + e;
        }
        __syncthreads();  // every read of g is done
        if (k_own >= 0) {
            g[k_own] = nv;
            out[k_own] = nv;
        }
        if (hk != HOP_NONE) {
            __syncthreads();
            for (int k = tid; k < nw; k += nth) p.exits[(t & 1) * V + w0 + k] = g[k * S + eidx[k]];
            grid.sync();
        }
    }
}

// Mirrored by lnasr_tpu_torch/ops/factored.py:forward_smem_bytes (capacity rule).
size_t smem_bytes(int V, int S, int wpb, int hop_kind) {
    size_t f = (size_t)wpb * S + (size_t)wpb * S * S + wpb + V;
    size_t bytes = f * sizeof(float) + (size_t)wpb * sizeof(int);
    if (hop_kind == HOP_DENSE) bytes += (size_t)wpb * V * sizeof(float);
    return bytes;
}

}  // namespace

extern "C" int factored_forward_launch(const float* pi_grid, const float* inner_a, const int* exit_idx,
                                       int hop_kind, const float* hop_t, const float* from_w,
                                       const float* uni, const float* sil_from, int sil_idx,
                                       const float* log_b, const uint8_t* mask, int T, int V, int S,
                                       int n_sm, float* grids, float* exits, void* stream) {
    if (T < 1 || V < 1 || S < 1 || n_sm < 1) return (int)cudaErrorInvalidValue;
    const int wpb = (V + n_sm - 1) / n_sm;
    const int blocks = (V + wpb - 1) / wpb;
    int threads = ((wpb * S + 31) / 32) * 32;
    if (threads < 256) threads = 256;
    if (wpb * S > MAX_THREADS) return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(V, S, wpb, hop_kind);
    if (smem + 1024 > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(factored_forward_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    Args a{pi_grid, inner_a, exit_idx, hop_t, from_w, uni, sil_from, log_b, mask, grids, exits,
           hop_kind, sil_idx, T, V, S, wpb};
    void* params[] = {&a};
    err = cudaLaunchCooperativeKernel((const void*)factored_forward_kernel, dim3(blocks), dim3(threads),
                                      params, smem, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

extern "C" const char* factored_forward_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
