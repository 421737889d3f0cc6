// Lattice-recording factored forward for Hopper (sm_90a): the forward
// trellis of factored_forward.cu, where every state also carries the frame
// its word token was entered (start) and the word it was entered from
// (pred, -1 at sentence begin). Per frame and word it writes the exit
// record (score, start, pred) at the word's exit state; no grids.
//
// Replaces lnasr_tpu/ops/factored_pallas.py:factored_lattice_pallas
// (_lattice_kernel). One frame, for words w and local states j:
//   within[w, j] = max_s grid[w, s] + inner_a[w, s, j], wsrc = first such s
//   start/pred[w, j] = start/pred[w, wsrc] of the previous frame
//   entry[w], esrc[w] = max / lowest argmax over v of exit[v] + hop[v, w]
//                       (dense hop), or max_v(exit + from_w) + uni[w] with
//                       its lowest argmax, silence: max_v(exit + sil_from)
//   where entry[w] > within[w, 0] (strictly): state 0 takes entry, start = t,
//                       pred = esrc[w]
//   grid = within + log_b[t]; masked frames are identity steps.
// The adds and compares are those of lnasr_tpu_torch/ops/factored.py:
// factored_lattice_scan, so scores are bitwise equal (-inf included) and start
// and pred equal at every record: every argmax takes the first index, and
// with all candidates -inf that is index 0, as torch.max gives.
//
// What bounds it on an H100: the work is the forward's, ~1.09 G operations
// at V = 1001, S = 8 and 510 valid frames (16 us at 67 TFLOP/s fp32); it
// moves ~27 MB (the 4 MB hop, 16.4 MB of emissions in, 6.1 MB of records
// out; 8 us at 3.35 TB/s). As in factored_forward.cu, frames depend on each
// other and the hop fits no block's shared memory, so block k owns
// ceil(V / SMs) words with their hop columns, inner blocks and grid,
// start and pred rows in shared memory for the whole utterance, and one
// grid barrier per frame publishes the V exit scores through a
// double-buffered (2, V) array. The dense-hop reduction carries
// (value, index) pairs, with the smaller index on equal values, so the
// lane-strided order cannot change which source wins.

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
    float* exit_score;      // (T, V)
    int* exit_start;        // (T, V)
    int* exit_pred;         // (T, V)
    float* exits;           // (2, V) exchange
    int hop_kind, sil_idx, T, V, S, wpb;
};

// (value, index) argmax: the larger value, the smaller index on a tie.
__device__ __forceinline__ void arg_take(float& m, int& a, float om, int oa) {
    if (om > m || (om == m && oa < a)) {
        m = om;
        a = oa;
    }
}

__device__ __forceinline__ void warp_argmax(float& m, int& a) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float om = __shfl_xor_sync(0xffffffffu, m, off);
        const int oa = __shfl_xor_sync(0xffffffffu, a, off);
        arg_take(m, a, om, oa);
    }
}

__device__ __forceinline__ void block_argmax(float& m, int& a, float* redv, int* redi) {
    warp_argmax(m, a);
    const int warp = threadIdx.x >> 5, nw = blockDim.x >> 5;
    __syncthreads();
    if ((threadIdx.x & 31) == 0) {
        redv[warp] = m;
        redi[warp] = a;
    }
    __syncthreads();
    m = redv[0];
    a = redi[0];
    for (int w = 1; w < nw; ++w) arg_take(m, a, redv[w], redi[w]);
}

// The launch bounds hold registers to 64 per thread, so that a block of
// up to 1024 threads fits the SM's 64 K registers.
__global__ void __launch_bounds__(MAX_THREADS) factored_lattice_kernel(Args p) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float redv[32];
    __shared__ int redi[32];
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
    int* esrc = eidx + p.wpb;                        // [wpb] hop source of each word
    int* st = esrc + p.wpb;                          // [wpb * S] token start frames
    int* pr = st + p.wpb * S;                        // [wpb * S] token predecessor words
    float* hs = reinterpret_cast<float*>(pr + p.wpb * S);  // [wpb * V] hop columns (dense)

    for (int k = tid; k < cells * S; k += nth) ia[k] = p.inner_a[(size_t)w0 * S * S + k];
    for (int k = tid; k < nw; k += nth) eidx[k] = p.exit_idx[w0 + k];
    if (hk == HOP_DENSE) {
        for (int k = tid; k < nw * V; k += nth) hs[k] = p.hop_t[(size_t)w0 * V + k];
    }
    const size_t row0 = (size_t)w0 * S;
    const size_t frame = (size_t)V * S;
    for (int k = tid; k < cells; k += nth) {
        g[k] = p.pi_grid[row0 + k] + p.log_b[row0 + k];
        st[k] = 0;
        pr[k] = -1;
    }
    __syncthreads();
    // the owner of each word writes its exit record (and, with a hop, its
    // exit score for the other blocks) at every frame, masked ones included
    for (int k = tid; k < nw; k += nth) {
        const int e = k * S + eidx[k];
        p.exit_score[w0 + k] = g[e];
        p.exit_start[w0 + k] = st[e];
        p.exit_pred[w0 + k] = pr[e];
        if (hk != HOP_NONE) p.exits[w0 + k] = g[e];
    }
    if (hk != HOP_NONE) grid.sync();

    for (int t = 1; t < T; ++t) {
        const bool valid = p.mask == nullptr || p.mask[t];
        const size_t rec = (size_t)t * V + w0;
        if (valid) {
            // emissions of this frame, issued before the hop reduction
            const int k_own = tid < cells ? tid : -1;
            const float e = k_own >= 0 ? p.log_b[(size_t)t * frame + row0 + k_own] : 0.0f;

            if (hk != HOP_NONE) {
                const float* prev = p.exits + ((t - 1) & 1) * V;
                // through L2: other SMs wrote it
                for (int v = tid; v < V; v += nth) ex[v] = __ldcg(prev + v);
                __syncthreads();
                if (hk == HOP_DENSE) {
                    // one warp per destination word, lanes over source words
                    // in increasing order: strict > keeps each lane's first
                    const int warp = tid >> 5, lane = tid & 31, nwarps = nth >> 5;
                    for (int w = warp; w < nw; w += nwarps) {
                        const float* col = hs + (size_t)w * V;
                        float m = -INFINITY;
                        int a = lane;
                        for (int v = lane; v < V; v += 32) {
                            const float c = ex[v] + col[v];
                            if (c > m) {
                                m = c;
                                a = v;
                            }
                        }
                        warp_argmax(m, a);
                        if (lane == 0) {
                            ent[w] = m;
                            esrc[w] = a;
                        }
                    }
                } else {
                    float m1 = -INFINITY, m2 = -INFINITY;
                    int a1 = tid, a2 = tid;
                    for (int v = tid; v < V; v += nth) {
                        const float c1 = ex[v] + p.from_w[v];
                        const float c2 = ex[v] + p.sil_from[v];
                        if (c1 > m1) {
                            m1 = c1;
                            a1 = v;
                        }
                        if (c2 > m2) {
                            m2 = c2;
                            a2 = v;
                        }
                    }
                    block_argmax(m1, a1, redv, redi);
                    block_argmax(m2, a2, redv, redi);
                    for (int w = tid; w < nw; w += nth) {
                        const bool sil = w0 + w == p.sil_idx;
                        ent[w] = sil ? m2 : m1 + p.uni[w0 + w];
                        esrc[w] = sil ? a2 : a1;
                    }
                }
                __syncthreads();
            }

            float nv = 0.0f;
            int nst = 0, npr = 0;
            if (k_own >= 0) {
                const int w = k_own / S, j = k_own - w * S;
                const float* gr = g + w * S;
                const float* a = ia + (size_t)w * S * S + j;
                float m = gr[0] + a[0];
                int src = 0;
                for (int s = 1; s < S; ++s) {
                    const float c = gr[s] + a[(size_t)s * S];
                    if (c > m) {
                        m = c;
                        src = s;
                    }
                }
                nst = st[w * S + src];
                npr = pr[w * S + src];
                if (hk != HOP_NONE && j == 0 && ent[w] > m) {
                    m = ent[w];
                    nst = t;
                    npr = esrc[w];
                }
                nv = m + e;
            }
            __syncthreads();  // every read of g, st and pr is done
            if (k_own >= 0) {
                g[k_own] = nv;
                st[k_own] = nst;
                pr[k_own] = npr;
            }
            __syncthreads();
        }
        // records of this frame; a masked frame repeats the carried state
        for (int k = tid; k < nw; k += nth) {
            const int e = k * S + eidx[k];
            p.exit_score[rec + k] = g[e];
            p.exit_start[rec + k] = st[e];
            p.exit_pred[rec + k] = pr[e];
            if (hk != HOP_NONE) p.exits[(t & 1) * V + w0 + k] = g[e];
        }
        if (hk != HOP_NONE) grid.sync();
    }
}

// Mirrored by lnasr_tpu_torch/ops/factored.py:lattice_smem_bytes (capacity rule).
size_t smem_bytes(int V, int S, int wpb, int hop_kind) {
    size_t f = (size_t)wpb * S + (size_t)wpb * S * S + wpb + V;
    size_t bytes = f * sizeof(float) + (size_t)(2 * wpb + 2 * wpb * S) * sizeof(int);
    if (hop_kind == HOP_DENSE) bytes += (size_t)wpb * V * sizeof(float);
    return bytes;
}

}  // namespace

extern "C" int factored_lattice_launch(const float* pi_grid, const float* inner_a, const int* exit_idx,
                                       int hop_kind, const float* hop_t, const float* from_w,
                                       const float* uni, const float* sil_from, int sil_idx,
                                       const float* log_b, const uint8_t* mask, int T, int V, int S,
                                       int n_sm, float* exit_score, int* exit_start, int* exit_pred,
                                       float* exits, void* stream) {
    if (T < 1 || V < 1 || S < 1 || n_sm < 1) return (int)cudaErrorInvalidValue;
    if (hop_kind != HOP_NONE && hop_kind != HOP_DENSE && hop_kind != HOP_RANK1)
        return (int)cudaErrorInvalidValue;
    const int wpb = (V + n_sm - 1) / n_sm;
    const int blocks = (V + wpb - 1) / wpb;
    int threads = ((wpb * S + 31) / 32) * 32;
    if (threads < 256) threads = 256;
    if (wpb * S > MAX_THREADS) return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(V, S, wpb, hop_kind);
    if (smem + 1024 > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(factored_lattice_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    Args a{pi_grid, inner_a, exit_idx, hop_t, from_w, uni, sil_from, log_b, mask,
           exit_score, exit_start, exit_pred, exits, hop_kind, sil_idx, T, V, S, wpb};
    void* params[] = {&a};
    err = cudaLaunchCooperativeKernel((const void*)factored_lattice_kernel, dim3(blocks), dim3(threads),
                                      params, smem, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

extern "C" const char* factored_lattice_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
