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
// exit + from_w, plus uni[w], and over exit + sil_from for the silence
// word), taken only when strictly better than the within-word candidate;
// masked frames point to themselves. Termination is the first maximum of
// grid[T-1] + final over flat v*S+s ids. These are the rules of
// lnasr_tpu_torch/models/decoder.py:factored_trellis_scan, so the path and
// score are bitwise those of the scan. Hop kind "none" (loop-free graphs)
// is taken here too, where the JAX package fell back to an XLA scan. The
// backoff kind (rank-1 plus sparse seen-bigram arcs) replaces the reverse
// scan of lnasr_tpu/models/decoder.py:709 factored_trellis_scan with
// HopFactors (backpointers at :732-741 by _hop_entry :115-151): at j = 0
// the rank-1 argmax above, plus the first argmax over w's arcs of
// exits[src] + val (the lowest source on a tie), the entry their larger
// value and its source the smaller of the achieving families' sources.
//
// What bounds it on an H100: the work is small (it reads at most the 16 MB
// of grids once at V = 1000, S = 8, T = 510, ~5 us at 3.35 TB/s) but it is
// a chain of T - 1 dependent steps. The first design walked it on one
// block of 512 threads with every step's reads on the chain: an L2 round
// trip for the state's S-row of grid[t-1], two block barriers every step,
// and at a word's first state (237 of the serving segment's 510 steps) a
// V-wide gather of exit scores (two dependent loads a source) and a block
// argmax with two more barriers; ~1.45 us a step.
//
// Now everything that does not depend on the path's state comes off the
// chain. (a) A pre-pass over all SMs gathers exits[t, v] =
// grids[t, v, exit_idx[v]] into a compact (T, Vp) buffer (Vp: V rounded up
// to 4, padded with -inf). (b) The chain runs in windows of K = 32 frames
// of one word. With the path in word w at frame t, warp i of one
// 1024-thread block takes the step from frame t - i: it loads the S-row
// grids[t-i-1, w, :], and on a valid frame with a hop it takes the hop's
// first argmax over v of exits[t-i-1, v] + w's hop column (staged in
// shared memory when the word changes; rank-1: from_w, or sil_from for the
// silence word, with uni[w] added after the argmax), its lanes loading the
// exit row as float4s, four (value, index) pairs a lane merged by the
// larger value and then the smaller index. Then for every local state j it
// writes row i of a table: the step's predecessor of j, which is j itself
// on a masked frame, else the first within-word argmax s, replaced at
// j = 0 by the hop's source exit where the hop's value is strictly larger.
// After one barrier one thread walks the K steps through the table, one
// shared load a step and no block barrier. The window ends after its K-th
// step or at the first step that leaves the word (only a hop does; a hop
// from the word to itself keeps the table valid), and the next starts
// there (ops/factored.py:backtrace_windows counts them from a path). The
// hop work is speculative (done for every frame of a window, used at j = 0
// only), but the block does it in parallel. What bounds it now: per
// window, the L2 round trips of the rows and of the K exit rows (K * V * 4
// bytes) and two block barrier waits (three when the word changes), plus
// the walk's chain of shared loads; windows are ~T / K plus the path's
// word changes. A backoff hop adds to each warp's speculative hop work a
// pass over w's arcs (a lane an arc, read through the read-only path: all
// of a window's warps read the same row) and one more warp argmax.
//
// A batch (the JAX package's jax.vmap of the scan, decoder.py:1125): grids
// (B, T, V, S) from one launch of kernel D, masks (B, T); the pre-pass
// gathers the exits of all B T frames, and the walk runs on grid (B,), a
// block an utterance, so B walks run side by side on B SMs where one
// walk leaves all but one idle. Each utterance's termination, mask and
// window rules are one utterance's.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HOP_NONE = 0;
constexpr int HOP_DENSE = 1;
constexpr int HOP_BACKOFF = 3;
constexpr int K = 32;                 // frames a window; one warp each
constexpr int THREADS = K * 32;
constexpr int SMEM_LIMIT = 232448;    // a block's shared memory on sm_90
constexpr int GATHER_THREADS = 256;

struct Args {
    const float* grids;     // (B, T, V, S)
    const float* inner_a;   // (V, S, S)
    const int* exit_idx;    // (V,)
    const float* hop_t;     // (V, V) transposed: hop_t[w, v] = hop[v, w]
    const float* from_w;    // (V,)
    const float* uni;       // (V,)
    const float* sil_from;  // (V,)
    const int* arc_ptr;     // (V + 1,) backoff arcs in CSR by destination
    const int* arc_src;     // (nnz,) ascending within a row
    const float* arc_val;   // (nnz,)
    const float* final_grid;  // (V, S)
    const uint8_t* mask;    // (B, T) or null
    const float* exits;     // (B, T, Vp) from the pre-pass, or null (no hop)
    int* path;              // (B, T)
    float* score;           // (B,)
    int hop_kind, sil_idx, B, T, V, S;
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

// exits[t, v] = grids[t, v, exit_idx[v]], spread over the card; rows
// padded to Vp = V rounded up to 4 with -inf (never a hop's argmax).
__global__ void gather_exits_kernel(const float* grids, const int* exit_idx, int T, int V, int Vp,
                                    int S, float* exits) {
    const size_t n = (size_t)T * Vp;
    for (size_t k = (size_t)blockIdx.x * blockDim.x + threadIdx.x; k < n;
         k += (size_t)gridDim.x * blockDim.x) {
        const int t = (int)(k / Vp), v = (int)(k - (size_t)t * Vp);
        exits[k] = v < V ? grids[((size_t)t * V + v) * S + exit_idx[v]] : -INFINITY;
    }
}

__global__ void __launch_bounds__(THREADS) factored_backtrace_kernel(Args p) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float redv[K];
    __shared__ int redi[K];
    __shared__ int state_sh, tau_sh;

    const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
    const int V = p.V, S = p.S, T = p.T;
    const size_t frame = (size_t)V * S;
    const int hk = p.hop_kind;
    const int BIG = 0x7fffffff;

    const int Vp = (V + 3) & ~3;                  // exits' and the column's padded width
    // this block's utterance
    const int b = blockIdx.x;
    const float* grids = p.grids + (size_t)b * T * frame;
    const uint8_t* mask = p.mask ? p.mask + (size_t)b * T : nullptr;
    const float* exits = p.exits ? p.exits + (size_t)b * T * Vp : nullptr;
    int* path = p.path + (size_t)b * T;
    float* col = reinterpret_cast<float*>(smem);  // [Vp] w's hop column (hop kinds only)
    float* ia = col + (hk != HOP_NONE ? Vp : 0);  // [S * S] w's inner block
    float* row = ia + S * S;                      // [K * S] staged S-rows
    int* tab = reinterpret_cast<int*>(row + K * S);  // [K * S] each step's predecessor of each j

    // termination over flat v*S+s ids
    {
        float bv = -INFINITY;
        int bi = BIG;
        const float* last = grids + (size_t)(T - 1) * frame;
        for (int k = tid; k < (int)frame; k += THREADS)
            arg_take(bv, bi, last[k] + p.final_grid[k], k);
        warp_argmax(bv, bi);
        if (lane == 0) {
            redv[warp] = bv;
            redi[warp] = bi;
        }
        __syncthreads();
        if (tid == 0) {
            for (int w = 1; w < K; ++w) arg_take(bv, bi, redv[w], redi[w]);
            const int state = bi < (int)frame ? bi : 0;
            p.score[b] = bv;
            path[T - 1] = state;
            state_sh = state;
            tau_sh = T - 1;
        }
        __syncthreads();
    }

    int w_staged = -1;
    for (;;) {
        const int state = state_sh, tau0 = tau_sh;  // the path is at `state` at frame tau0
        if (tau0 < 1) break;
        const int w = state / S, lo = w * S;
        if (w != w_staged) {  // uniform across the block
            if (hk != HOP_NONE) {
                const float* add = hk == HOP_DENSE ? p.hop_t + (size_t)w * V
                                   : (w == p.sil_idx ? p.sil_from : p.from_w);
                for (int v = tid; v < Vp; v += THREADS) col[v] = v < V ? add[v] : 0.0f;
            }
            for (int k = tid; k < S * S; k += THREADS) ia[k] = p.inner_a[(size_t)lo * S + k];
            w_staged = w;
            __syncthreads();
        }
        // warp i: the step from frame tau = tau0 - i to tau - 1, as row i of
        // the table: the predecessor of each local state j
        const int tau = tau0 - warp;
        if (tau >= 1) {
            const float* src = grids + (size_t)(tau - 1) * frame + lo;
            const float rv = lane < S ? src[lane] : 0.0f;  // in flight during the hop
            const bool valid = mask == nullptr || mask[tau];
            float hv = -INFINITY;
            int hpred = -1;
            if (hk != HOP_NONE && valid) {
                // first argmax over v of exits[tau - 1, v] + col[v]: lane l
                // loads the float4s l, l + 32, ...; pair k takes their
                // component k, sources 4 (l + 32 m) + k in increasing order
                const float4* ex4 =
                    reinterpret_cast<const float4*>(exits + (size_t)(tau - 1) * Vp);
                const float4* c4 = reinterpret_cast<const float4*>(col);
                float m0 = -INFINITY, m1 = -INFINITY, m2 = -INFINITY, m3 = -INFINITY;
                int a0 = 4 * lane, a1 = 4 * lane + 1, a2 = 4 * lane + 2, a3 = 4 * lane + 3;
#pragma unroll 8
                for (int q = lane; q < Vp / 4; q += 32) {
                    const float4 e = __ldg(ex4 + q), c = c4[q];
                    const float c0 = e.x + c.x, c1 = e.y + c.y, c2 = e.z + c.z, c3 = e.w + c.w;
                    if (c0 > m0) { m0 = c0; a0 = 4 * q; }
                    if (c1 > m1) { m1 = c1; a1 = 4 * q + 1; }
                    if (c2 > m2) { m2 = c2; a2 = 4 * q + 2; }
                    if (c3 > m3) { m3 = c3; a3 = 4 * q + 3; }
                }
                arg_take(m0, a0, m1, a1);
                arg_take(m2, a2, m3, a3);
                arg_take(m0, a0, m2, a2);
                warp_argmax(m0, a0);  // every lane holds it
                hv = m0;
                int hsrc = a0;
                if (hk != HOP_DENSE && w != p.sil_idx) {
                    const float r1 = m0 + p.uni[w];
                    hv = r1;
                    if (hk == HOP_BACKOFF) {
                        // the first argmax over w's arcs of exits[src] + val
                        const float* exr = exits + (size_t)(tau - 1) * Vp;
                        float sm = -INFINITY;
                        int sa = BIG;
                        const int k1 = __ldg(p.arc_ptr + w + 1);
                        for (int k = __ldg(p.arc_ptr + w) + lane; k < k1; k += 32) {
                            const int sk = __ldg(p.arc_src + k);
                            arg_take(sm, sa, __ldg(exr + sk) + __ldg(p.arc_val + k), sk);
                        }
                        warp_argmax(sm, sa);
                        hv = fmaxf(r1, sm);
                        hsrc = min(r1 >= hv ? a0 : BIG, sm >= hv ? sa : BIG);
                    }
                }
                // a source past V only from NaN inputs: keep the read in bounds
                hpred = hsrc < V ? hsrc * S + p.exit_idx[hsrc] : -1;
            }
            float* r = row + warp * S;
            if (lane < S) r[lane] = rv;
            for (int s = lane + 32; s < S; s += 32) r[s] = src[s];
            __syncwarp();
            for (int j = lane; j < S; j += 32) {
                int pred = lo + j;  // a masked frame points to itself
                if (valid) {  // first s, strict > in increasing s
                    float m = r[0] + ia[j];
                    int sa = 0;
                    for (int s = 1; s < S; ++s) {
                        const float c = r[s] + ia[s * S + j];
                        if (c > m) {
                            m = c;
                            sa = s;
                        }
                    }
                    pred = j == 0 && hv > m ? hpred : lo + sa;
                }
                tab[warp * S + j] = pred;
            }
        }
        __syncthreads();
        if (tid == 0) {  // the walk: one shared load a step, no barrier
            int cur = state, t = tau0;
            const int steps = min(K, tau0);
            for (int i = 0; i < steps; ++i) {
                cur = tab[i * S + cur - lo];
                path[--t] = cur;
                if ((unsigned)(cur - lo) >= (unsigned)S) break;  // a hop into another word
            }
            state_sh = cur;
            tau_sh = t;
        }
        __syncthreads();
    }
}

// Mirrored by lnasr_tpu_torch/ops/factored.py:backtrace_smem_bytes (capacity rule).
size_t smem_bytes(int V, int S, int hop_kind) {
    const size_t vp = (size_t)((V + 3) & ~3);
    return ((hop_kind != HOP_NONE ? vp : 0) + (size_t)S * S + 2 * (size_t)K * S) * sizeof(float);
}

}  // namespace

extern "C" int factored_backtrace_launch(const float* grids, const float* inner_a, const int* exit_idx,
                                         int hop_kind, const float* hop_t, const float* from_w,
                                         const float* uni, const float* sil_from, int sil_idx,
                                         const int* arc_ptr, const int* arc_dst,
                                         const int* arc_src, const float* arc_val,
                                         const float* final_grid, const uint8_t* mask, int B, int T,
                                         int V, int S, float* exits, int* path, float* score,
                                         void* stream) {
    (void)arc_dst;  // the forwards' flat arc walk needs it, the replay's row walk does not
    if (B < 1 || T < 1 || V < 1 || S < 1) return (int)cudaErrorInvalidValue;
    if (hop_kind < HOP_NONE || hop_kind > HOP_BACKOFF) return (int)cudaErrorInvalidValue;
    if (hop_kind == HOP_BACKOFF && arc_ptr == nullptr) return (int)cudaErrorInvalidValue;
    if (hop_kind != HOP_NONE && exits == nullptr) return (int)cudaErrorInvalidValue;
    const size_t smem = smem_bytes(V, S, hop_kind);
    if (smem + 1024 > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(factored_backtrace_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    if (hop_kind != HOP_NONE) {
        const int vp = (V + 3) & ~3;
        // every utterance's frames: (B, T) rows of grids and exits
        const size_t want = ((size_t)B * T * vp + GATHER_THREADS - 1) / GATHER_THREADS;
        const int blocks = (int)(want < 4096 ? want : 4096);
        gather_exits_kernel<<<blocks, GATHER_THREADS, 0, (cudaStream_t)stream>>>(
            grids, exit_idx, B * T, V, vp, S, exits);
        err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    Args a{grids, inner_a, exit_idx, hop_t, from_w, uni, sil_from, arc_ptr, arc_src, arc_val,
           final_grid, mask, exits, path, score, hop_kind, sil_idx, B, T, V, S};
    factored_backtrace_kernel<<<B, THREADS, smem, (cudaStream_t)stream>>>(a);
    return (int)cudaGetLastError();
}

extern "C" const char* factored_backtrace_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
