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
//                | max(rank-1, max over w's arcs of exit[src] + val)   (backoff)
//   grid         = max(within, entry at j = 0) + log_b[t]; masked frames keep it.
// The backoff kind also replaces lnasr_tpu/models/decoder.py:709
// factored_trellis_scan's forward with HopFactors (_hop_entry :115-151,
// jitted at :1044 and :1125), a lax.scan that XLA ran as one device program.
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
// others is the previous frame's V exit scores, so the time is T times the
// latency of that exchange plus the block's hop reduction.
//
// The exchange (factored_exchange.cuh, which states its format and why its
// publication order is safe): each word's exit, or for the rank-1 and
// backoff hops each block's two rank-1 partials as (value, source) keys
// and, for the backoff kind, the exits of the block's own arcs' sources,
// travel with their frame's tag in 64-bit words polled by the readers,
// with no barrier across blocks in the frame loop. Each block's own
// within-word step is computed before the poll, while the other blocks'
// exits are in flight; the grid rows' stores are never waited for (only
// kernel E reads them, after the kernel ends). Hop kind "none"
// (loop-free graphs) has no exchange. What bounds the factored kinds is
// the exchange's latency: ~2.3 us a frame on an H100 at the V = 5000
// segment (1.19 ms over 509 frames), a third of it the wait for the
// slowest block's partials (kernel_phases.py --kernels D). The backoff
// kind's words are cut into blocks by arcs (ops/factored.py:block_map),
// since a corpus bigram's popular words have the lowest ids and equal
// ranges of words would give block 0 most of the arcs.

#include "factored_exchange.cuh"
#include <stdint.h>

namespace {

struct Args {
    const float* pi_grid;   // (V, S)
    const float* inner_a;   // (V, S, S)
    const int* exit_idx;    // (V,)
    const float* hop_t;     // (V, V) transposed: hop_t[w, v] = hop[v, w]
    const float* from_w;    // (V,) rank-1 rows
    const float* uni;       // (V,)
    const float* sil_from;  // (V,)
    const int* arc_ptr;     // (V + 1,) backoff arcs in CSR by destination
    const int* arc_dst;     // (nnz,) each arc's destination
    const int* arc_src;     // (nnz,)
    const float* arc_val;   // (nnz,)
    const int* blk_ptr;     // (n_blocks + 1,) backoff: block b's words [blk_ptr[b], blk_ptr[b + 1])
    const int* src_ptr;     // (n_blocks + 1,) backoff: block b's sources src[src_ptr[b] ...]
    const int* src;         // each block's distinct arc sources, ascending
    const int* arc_lsrc;    // (nnz,) each arc's source, an index into its block's list
    const float* log_b;     // (T, V, S)
    const uint8_t* mask;    // (T,) or null
    float* grids;           // (T, V, S)
    // (2, V) exits: (frame tag << 32) | exit bits (dense, backoff), then
    // (2, n_blocks, PART) partials: (frame tag << 32) | half a key (rank-1, backoff)
    unsigned long long* xch;
    int hop_kind, sil_idx, T, V, S, wpb, n_blocks;
};

// The launch bounds hold registers to 64 per thread, so that a block of
// up to 1024 threads fits the SM's 64 K registers. kFactors: the rank-1 and
// backoff kinds (partials); otherwise none and dense (the V-slot exchange).
template <bool kFactors>
__global__ void __launch_bounds__(MAX_THREADS) factored_forward_kernel(Args p) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ unsigned long long wk[32][2];  // each warp's partial keys (factors)
    __shared__ unsigned long long rk[32][2];  // the polled keys, combined 32 blocks each

    const int V = p.V, S = p.S, T = p.T;
    const BlockRange r = block_range<kFactors>(p);
    const int w0 = r.w0, nw = r.nw, n_src = r.n_src;
    const int cells = nw * S;
    const int tid = threadIdx.x, nth = blockDim.x;
    const int hk = p.hop_kind;
    const int n_part = PART * p.n_blocks;
    // rank-1, backoff: the polled slots and the sparse keys, then the rows
    const Polled pl = polled_layout(smem, n_part, n_src);
    unsigned* got = pl.got;                          // [n_part + n_src]
    unsigned long long* spk = pl.spk;                // [wpb] (backoff)
    float* g = kFactors ? reinterpret_cast<float*>(spk + (hk == HOP_BACKOFF ? p.wpb : 0))
                        : reinterpret_cast<float*>(smem);  // [wpb * S] this block's rows
    float* ia = g + p.wpb * S;                       // [wpb * S * S]
    // none, dense
    float* ent = ia + p.wpb * S * S;                 // [wpb]
    float* ex = ent + p.wpb;                         // [V] exits of the last published frame
    int* eidx = kFactors ? reinterpret_cast<int*>(ent) : reinterpret_cast<int*>(ex + V);  // [wpb]
    float* hs = reinterpret_cast<float*>(eidx + p.wpb);  // [wpb * V] hop columns (dense)
    int* bsrc = eidx + p.wpb;                        // [n_src] the block's sources (backoff)
    unsigned long long* part = p.xch + (hk == HOP_BACKOFF ? 2 * (size_t)V : 0);

    for (int k = tid; k < cells * S; k += nth) ia[k] = p.inner_a[(size_t)w0 * S * S + k];
    for (int k = tid; k < nw; k += nth) eidx[k] = p.exit_idx[w0 + k];
    if (!kFactors && hk == HOP_DENSE) {
        for (int k = tid; k < nw * V; k += nth) hs[k] = p.hop_t[(size_t)w0 * V + k];
    }
    if (kFactors) {
        for (int k = tid; k < n_src; k += nth) bsrc[k] = p.src[r.src0 + k];
    }
    const size_t row0 = (size_t)w0 * S;
    const size_t frame = (size_t)V * S;
    // this thread's cell (word w, state j), if it has one
    const int k_own = tid < cells ? tid : -1;
    const int w_own = k_own >= 0 ? k_own / S : 0, j_own = k_own >= 0 ? k_own - w_own * S : 0;
    if (k_own >= 0) {
        const float x = p.pi_grid[row0 + k_own] + p.log_b[row0 + k_own];
        g[k_own] = x;
        p.grids[row0 + k_own] = x;
    }
    __syncthreads();
    const bool exits_own = hk != HOP_NONE && k_own >= 0 && j_own == eidx[w_own];
    // the factors this thread adds on a frame's chain, in registers: its
    // exit's rank-1 rows, its word's unigram at state 0
    const float fw = kFactors && exits_own ? p.from_w[w0 + w_own] : 0.0f;
    const float sf = kFactors && exits_own ? p.sil_from[w0 + w_own] : 0.0f;
    const float un = kFactors && k_own >= 0 && j_own == 0 ? p.uni[w0 + w_own] : 0.0f;
    // the exit cell's publication of frame t's exit x (buffer `buf`)
    auto publish_exit = [&](int buf, int t, float x) {
        if (!kFactors || hk == HOP_BACKOFF)
            st_relaxed(p.xch + (size_t)buf * V + w0 + w_own, tagged(t, x));
    };
    if (exits_own) publish_exit(0, 0, g[k_own]);
    if (kFactors) {
        const float x = k_own >= 0 ? g[k_own] : 0.0f;
        fold_partials(wk, exits_own, x + fw, x + sf, w0 + w_own);
        __syncthreads();
        publish_partials(wk, part, p.n_blocks, 0, 0);
    }
    int n_pub = 0, last_pub = 0;  // publications so far - 1, frame of the last

    bool valid_next = T > 1 && (p.mask == nullptr || p.mask[1]);
    for (int t = 1; t < T; ++t) {
        const bool valid = valid_next;
        if (t + 1 < T) valid_next = p.mask == nullptr || p.mask[t + 1];  // ahead of its use
        float* out = p.grids + (size_t)t * frame + row0;
        if (!valid) {  // identity step: the grid carries over; nothing is published
            if (k_own >= 0) out[k_own] = g[k_own];
            continue;
        }
        // this frame's emission and the block's own within-word step,
        // loaded before the wait for the other blocks' exits
        float e = 0.0f, m = -INFINITY;
        if (k_own >= 0) {
            e = p.log_b[(size_t)t * frame + row0 + k_own];
            const float* gr = g + w_own * S;
            const float* a = ia + (size_t)w_own * S * S + j_own;
            m = gr[0] + a[0];
            for (int s = 1; s < S; ++s) m = fmaxf(m, gr[s] + a[(size_t)s * S]);
        }

        if (kFactors) {
            // the sparse keys' reset: every read of the last frame's is done
            if (hk == HOP_BACKOFF)
                for (int w = tid; w < nw; w += nth) spk[w] = key_of(-INFINITY, BIG);
            read_slots(part + (size_t)(n_pub & 1) * n_part, n_part, p.xch + (size_t)(n_pub & 1) * V,
                       bsrc, n_src, (unsigned)last_pub, got);
            __syncthreads();  // also: every read of g is done
            combine_polled(got, p.n_blocks, rk);
            if (hk == HOP_BACKOFF)
                fold_arcs(spk, w0, r.arc0, r.arc1, p.arc_dst, p.arc_lsrc, p.arc_val, p.arc_src,
                          reinterpret_cast<const float*>(got + n_part));
            __syncthreads();  // the warps' combines (and the arcs' atomics) are done
            if (k_own >= 0 && j_own == 0) {
                unsigned long long k1, k2;
                polled_max(rk, p.n_blocks, k1, k2);
                const int w = w0 + w_own;
                float en = w == p.sil_idx ? value_of(k2) : value_of(k1) + un;
                if (hk == HOP_BACKOFF && w != p.sil_idx) {
                    const float sp = value_of(spk[w_own]);
                    if (sp > en) en = sp;  // torch.maximum(r1, sp): r1 on a tie
                }
                if (en > m) m = en;
            }
        } else if (hk != HOP_NONE) {
            read_exits(p.xch + (n_pub & 1) * V, (unsigned)last_pub, V, ex);
            __syncthreads();
            // one warp per destination word, lanes over source words
            const int warp = tid >> 5, lane = tid & 31, nwarps = nth >> 5;
            for (int w = warp; w < nw; w += nwarps) {
                const float* col = hs + (size_t)w * V;
                // four running maxima (max is exact and order-free), so
                // four sources' loads are in flight at once
                float h0 = -INFINITY, h1 = -INFINITY, h2 = -INFINITY, h3 = -INFINITY;
                int v = lane;
                for (; v + 96 < V; v += 128) {
                    h0 = fmaxf(h0, ex[v] + col[v]);
                    h1 = fmaxf(h1, ex[v + 32] + col[v + 32]);
                    h2 = fmaxf(h2, ex[v + 64] + col[v + 64]);
                    h3 = fmaxf(h3, ex[v + 96] + col[v + 96]);
                }
                for (; v < V; v += 32) h0 = fmaxf(h0, ex[v] + col[v]);
                float h = fmaxf(fmaxf(h0, h1), fmaxf(h2, h3));
#pragma unroll
                for (int off = 16; off > 0; off >>= 1)
                    h = fmaxf(h, __shfl_xor_sync(0xffffffffu, h, off));
                if (lane == 0) ent[w] = h;
            }
            __syncthreads();  // also: every read of g is done
            if (k_own >= 0 && j_own == 0 && ent[w_own] > m) m = ent[w_own];
        } else {
            __syncthreads();  // every read of g is done
        }

        const float nv = m + e;
        if (k_own >= 0) {
            g[k_own] = nv;
            out[k_own] = nv;
            if (exits_own) publish_exit((n_pub + 1) & 1, t, nv);
        }
        if (kFactors) fold_partials(wk, exits_own, nv + fw, nv + sf, w0 + w_own);
        ++n_pub;
        last_pub = t;
        __syncthreads();  // the new rows are in g (and every warp's partial keys in wk)
        if (kFactors) publish_partials(wk, part, p.n_blocks, n_pub & 1, t);
    }
}

// Mirrored by lnasr_tpu_torch/ops/factored.py:forward_smem_bytes (capacity rule).
size_t smem_bytes(int V, int S, int wpb, int hop_kind, int n_blocks, int n_src) {
    if (hop_kind == HOP_RANK1 || hop_kind == HOP_BACKOFF)  // rows, inner blocks, exit indices
        return factors_smem_bytes((size_t)wpb * S + (size_t)wpb * S * S + wpb, wpb, hop_kind, n_blocks, n_src);
    size_t f = (size_t)wpb * S + (size_t)wpb * S * S + wpb + V;
    size_t bytes = f * sizeof(float) + (size_t)wpb * sizeof(int);
    if (hop_kind == HOP_DENSE) bytes += (size_t)wpb * V * sizeof(float);
    return bytes;
}

}  // namespace

// blk_ptr, src_ptr, src, arc_lsrc, n_blocks, max_words and max_src are the
// backoff kind's word-to-block map and block source lists
// (ops/factored.py:block_layout); the other kinds take null and 0 and get
// ceil(V / n_sm) words a block.
extern "C" int factored_forward_launch(const float* pi_grid, const float* inner_a, const int* exit_idx,
                                       int hop_kind, const float* hop_t, const float* from_w,
                                       const float* uni, const float* sil_from, int sil_idx,
                                       const int* arc_ptr, const int* arc_dst, const int* arc_src,
                                       const float* arc_val, const float* log_b,
                                       const uint8_t* mask, int T, int V, int S, int n_sm,
                                       const int* blk_ptr, const int* src_ptr, const int* src,
                                       const int* arc_lsrc, int n_blocks, int max_words, int max_src,
                                       float* grids, unsigned long long* xch, void* stream) {
    if (T < 1) return (int)cudaErrorInvalidValue;
    Geometry geo;
    cudaError_t err = launch_geometry(hop_kind, V, S, n_sm, arc_ptr, blk_ptr, src_ptr, arc_lsrc, n_blocks,
                                      max_words, max_src, geo);
    if (err != cudaSuccess) return (int)err;
    const bool factors = hop_kind == HOP_RANK1 || hop_kind == HOP_BACKOFF;
    const void* kernel = factors ? (const void*)factored_forward_kernel<true>
                                 : (const void*)factored_forward_kernel<false>;
    Args a{pi_grid, inner_a, exit_idx, hop_t, from_w, uni, sil_from, arc_ptr, arc_dst, arc_src, arc_val,
           blk_ptr, src_ptr, src, arc_lsrc, log_b, mask, grids, xch, hop_kind, sil_idx, T, V, S, geo.wpb,
           geo.blocks};
    return (int)launch_exchange(kernel, geo, smem_bytes(V, S, geo.wpb, hop_kind, geo.blocks, max_src),
                                exchange_slots(hop_kind, V, geo.blocks), xch, &a, stream);
}

extern "C" const char* factored_forward_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
