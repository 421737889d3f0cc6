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
//
// A batch (the JAX package's jax.vmap of the scan, decoder.py:1125): one
// launch decodes B utterances of the graph (log_b and grids (B, T, V, S),
// mask (B, T)). Since the time is the exchange's latency a frame and not
// the work, block k steps its words for all B utterances each frame (a
// thread keeps one cell and steps it for its utterances u, u + L, ...)
// and one exchange round carries every utterance's exits or partials
// (factored_exchange.cuh states how masks that differ by utterance are
// kept in lockstep). The hop columns, inner blocks and exit indices are
// loaded once for the batch; each utterance's grid rows, within-word
// maxima and emissions take B times one utterance's shared memory (a
// thread's first utterance keeps its maximum and emission in registers,
// the later ones' emissions come by cp.async while the block waits), and
// the dense hop's reduction reads a source's hop entry once for four
// utterances. One utterance is B = 1 of the same source, instantiated
// with the batch a compile-time 1.

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
    const float* log_b;     // (B, T, V, S)
    const uint8_t* mask;    // (B, T) or null
    float* grids;           // (B, T, V, S)
    // (2, B, V) exits: (frame tag << 32) | exit bits (dense, backoff), then
    // (2, B, n_blocks, PART) partials: (frame tag << 32) | half a key (rank-1, backoff)
    unsigned long long* xch;
    int hop_kind, sil_idx, B, T, V, S, wpb, n_blocks;
};

// The launch bounds hold registers to 64 per thread, so that a block of
// up to 1024 threads fits the SM's 64 K registers. kFactors: the rank-1 and
// backoff kinds (partials); otherwise none and dense (the V-slot exchange).
// kBatch: a launch of p.B > 1 utterances; otherwise one, whose batch is the
// compile-time 1 (its lanes, valid bits and copies fold away, and its frame
// keeps the registers one utterance needs).
template <bool kFactors, bool kBatch>
__global__ void __launch_bounds__(MAX_THREADS) factored_forward_kernel(Args p) {
    extern __shared__ __align__(16) unsigned char smem[];

    const int V = p.V, S = p.S, T = p.T, B = kBatch ? p.B : 1;
    const BlockRange r = block_range<kFactors>(p);
    const int w0 = r.w0, nw = r.nw, n_src = r.n_src;
    // an item is an (utterance, cell) pair, item b cells + k; its row slot
    // is its index
    const int cells = nw * S;
    const int tid = threadIdx.x, nth = blockDim.x;
    const int hk = p.hop_kind;
    const int n_part = PART * p.n_blocks;  // one utterance's partial words
    const int groups = (p.n_blocks + 31) >> 5;
    const int rows = B * p.wpb * S;
    // rank-1, backoff: the polled slots and the keys, then the rows
    const Polled pl = polled_layout(smem, B * n_part, B * n_src, hk == HOP_BACKOFF ? B * p.wpb : 0, B,
                                    p.wpb, groups);
    float* g = kFactors ? reinterpret_cast<float*>(pl.end)
                        : reinterpret_cast<float*>(smem);  // [rows] this block's rows, by item
    float* wm = g + rows;                            // [rows] each item's within-word maximum
    float* es = wm + rows;                           // [rows] each item's emission of the frame
    float* ia = es + rows;                           // [wpb * S * S]
    // none, dense
    float* ent = ia + p.wpb * S * S;                 // [B * wpb] each (utterance, word)'s entry
    float* ex = ent + B * p.wpb;                     // [B * V] exits of the last published frame (dense)
    int* eidx = kFactors ? reinterpret_cast<int*>(ent)
                         : reinterpret_cast<int*>(ex + (hk == HOP_DENSE ? B * V : 0));  // [wpb]
    float* hs = reinterpret_cast<float*>(eidx + p.wpb);  // [wpb * V] hop columns (dense)
    int* bsrc = eidx + p.wpb;                        // [n_src] the block's sources (backoff)
    unsigned long long* part = p.xch + (hk == HOP_BACKOFF ? 2 * (size_t)B * V : 0);

    for (int k = tid; k < cells * S; k += nth) ia[k] = p.inner_a[(size_t)w0 * S * S + k];
    for (int k = tid; k < nw; k += nth) eidx[k] = p.exit_idx[w0 + k];
    if (!kFactors && hk == HOP_DENSE) {
        for (int k = tid; k < nw * V; k += nth) hs[k] = p.hop_t[(size_t)w0 * V + k];
    }
    if (kFactors) {
        for (int k = tid; k < n_src; k += nth) bsrc[k] = p.src[r.src0 + k];
    }
    const size_t row0 = (size_t)w0 * S;
    const size_t frame = (size_t)V * S, utt = (size_t)T * frame;  // log_b's and grids' strides
    // this thread's cell (word w_own, state j_own) and its utterances
    const CellLanes cl = cell_lanes(cells, B);
    const int k_own = cl.k, w_own = k_own / S, j_own = k_own - w_own * S;
    // the thread's first utterance is the compile-time 0 for one utterance
    // of the none and dense kinds; the factored kinds keep it at run time
    // (cl.b0: 0 or B), where the constant made the compiler spill in the
    // frame loop (PERF.md, PR 23)
    constexpr bool kLoop = kBatch || kFactors;
    const bool active = cl.b0 < B;          // the thread has a cell
    const int bf = kLoop ? cl.b0 : 0;       // its first utterance
    // fn(b) for each of the thread's utterances
    auto each = [&](auto&& fn) {
        if (kLoop) {
            for (int b = cl.b0; b < B; b += cl.step) fn(b);
        } else if (active) {
            fn(0);
        }
    };
    __syncthreads();
    const bool exits_own = hk != HOP_NONE && active && j_own == eidx[w_own];
    // the factors this thread adds on a frame's chain, in registers: its
    // exit's rank-1 rows, its word's unigram at state 0
    const float fw = kFactors && exits_own ? p.from_w[w0 + w_own] : 0.0f;
    const float sf = kFactors && exits_own ? p.sil_from[w0 + w_own] : 0.0f;
    const float un = kFactors && active && j_own == 0 ? p.uni[w0 + w_own] : 0.0f;
    // the exit cell's publication of utterance b's exit x of frame t
    // (buffer `buf`) and its word's partial keys
    auto publish_exit = [&](int b, int buf, int t, float x) {
        if (!kFactors || hk == HOP_BACKOFF)
            st_relaxed(p.xch + ((size_t)buf * B + b) * V + w0 + w_own, tagged(t, x));
        if (kFactors) {
            pl.xk[2 * (b * p.wpb + w_own)] = key_of(x + fw, w0 + w_own);
            pl.xk[2 * (b * p.wpb + w_own) + 1] = key_of(x + sf, w0 + w_own);
        }
    };
    each([&](int b) {
        const size_t at = b * utt + row0 + k_own;
        const float x = p.pi_grid[row0 + k_own] + p.log_b[at];
        g[b * cells + k_own] = x;
        p.grids[at] = x;
        if (exits_own) publish_exit(b, 0, 0, x);
    });
    __syncthreads();  // frame 0's rows are in g (and every exit key in xk)
    if (kFactors) publish_partials(pl.xk, p.wpb, nw, part, B, p.n_blocks, 0, 0);
    int n_pub = 0, last_pub = 0;  // publications so far - 1, frame of the last

    unsigned long long live_next = T > 1 ? frame_bits(p.mask, B, T, 1) : 0;
    for (int t = 1; t < T; ++t) {
        const unsigned long long live = live_next;  // the utterances valid at t
        if (t + 1 < T) live_next = frame_bits(p.mask, B, T, t + 1);  // ahead of its use
        const size_t fo = (size_t)t * frame + row0 + k_own;
        if (!live) {  // no utterance takes the frame: the grids carry over; nothing is published
            each([&](int b) { p.grids[b * utt + fo] = g[b * cells + k_own]; });
            continue;
        }
        // this frame's emissions (in flight) and the block's own
        // within-word step, before the wait for the other blocks' exits:
        // the thread's first utterance's in registers, the others' in
        // shared memory
        auto within = [&](int b) {
            const float* gr = g + b * cells + w_own * S;
            const float* a = ia + (size_t)w_own * S * S + j_own;
            float m = gr[0] + a[0];
            for (int s = 1; s < S; ++s) m = fmaxf(m, gr[s] + a[(size_t)s * S]);
            return m;
        };
        float e0 = 0.0f, m0 = -INFINITY;
        if (active && (live >> bf & 1)) {
            e0 = p.log_b[bf * utt + fo];
            m0 = within(bf);
        }
        for (int b = cl.b0 + cl.step; kBatch && b < B; b += cl.step) {
            if (!(live >> b & 1)) continue;
            const int i = b * cells + k_own;
            cp_async4(es + i, p.log_b + b * utt + fo);
            wm[i] = within(b);
        }

        if (kFactors) {
            // the sparse keys' reset: every read of the last frame's is done
            if (hk == HOP_BACKOFF)
                for (int q = tid; q < B * nw; q += nth) pl.spk[q] = key_of(-INFINITY, BIG);
            read_slots(part + (size_t)(n_pub & 1) * B * n_part, B * n_part,
                       p.xch + (size_t)(n_pub & 1) * B * V, bsrc, n_src, B, V, (unsigned)last_pub, pl.got);
            __syncthreads();  // also: every read of g is done
            combine_polled(pl.got, p.n_blocks, B, pl.rk);
            if (hk == HOP_BACKOFF)
                fold_arcs(pl.spk, nw, w0, r.arc0, r.arc1 - r.arc0, arc_lanes<kBatch>(r.arc1 - r.arc0, B), B, live,
                          p.arc_dst, p.arc_lsrc, p.arc_val, p.arc_src,
                          reinterpret_cast<const float*>(pl.got + B * n_part), n_src);
            __syncthreads();  // the warps' combines (and the arcs' atomics) are done
        } else if (hk != HOP_NONE) {
            read_exits(p.xch + (size_t)(n_pub & 1) * B * V, (unsigned)last_pub, B * V, ex);
            __syncthreads();
            const int warp = tid >> 5, lane = tid & 31, nwarps = nth >> 5;
            if (B == 1) {
                // one warp per destination word, lanes over source words
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
            } else {
                // one warp per (destination word, four utterances), lanes
                // over source words, a running maximum an utterance: each
                // hop entry read once for the four
                const int quads = (B + 3) >> 2;
                for (int q = warp; q < nw * quads; q += nwarps) {
                    const int w = q / quads, b0 = (q - w * quads) * 4, nb = min(4, B - b0);
                    const float* col = hs + (size_t)w * V;
                    // rows past the batch re-read utterance b0's, unused
                    const float* e0 = ex + (size_t)b0 * V;
                    const float* e1 = e0 + (nb > 1 ? V : 0);
                    const float* e2 = e0 + (nb > 2 ? 2 * V : 0);
                    const float* e3 = e0 + (nb > 3 ? 3 * V : 0);
                    float h[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
                    for (int v = lane; v < V; v += 32) {
                        const float c = col[v];
                        h[0] = fmaxf(h[0], e0[v] + c);
                        h[1] = fmaxf(h[1], e1[v] + c);
                        h[2] = fmaxf(h[2], e2[v] + c);
                        h[3] = fmaxf(h[3], e3[v] + c);
                    }
#pragma unroll
                    for (int u = 0; u < 4; ++u) {
#pragma unroll
                        for (int off = 16; off > 0; off >>= 1)
                            h[u] = fmaxf(h[u], __shfl_xor_sync(0xffffffffu, h[u], off));
                    }
                    if (lane < nb) ent[(b0 + lane) * nw + w] = lane == 0 ? h[0] : lane == 1 ? h[1]
                                                                : lane == 2 ? h[2] : h[3];
                }
            }
            __syncthreads();  // also: every read of g is done
        } else {
            __syncthreads();  // every read of g is done
        }

        if (kBatch) cp_async_wait();  // this thread's emissions are in es
        const int buf = (n_pub + 1) & 1;
        each([&](int b) {
            const int i = b * cells + k_own;
            const bool first = !kBatch || b == bf;  // its values in registers
            float nv;
            if (live >> b & 1) {
                float m = first ? m0 : wm[i];
                if (j_own == 0 && hk != HOP_NONE) {
                    float en;
                    if (kFactors) {
                        unsigned long long k1, k2;
                        polled_max(pl.rk + 2 * (size_t)b * groups, groups, k1, k2);
                        const int wg = w0 + w_own;
                        en = wg == p.sil_idx ? value_of(k2) : value_of(k1) + un;
                        if (hk == HOP_BACKOFF && wg != p.sil_idx) {
                            const float sp = value_of(pl.spk[b * nw + w_own]);
                            if (sp > en) en = sp;  // torch.maximum(r1, sp): r1 on a tie
                        }
                    } else {
                        en = ent[b * nw + w_own];
                    }
                    if (en > m) m = en;
                }
                nv = m + (first ? e0 : es[i]);
                g[i] = nv;
            } else {
                nv = g[i];  // an utterance masked at t keeps its grid
            }
            p.grids[b * utt + fo] = nv;
            if (exits_own) publish_exit(b, buf, t, nv);
        });
        ++n_pub;
        last_pub = t;
        __syncthreads();  // the new rows are in g (and every exit key in xk)
        if (kFactors) publish_partials(pl.xk, p.wpb, nw, part, B, p.n_blocks, n_pub & 1, t);
    }
}

// Mirrored by lnasr_tpu_torch/ops/factored.py:forward_smem_bytes (capacity rule).
size_t smem_bytes(int B, int V, int S, int wpb, int hop_kind, int n_blocks, int n_src) {
    const size_t rows = (size_t)B * wpb * S;  // grid rows, within-word maxima, emissions
    if (hop_kind == HOP_RANK1 || hop_kind == HOP_BACKOFF)  // rows, inner blocks, exit indices
        return factors_smem_bytes(3 * rows + (size_t)wpb * S * S + wpb, wpb, hop_kind, n_blocks, n_src, B);
    size_t f = 3 * rows + (size_t)wpb * S * S + (size_t)B * wpb + (hop_kind == HOP_DENSE ? (size_t)B * V : 0);
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
                                       const uint8_t* mask, int B, int T, int V, int S, int n_sm,
                                       const int* blk_ptr, const int* src_ptr, const int* src,
                                       const int* arc_lsrc, int n_blocks, int max_words, int max_src,
                                       float* grids, unsigned long long* xch, void* stream) {
    if (T < 1) return (int)cudaErrorInvalidValue;
    Geometry geo;
    cudaError_t err = launch_geometry(hop_kind, B, V, S, n_sm, arc_ptr, blk_ptr, src_ptr, arc_lsrc, n_blocks,
                                      max_words, max_src, geo);
    if (err != cudaSuccess) return (int)err;
    const bool factors = hop_kind == HOP_RANK1 || hop_kind == HOP_BACKOFF;
    const void* kernel = factors ? (B > 1 ? (const void*)factored_forward_kernel<true, true>
                                          : (const void*)factored_forward_kernel<true, false>)
                                 : (B > 1 ? (const void*)factored_forward_kernel<false, true>
                                          : (const void*)factored_forward_kernel<false, false>);
    Args a{pi_grid, inner_a, exit_idx, hop_t, from_w, uni, sil_from, arc_ptr, arc_dst, arc_src, arc_val,
           blk_ptr, src_ptr, src, arc_lsrc, log_b, mask, grids, xch, hop_kind, sil_idx, B, T, V, S, geo.wpb,
           geo.blocks};
    return (int)launch_exchange(kernel, geo, smem_bytes(B, V, S, geo.wpb, hop_kind, geo.blocks, max_src),
                                exchange_slots(hop_kind, B, V, geo.blocks), xch, &a, stream);
}

extern "C" const char* factored_forward_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
