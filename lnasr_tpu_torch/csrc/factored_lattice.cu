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
//                       (rank-1), or the larger of that and max over w's
//                       arcs of exit[src] + val, the source the smaller of
//                       the achieving families' lowest sources (backoff)
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
// start and pred rows in shared memory for the whole utterance, and the
// one thing a block needs from the others is the previous frame's V exit
// scores. The first design published them through a (2, V) float array
// and one cooperative grid barrier per frame, and that barrier was all of
// the kernel's time (~3.9 us a frame, as in kernel D before it lost its
// own).
//
// The exchange is kernel D's (factored_exchange.cuh states its format
// and why its publication order is safe): each word's exit, or for the
// rank-1 and backoff hops each block's rank-1 partials as (value, source)
// keys and, for the backoff kind, the exits of the block's own arcs'
// sources, travel with their frame's tag in 64-bit words polled by the
// readers. There is no fence, counter or cross-block barrier anywhere in
// the kernel. A masked frame publishes nothing (its exits are the last
// published frame's) but still writes its three records, repeating the
// carried state. The block's own within-word step (max, first argmax,
// carried start and pred) is computed before the poll, while the other
// blocks' exits are in flight; only state 0 compares with the entry after
// it. The dense-hop reduction carries four (value, index) pairs a lane
// over interleaved strides, so four sources' loads are in flight, merged
// (and then across the warp) by the larger value and, on a tie, the
// smaller index, so the lowest source still wins exact ties. F reads the
// factored kinds' keys' sources too: combining the blocks' keys by max
// gives the global first argmax, the tie rule of the plain torch.max,
// since a block's sources are the words it owns, and the sparse arcs are
// folded into per-word keys of the same form (the lowest achieving arc
// source); the entry and its source are formed in the word's state-0
// thread's registers. What bounds it is what bounds D: the exchange's
// latency per frame plus the block's hop reduction, T times over.
//
// The backoff kind also replaces lnasr_tpu/models/decoder.py:765
// factored_lattice_scan with HopFactors (jitted at :1162), a lax.scan XLA
// ran as one device program.
//
// A batch (the JAX package's jax.vmap of the scan, decoder.py:1266): one
// launch records B utterances of the graph (log_b (B, T, V, S), mask
// (B, T), records (B, T, V)) over kernel D's batched exchange and layout
// (factored_forward.cu, factored_exchange.cuh): block k steps its words
// for every utterance each frame, with each utterance's grid, start and
// pred rows and each item's within-word maximum, its start and pred, and
// its emission in shared memory (a thread's first utterance's in
// registers); the dense hop's argmax is a warp an (utterance, word), as
// for one utterance.

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
    float* exit_score;      // (B, T, V)
    int* exit_start;        // (B, T, V)
    int* exit_pred;         // (B, T, V)
    // (2, B, V) exits: (frame tag << 32) | exit bits (dense, backoff), then
    // (2, B, n_blocks, PART) partials: (frame tag << 32) | half a key (rank-1, backoff)
    unsigned long long* xch;
    int hop_kind, sil_idx, B, T, V, S, wpb, n_blocks;
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

// The launch bounds hold registers to 64 per thread, so that a block of
// up to 1024 threads fits the SM's 64 K registers. kFactors: the rank-1 and
// backoff kinds (partials); otherwise none and dense (the V-slot exchange).
// kBatch: a launch of p.B > 1 utterances; otherwise one, whose batch is the
// compile-time 1 (its lanes, valid bits and copies fold away, and its frame
// keeps the registers one utterance needs).
template <bool kFactors, bool kBatch>
__global__ void __launch_bounds__(MAX_THREADS) factored_lattice_kernel(Args p) {
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
    int* esrc = eidx + p.wpb;                        // [B * wpb] hop source of each entry (dense)
    int* st = kFactors ? esrc : esrc + B * p.wpb;    // [rows] token start frames
    int* pr = st + rows;                             // [rows] token predecessor words
    int* wst = pr + rows;                            // [rows] each item's start and pred after
    int* wpr = wst + rows;                           // [rows] the within-word step
    float* hs = reinterpret_cast<float*>(wpr + rows);  // [wpb * V] hop columns (dense)
    int* bsrc = wpr + rows;                          // [n_src] the block's sources (backoff)
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
    const size_t frame = (size_t)V * S, utt = (size_t)T * frame;  // log_b's strides
    // this thread's cell (word w_own, state j_own) and its utterances
    const CellLanes cl = cell_lanes(cells, B);
    const int k_own = cl.k, w_own = k_own / S, j_own = k_own - w_own * S;
    const bool active = cl.b0 < B;          // the thread has a cell
    const int bf = kBatch ? cl.b0 : 0;      // its first utterance (one utterance's: 0)
    // fn(b) for each of the thread's utterances; one utterance's is a
    // guarded call with b the compile-time 0
    auto each = [&](auto&& fn) {
        if (kBatch) {
            for (int b = cl.b0; b < B; b += cl.step) fn(b);
        } else if (active) {
            fn(0);
        }
    };
    __syncthreads();
    // the exit cell's thread writes its word's records at every frame,
    // masked ones included, and publishes its exit at frame 0 and every
    // live frame; it reads back only its own row slots, so no barrier
    // orders it
    const bool exits_own = active && j_own == eidx[w_own];
    // the factors this thread adds on a frame's chain, in registers: its
    // exit's rank-1 rows, its word's unigram at state 0
    const float fw = kFactors && exits_own ? p.from_w[w0 + w_own] : 0.0f;
    const float sf = kFactors && exits_own ? p.sil_from[w0 + w_own] : 0.0f;
    const float un = kFactors && active && j_own == 0 ? p.uni[w0 + w_own] : 0.0f;
    // the exit cell's records of utterance b at frame t, and its
    // publication of the exit x (buffer `buf`) and its word's partial keys
    auto exit_records = [&](int b, int t, float x, int s0, int p0) {
        const size_t rec = ((size_t)b * T + t) * V + w0 + w_own;
        p.exit_score[rec] = x;
        p.exit_start[rec] = s0;
        p.exit_pred[rec] = p0;
    };
    auto publish_exit = [&](int b, int buf, int t, float x) {
        if (hk == HOP_DENSE || hk == HOP_BACKOFF)
            st_relaxed(p.xch + ((size_t)buf * B + b) * V + w0 + w_own, tagged(t, x));
        if (kFactors) {
            pl.xk[2 * (b * p.wpb + w_own)] = key_of(x + fw, w0 + w_own);
            pl.xk[2 * (b * p.wpb + w_own) + 1] = key_of(x + sf, w0 + w_own);
        }
    };
    each([&](int b) {
        const int i = b * cells + k_own;
        const float x = p.pi_grid[row0 + k_own] + p.log_b[b * utt + row0 + k_own];
        g[i] = x;
        st[i] = 0;
        pr[i] = -1;
        if (exits_own) {
            exit_records(b, 0, x, 0, -1);
            if (hk != HOP_NONE) publish_exit(b, 0, 0, x);
        }
    });
    __syncthreads();  // frame 0's rows are in g, st and pr (and every exit key in xk)
    if (kFactors) publish_partials(pl.xk, p.wpb, nw, part, B, p.n_blocks, 0, 0);
    int n_pub = 0, last_pub = 0;  // publications so far - 1, frame of the last

    unsigned long long live_next = T > 1 ? frame_bits(p.mask, B, T, 1) : 0;
    for (int t = 1; t < T; ++t) {
        const unsigned long long live = live_next;  // the utterances valid at t
        if (t + 1 < T) live_next = frame_bits(p.mask, B, T, t + 1);  // ahead of its use
        const size_t fo = (size_t)t * frame + row0 + k_own;
        if (!live) {  // no utterance takes the frame: the records repeat; nothing is published
            if (exits_own)
                each([&](int b) {
                    const int i = b * cells + k_own;
                    exit_records(b, t, g[i], st[i], pr[i]);
                });
            continue;
        }
        // this frame's emissions (in flight) and the block's own
        // within-word step (max, first argmax, carried start and pred),
        // before the wait for the other blocks' exits: the thread's first
        // utterance's in registers, the others' in shared memory
        auto within = [&](int b, float& m, int& s0, int& p0) {
            const int gw = b * cells + w_own * S;  // the word's row slots
            const float* gr = g + gw;
            const float* a = ia + (size_t)w_own * S * S + j_own;
            m = gr[0] + a[0];
            int src = 0;
            for (int s = 1; s < S; ++s) {
                const float c = gr[s] + a[(size_t)s * S];
                if (c > m) {
                    m = c;
                    src = s;
                }
            }
            s0 = st[gw + src];
            p0 = pr[gw + src];
        };
        float e0 = 0.0f, m0 = -INFINITY;
        int st0 = 0, pr0 = 0;
        if (active && (live >> bf & 1)) {
            e0 = p.log_b[bf * utt + fo];
            within(bf, m0, st0, pr0);
        }
        for (int b = cl.b0 + cl.step; kBatch && b < B; b += cl.step) {
            if (!(live >> b & 1)) continue;
            const int i = b * cells + k_own;
            cp_async4(es + i, p.log_b + b * utt + fo);
            within(b, wm[i], wst[i], wpr[i]);
        }

        if (kFactors) {
            // the sparse keys' reset: every read of the last frame's is done
            if (hk == HOP_BACKOFF)
                for (int q = tid; q < B * nw; q += nth) pl.spk[q] = key_of(-INFINITY, BIG);
            read_slots(part + (size_t)(n_pub & 1) * B * n_part, B * n_part,
                       p.xch + (size_t)(n_pub & 1) * B * V, bsrc, n_src, B, V, (unsigned)last_pub, pl.got);
            __syncthreads();  // also: every read of g, st and pr is done
            combine_polled(pl.got, p.n_blocks, B, pl.rk);
            if (hk == HOP_BACKOFF)
                fold_arcs(pl.spk, nw, w0, r.arc0, r.arc1 - r.arc0, arc_lanes<kBatch>(r.arc1 - r.arc0, B), B, live,
                          p.arc_dst, p.arc_lsrc, p.arc_val, p.arc_src,
                          reinterpret_cast<const float*>(pl.got + B * n_part), n_src);
            __syncthreads();  // the warps' combines (and the arcs' atomics) are done
        } else if (hk != HOP_NONE) {
            read_exits(p.xch + (size_t)(n_pub & 1) * B * V, (unsigned)last_pub, B * V, ex);
            __syncthreads();
            // one warp per (utterance live at t, destination word), lanes
            // over source words; four (value, index) pairs a lane, each over
            // increasing sources (strict > keeps its first), so four
            // sources' loads are in flight at once
            const int warp = tid >> 5, lane = tid & 31, nwarps = nth >> 5;
            for (int q = warp; q < B * nw; q += nwarps) {
                const int b = B == 1 ? 0 : q / nw, w = q - b * nw;
                if (!(live >> b & 1)) continue;
                const float* col = hs + (size_t)w * V;
                const float* eb = ex + (size_t)b * V;
                float m0 = -INFINITY, m1 = -INFINITY, m2 = -INFINITY, m3 = -INFINITY;
                int a0 = lane, a1 = lane + 32, a2 = lane + 64, a3 = lane + 96;
                int v = lane;
                for (; v + 96 < V; v += 128) {
                    const float c0 = eb[v] + col[v];
                    const float c1 = eb[v + 32] + col[v + 32];
                    const float c2 = eb[v + 64] + col[v + 64];
                    const float c3 = eb[v + 96] + col[v + 96];
                    if (c0 > m0) { m0 = c0; a0 = v; }
                    if (c1 > m1) { m1 = c1; a1 = v + 32; }
                    if (c2 > m2) { m2 = c2; a2 = v + 64; }
                    if (c3 > m3) { m3 = c3; a3 = v + 96; }
                }
                for (; v < V; v += 32) {
                    const float c = eb[v] + col[v];
                    if (c > m0) { m0 = c; a0 = v; }
                }
                arg_take(m0, a0, m1, a1);
                arg_take(m2, a2, m3, a3);
                arg_take(m0, a0, m2, a2);
                warp_argmax(m0, a0);
                if (lane == 0) {
                    ent[q] = m0;
                    esrc[q] = a0;
                }
            }
            __syncthreads();  // also: every read of g, st and pr is done
        } else {
            __syncthreads();  // every read of g, st and pr is done
        }

        if (kBatch) cp_async_wait();  // this thread's emissions are in es
        const int buf = (n_pub + 1) & 1;
        each([&](int b) {
            const int i = b * cells + k_own;
            float nv;
            int nst, npr;
            if (live >> b & 1) {
                const bool first = !kBatch || b == cl.b0;  // its values in registers
                float m = first ? m0 : wm[i];
                nst = first ? st0 : wst[i];
                npr = first ? pr0 : wpr[i];
                if (j_own == 0 && hk != HOP_NONE) {
                    float en;
                    int s;
                    if (kFactors) {
                        unsigned long long k1, k2;
                        polled_max(pl.rk + 2 * (size_t)b * groups, groups, k1, k2);
                        const int wg = w0 + w_own;
                        const bool sil = wg == p.sil_idx;
                        en = sil ? value_of(k2) : value_of(k1) + un;
                        s = source_of(sil ? k2 : k1);
                        if (hk == HOP_BACKOFF && !sil) {
                            const unsigned long long key = pl.spk[b * nw + w_own];
                            const float sp = value_of(key), r1 = en;
                            if (sp > r1) en = sp;  // torch.maximum(r1, sp): r1 on a tie
                            s = min(r1 >= en ? s : BIG, sp >= en ? source_of(key) : BIG);
                        }
                    } else {
                        en = ent[b * nw + w_own];
                        s = esrc[b * nw + w_own];
                    }
                    if (en > m) {
                        m = en;
                        nst = t;
                        npr = s;
                    }
                }
                nv = m + (first ? e0 : es[i]);
                g[i] = nv;
                st[i] = nst;
                pr[i] = npr;
            } else {  // an utterance masked at t keeps its state
                nv = g[i];
                nst = st[i];
                npr = pr[i];
            }
            if (exits_own) {
                exit_records(b, t, nv, nst, npr);
                if (hk != HOP_NONE) publish_exit(b, buf, t, nv);
            }
        });
        ++n_pub;
        last_pub = t;
        __syncthreads();  // the new rows are in g, st and pr (and every exit key in xk)
        if (kFactors) publish_partials(pl.xk, p.wpb, nw, part, B, p.n_blocks, n_pub & 1, t);
    }
}

// Mirrored by lnasr_tpu_torch/ops/factored.py:lattice_smem_bytes (capacity rule).
size_t smem_bytes(int B, int V, int S, int wpb, int hop_kind, int n_blocks, int n_src) {
    const size_t rows = (size_t)B * wpb * S;
    // rows, within-word maxima, emissions, inner blocks, exit indices; start,
    // pred and their within-word step's
    if (hop_kind == HOP_RANK1 || hop_kind == HOP_BACKOFF)
        return factors_smem_bytes(7 * rows + (size_t)wpb * S * S + wpb, wpb, hop_kind, n_blocks, n_src, B);
    size_t f = 3 * rows + (size_t)wpb * S * S + (size_t)B * wpb + (hop_kind == HOP_DENSE ? (size_t)B * V : 0);
    size_t bytes = f * sizeof(float) + ((size_t)wpb + (size_t)B * wpb + 4 * rows) * sizeof(int);
    if (hop_kind == HOP_DENSE) bytes += (size_t)wpb * V * sizeof(float);
    return bytes;
}

}  // namespace

// blk_ptr, src_ptr, src, arc_lsrc, n_blocks, max_words and max_src are the
// backoff kind's word-to-block map and block source lists
// (ops/factored.py:block_layout); the other kinds take null and 0 and get
// ceil(V / n_sm) words a block.
extern "C" int factored_lattice_launch(const float* pi_grid, const float* inner_a, const int* exit_idx,
                                       int hop_kind, const float* hop_t, const float* from_w,
                                       const float* uni, const float* sil_from, int sil_idx,
                                       const int* arc_ptr, const int* arc_dst, const int* arc_src,
                                       const float* arc_val, const float* log_b,
                                       const uint8_t* mask, int B, int T, int V, int S, int n_sm,
                                       const int* blk_ptr, const int* src_ptr, const int* src,
                                       const int* arc_lsrc, int n_blocks, int max_words, int max_src,
                                       float* exit_score, int* exit_start, int* exit_pred,
                                       unsigned long long* xch, void* stream) {
    if (T < 1) return (int)cudaErrorInvalidValue;
    Geometry geo;
    cudaError_t err = launch_geometry(hop_kind, B, V, S, n_sm, arc_ptr, blk_ptr, src_ptr, arc_lsrc, n_blocks,
                                      max_words, max_src, geo);
    if (err != cudaSuccess) return (int)err;
    const bool factors = hop_kind == HOP_RANK1 || hop_kind == HOP_BACKOFF;
    const void* kernel = factors ? (B > 1 ? (const void*)factored_lattice_kernel<true, true>
                                          : (const void*)factored_lattice_kernel<true, false>)
                                 : (B > 1 ? (const void*)factored_lattice_kernel<false, true>
                                          : (const void*)factored_lattice_kernel<false, false>);
    Args a{pi_grid, inner_a, exit_idx, hop_t, from_w, uni, sil_from, arc_ptr, arc_dst, arc_src,
           arc_val, blk_ptr, src_ptr, src, arc_lsrc, log_b, mask, exit_score, exit_start, exit_pred,
           xch, hop_kind, sil_idx, B, T, V, S, geo.wpb, geo.blocks};
    return (int)launch_exchange(kernel, geo, smem_bytes(B, V, S, geo.wpb, hop_kind, geo.blocks, max_src),
                                exchange_slots(hop_kind, B, V, geo.blocks), xch, &a, stream);
}

extern "C" const char* factored_lattice_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
