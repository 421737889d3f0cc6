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
    float* exit_score;      // (T, V)
    int* exit_start;        // (T, V)
    int* exit_pred;         // (T, V)
    // (2, V) exits: (frame tag << 32) | exit bits (dense, backoff), then
    // (2, n_blocks, PART) partials: (frame tag << 32) | half a key (rank-1, backoff)
    unsigned long long* xch;
    int hop_kind, sil_idx, T, V, S, wpb, n_blocks;
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
template <bool kFactors>
__global__ void __launch_bounds__(MAX_THREADS) factored_lattice_kernel(Args p) {
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
    int* esrc = eidx + p.wpb;                        // [wpb] hop source of each word (dense)
    int* st = kFactors ? esrc : esrc + p.wpb;        // [wpb * S] token start frames
    int* pr = st + p.wpb * S;                        // [wpb * S] token predecessor words
    float* hs = reinterpret_cast<float*>(pr + p.wpb * S);  // [wpb * V] hop columns (dense)
    int* bsrc = pr + p.wpb * S;                      // [n_src] the block's sources (backoff)
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
        g[k_own] = p.pi_grid[row0 + k_own] + p.log_b[row0 + k_own];
        st[k_own] = 0;
        pr[k_own] = -1;
    }
    __syncthreads();
    // the exit cell's thread writes its word's records at every frame,
    // masked ones included, and publishes its exit at frame 0 and every
    // valid frame; it reads back only its own cell, so no barrier orders it
    const bool exits_own = k_own >= 0 && j_own == eidx[w_own];
    // the factors this thread adds on a frame's chain, in registers: its
    // exit's rank-1 rows, its word's unigram at state 0
    const float fw = kFactors && exits_own ? p.from_w[w0 + w_own] : 0.0f;
    const float sf = kFactors && exits_own ? p.sil_from[w0 + w_own] : 0.0f;
    const float un = kFactors && k_own >= 0 && j_own == 0 ? p.uni[w0 + w_own] : 0.0f;
    // the exit cell's publication of frame t's exit x (buffer `buf`)
    auto publish_exit = [&](int buf, int t, float x) {
        if (hk == HOP_DENSE || hk == HOP_BACKOFF)
            st_relaxed(p.xch + (size_t)buf * V + w0 + w_own, tagged(t, x));
    };
    if (exits_own) {
        p.exit_score[w0 + w_own] = g[k_own];
        p.exit_start[w0 + w_own] = 0;
        p.exit_pred[w0 + w_own] = -1;
        if (hk != HOP_NONE) publish_exit(0, 0, g[k_own]);
    }
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
        const size_t rec = (size_t)t * V + w0;
        if (!valid) {  // identity step: the records repeat; nothing is published
            if (exits_own) {
                p.exit_score[rec + w_own] = g[k_own];
                p.exit_start[rec + w_own] = st[k_own];
                p.exit_pred[rec + w_own] = pr[k_own];
            }
            continue;
        }
        // this frame's emission and the block's own within-word step,
        // loaded before the wait for the other blocks' exits
        float e = 0.0f, m = -INFINITY;
        int nst = 0, npr = 0;
        if (k_own >= 0) {
            e = p.log_b[(size_t)t * frame + row0 + k_own];
            const float* gr = g + w_own * S;
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
            nst = st[w_own * S + src];
            npr = pr[w_own * S + src];
        }

        if (kFactors) {
            // the sparse keys' reset: every read of the last frame's is done
            if (hk == HOP_BACKOFF)
                for (int w = tid; w < nw; w += nth) spk[w] = key_of(-INFINITY, BIG);
            read_slots(part + (size_t)(n_pub & 1) * n_part, n_part, p.xch + (size_t)(n_pub & 1) * V,
                       bsrc, n_src, (unsigned)last_pub, got);
            __syncthreads();  // also: every read of g, st and pr is done
            combine_polled(got, p.n_blocks, rk);
            if (hk == HOP_BACKOFF)
                fold_arcs(spk, w0, r.arc0, r.arc1, p.arc_dst, p.arc_lsrc, p.arc_val, p.arc_src,
                          reinterpret_cast<const float*>(got + n_part));
            __syncthreads();  // the warps' combines (and the arcs' atomics) are done
            if (k_own >= 0 && j_own == 0) {
                unsigned long long k1, k2;
                polled_max(rk, p.n_blocks, k1, k2);
                const int w = w0 + w_own;
                const bool sil = w == p.sil_idx;
                float en = sil ? value_of(k2) : value_of(k1) + un;
                int s = source_of(sil ? k2 : k1);
                if (hk == HOP_BACKOFF && !sil) {
                    const float sp = value_of(spk[w_own]), r1 = en;
                    if (sp > r1) en = sp;  // torch.maximum(r1, sp): r1 on a tie
                    s = min(r1 >= en ? s : BIG, sp >= en ? source_of(spk[w_own]) : BIG);
                }
                if (en > m) {
                    m = en;
                    nst = t;
                    npr = s;
                }
            }
        } else if (hk != HOP_NONE) {
            read_exits(p.xch + (n_pub & 1) * V, (unsigned)last_pub, V, ex);
            __syncthreads();
            // one warp per destination word, lanes over source words;
            // four (value, index) pairs a lane, each over increasing
            // sources (strict > keeps its first), so four sources'
            // loads are in flight at once
            const int warp = tid >> 5, lane = tid & 31, nwarps = nth >> 5;
            for (int w = warp; w < nw; w += nwarps) {
                const float* col = hs + (size_t)w * V;
                float m0 = -INFINITY, m1 = -INFINITY, m2 = -INFINITY, m3 = -INFINITY;
                int a0 = lane, a1 = lane + 32, a2 = lane + 64, a3 = lane + 96;
                int v = lane;
                for (; v + 96 < V; v += 128) {
                    const float c0 = ex[v] + col[v];
                    const float c1 = ex[v + 32] + col[v + 32];
                    const float c2 = ex[v + 64] + col[v + 64];
                    const float c3 = ex[v + 96] + col[v + 96];
                    if (c0 > m0) { m0 = c0; a0 = v; }
                    if (c1 > m1) { m1 = c1; a1 = v + 32; }
                    if (c2 > m2) { m2 = c2; a2 = v + 64; }
                    if (c3 > m3) { m3 = c3; a3 = v + 96; }
                }
                for (; v < V; v += 32) {
                    const float c = ex[v] + col[v];
                    if (c > m0) { m0 = c; a0 = v; }
                }
                arg_take(m0, a0, m1, a1);
                arg_take(m2, a2, m3, a3);
                arg_take(m0, a0, m2, a2);
                warp_argmax(m0, a0);
                if (lane == 0) {
                    ent[w] = m0;
                    esrc[w] = a0;
                }
            }
            __syncthreads();  // also: every read of g, st and pr is done
            if (k_own >= 0 && j_own == 0 && ent[w_own] > m) {
                m = ent[w_own];
                nst = t;
                npr = esrc[w_own];
            }
        } else {
            __syncthreads();  // every read of g, st and pr is done
        }

        const float nv = m + e;
        if (k_own >= 0) {
            g[k_own] = nv;
            st[k_own] = nst;
            pr[k_own] = npr;
            if (exits_own) {
                if (hk != HOP_NONE) publish_exit((n_pub + 1) & 1, t, nv);
                p.exit_score[rec + w_own] = nv;
                p.exit_start[rec + w_own] = nst;
                p.exit_pred[rec + w_own] = npr;
            }
        }
        if (kFactors) fold_partials(wk, exits_own, nv + fw, nv + sf, w0 + w_own);
        ++n_pub;
        last_pub = t;
        __syncthreads();  // the new rows are in g, st and pr (and every warp's keys in wk)
        if (kFactors) publish_partials(wk, part, p.n_blocks, n_pub & 1, t);
    }
}

// Mirrored by lnasr_tpu_torch/ops/factored.py:lattice_smem_bytes (capacity rule).
size_t smem_bytes(int V, int S, int wpb, int hop_kind, int n_blocks, int n_src) {
    if (hop_kind == HOP_RANK1 || hop_kind == HOP_BACKOFF)  // rows, inner blocks, exit indices, start, pred
        return factors_smem_bytes((size_t)wpb * S + (size_t)wpb * S * S + wpb + 2 * (size_t)wpb * S, wpb,
                                  hop_kind, n_blocks, n_src);
    size_t f = (size_t)wpb * S + (size_t)wpb * S * S + wpb + V;
    size_t bytes = f * sizeof(float) + (size_t)(2 * wpb + 2 * wpb * S) * sizeof(int);
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
                                       const uint8_t* mask, int T, int V, int S, int n_sm,
                                       const int* blk_ptr, const int* src_ptr, const int* src,
                                       const int* arc_lsrc, int n_blocks, int max_words, int max_src,
                                       float* exit_score, int* exit_start, int* exit_pred,
                                       unsigned long long* xch, void* stream) {
    if (T < 1) return (int)cudaErrorInvalidValue;
    Geometry geo;
    cudaError_t err = launch_geometry(hop_kind, V, S, n_sm, arc_ptr, blk_ptr, src_ptr, arc_lsrc, n_blocks,
                                      max_words, max_src, geo);
    if (err != cudaSuccess) return (int)err;
    const bool factors = hop_kind == HOP_RANK1 || hop_kind == HOP_BACKOFF;
    const void* kernel = factors ? (const void*)factored_lattice_kernel<true>
                                 : (const void*)factored_lattice_kernel<false>;
    Args a{pi_grid, inner_a, exit_idx, hop_t, from_w, uni, sil_from, arc_ptr, arc_dst, arc_src,
           arc_val, blk_ptr, src_ptr, src, arc_lsrc, log_b, mask, exit_score, exit_start, exit_pred,
           xch, hop_kind, sil_idx, T, V, S, geo.wpb, geo.blocks};
    return (int)launch_exchange(kernel, geo, smem_bytes(V, S, geo.wpb, hop_kind, geo.blocks, max_src),
                                exchange_slots(hop_kind, V, geo.blocks), xch, &a, stream);
}

extern "C" const char* factored_lattice_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
