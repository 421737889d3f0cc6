// The exit exchange of kernels D (factored_forward.cu) and F
// (factored_lattice.cu), and the helpers both take it from: one copy of its
// data format, its publication order and its launch geometry.
//
// A block owns a contiguous range of destination words and keeps their
// rows in shared memory for the whole utterance; the one thing it needs
// from the other blocks each frame is what their words' exits of the
// previous frame contribute to its entries. There is no barrier across
// blocks in the frame loop. Each published value travels with its frame's
// tag in one aligned 64-bit word, (tag << 32) | 32 bits, stored with
// st.relaxed.gpu; readers poll their slots with ld.relaxed.gpu (all of a
// thread's slots loaded at once, one L2 round trip when the values are
// there) until every tag is the frame they need. A 64-bit access is
// single-copy atomic, so a matching tag brings its own value and nothing
// needs a fence or a counter.
//
// Tags and buffers. Frame 0 and every valid frame publish; a masked frame
// leaves the grid, so its exits are those of the last published frame and
// it publishes nothing (readers ask for the last published frame's tag).
// The k-th publication goes to buffer k & 1. Stale tags: the launcher
// fills the exchange with tag 0xffffffff (cudaMemsetAsync on the kernel's
// stream, before it; exchange_slots) on every launch, a tag no frame uses
// (T < 2^31), so a buffer that PyTorch's caching allocator hands back from
// an earlier launch is never taken as ready. The cooperative launch
// guarantees that every block is resident, without which a spin could
// wait for a block that never runs. A spin that lasts SPIN_LIMIT rounds
// traps (a launch error, not a hung card).
//
// Dense hop: a (2, V) region of exits, one word's exit a slot, stored by
// its exit cell's thread; every block polls all V (read_exits). No hop: no
// exchange.
//
// Rank-1 and backoff hops (the factored kinds): the rank-1 family needs
// two numbers a frame, m1 = max_v exit[v] + from_w[v] and m2 = max_v
// exit[v] + sil_from[v], with (for F) their lowest achieving source. Each
// block folds its own exit cells into two partials, the same adds, each
// into a 64-bit (value, source) key (key_of: the larger value, then the
// smaller source, -0 and +0 tied with the lowest source's sign kept): each
// exit cell's thread writes its word's two keys to a slot of its own, and
// after the frame's closing barrier a warp takes their maximum by two
// redux.sync and publishes both, each key as two tagged words,
// (tag << 32) | its high half and (tag << 32) | its low half, in a
// (2, n_blocks, PART) region (publish_partials). A tag, a value and a
// source do not fit one single-copy-atomic word; a reader takes a pair once
// both tags are the frame it asks for, and a tag names one frame, so both
// halves are one publication's. (Not taken: a 16-bit tag packed with the
// value and a 16-bit source, which would cap T and V at 65,536, or one
// 128-bit access, whose single-copy atomicity on sm_90 the PTX memory model
// was not checked for.) A reader polls the PART * n_blocks partial words
// (read_slots), a warp combines 32 blocks' keys (combine_polled) and, after
// the barrier that the arc pass needs anyway, each word's state-0 thread
// takes the largest of those few (polled_max). Max is exact and order-free
// and the blocks own contiguous words, so the combined key is the plain
// torch.max's first argmax and its value's bits. The rank-1 kind publishes
// nothing else. (One utterance's regions are shown; a batch's follow.)
//
// The backoff kind also publishes every word's exit in a (2, V) region in
// front of the partials, but a block polls only the distinct sources of its
// own arcs, a CSR built on the host once per graph (ops/factored.py:
// block_sources), ascending so that neighbouring slots share lines, read
// into shared memory beside the partials; arc_lsrc gives each arc's source
// as an index into its block's list. The arcs come in CSR by destination
// and a block owns a contiguous range of words, so its arcs are one range.
// The ranges are cut on the host by arcs (ops/factored.py:block_map, passed
// as blk_ptr): at most n_sm blocks, at most MAX_THREADS / S words a block,
// none with more than the largest row plus an even share of the arcs.
// Each frame a block's threads walk its arcs flat (an arc a thread a
// round) and fold exit[src] + val into their destination's (value,
// source) key with a shared-memory atomicMax (fold_arcs).
//
// Batch. A launch decodes B utterances of one graph (B <= MAX_BATCH): block
// k owns the same words for all of them, loads their hop columns, inner
// blocks and exit indices once, and keeps a grid row per utterance. Every
// slot above is per utterance ((2, B, V) exits, (2, B, n_blocks, PART)
// partials), so one exchange round a frame carries all B utterances'
// exits or partials, and no key of one utterance is compared with
// another's. The frames run in lockstep: frame t is live when any
// utterance is valid at it (bit b of frame_bits). A live frame publishes
// every utterance with tag t, an utterance masked at t its unchanged exits
// and partials (its grid carries over), so every reader asks for one tag,
// the last live frame's, for all utterances; a frame no utterance takes
// publishes nothing. Each publication is as for one utterance, so the
// order argument below holds utterance by utterance. A thread keeps one
// cell of the block for the launch and steps it for utterances u, u + L,
// ... (cell_lanes: L = threads / cells), so no frame divides by a run-time
// value; a warp an utterance publishes the block's partials
// (publish_partials), and a warp an (utterance, 32 blocks) combines the
// polled ones (combine_polled).
//
// Publication order. A block publishes k + 1 (overwriting k - 1) only after
// its poll of k has seen everything it reads of k, and it reads k only
// after its closing barrier of k - 1's frame, which follows all its reads
// of k - 1. Dense hop: every block reads every word's exit of k before it
// publishes k + 1, so nobody still reads k - 1. Factored kinds: every block
// reads every block's partials of k before it publishes k + 1, so the same
// argument holds with "every block's partials" in place of "every word's
// exit", and it covers the backoff kind's per-word exits too, of which a
// block reads only some. Frame 0's partials are published once every exit
// thread has folded its exit in.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HOP_NONE = 0;
constexpr int HOP_DENSE = 1;
constexpr int HOP_RANK1 = 2;
constexpr int HOP_BACKOFF = 3;
constexpr int PART = 4;             // partial words a block publishes a frame: m1's key, m2's
constexpr int BIG = 0x7fffffff;     // no source
constexpr int SMEM_LIMIT = 232448;  // a block's shared memory on sm_90
constexpr int MAX_THREADS = 1024;   // one thread per (word, state) cell of a block
constexpr int MAX_BLOCKS = 1024;    // the factored kinds' blocks: 32 warps' combines of 32 blocks
constexpr int MAX_BATCH = 64;       // a launch's utterances: a frame's valid flags are one 64-bit word
constexpr int POLL = 4;             // exchange slots a thread loads at once
constexpr long long SPIN_LIMIT = 1ll << 24;  // polling rounds before the kernel traps

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
    unsigned long long x;
    asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(x) : "l"(p) : "memory");
    return x;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long x) {
    asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(x) : "memory");
}

__device__ __forceinline__ unsigned long long tagged(int t, float x) {
    return ((unsigned long long)(unsigned)t << 32) | __float_as_uint(x);
}

// A 4-byte copy from device memory into shared memory that does not stall
// the thread (cp.async, sm_80 on): a frame's emissions are in flight while
// the block waits for the exchange; cp_async_wait waits for the thread's
// own copies.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_all;" ::: "memory");
}

// The valid flags of frame t, bit b for utterance b: mask (B, T), or null
// (every frame valid).
__device__ __forceinline__ unsigned long long frame_bits(const uint8_t* mask, int B, int T, int t) {
    if (mask == nullptr) return B >= 64 ? ~0ull : (1ull << B) - 1;
    unsigned long long bits = 0;
    for (int b = 0; b < B; ++b)
        if (mask[(size_t)b * T + t]) bits |= 1ull << b;
    return bits;
}

// A (value, source) pair as one 64-bit key, larger for a larger value
// and, between equal values, for the smaller source: the first argmax of
// torch.max over the sources in order, in any order of the atomics. The
// high half is the value's order-preserving pattern with -0 taken as +0
// (the two zeros tie, as they do for torch.max); the low half is the
// complemented source over a bit that marks -0, so that the value comes
// back with the sign its (lowest) source gave it.
__device__ __forceinline__ unsigned long long key_of(float x, int src) {
    const unsigned b = __float_as_uint(x + 0.0f);  // -0 + 0 = +0
    const unsigned k = (b & 0x80000000u) ? ~b : b | 0x80000000u;
    const unsigned neg0 = __float_as_uint(x) == 0x80000000u;
    return ((unsigned long long)k << 32) | ((unsigned)~src << 1) | neg0;
}

__device__ __forceinline__ float value_of(unsigned long long key) {
    if (key & 1) return -0.0f;
    const unsigned k = (unsigned)(key >> 32);
    return __uint_as_float((k & 0x80000000u) ? k & 0x7fffffffu : ~k);
}

__device__ __forceinline__ int source_of(unsigned long long key) {
    return (int)~(((unsigned)key >> 1) | 0x80000000u);
}

__device__ __forceinline__ unsigned long long umax64(unsigned long long a, unsigned long long b) {
    return a > b ? a : b;
}

// The largest 64-bit key over the warp's 32 lanes (all take part): the
// largest high half, then the largest low half among the lanes that hold
// it, by two redux.sync (sm_80 on) instead of five rounds of shuffles.
__device__ __forceinline__ unsigned long long warp_max_key(unsigned long long k) {
    const unsigned hi = __reduce_max_sync(0xffffffffu, (unsigned)(k >> 32));
    const unsigned lo = __reduce_max_sync(0xffffffffu, (unsigned)(k >> 32) == hi ? (unsigned)k : 0u);
    return ((unsigned long long)hi << 32) | lo;
}

// ex[i] = slot i of `src` tagged `tag`, for i < n (the B V exits of one
// buffer of the exchange). A thread's slots are polled together: every
// round reloads all its slots not yet tagged, so a round costs one L2
// round trip however many of them were early.
__device__ __forceinline__ void read_exits(const unsigned long long* src, unsigned tag, int n, float* ex) {
    const int tid = threadIdx.x, nth = blockDim.x;
    for (int base = tid; base < n; base += nth * POLL) {
        unsigned long long x[POLL];
        unsigned pending = 0;
#pragma unroll
        for (int q = 0; q < POLL; ++q) {
            const int v = base + q * nth;
            if (v < n) {
                x[q] = ld_relaxed(src + v);
                pending |= 1u << q;
            }
        }
        for (long long round = 0; pending; ++round) {
            if (round > SPIN_LIMIT) __trap();
#pragma unroll
            for (int q = 0; q < POLL; ++q) {
                if ((pending >> q & 1) && (unsigned)(x[q] >> 32) == tag) {
                    ex[base + q * nth] = __uint_as_float((unsigned)x[q]);
                    pending &= ~(1u << q);
                }
            }
#pragma unroll
            for (int q = 0; q < POLL; ++q)
                if (pending >> q & 1) x[q] = ld_relaxed(src + base + q * nth);
        }
    }
}

// got[i] = the low 32 bits of slot i tagged `tag`: slots [0, n_part) are the
// partials `part[i]` (every utterance's, (B, n_blocks, PART)), slot
// n_part + b n_src + j utterance b's exit of the block's j-th source,
// `exits[b V + srcs[j]]` (read_exits' polling over a gathered list).
__device__ __forceinline__ void read_slots(const unsigned long long* part, int n_part,
                           const unsigned long long* exits, const int* srcs, int n_src, int B, int V,
                           unsigned tag, unsigned* got) {
    const int tid = threadIdx.x, nth = blockDim.x, n = n_part + B * n_src;
    for (int base = tid; base < n; base += nth * POLL) {
        const unsigned long long* at[POLL];
        unsigned long long x[POLL];
        unsigned pending = 0;
#pragma unroll
        for (int q = 0; q < POLL; ++q) {
            const int i = base + q * nth;
            if (i < n) {
                if (i < n_part) {
                    at[q] = part + i;
                } else {
                    const int k = i - n_part, b = B == 1 ? 0 : k / n_src;
                    at[q] = exits + (size_t)b * V + srcs[k - b * n_src];
                }
                x[q] = ld_relaxed(at[q]);
                pending |= 1u << q;
            }
        }
        for (long long round = 0; pending; ++round) {
            if (round > SPIN_LIMIT) __trap();
#pragma unroll
            for (int q = 0; q < POLL; ++q) {
                if ((pending >> q & 1) && (unsigned)(x[q] >> 32) == tag) {
                    got[base + q * nth] = (unsigned)x[q];
                    pending &= ~(1u << q);
                }
            }
#pragma unroll
            for (int q = 0; q < POLL; ++q)
                if (pending >> q & 1) x[q] = ld_relaxed(at[q]);
        }
    }
}

// A block's words [w0, w0 + nw) (>= 1: the launcher sizes the grid, the map
// has no empty block), its arcs [arc0, arc1) and its distinct sources
// src[src0, src0 + n_src) (backoff): the map's ranges for the backoff kind,
// wpb words a block for the others.
struct BlockRange {
    int w0, nw, arc0, arc1, src0, n_src;
};

template <bool kFactors, class Args>
__device__ __forceinline__ BlockRange block_range(const Args& p) {
    BlockRange r;
    r.w0 = kFactors && p.blk_ptr ? p.blk_ptr[blockIdx.x] : blockIdx.x * p.wpb;
    r.nw = kFactors && p.blk_ptr ? p.blk_ptr[blockIdx.x + 1] - r.w0 : min(p.wpb, p.V - r.w0);
    const bool arcs = p.hop_kind == HOP_BACKOFF;
    r.arc0 = arcs ? p.arc_ptr[r.w0] : 0;
    r.arc1 = arcs ? p.arc_ptr[r.w0 + r.nw] : 0;
    r.src0 = arcs ? p.src_ptr[blockIdx.x] : 0;
    r.n_src = arcs ? p.src_ptr[blockIdx.x + 1] - r.src0 : 0;
    return r;
}

// The factored kinds' shared memory in front of the kernel's rows: the
// polled slots `got` (n_part partial words, every utterance's, a block's
// four 16-byte aligned, then the utterances' source exits, n_src_all of
// them, padded to an even count), then the 64-bit keys: the sparse
// family's `spk` (backoff: an (utterance, word) each), the words' exit
// keys `xk` (m1's and m2's an (utterance, word): B wpb pairs) and the
// polled keys combined 32 blocks a group, `rk` (m1's and m2's an
// (utterance, group)).
struct Polled {
    unsigned* got;
    unsigned long long* spk;
    unsigned long long* xk;
    unsigned long long* rk;
    unsigned long long* end;
};

__device__ __forceinline__ Polled polled_layout(unsigned char* smem, int n_part, int n_src_all, int n_spk,
                                                int B, int wpb, int groups) {
    Polled q;
    q.got = reinterpret_cast<unsigned*>(smem);
    q.spk = reinterpret_cast<unsigned long long*>(q.got + n_part + (n_src_all + 1) / 2 * 2);
    q.xk = q.spk + n_spk;
    q.rk = q.xk + 2 * B * wpb;
    q.end = q.rk + 2 * B * groups;
    return q;
}

// A thread's cell and utterances for the launch: cell k of utterances b0,
// b0 + step, ... (threads past `step` utterance slots of `cells` cells get
// none: b0 = B). Computed once, so the frame loop divides nothing.
struct CellLanes {
    int k, b0, step;
};

__device__ __forceinline__ CellLanes cell_lanes(int cells, int B) {
    CellLanes c;
    c.step = blockDim.x / cells;  // >= 1: the launch has at least a thread a cell
    const int u = threadIdx.x / cells;
    c.k = threadIdx.x - u * cells;
    c.b0 = u < c.step ? u : B;
    return c;
}

// The block's partials of frame t, a warp an utterance b: the largest of
// its words' exit keys xk[2 (b wpb + w) + 0 / 1], w < nw (each written by
// its word's exit thread), by two redux.sync a key, published by lane 0
// into buffer `buf` of the partials' region `part` ((2, B, n_blocks,
// PART)), after a barrier that follows every exit thread's keys; the
// next frame's keys are written only after that frame's poll barrier,
// which each warp reaches after this.
__device__ __forceinline__ void publish_partials(const unsigned long long* xk, int wpb, int nw,
                                                 unsigned long long* part, int B, int n_blocks, int buf,
                                                 int t) {
    const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
    const unsigned long long tag = (unsigned long long)(unsigned)t << 32;
    for (int b = threadIdx.x >> 5; b < B; b += nwarps) {
        unsigned long long a = 0, c = 0;
#pragma unroll 1  // one pass a 32 words: this warp's wait is every block's
        for (int w = lane; w < nw; w += 32) {
            a = umax64(a, xk[2 * (b * wpb + w)]);
            c = umax64(c, xk[2 * (b * wpb + w) + 1]);
        }
        a = warp_max_key(a);
        c = warp_max_key(c);
        if (lane == 0) {
            unsigned long long* dst = part + (((size_t)buf * B + b) * n_blocks + blockIdx.x) * PART;
            st_relaxed(dst, tag | (unsigned)(a >> 32));
            st_relaxed(dst + 1, tag | (unsigned)a);
            st_relaxed(dst + 2, tag | (unsigned)(c >> 32));
            st_relaxed(dst + 3, tag | (unsigned)c);
        }
    }
}

// The rank-1 maxima, first step: a warp combines 32 blocks' polled keys of
// one utterance, a lane a block (max is exact and order-free), into
// rk[2 (b groups + c) + 0 / 1] for group c of utterance b.
__device__ __forceinline__ void combine_polled(const unsigned* got, int n_blocks, int B, unsigned long long* rk) {
    const int lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
    const int groups = (n_blocks + 31) >> 5;
    for (int q = threadIdx.x >> 5; q < B * groups; q += nwarps) {
        const int b = B == 1 ? 0 : q / groups, blk = (q - b * groups) * 32 + lane;
        unsigned long long a = 0, d = 0;
        if (blk < n_blocks) {
            const uint4 w = reinterpret_cast<const uint4*>(got)[(size_t)b * n_blocks + blk];  // PART == 4
            a = (unsigned long long)w.x << 32 | w.y;
            d = (unsigned long long)w.z << 32 | w.w;
        }
        a = warp_max_key(a);
        d = warp_max_key(d);
        if (lane == 0) {
            rk[2 * q] = a;
            rk[2 * q + 1] = d;
        }
    }
}

// Second step, after a barrier: the few groups' keys of one utterance
// (rk of that utterance), m1's and m2's.
__device__ __forceinline__ void polled_max(const unsigned long long* rk, int groups, unsigned long long& k1,
                                           unsigned long long& k2) {
    k1 = k2 = 0;
#pragma unroll 1  // a few groups; unrolled, it crowds the frame loop's registers
    for (int c = 0; c < groups; ++c) {
        k1 = umax64(k1, rk[2 * c]);
        k2 = umax64(k2, rk[2 * c + 1]);
    }
}

// A thread's arcs of the block's n_arcs: arc a of utterances b0, b0 +
// step, ... and, where the block has more arcs than threads, every `astep`
// arcs past a; threads with none get b0 = B. One utterance's (kBatch
// false) are the threads' strided walk over the arcs, with no division.
struct ArcLanes {
    int a, astep, b0, step;
};

template <bool kBatch>
__device__ __forceinline__ ArcLanes arc_lanes(int n_arcs, int B) {
    ArcLanes l;
    const int nth = blockDim.x;
    if (!kBatch || n_arcs > nth || n_arcs < 1) {
        l = {(int)threadIdx.x, nth, n_arcs > 0 ? 0 : B, 1};
    } else {
        const int u = threadIdx.x / n_arcs;
        l = {(int)threadIdx.x - u * n_arcs, n_arcs, u < nth / n_arcs ? u : B, nth / n_arcs};
    }
    return l;
}

// The block's arcs [arc0, arc0 + n_arcs) for each utterance b live at the
// frame, by the thread's lanes: (exit[src] + val, src) into its
// destination's key spk[b nw + w - w0], exit[src] from utterance b's
// polled sources exs[b n_src ...].
__device__ __forceinline__ void fold_arcs(unsigned long long* spk, int nw, int w0, int arc0, int n_arcs,
                                          const ArcLanes& l, int B, unsigned long long live,
                                          const int* arc_dst, const int* arc_lsrc, const float* arc_val,
                                          const int* arc_src, const float* exs, int n_src) {
    for (int b = l.b0; b < B; b += l.step) {
        if (!(live >> b & 1)) continue;
        for (int a = arc0 + l.a; a < arc0 + n_arcs; a += l.astep)
            atomicMax(spk + (size_t)b * nw + (__ldg(arc_dst + a) - w0),
                      key_of(exs[(size_t)b * n_src + __ldg(arc_lsrc + a)] + __ldg(arc_val + a),
                             __ldg(arc_src + a)));
    }
}

// -- host side --------------------------------------------------------------

// The factored kinds' shared memory of one block for B utterances: the
// kernel's `row_words` 4-byte words, the polled slots and the source list,
// and the 64-bit keys (polled_layout). Mirrored by
// ops/factored.py:_factors_smem_bytes.
inline size_t factors_smem_bytes(size_t row_words, int wpb, int hop_kind, int n_blocks, int n_src, int B) {
    const size_t groups = ((size_t)n_blocks + 31) / 32;
    const size_t words = row_words + (size_t)B * PART * n_blocks + ((size_t)B * n_src + 1) / 2 * 2 + n_src;
    const size_t keys = (hop_kind == HOP_BACKOFF ? (size_t)B * wpb : 0) + 2 * (size_t)B * wpb +
                        2 * (size_t)B * groups;
    return words * 4 + keys * 8;
}

// A launch's words a block (wpb, the largest block's), blocks and threads:
// one utterance's the largest block's cells rounded up to a warp, at least
// 256; a batch the most (its polls, reductions and steps are B times one
// utterance's, over the same blocks). The backoff kind takes its map
// (ops/factored.py:block_layout: blk_ptr, src_ptr, src, arc_lsrc,
// n_blocks, max_words, max_src); the others get ceil(V / n_sm) words a
// block, and their map operands are cleared.
struct Geometry {
    int wpb, blocks, threads;
};

inline cudaError_t launch_geometry(int hop_kind, int B, int V, int S, int n_sm, const int* arc_ptr,
                                   const int*& blk_ptr, const int* src_ptr, const int* arc_lsrc,
                                   int n_blocks, int max_words, int& max_src, Geometry& g) {
    if (B < 1 || B > MAX_BATCH || V < 1 || S < 1 || n_sm < 1) return cudaErrorInvalidValue;
    if (hop_kind < HOP_NONE || hop_kind > HOP_BACKOFF) return cudaErrorInvalidValue;
    if (hop_kind == HOP_BACKOFF) {
        if (arc_ptr == nullptr || blk_ptr == nullptr || src_ptr == nullptr || arc_lsrc == nullptr ||
            n_blocks < 1 || n_blocks > n_sm || n_blocks > MAX_BLOCKS || max_words < 1 || max_src < 0)
            return cudaErrorInvalidValue;
        g.wpb = max_words;
        g.blocks = n_blocks;
    } else {
        g.wpb = (V + n_sm - 1) / n_sm;
        g.blocks = (V + g.wpb - 1) / g.wpb;
        blk_ptr = nullptr;
        max_src = 0;
        if (hop_kind == HOP_RANK1 && g.blocks > MAX_BLOCKS) return cudaErrorInvalidValue;
    }
    if (g.wpb * S > MAX_THREADS) return cudaErrorInvalidValue;
    g.threads = ((g.wpb * S + 31) / 32) * 32;
    if (g.threads < 256) g.threads = 256;
    if (B > 1) g.threads = MAX_THREADS;
    return cudaSuccess;
}

// The exchange's 64-bit slots for B utterances: (2, B, V) exits (dense,
// backoff; also, unused, for no hop), then (2, B, blocks, PART) partials
// (rank-1, backoff). Mirrored by ops/factored.py:exchange_slots.
inline size_t exchange_slots(int hop_kind, int B, int V, int blocks) {
    const bool factors = hop_kind == HOP_RANK1 || hop_kind == HOP_BACKOFF;
    return (size_t)B * ((hop_kind == HOP_RANK1 ? 0 : (size_t)2 * V) + (factors ? (size_t)2 * blocks * PART : 0));
}

// The launch: shared memory opted in, the exchange filled with tag
// 0xffffffff (no frame's), then the cooperative kernel.
inline cudaError_t launch_exchange(const void* kernel, const Geometry& g, size_t smem, size_t slots,
                                   unsigned long long* xch, void* args, void* stream) {
    if (smem + 1024 > (size_t)SMEM_LIMIT) return cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    err = cudaMemsetAsync(xch, 0xff, slots * sizeof(unsigned long long), (cudaStream_t)stream);
    if (err != cudaSuccess) return err;
    void* params[] = {args};
    err = cudaLaunchCooperativeKernel(kernel, dim3(g.blocks), dim3(g.threads), params, smem,
                                      (cudaStream_t)stream);
    if (err != cudaSuccess) return err;
    return cudaGetLastError();
}

}  // namespace
