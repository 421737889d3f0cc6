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
// smaller source, -0 and +0 tied with the lowest source's sign kept). Each
// warp takes the largest key of its cells by two redux.sync (fold_partials),
// and after the frame's closing barrier warp 0 takes the largest of the
// warps' keys and publishes both, each key as two tagged words,
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
// nothing else.
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

// ex[v] = the exit of word v tagged `tag`, from one buffer of the exchange.
// A thread's slots are polled together: every round reloads all its slots
// not yet tagged, so a round costs one L2 round trip however many of them
// were early.
__device__ void read_exits(const unsigned long long* src, unsigned tag, int V, float* ex) {
    const int tid = threadIdx.x, nth = blockDim.x;
    for (int base = tid; base < V; base += nth * POLL) {
        unsigned long long x[POLL];
        unsigned pending = 0;
#pragma unroll
        for (int q = 0; q < POLL; ++q) {
            const int v = base + q * nth;
            if (v < V) {
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
// partials `part[i]`, slots n_part + j the exit of the block's j-th source,
// `exits[srcs[j]]` (read_exits' polling over a gathered list).
__device__ void read_slots(const unsigned long long* part, int n_part,
                           const unsigned long long* exits, const int* srcs, int n_src,
                           unsigned tag, unsigned* got) {
    const int tid = threadIdx.x, nth = blockDim.x, n = n_part + n_src;
    for (int base = tid; base < n; base += nth * POLL) {
        const unsigned long long* at[POLL];
        unsigned long long x[POLL];
        unsigned pending = 0;
#pragma unroll
        for (int q = 0; q < POLL; ++q) {
            const int i = base + q * nth;
            if (i < n) {
                at[q] = i < n_part ? part + i : exits + srcs[i - n_part];
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
// polled slots `got` (n_part partial words, a block's four 16-byte
// aligned, then n_src source exits, padded to an even count), then the
// sparse family's 64-bit keys `spk` (backoff: wpb of them).
struct Polled {
    unsigned* got;
    unsigned long long* spk;
};

__device__ __forceinline__ Polled polled_layout(unsigned char* smem, int n_part, int n_src) {
    unsigned* got = reinterpret_cast<unsigned*>(smem);
    return {got, reinterpret_cast<unsigned long long*>(got + n_part + (n_src + 1) / 2 * 2)};
}

// Each warp's partial keys of its exit cells' rank-1 sums a1 = x + from_w
// and a2 = x + sil_from of word `word` (every thread of the block takes
// part; exit cells bring theirs, the rest nothing).
__device__ __forceinline__ void fold_partials(unsigned long long (*wk)[2], bool mine, float a1, float a2,
                                              int word) {
    const unsigned long long a = warp_max_key(mine ? key_of(a1, word) : 0ull);
    const unsigned long long c = warp_max_key(mine ? key_of(a2, word) : 0ull);
    if ((threadIdx.x & 31) == 0) {
        wk[threadIdx.x >> 5][0] = a;
        wk[threadIdx.x >> 5][1] = c;
    }
}

// Warp 0's publication of the block's partials of frame t into buffer `buf`
// of the partials' region `part`, after a barrier that follows every warp's
// keys; the next frame's keys are written only after that frame's poll
// barrier, which warp 0 reaches after this.
__device__ __forceinline__ void publish_partials(const unsigned long long (*wk)[2], unsigned long long* part,
                                                 int n_blocks, int buf, int t) {
    if (threadIdx.x >= 32) return;
    const int lane = threadIdx.x, nwarps = blockDim.x >> 5;
    const unsigned long long a = warp_max_key(lane < nwarps ? wk[lane][0] : 0ull);
    const unsigned long long c = warp_max_key(lane < nwarps ? wk[lane][1] : 0ull);
    if (lane == 0) {
        unsigned long long* dst = part + ((size_t)buf * n_blocks + blockIdx.x) * PART;
        const unsigned long long tag = (unsigned long long)(unsigned)t << 32;
        st_relaxed(dst, tag | (unsigned)(a >> 32));
        st_relaxed(dst + 1, tag | (unsigned)a);
        st_relaxed(dst + 2, tag | (unsigned)(c >> 32));
        st_relaxed(dst + 3, tag | (unsigned)c);
    }
}

// The rank-1 maxima, first step: a warp combines 32 blocks' polled keys, a
// lane a block (max is exact and order-free), into rk[its group].
__device__ __forceinline__ void combine_polled(const unsigned* got, int n_blocks, unsigned long long (*rk)[2]) {
    const int tid = threadIdx.x, nth = blockDim.x;
    for (int c = tid >> 5; c * 32 < n_blocks; c += nth >> 5) {
        const int b = c * 32 + (tid & 31);
        unsigned long long a = 0, d = 0;
        if (b < n_blocks) {
            const uint4 w = reinterpret_cast<const uint4*>(got)[b];  // PART == 4
            a = (unsigned long long)w.x << 32 | w.y;
            d = (unsigned long long)w.z << 32 | w.w;
        }
        a = warp_max_key(a);
        d = warp_max_key(d);
        if ((tid & 31) == 0) {
            rk[c][0] = a;
            rk[c][1] = d;
        }
    }
}

// Second step, after a barrier: the few groups' keys, m1's and m2's.
__device__ __forceinline__ void polled_max(const unsigned long long (*rk)[2], int n_blocks,
                                           unsigned long long& k1, unsigned long long& k2) {
    k1 = k2 = 0;
    for (int c = 0; c * 32 < n_blocks; ++c) {
        k1 = umax64(k1, rk[c][0]);
        k2 = umax64(k2, rk[c][1]);
    }
}

// Each of the block's arcs [arc0, arc1): (exit[src] + val, src) into its
// destination's key, exit[src] read from the polled sources `exs`.
__device__ __forceinline__ void fold_arcs(unsigned long long* spk, int w0, int arc0, int arc1,
                                          const int* arc_dst, const int* arc_lsrc, const float* arc_val,
                                          const int* arc_src, const float* exs) {
    for (int k = arc0 + threadIdx.x; k < arc1; k += blockDim.x)
        atomicMax(spk + (__ldg(arc_dst + k) - w0),
                  key_of(exs[__ldg(arc_lsrc + k)] + __ldg(arc_val + k), __ldg(arc_src + k)));
}

// -- host side --------------------------------------------------------------

// The factored kinds' shared memory of one block: the kernel's `row_words`
// 4-byte words, the polled slots and the source list, and 8 bytes a word
// of sparse keys (backoff). Mirrored by ops/factored.py:_factors_smem_bytes.
inline size_t factors_smem_bytes(size_t row_words, int wpb, int hop_kind, int n_blocks, int n_src) {
    const size_t words = row_words + (size_t)PART * n_blocks + (size_t)(n_src + 1) / 2 * 2 + n_src;
    return words * 4 + (hop_kind == HOP_BACKOFF ? (size_t)wpb * 8 : 0);
}

// A launch's words a block (wpb, the largest block's), blocks and threads
// (the largest block's cells rounded up to a warp, at least 256). The
// backoff kind takes its map (ops/factored.py:block_layout: blk_ptr,
// src_ptr, src, arc_lsrc, n_blocks, max_words, max_src); the others get
// ceil(V / n_sm) words a block, and their map operands are cleared.
struct Geometry {
    int wpb, blocks, threads;
};

inline cudaError_t launch_geometry(int hop_kind, int V, int S, int n_sm, const int* arc_ptr,
                                   const int*& blk_ptr, const int* src_ptr, const int* arc_lsrc,
                                   int n_blocks, int max_words, int& max_src, Geometry& g) {
    if (V < 1 || S < 1 || n_sm < 1) return cudaErrorInvalidValue;
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
    return cudaSuccess;
}

// The exchange's 64-bit slots: (2, V) exits (dense, backoff; also, unused,
// for no hop), then (2, blocks, PART) partials (rank-1, backoff). Mirrored
// by ops/factored.py:exchange_slots.
inline size_t exchange_slots(int hop_kind, int V, int blocks) {
    const bool factors = hop_kind == HOP_RANK1 || hop_kind == HOP_BACKOFF;
    return (hop_kind == HOP_RANK1 ? 0 : (size_t)2 * V) + (factors ? (size_t)2 * blocks * PART : 0);
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
