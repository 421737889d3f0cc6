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
// The first design ordered the exchange with a cooperative grid barrier
// per frame (3.8 us: a block barrier, a device-wide fence that also waited
// for the block's grid rows, an atomic on one counter shared by 126
// blocks, a spin; then a second trip through L2 for the exits). This one
// has no barrier across blocks in its frame loop. Each word's exit travels
// with its frame's tag in one aligned 64-bit word, (tag << 32) | bits, that
// the exit cell's thread stores with st.relaxed.gpu; readers poll the V
// slots with ld.relaxed.gpu (all their slots loaded at once, one L2 round
// trip when the values are there) until every tag is the frame they need.
// A 64-bit access is single-copy atomic, so a matching tag brings its own
// value and nothing needs a fence or a counter; the grid rows' stores are
// never waited for (only kernel E reads them, after the kernel ends). Each
// block's own within-word step is computed before the poll, while the
// other blocks' exits are in flight.
//
// Tags and buffers. Frame 0 and every valid frame publish; a masked frame
// leaves the grid, so its exits are those of the last published frame and
// it publishes nothing (readers ask for the last published frame's tag).
// The k-th publication goes to buffer k & 1 of a (2, V) array. Two buffers
// are enough: a block publishes k + 1 (overwriting k - 1) only after
// reading every word's k, and each block publishes k only after reading
// all of k - 1, so nobody still reads k - 1. Stale tags: the launcher
// fills the exchange with tag 0xffffffff (cudaMemsetAsync on the kernel's
// stream, before it) on every launch, a tag no frame uses (T < 2^31), so a
// buffer that PyTorch's caching allocator hands back from an earlier
// launch is never taken as ready. The cooperative launch is kept: it
// guarantees that every block is resident, without which a spin could
// wait for a block that never runs. A spin that lasts seconds traps (a
// launch error, not a hung card).
//
// Hop kind "none" (loop-free graphs) has no exchange. The rank-1 hop reads
// the same exchange.
//
// The backoff hop (rank-1 plus the sparse seen-bigram arcs) reads the same
// exchange: the V exits of the previous frame are already in shared memory
// for the rank-1 max. Its arcs come in CSR by destination (the factors'
// finite (V, K) slots; the padding is -inf and changes no maximum), so a
// block's arcs are one contiguous range [arc_ptr[w0], arc_ptr[w0 + nw]).
// Each frame the block's threads walk that range flat (an arc a thread a
// round: no warp idles on a short row, as one per destination word would),
// add exit[src] + val from the shared column, and fold the sum into their
// destination's 32-bit key with a shared-memory atomicMax. The key is the
// float's order-preserving bit pattern, so the max is exact and the order
// of the atomics changes no bit. The arcs are read through the read-only
// data path each frame, not staged: at the 5k-word serving graph a block
// owns a few hundred arcs, which stay in L1. What this adds to a frame: one
// barrier-free pass over the block's arcs plus the barrier the rank-1
// block max already has.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HOP_NONE = 0;
constexpr int HOP_DENSE = 1;
constexpr int HOP_BACKOFF = 3;
constexpr int SMEM_LIMIT = 232448;  // a block's shared memory on sm_90
constexpr int MAX_THREADS = 1024;   // one thread per (word, state) cell of a block
constexpr int POLL = 4;             // exchange slots a thread loads at once
constexpr long long SPIN_LIMIT = 1ll << 24;  // polling rounds before the kernel traps

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
    const float* log_b;     // (T, V, S)
    const uint8_t* mask;    // (T,) or null
    float* grids;           // (T, V, S)
    unsigned long long* xch;  // (2, V) exchange: (frame tag << 32) | exit bits
    int hop_kind, sil_idx, T, V, S, wpb;
};

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

// A float's order-preserving 32-bit key (larger float, larger key) and back.
__device__ __forceinline__ unsigned key_of(float x) {
    const unsigned b = __float_as_uint(x);
    return (b & 0x80000000u) ? ~b : b | 0x80000000u;
}

__device__ __forceinline__ float float_of(unsigned k) {
    return __uint_as_float((k & 0x80000000u) ? k & 0x7fffffffu : ~k);
}

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

// The launch bounds hold registers to 64 per thread, so that a block of
// up to 1024 threads fits the SM's 64 K registers.
__global__ void __launch_bounds__(MAX_THREADS) factored_forward_kernel(Args p) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float red[32];

    const int V = p.V, S = p.S, T = p.T;
    const int w0 = blockIdx.x * p.wpb;
    const int nw = min(p.wpb, V - w0);  // >= 1: the launcher sizes the grid
    const int cells = nw * S;
    const int tid = threadIdx.x, nth = blockDim.x;
    const int hk = p.hop_kind;

    float* g = reinterpret_cast<float*>(smem);       // [wpb * S] this block's rows
    float* ia = g + p.wpb * S;                       // [wpb * S * S]
    float* ent = ia + p.wpb * S * S;                 // [wpb]
    float* ex = ent + p.wpb;                         // [V] exits of the last published frame
    int* eidx = reinterpret_cast<int*>(ex + V);      // [wpb]
    float* hs = reinterpret_cast<float*>(eidx + p.wpb);  // [wpb * V] hop columns (dense)
    unsigned* spk = reinterpret_cast<unsigned*>(eidx + p.wpb);  // [wpb] sparse maxima (backoff)
    // the block's arcs (backoff): one range, the CSR being by destination
    const int arc0 = hk == HOP_BACKOFF ? p.arc_ptr[w0] : 0;
    const int arc1 = hk == HOP_BACKOFF ? p.arc_ptr[w0 + nw] : 0;

    for (int k = tid; k < cells * S; k += nth) ia[k] = p.inner_a[(size_t)w0 * S * S + k];
    for (int k = tid; k < nw; k += nth) eidx[k] = p.exit_idx[w0 + k];
    if (hk == HOP_DENSE) {
        for (int k = tid; k < nw * V; k += nth) hs[k] = p.hop_t[(size_t)w0 * V + k];
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
    if (exits_own) st_relaxed(p.xch + w0 + w_own, tagged(0, g[k_own]));
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

        if (hk != HOP_NONE) {
            // the sparse keys' reset: every read of the last frame's is done
            if (hk == HOP_BACKOFF)
                for (int w = tid; w < nw; w += nth) spk[w] = key_of(-INFINITY);
            read_exits(p.xch + (n_pub & 1) * V, (unsigned)last_pub, V, ex);
            __syncthreads();
            if (hk == HOP_DENSE) {
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
            } else {
                float m1 = -INFINITY, m2 = -INFINITY;
                for (int v = tid; v < V; v += nth) {
                    m1 = fmaxf(m1, ex[v] + p.from_w[v]);
                    m2 = fmaxf(m2, ex[v] + p.sil_from[v]);
                }
                // backoff: each arc's exit[src] + val into its word's key
                // (the block max's barriers order the atomics before the reads)
                for (int k = arc0 + tid; k < arc1; k += nth)
                    atomicMax(spk + (__ldg(p.arc_dst + k) - w0),
                              key_of(ex[__ldg(p.arc_src + k)] + __ldg(p.arc_val + k)));
                m1 = block_max(m1, red);
                m2 = block_max(m2, red);
                for (int w = tid; w < nw; w += nth) {
                    float e = (w0 + w == p.sil_idx) ? m2 : m1 + p.uni[w0 + w];
                    if (hk == HOP_BACKOFF && w0 + w != p.sil_idx) e = fmaxf(e, float_of(spk[w]));
                    ent[w] = e;
                }
            }
            __syncthreads();  // also: every read of g is done
        } else {
            __syncthreads();  // every read of g is done
        }

        if (k_own >= 0) {
            if (hk != HOP_NONE && j_own == 0 && ent[w_own] > m) m = ent[w_own];
            const float nv = m + e;
            g[k_own] = nv;
            out[k_own] = nv;
            if (exits_own) st_relaxed(p.xch + ((n_pub + 1) & 1) * V + w0 + w_own, tagged(t, nv));
        }
        ++n_pub;
        last_pub = t;
        __syncthreads();  // the new rows are in g
    }
}

// Mirrored by lnasr_tpu_torch/ops/factored.py:forward_smem_bytes (capacity rule).
size_t smem_bytes(int V, int S, int wpb, int hop_kind) {
    size_t f = (size_t)wpb * S + (size_t)wpb * S * S + wpb + V;
    size_t bytes = f * sizeof(float) + (size_t)wpb * sizeof(int);
    if (hop_kind == HOP_DENSE) bytes += (size_t)wpb * V * sizeof(float);
    if (hop_kind == HOP_BACKOFF) bytes += (size_t)wpb * sizeof(unsigned);
    return bytes;
}

}  // namespace

extern "C" int factored_forward_launch(const float* pi_grid, const float* inner_a, const int* exit_idx,
                                       int hop_kind, const float* hop_t, const float* from_w,
                                       const float* uni, const float* sil_from, int sil_idx,
                                       const int* arc_ptr, const int* arc_dst, const int* arc_src,
                                       const float* arc_val, const float* log_b,
                                       const uint8_t* mask, int T, int V, int S, int n_sm,
                                       float* grids, unsigned long long* xch, void* stream) {
    if (T < 1 || V < 1 || S < 1 || n_sm < 1) return (int)cudaErrorInvalidValue;
    if (hop_kind < HOP_NONE || hop_kind > HOP_BACKOFF) return (int)cudaErrorInvalidValue;
    if (hop_kind == HOP_BACKOFF && arc_ptr == nullptr) return (int)cudaErrorInvalidValue;
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
    // tag 0xffffffff in every slot: no frame's (see the note on stale tags)
    err = cudaMemsetAsync(xch, 0xff, (size_t)2 * V * sizeof(unsigned long long),
                          (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    Args a{pi_grid, inner_a, exit_idx, hop_t, from_w, uni, sil_from, arc_ptr, arc_dst, arc_src,
           arc_val, log_b, mask, grids, xch, hop_kind, sil_idx, T, V, S, wpb};
    void* params[] = {&a};
    err = cudaLaunchCooperativeKernel((const void*)factored_forward_kernel, dim3(blocks), dim3(threads),
                                      params, smem, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

extern "C" const char* factored_forward_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
