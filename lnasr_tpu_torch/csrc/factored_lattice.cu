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
// The exchange is now kernel D's (factored_forward.cu explains why it is
// safe): each word's exit travels with its frame's tag in one aligned
// 64-bit word, (tag << 32) | bits, stored by the exit cell's thread with
// st.relaxed.gpu; readers poll all their slots at once with ld.relaxed.gpu
// until every tag is the frame they need. There is no fence, counter or
// cross-block barrier anywhere in the kernel. Frame 0 and every valid
// frame publish, the k-th publication into buffer k & 1; a masked frame
// publishes nothing (its exits are the last published frame's) but still
// writes its three records, repeating the carried state. The launcher
// fills the int64 exchange with tag 0xffffffff before every launch, a spin
// that lasts SPIN_LIMIT rounds traps, and the launch stays cooperative so
// that every block is resident. The block's own within-word step (max,
// first argmax, carried start and pred) is computed before the poll, while
// the other blocks' exits are in flight; only state 0 compares with the
// entry after it. The dense-hop reduction carries four (value, index)
// pairs a lane over interleaved strides, so four sources' loads are in
// flight, merged (and then across the warp) by the larger value and, on a
// tie, the smaller index, so the lowest source still wins exact ties.
// What bounds it now is what bounds D: the exchange's latency per frame
// (a store's trip to L2 and the poll's round trip) plus the block's hop
// reduction, T times over.
//
// The backoff kind also replaces lnasr_tpu/models/decoder.py:765
// factored_lattice_scan with HopFactors (jitted at :1162), a lax.scan XLA
// ran as one device program. Its sparse arcs come in CSR by destination and
// are walked as in factored_forward.cu: the block's arcs flat over its
// threads, each sum folded into its destination's key with a shared-memory
// atomicMax. Here the key is 64 bits, the float's order-preserving pattern
// above the complemented source, so the largest value wins and, on a tie,
// the smallest source: the first argmax of the rows sorted by source, in
// any order of the atomics.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int HOP_NONE = 0;
constexpr int HOP_DENSE = 1;
constexpr int HOP_BACKOFF = 3;
constexpr int BIG = 0x7fffffff;     // no source
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
    float* exit_score;      // (T, V)
    int* exit_start;        // (T, V)
    int* exit_pred;         // (T, V)
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

// A (value, source) pair as one 64-bit key: a larger value, or an equal
// value and a smaller source, is a larger key.
__device__ __forceinline__ unsigned long long key_of(float x, int src) {
    const unsigned b = __float_as_uint(x);
    const unsigned k = (b & 0x80000000u) ? ~b : b | 0x80000000u;
    return ((unsigned long long)k << 32) | (unsigned)~src;
}

__device__ __forceinline__ float value_of(unsigned long long key) {
    const unsigned k = (unsigned)(key >> 32);
    return __uint_as_float((k & 0x80000000u) ? k & 0x7fffffffu : ~k);
}

__device__ __forceinline__ int source_of(unsigned long long key) { return (int)~(unsigned)key; }

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

// ex[v] = the exit of word v tagged `tag`, from one buffer of the exchange
// (factored_forward.cu:read_exits): every round reloads all of a thread's
// slots not yet tagged, so a round costs one L2 round trip.
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
__global__ void __launch_bounds__(MAX_THREADS) factored_lattice_kernel(Args p) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float redv[32];
    __shared__ int redi[32];

    const int V = p.V, S = p.S, T = p.T;
    const int w0 = blockIdx.x * p.wpb;
    const int nw = min(p.wpb, V - w0);  // >= 1: the launcher sizes the grid
    const int cells = nw * S;
    const int tid = threadIdx.x, nth = blockDim.x;
    const int hk = p.hop_kind;

    // [wpb] the sparse family's (value, source) keys (backoff), first: 8-byte aligned
    unsigned long long* spk = reinterpret_cast<unsigned long long*>(smem);
    float* g = reinterpret_cast<float*>(smem + (hk == HOP_BACKOFF ? 8 * p.wpb : 0));
    // [wpb * S] this block's rows
    float* ia = g + p.wpb * S;                       // [wpb * S * S]
    float* ent = ia + p.wpb * S * S;                 // [wpb]
    float* ex = ent + p.wpb;                         // [V] exits of the last published frame
    int* eidx = reinterpret_cast<int*>(ex + V);      // [wpb]
    int* esrc = eidx + p.wpb;                        // [wpb] hop source of each word
    int* st = esrc + p.wpb;                          // [wpb * S] token start frames
    int* pr = st + p.wpb * S;                        // [wpb * S] token predecessor words
    float* hs = reinterpret_cast<float*>(pr + p.wpb * S);  // [wpb * V] hop columns (dense)
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
        g[k_own] = p.pi_grid[row0 + k_own] + p.log_b[row0 + k_own];
        st[k_own] = 0;
        pr[k_own] = -1;
    }
    __syncthreads();
    // the exit cell's thread writes its word's records at every frame,
    // masked ones included, and publishes its exit at frame 0 and every
    // valid frame; it reads back only its own cell, so no barrier orders it
    const bool exits_own = k_own >= 0 && j_own == eidx[w_own];
    if (exits_own) {
        p.exit_score[w0 + w_own] = g[k_own];
        p.exit_start[w0 + w_own] = 0;
        p.exit_pred[w0 + w_own] = -1;
        if (hk != HOP_NONE) st_relaxed(p.xch + w0 + w_own, tagged(0, g[k_own]));
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

        if (hk != HOP_NONE) {
            // the sparse keys' reset: every read of the last frame's is done
            if (hk == HOP_BACKOFF)
                for (int w = tid; w < nw; w += nth) spk[w] = key_of(-INFINITY, BIG);
            read_exits(p.xch + (n_pub & 1) * V, (unsigned)last_pub, V, ex);
            __syncthreads();
            if (hk == HOP_DENSE) {
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
                // backoff: each arc's (exit[src] + val, src) into its word's
                // key (the block argmax's barriers order the atomics before
                // the reads)
                for (int k = arc0 + tid; k < arc1; k += nth) {
                    const int src = __ldg(p.arc_src + k);
                    atomicMax(spk + (__ldg(p.arc_dst + k) - w0),
                              key_of(ex[src] + __ldg(p.arc_val + k), src));
                }
                block_argmax(m1, a1, redv, redi);
                block_argmax(m2, a2, redv, redi);
                for (int w = tid; w < nw; w += nth) {
                    const bool sil = w0 + w == p.sil_idx;
                    float e = sil ? m2 : m1 + p.uni[w0 + w];
                    int s = sil ? a2 : a1;
                    if (hk == HOP_BACKOFF && !sil) {
                        const float sp = value_of(spk[w]), r1 = e;
                        e = fmaxf(r1, sp);
                        s = min(r1 >= e ? a1 : BIG, sp >= e ? source_of(spk[w]) : BIG);
                    }
                    ent[w] = e;
                    esrc[w] = s;
                }
            }
            __syncthreads();  // also: every read of g, st and pr is done
        } else {
            __syncthreads();  // every read of g, st and pr is done
        }

        if (k_own >= 0) {
            if (hk != HOP_NONE && j_own == 0 && ent[w_own] > m) {
                m = ent[w_own];
                nst = t;
                npr = esrc[w_own];
            }
            const float nv = m + e;
            g[k_own] = nv;
            st[k_own] = nst;
            pr[k_own] = npr;
            if (exits_own) {
                if (hk != HOP_NONE)
                    st_relaxed(p.xch + ((n_pub + 1) & 1) * V + w0 + w_own, tagged(t, nv));
                p.exit_score[rec + w_own] = nv;
                p.exit_start[rec + w_own] = nst;
                p.exit_pred[rec + w_own] = npr;
            }
        }
        ++n_pub;
        last_pub = t;
        __syncthreads();  // the new rows are in g, st and pr
    }
}

// Mirrored by lnasr_tpu_torch/ops/factored.py:lattice_smem_bytes (capacity rule).
size_t smem_bytes(int V, int S, int wpb, int hop_kind) {
    size_t f = (size_t)wpb * S + (size_t)wpb * S * S + wpb + V;
    size_t bytes = f * sizeof(float) + (size_t)(2 * wpb + 2 * wpb * S) * sizeof(int);
    if (hop_kind == HOP_DENSE) bytes += (size_t)wpb * V * sizeof(float);
    if (hop_kind == HOP_BACKOFF) bytes += (size_t)wpb * sizeof(unsigned long long);
    return bytes;
}

}  // namespace

extern "C" int factored_lattice_launch(const float* pi_grid, const float* inner_a, const int* exit_idx,
                                       int hop_kind, const float* hop_t, const float* from_w,
                                       const float* uni, const float* sil_from, int sil_idx,
                                       const int* arc_ptr, const int* arc_dst, const int* arc_src,
                                       const float* arc_val, const float* log_b,
                                       const uint8_t* mask, int T, int V, int S, int n_sm,
                                       float* exit_score, int* exit_start, int* exit_pred,
                                       unsigned long long* xch, void* stream) {
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
    cudaError_t err = cudaFuncSetAttribute(factored_lattice_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    // tag 0xffffffff in every slot: no frame's (factored_forward.cu, stale tags)
    err = cudaMemsetAsync(xch, 0xff, (size_t)2 * V * sizeof(unsigned long long),
                          (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    Args a{pi_grid, inner_a, exit_idx, hop_t, from_w, uni, sil_from, arc_ptr, arc_dst, arc_src,
           arc_val, log_b, mask, exit_score, exit_start, exit_pred, xch, hop_kind, sil_idx, T,
           V, S, wpb};
    void* params[] = {&a};
    err = cudaLaunchCooperativeKernel((const void*)factored_lattice_kernel, dim3(blocks), dim3(threads),
                                      params, smem, (cudaStream_t)stream);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

extern "C" const char* factored_lattice_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
