// Batched Viterbi over a dense graph of N > 32 states for Hopper (sm_90a):
// max-plus trellis with first-index argmax backpointers, optional frame
// mask and termination weights, then the backtrace, in one kernel.
//
// Replaces lnasr_tpu/ops/trellis_pallas.py:viterbi_pallas_dense
// (_viterbi_dense_kernel). The TPU kernel stored every frame's max row and
// recovered the path by exact-equality replay, because an argmax over the
// N x N candidates cost it more than the add, and it mapped -inf to a
// finite NEG so that its MXU relayout (0 * -inf) made no NaNs. Neither
// holds here: the kernel keeps each target's running max and the FIRST
// source i reaching it (strict > from i = 0, as torch.max and jnp.argmax)
// and writes an int16 backpointer per (t, j); -inf stays -inf. The adds
// are the scan's (v[i] + A[i, j], then + log_b[t, j]) and max is exact, so
// paths and scores are bitwise those of lnasr_tpu_torch/ops/trellis.py:
// viterbi_scan (no --use_fast_math; there is no multiply to contract).
// Masked frames are identity steps whose backpointers point to themselves.
//
// What bounds it on an H100: at the recognizer's shape (N = 179, T = 511)
// it moves 0.5 MB and does 2 N^2 T = 33 M max/add operations: 0.15 us of
// bytes, 0.5 us of fp32 peak. Neither is the limit. The T - 1 frames depend
// on each other, so the time is T times one frame's critical path: the
// longest compare chain plus a block barrier. The first design ran one
// thread per target over all N sources (a 179-long chain, 5.5 us a frame).
// But the recognizer's graph is 97% -inf (867 finite entries of 32,041;
// 154 targets have 2 sources, the 23 word-entry states 24-25), so:
//
// - Source lists. The prologue builds, per target j, the list of i = 0
//   and then the ascending i >= 1 with A[i, j] != -inf, as (int16 index,
//   fp32 value) in shared memory (CSR by target). Skipping a -inf entry at
//   i >= 1 cannot change a strict-> first-index scan: its candidate is
//   -inf or NaN, and neither beats `best`. Keeping i = 0 first keeps the
//   scan's answer when every candidate is -inf (index 0) and when c_0 is
//   NaN. A dense A gives lists of length N.
// - Lane split. A target's list goes to g = 2^k lanes of one warp over
//   contiguous sub-ranges of at most K entries (K from 8 up, doubled until
//   all groups fit the block's threads). Groups are packed largest first,
//   so each is aligned to its size inside a warp, and merged with xor
//   shuffles that keep the larger value and, on equal values, the lower
//   index (kernel F's hop rule). The group's first lane starts from c_0 as
//   the scan does; every other lane starts from (-inf, none) and takes only
//   candidates strictly above it, so NaNs at i >= 1 are skipped as in the
//   scan. With lists of <= 8 entries per lane (the recognizer's graph: 4
//   lanes of <= 7 for the long lists), each lane holds its entries in
//   registers for the whole utterance: a frame is <= 8 shared loads of v,
//   a short chain and two shuffle levels.
// - Whole columns. A dense A (or lists past shared memory) takes no
//   lists: column j goes to cg lanes over contiguous rows, cg the largest
//   power of two <= 32 with N cg within the block, with the same first-lane
//   rule and merge; A from shared memory where it fits (staged with 16-byte
//   loads), else through L1/L2, eight loads ahead of their chain.
// - The route comes from the list lengths alone, before anything is built:
//   lists in registers; lists in shared memory where A does not fit there
//   or they hold under a third of it (an entry is a gather: index, value,
//   then v[i]); else columns. The block has 8 N threads (at most
//   1024) so that the lanes fit, but only the route's lanes run the frame
//   loop, on a barrier of their own (bar.sync 1, n), and the rest wait at
//   the backtrace. Each route has its own copy of the frame loop, so that
//   the register route's entries are not live in the others' loops.
// - Loads off the critical path: emissions come through a ring of RING
//   frames in shared memory filled by cp.async RING - 1 frames ahead; the
//   mask is staged in shared memory, MASK_CHUNK frames at a time.
// - Capacity. All regions used only in the forward share their space with
//   the backtrace's staged backpointer frames, so the kernel takes every N
//   the first design took.
//
// The backtrace stages CHUNK frames of backpointers with one coalesced
// read and thread 0 walks the chain there.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 32;            // backtrace frames staged per load
constexpr int RING = 8;              // emission frames in the ring
constexpr int MASK_CHUNK = 1024;     // mask frames staged at a time (multiple of 16)
constexpr int KREG = 8;              // list entries a lane keeps in registers
constexpr int MAX_THREADS = 1024;
constexpr int SMEM_LIMIT = 232448;   // a block's shared memory on sm_90
constexpr unsigned FULL = 0xffffffffu;

__host__ __device__ inline size_t align16(size_t x) { return (x + 15) & ~(size_t)15; }

__host__ __device__ inline int threads_for(int N) {
    const int t = ((8 * N + 31) / 32) * 32;
    return t < MAX_THREADS ? t : MAX_THREADS;
}

// Shared memory, byte offsets: v [2][N], then the forward's regions (the
// emission ring, the staged mask, list offsets, lane descriptors and the
// pool of source lists), which share their space with the backtrace's
// staged frames. A staged A (no lists, so no descriptors) starts at the
// descriptors. Mirrored by lnasr_tpu_torch/ops/viterbi_dense.py:_layout.
struct Layout {
    size_t ring, mask, offs, dj, dlo, dhi, pool, pool_bytes, total;
};

__host__ __device__ inline Layout layout(int N) {
    Layout L;
    const int nth = threads_for(N);
    const size_t d = (size_t)((N + nth - 1) / nth) * nth;  // lane descriptors
    const size_t u = align16((size_t)2 * N * 4);           // after v
    L.ring = u;
    L.mask = L.ring + align16((size_t)RING * N * 4);
    L.offs = L.mask + MASK_CHUNK;
    L.dj = L.offs + align16((size_t)(N + 1) * 4);
    L.dlo = L.dj + align16(4 * d);
    L.dhi = L.dlo + align16(4 * d);
    L.pool = L.dhi + align16(4 * d);
    const size_t cap = (size_t)SMEM_LIMIT - 1024;
    const size_t avail = cap > L.pool ? (cap - L.pool) & ~(size_t)15 : 0;
    const size_t want = align16((size_t)6 * N * N);  // lists of a dense A
    L.pool_bytes = want < avail ? want : avail;
    const size_t fwd = L.pool - u + L.pool_bytes;
    const size_t stage = align16((size_t)CHUNK * N * 2);
    L.total = u + (fwd > stage ? fwd : stage);
    return L;
}

__device__ __forceinline__ void argmax_merge(float& bv, int& bi, float ov, int oi) {
    if (ov > bv || (ov == bv && oi < bi)) { bv = ov; bi = oi; }
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int P>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(P) : "memory"); }

// barrier 1 over the block's first n threads (n a multiple of 32)
__device__ __forceinline__ void bar_sync(int n) { asm volatile("bar.sync 1, %0;\n" ::"r"(n) : "memory"); }

// Sum (op 0) or max (op 1) of x over the block, returned to every thread.
__device__ int block_reduce(int x, int op, int* red) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
        const int y = __shfl_xor_sync(FULL, x, o);
        x = op ? max(x, y) : x + y;
    }
    const int w = threadIdx.x >> 5, nw = blockDim.x >> 5;
    __syncthreads();
    if ((threadIdx.x & 31) == 0) red[w] = x;
    __syncthreads();
    int r = red[0];
    for (int k = 1; k < nw; ++k) r = op ? max(r, red[k]) : r + red[k];
    return r;
}

// Exclusive prefix sum of x over threads in order; `total` gets the sum.
__device__ int block_exclusive_scan(int x, int* red, int& total) {
    const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
    int inc = x;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        const int y = __shfl_up_sync(FULL, inc, o);
        if (lane >= o) inc += y;
    }
    __syncthreads();
    if (lane == 31) red[w] = inc;
    __syncthreads();
    int before = 0;
    total = 0;
    for (int k = 0; k < nw; ++k) {
        if (k < w) before += red[k];
        total += red[k];
    }
    return before + inc - x;
}

__device__ __forceinline__ int ceil_pow2(int x) {  // x >= 1
    return x <= 1 ? 1 : 1 << (32 - __clz(x - 1));
}

// lanes of a list of `len` entries at `per` entries a lane: a power of two, <= 32
__device__ __forceinline__ int group_lanes(int len, int per) {
    const int g = ceil_pow2((len + per - 1) / per);
    return g < 32 ? g : 32;
}

__global__ void __launch_bounds__(MAX_THREADS)
viterbi_dense_kernel(const float* __restrict__ log_pi,    // (N,)
                     const float* __restrict__ log_a,     // (N, N)
                     const float* __restrict__ log_b,     // (B, T, N)
                     const uint8_t* __restrict__ mask,    // (B, T) or null
                     const float* __restrict__ log_final, // (N,) or null
                     int T, int N,
                     int16_t* __restrict__ bp,            // (B, T, N) scratch
                     int* __restrict__ path,              // (B, T)
                     float* __restrict__ score)           // (B,)
{
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float red_v[32];
    __shared__ int red_i[32];
    __shared__ int bucket[6], fill[6];
    __shared__ int state_sh;

    const Layout L = layout(N);
    float* v = reinterpret_cast<float*>(smem);                 // [2][N]
    float* ring = reinterpret_cast<float*>(smem + L.ring);     // [RING][N]
    int* dj = reinterpret_cast<int*>(smem + L.dj);             // lane: target | log2(g) << 16, or -1
    int* dlo = reinterpret_cast<int*>(smem + L.dlo);           // lane: first list entry
    int* dhi = reinterpret_cast<int*>(smem + L.dhi);           // lane: one past its last
    int* offs = reinterpret_cast<int*>(smem + L.offs);         // [N + 1] list starts
    uint8_t* msk = smem + L.mask;                              // [MASK_CHUNK]
    unsigned char* pool = smem + L.pool;                       // lists, or A
    int16_t* stage = reinterpret_cast<int16_t*>(smem + L.ring);  // backtrace [CHUNK][N]

    const int b = blockIdx.x;
    const int tid = threadIdx.x;
    const int nth = blockDim.x;
    const int lane = tid & 31, warp = tid >> 5;
    const float* lb = log_b + (size_t)b * T * N;
    const uint8_t* mk = mask ? mask + (size_t)b * T : nullptr;
    int16_t* bpb = bp + (size_t)b * T * N;

    // frame f's emissions into the ring over `stride` threads; one commit a frame
    auto prefetch = [&](int f, int stride) {
        if (f < T) {
            const float* src = lb + (size_t)f * N;
            float* dst = ring + (f % RING) * N;
            for (int j = tid; j < N; j += stride) cp_async4(dst + j, src + j);
        }
        cp_async_commit();
    };
    for (int f = 1; f < RING; ++f) prefetch(f, nth);
    if (mk) {
        for (int k = tid; k < T && k < MASK_CHUNK; k += nth) msk[k] = mk[k];
    }
    for (int j = tid; j < N; j += nth) v[j] = log_pi[j] + lb[j];

    // -- prologue: per-target source lists -------------------------------
    // list lengths: 1 (i = 0) + the finite A[i, j] at i >= 1; rows are read
    // with neighbouring threads on neighbouring j (coalesced)
    for (int j = tid; j < N; j += nth) {
        int cnt = 1;
#pragma unroll 8
        for (int i = 1; i < N; ++i) cnt += log_a[(size_t)i * N + j] != -INFINITY;
        offs[j] = cnt;
    }
    __syncthreads();
    const int per_t = (N + nth - 1) / nth;  // targets per thread for the scan
    const int j0 = min(N, tid * per_t), j1 = min(N, j0 + per_t);
    int mine = 0;
    for (int j = j0; j < j1; ++j) mine += offs[j];
    int n_entries;
    int run = block_exclusive_scan(mine, red_i, n_entries);
    for (int j = j0; j < j1; ++j) {
        const int len = offs[j];
        offs[j] = run;
        run += len;
    }
    if (tid == 0) offs[N] = n_entries;
    __syncthreads();

    // the route, from the list lengths alone: lists in registers, lists in
    // shared memory, or whole columns
    const bool a_fits = (size_t)4 * N * N <= L.pool + L.pool_bytes - L.dj;  // A in shared memory
    bool lists = (size_t)6 * n_entries <= L.pool_bytes;
    bool fast = false;
    int per = KREG, n_lanes = 0;
    if (lists) {
        // entries a lane: KREG, doubled until the groups fit the block (or
        // every group is one lane; then lanes take several rounds)
        for (;;) {
            int w = 0;
            for (int j = tid; j < N; j += nth) w += group_lanes(offs[j + 1] - offs[j], per);
            n_lanes = block_reduce(w, 0, red_i);
            if (n_lanes <= nth || per >= N) break;
            per <<= 1;
        }
        int longest = 0;
        for (int j = tid; j < N; j += nth) {
            const int len = offs[j + 1] - offs[j], g = group_lanes(len, per);
            longest = max(longest, (len + g - 1) / g);
        }
        fast = block_reduce(longest, 1, red_i) <= KREG && n_lanes <= nth;
        // lists and columns split over lanes alike, but a list entry is a
        // gather (index, value, then v[i]) where a column entry is two
        // conflict-free loads: lists too long for registers pay against A in
        // shared memory only below a third of it (kernel_timing.py), and
        // always against A read through L2
        if (!fast && a_fits && (long long)3 * n_entries > (long long)N * N) lists = false;
    }
    // columns: each over cg lanes, the largest power of two <= 32 that fits
    int cg = 1;
    while (cg < 32 && 2 * cg * N <= nth) cg <<= 1;
    if (!lists) n_lanes = N * cg;
    const int rounds = (n_lanes + nth - 1) / nth;
    // threads that run the frame loop: its lanes; the rest of the block
    // waits at the backtrace, off the loop's barrier
    const int nact = min(nth, (n_lanes + 31) & ~31);
    const bool a_smem = !lists && a_fits;
    float* lval = reinterpret_cast<float*>(pool);                        // [E]
    int16_t* lsrc = reinterpret_cast<int16_t*>(pool + (size_t)4 * n_entries);  // [E]
    const float* A = log_a;
    if (lists) {
        for (int j = tid; j < N; j += nth) {
            int pos = offs[j];
            lval[pos] = log_a[j];
            lsrc[pos] = 0;
            ++pos;
            for (int i = 1; i < N; ++i) {
                const float a = log_a[(size_t)i * N + j];
                if (a != -INFINITY) {
                    lval[pos] = a;
                    lsrc[pos] = (int16_t)i;
                    ++pos;
                }
            }
        }
        // pack groups largest first: each lands aligned to its size in a warp
        if (tid < 6) { bucket[tid] = 0; fill[tid] = 0; }
        __syncthreads();
        for (int j = tid; j < N; j += nth)
            atomicAdd(&bucket[31 - __clz(group_lanes(offs[j + 1] - offs[j], per))], 1);
        for (int k = tid; k < rounds * nth; k += nth) dj[k] = -1;
        __syncthreads();
        for (int j = tid; j < N; j += nth) {
            const int lo = offs[j], len = offs[j + 1] - lo;
            const int g = group_lanes(len, per), lg = 31 - __clz(g);
            int base = 0;
            for (int k = 5; k > lg; --k) base += bucket[k] << k;
            const int first = base + (atomicAdd(&fill[lg], 1) << lg);
            const int sub = (len + g - 1) / g;
            for (int r = 0; r < g; ++r) {
                const int a = min(lo + len, lo + r * sub), z = min(lo + len, a + sub);
                dj[first + r] = j | (lg << 16);
                dlo[first + r] = a;
                dhi[first + r] = z;
            }
        }
    } else if (a_smem) {
        float* sa = reinterpret_cast<float*>(smem + L.dj);
        const size_t nn = (size_t)N * N;
        size_t k0 = 0;
        if ((reinterpret_cast<uintptr_t>(log_a) & 15) == 0) {
            const float4* src = reinterpret_cast<const float4*>(log_a);
            float4* dst = reinterpret_cast<float4*>(sa);
            for (size_t q = tid; q < nn / 4; q += nth) dst[q] = src[q];
            k0 = nn / 4 * 4;
        }
        for (size_t k = k0 + tid; k < nn; k += nth) sa[k] = log_a[k];
        A = sa;
    }
    cp_async_wait<0>();  // this thread's copies of frames 1 .. RING-1 landed
    __syncthreads();

    // the frame loop, one copy a route so that only that route's state is
    // live in it: `step` updates the targets of a frame that is not masked
    auto frames = [&](auto step) {
        int cur = 0;
        for (int t = 1; t < T; ++t) {
            if (mk && t % MASK_CHUNK == 0) {
                for (int k = tid; k < MASK_CHUNK && t + k < T; k += nact) msk[k] = mk[t + k];
                bar_sync(nact);
            }
            prefetch(t + RING - 1, nact);  // into the slot frame t - 1 used
            const float* vc = v + cur * N;
            float* vn = v + (cur ^ 1) * N;
            int16_t* bpt = bpb + (size_t)t * N;
            if (mk == nullptr || msk[t % MASK_CHUNK]) {
                step(vc, vn, ring + (t % RING) * N, bpt);
            } else {  // masked frame: identity step, self backpointers
                for (int j = tid; j < N; j += nact) {
                    vn[j] = vc[j];
                    bpt[j] = (int16_t)j;
                }
            }
            cp_async_wait<RING - 2>();  // frame t + 1 landed
            bar_sync(nact);
            cur ^= 1;
        }
        cp_async_wait<0>();
    };
    // (value, index) merge over groups of g lanes, wg the warp's largest g
    auto merge = [](float& best, int& arg, int g, int wg) {
        for (int off = wg >> 1; off > 0; off >>= 1) {
            const float ov = __shfl_xor_sync(FULL, best, off);
            const int oi = __shfl_xor_sync(FULL, arg, off);
            if (off < g) argmax_merge(best, arg, ov, oi);
        }
    };

    if (tid < nact && fast) {
        // this lane's list entries, in registers for the whole utterance
        int my_j = -1, my_g = 1, n_my = 0, lo = 0;
        int s_reg[KREG];
        float a_reg[KREG];
        const int d = dj[tid];
        if (d >= 0) {
            my_j = d & 0xffff;
            my_g = 1 << (d >> 16);
            lo = dlo[tid];
            n_my = dhi[tid] - lo;
        }
#pragma unroll
        for (int k = 0; k < KREG; ++k) {
            s_reg[k] = 0;
            a_reg[k] = -INFINITY;  // padding: its candidate never beats `best`
            if (k < n_my) {
                s_reg[k] = lsrc[lo + k];
                a_reg[k] = lval[lo + k];
            }
        }
        const int warp_g = __reduce_max_sync(FULL, my_g);
        const bool lead = my_j >= 0 && (lane & (my_g - 1)) == 0;
        frames([&](const float* vc, float* vn, const float* e, int16_t* bpt) {
            float best = -INFINITY;
            int arg = 0x7fffffff;
#pragma unroll
            for (int k = 0; k < KREG; ++k) {
                const float c = vc[s_reg[k]] + a_reg[k];
                if (k == 0 && lead) { best = c; arg = s_reg[0]; }
                else if (c > best) { best = c; arg = s_reg[k]; }
            }
            merge(best, arg, my_g, warp_g);
            if (lead) {
                vn[my_j] = best + e[my_j];
                bpt[my_j] = (int16_t)arg;
            }
        });
    } else if (tid < nact && lists) {
        frames([&](const float* vc, float* vn, const float* e, int16_t* bpt) {
            for (int r = 0; r < rounds; ++r) {  // rounds > 1 only when nact == nth
                const int k = r * nth + tid;
                if (k - lane >= n_lanes) break;  // the warp has no lane left (warp-uniform)
                const int d = dj[k];
                const int j = d & 0xffff, g = d >= 0 ? 1 << (d >> 16) : 1;
                const bool lead = d >= 0 && (lane & (g - 1)) == 0;
                float best = -INFINITY;
                int arg = 0x7fffffff;
                int q = dlo[k];
                const int z = d >= 0 ? dhi[k] : q;
                if (lead) { best = vc[lsrc[q]] + lval[q]; arg = lsrc[q]; ++q; }
                for (; q + 3 < z; q += 4) {  // four entries' loads before their chain
                    int i4[4];
                    float c4[4];
#pragma unroll
                    for (int u = 0; u < 4; ++u) i4[u] = lsrc[q + u];
#pragma unroll
                    for (int u = 0; u < 4; ++u) c4[u] = vc[i4[u]] + lval[q + u];
#pragma unroll
                    for (int u = 0; u < 4; ++u)
                        if (c4[u] > best) { best = c4[u]; arg = i4[u]; }
                }
                for (; q < z; ++q) {
                    const float c = vc[lsrc[q]] + lval[q];
                    if (c > best) { best = c; arg = lsrc[q]; }
                }
                merge(best, arg, g, __reduce_max_sync(FULL, g));
                if (lead) {
                    vn[j] = best + e[j];
                    bpt[j] = (int16_t)arg;
                }
            }
        });
    } else if (tid < nact) {
        // column j over cg lanes of contiguous rows, from shared memory or L2
        const int lg = 31 - __clz(cg), sub = (N + cg - 1) / cg;
        frames([&](const float* vc, float* vn, const float* e, int16_t* bpt) {
            for (int r = 0; r < rounds; ++r) {  // rounds > 1 only when nact == nth
                const int k = r * nth + tid;
                if (k - lane >= n_lanes) break;  // warp-uniform
                const int j = k >> lg, part = k & (cg - 1);
                const bool live = k < n_lanes, lead = live && part == 0;
                int i = live ? min(N, part * sub) : N;
                const int z = min(N, i + sub);
                const float* col = A + (live ? j : 0);
                float best = -INFINITY;
                int arg = 0x7fffffff;
                if (lead) { best = vc[0] + col[0]; arg = 0; i = 1; }
                for (; i + 7 < z; i += 8) {  // eight loads before their chain
                    float c8[8];
#pragma unroll
                    for (int u = 0; u < 8; ++u) c8[u] = col[(size_t)(i + u) * N];
#pragma unroll
                    for (int u = 0; u < 8; ++u) c8[u] = vc[i + u] + c8[u];
#pragma unroll
                    for (int u = 0; u < 8; ++u)
                        if (c8[u] > best) { best = c8[u]; arg = i + u; }
                }
                for (; i < z; ++i) {
                    const float c = vc[i] + col[(size_t)i * N];
                    if (c > best) { best = c; arg = i; }
                }
                merge(best, arg, cg, cg);
                if (lead) {
                    vn[j] = best + e[j];
                    bpt[j] = (int16_t)arg;
                }
            }
        });
    }
    __syncthreads();

    // termination: first argmax of v (+ log_final); score is its value
    const float* vc = v + ((T - 1) & 1) * N;  // the loop's last buffer
    float bv = -INFINITY;
    int bi = 0x7fffffff;
    for (int j = tid; j < N; j += nth) {
        const float x = log_final ? vc[j] + log_final[j] : vc[j];
        argmax_merge(bv, bi, x, j);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(FULL, bv, off);
        const int oi = __shfl_xor_sync(FULL, bi, off);
        argmax_merge(bv, bi, ov, oi);
    }
    if (lane == 0) { red_v[warp] = bv; red_i[warp] = bi; }
    __syncthreads();
    if (tid == 0) {
        for (int w = 1; w < nth / 32; ++w) argmax_merge(bv, bi, red_v[w], red_i[w]);
        if (bi >= N) bi = 0;  // every candidate NaN: cannot happen on real graphs
        score[b] = bv;
        path[(size_t)b * T + T - 1] = bi;
        state_sh = bi;
    }
    __syncthreads();

    // backtrace: path[t-1] = bp[t][path[t]] for t = T-1 .. 1
    int* pb = path + (size_t)b * T;
    int state = state_sh;
    for (int hi = T - 1; hi >= 1; hi -= CHUNK) {
        const int lo = hi - CHUNK + 1 > 1 ? hi - CHUNK + 1 : 1;
        const int count = (hi - lo + 1) * N;
        const int16_t* src = bpb + (size_t)lo * N;
        for (int k = tid; k < count; k += nth) stage[k] = src[k];
        __syncthreads();
        if (tid == 0) {
            for (int t = hi; t >= lo; --t) {
                state = stage[(t - lo) * N + state];
                pb[t - 1] = state;
            }
        }
        __syncthreads();
    }
}

}  // namespace

extern "C" int viterbi_dense_launch(const float* log_pi, const float* log_a, const float* log_b,
                                    const uint8_t* mask, const float* log_final,
                                    int B, int T, int N, int16_t* bp, int* path, float* score,
                                    void* stream) {
    if (N < 1 || N > 32767 || T < 1 || B < 1) return (int)cudaErrorInvalidValue;
    const size_t smem = layout(N).total;
    if (smem + 1024 > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    cudaError_t err = cudaFuncSetAttribute(viterbi_dense_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    viterbi_dense_kernel<<<B, threads_for(N), smem, (cudaStream_t)stream>>>(
        log_pi, log_a, log_b, mask, log_final, T, N, bp, path, score);
    return (int)cudaGetLastError();
}

extern "C" const char* viterbi_dense_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
