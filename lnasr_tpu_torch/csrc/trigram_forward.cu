// Exact trigram Viterbi forward for Hopper (sm_90a): the history-expanded
// word graph's (H, V, S) grid frame by frame, its (T-1, H, V, S) int32
// backpointers (walked by trigram_backtrace.cu) and the final argmax.
//
// Replaces the jitted lax.scan of lnasr_tpu/models/decoder.py:1510-1563
// (TrigramDecodingGraph's step, scan and final argmax), which has no
// Pallas kernel: XLA runs the whole recursion as one device program.
// States are copies (h, w, s): history word h (V words, then the <s> row
// h = V), current word w, local state s. One frame:
//   within[h, w, j] = max_s grid[h, w, s] + inner_a[w, s, j]
//   exit[h, u]      = grid[h, u, exit_idx[u]]
//   entry[u, w]     = max_h exit[h, u] + hop3[h, u, w]    (into copy (u, w, 0))
//   grid[h, w, j]   = max(within, entry at j = 0, h < V) + log_b[t, w, j]
// with the plain version's ties (ops/trigram.py:trigram_forward_plain):
// the first within-word source, the first history, a hop only when
// strictly better than `within` at state 0, the <s> row never re-entered,
// masked frames keep the grid and point to themselves, the final argmax
// the first of the flattened (H, V, S) states. Only adds, compares and
// selects: the grid, the backpointers, path and score are bitwise those
// of the plain frame loop, float32 and float64.
//
// What bounds it on an H100. At V = 200 (H = 202, S = 8, 324,816 states),
// T = 512, float32: 32.6 MB of hop3 and 3.3 MB of emissions in, 511
// backpointer frames of 1.3 MB out: 0.209 ms at 3.35 TB/s; 10.95 G adds
// and maxes, 0.163 ms at 67 TFLOP/s. A frame's hop reads all of hop3,
// which no SM's 227 KB of shared memory holds (247 KB an SM at V = 200),
// so every frame streams it again, from L2 where it stays there (32.6 MB
// could, at float32; float64's 65 MB cannot) or from device memory:
// 16.6 GB over 509 frames, 4.96 ms at HBM's rate. Frames depend on each
// other, so the work of a frame is spread over the card and the
// frame-to-frame exchange is kept small.
//
// Ownership by history row. Block k owns rows h in [k*rpb, (k+1)*rpb)
// (rpb = ceil(H / SMs), 2 at V = 200), keeps them in shared memory (or,
// past what it holds, in a device-memory scratch of two frames: the
// "global" route, chosen in Python), and computes for each own row u < V
// the hop into every copy (u, w, 0) from the (H, V) slab hop3[:, u, :].
// The one thing it needs from the others is the column exit[:, u] of the
// last published frame, H values a row; it publishes the exits of its own
// rows, V a row. The other ownership, by current word, would exchange V
// entry maxima and their argmaxes per owned word instead.
//
// The exchange is kernel D's (factored_forward.cu): each exit travels
// with its frame's tag in aligned 64-bit words, (tag << 32) | 32 bits,
// stored with st.relaxed.gpu and polled with ld.relaxed.gpu until every
// tag is the frame wanted. A 64-bit access is single-copy atomic, so a
// matching tag brings its own bits and nothing needs a fence; a float64
// exit takes two words (its low and high halves), each tagged, and is
// taken when both tags match. Frame 0 and every valid frame publish, the
// k-th publication into buffer k & 1 of a (2, V, H, W) array: a block
// publishes k + 1 only after reading a whole column of k (one word from
// every block), and every block published k only after reading a column of
// k - 1, so two buffers suffice; the block of the <s> row alone, which no
// hop enters, reads word 0's column for this alone. The
// launcher fills the exchange with tag 0xffffffff (no frame's) before
// every launch, and the cooperative launch keeps every block resident; a
// spin that lasts seconds traps. The final argmax: each block's first
// maximum, then the last block to finish (an atomic count) takes the
// first of them in block order.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int SMEM_LIMIT = 232448;  // a block's shared memory on sm_90
constexpr int SMEM_STATIC = 1024;   // the static arrays' share (mirrored in ops/trigram.py)
constexpr int POLL = 4;             // exchange words a thread loads at once
constexpr long long SPIN_LIMIT = 1ll << 24;  // polling rounds before the kernel traps
constexpr int ROUTE_SMEM = 0, ROUTE_GLOBAL = 1;

struct Args {
    const void* log_b;        // (T, V, S)
    const uint8_t* mask;      // (T,) or null
    const void* inner_a;      // (V, S, S)
    const void* hop3;         // (H, V, V)
    const void* log_pi_w;     // (V,)
    const void* final3;       // (H, V)
    const int* exit_idx;      // (V,)
    int* bts;                 // (T-1, H, V, S)
    void* score;              // ()
    int* last;                // ()
    unsigned long long* xch;  // (2, V, H, W) tagged exit words
    void* rows;               // (2, H, V, S) on the global route, else null
    void* part_v;             // (blocks,) each block's final maximum
    int* part_i;              // (blocks,) its first flat state
    unsigned* done;           // blocks finished, zeroed before the launch
    int n_t, H, V, S, rpb;  // n_t: frames
};

template <typename T>
struct Num;
template <>
struct Num<float> {
    static constexpr int W = 1;  // exchange words a value takes
    __device__ static float ninf() { return -INFINITY; }
    __device__ static unsigned half(float x, int) { return __float_as_uint(x); }
};
template <>
struct Num<double> {
    static constexpr int W = 2;
    __device__ static double ninf() { return -(double)INFINITY; }
    // word 0 the low half, word 1 the high half: their order in memory
    __device__ static unsigned half(double x, int q) {
        return q ? (unsigned)__double2hiint(x) : (unsigned)__double2loint(x);
    }
};

__device__ __forceinline__ unsigned long long ld_relaxed(const unsigned long long* p) {
    unsigned long long x;
    asm volatile("ld.relaxed.gpu.global.b64 %0, [%1];" : "=l"(x) : "l"(p) : "memory");
    return x;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p, unsigned long long x) {
    asm volatile("st.relaxed.gpu.global.b64 [%0], %1;" ::"l"(p), "l"(x) : "memory");
}

// out[j] = the low 32 bits of src[j] once its tag is `tag`, j < n. A
// thread's words are polled together: a round reloads all of them not yet
// tagged, one L2 round trip however many were early.
__device__ void read_exits(const unsigned long long* src, unsigned tag, int n, unsigned* out) {
    const int tid = threadIdx.x, nth = blockDim.x;
    for (int base = tid; base < n; base += nth * POLL) {
        unsigned long long x[POLL];
        unsigned pending = 0;
#pragma unroll
        for (int q = 0; q < POLL; ++q) {
            const int j = base + q * nth;
            if (j < n) {
                x[q] = ld_relaxed(src + j);
                pending |= 1u << q;
            }
        }
        for (long long round = 0; pending; ++round) {
            if (round > SPIN_LIMIT) __trap();
#pragma unroll
            for (int q = 0; q < POLL; ++q) {
                if ((pending >> q & 1) && (unsigned)(x[q] >> 32) == tag) {
                    out[base + q * nth] = (unsigned)x[q];
                    pending &= ~(1u << q);
                }
            }
#pragma unroll
            for (int q = 0; q < POLL; ++q)
                if (pending >> q & 1) x[q] = ld_relaxed(src + base + q * nth);
        }
    }
}

// The exits of the block's rows g (nr rows of V*S) into buffer `buf`,
// tagged `tag`: word q of exit (h, u) at xch[buf, u, h, q].
template <typename T>
__device__ void publish(const T* g, unsigned long long* xch, int buf, unsigned tag, int h0,
                        int nr, int H, int V, int S, const int* eidx) {
    constexpr int W = Num<T>::W;
    for (int k = threadIdx.x; k < nr * V * W; k += blockDim.x) {
        const int ru = k / W, q = k - ru * W;
        const int r = ru / V, u = ru - r * V;
        const T x = g[(size_t)r * V * S + u * S + eidx[u]];
        st_relaxed(xch + (((size_t)buf * V + u) * H + h0 + r) * W + q,
                   ((unsigned long long)tag << 32) | Num<T>::half(x, q));
    }
}

// Sources h0 .. h0 + AHEAD - 1 of a hop column (stride V * V), -inf past H.
template <typename T, int AHEAD>
__device__ __forceinline__ void load_sources(T (&x)[AHEAD], const T* col, int h0, int H, int V) {
#pragma unroll
    for (int q = 0; q < AHEAD; ++q)
        x[q] = h0 + q < H ? col[(size_t)(h0 + q) * V * V] : Num<T>::ninf();
}

// The running first maximum over sources h0 .. of exit + hop (e[h] + x):
// source 0 starts it, a later one takes it only when strictly larger.
template <typename T, int AHEAD>
__device__ __forceinline__ void take_sources(T& best, int& arg, const T (&x)[AHEAD], const T* e,
                                             int h0, int H) {
#pragma unroll
    for (int q = 0; q < AHEAD; ++q) {
        const int h = h0 + q;
        if (h < H) {
            const T c = e[h] + x[q];
            if (h == 0 || c > best) {
                best = c;
                arg = h;
            }
        }
    }
}

// (v, i) becomes (ov, oi) when that is larger, or equal at an earlier state.
template <typename T>
__device__ __forceinline__ void take_first_max(T& v, int& i, T ov, int oi) {
    if (ov > v || (ov == v && oi < i)) {
        v = ov;
        i = oi;
    }
}

template <typename T, int ROUTE>
__global__ void __launch_bounds__(THREADS) trigram_forward_kernel(Args p) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ T red_v[THREADS / 32];
    __shared__ int red_i[THREADS / 32];
    __shared__ bool is_last;
    constexpr int W = Num<T>::W;
    constexpr int AHEAD = sizeof(T) == 4 ? 16 : 8;  // hop sources a register buffer holds

    const int H = p.H, V = p.V, S = p.S, rpb = p.rpb;
    const int VS = V * S;
    const int h0 = blockIdx.x * rpb;
    const int nr = min(rpb, H - h0);          // >= 1: the launcher sizes the grid
    const int nhop = max(0, min(nr, V - h0));  // own rows a hop enters (h < V)
    const int cells = nr * VS;
    const int base_id = h0 * VS;               // the block's first flat state
    const size_t frame = (size_t)H * VS;
    const int tid = threadIdx.x, nth = blockDim.x;
    const T* log_b = static_cast<const T*>(p.log_b);
    const T* inner_a = static_cast<const T*>(p.inner_a);
    const T* hop3 = static_cast<const T*>(p.hop3);
    const T* log_pi_w = static_cast<const T*>(p.log_pi_w);
    const T* final3 = static_cast<const T*>(p.final3);

    T* ex = reinterpret_cast<T*>(smem);                           // [rpb * H] exit columns
    int* src0 = reinterpret_cast<int*>(ex + (size_t)rpb * H);     // [rpb * V] state 0's source
    int* eidx = src0 + rpb * V;                                   // [V]
    T* gc;  // the block's rows at the last valid frame
    T* gn;  // the next frame's
    if (ROUTE == ROUTE_SMEM) {
        const size_t head = ((size_t)rpb * H * sizeof(T) + (size_t)(rpb + 1) * V * sizeof(int)
                             + 15) & ~(size_t)15;
        gc = reinterpret_cast<T*>(smem + head);
        gn = gc + (size_t)rpb * VS;
    } else {
        gc = static_cast<T*>(p.rows) + base_id;
        gn = gc + frame;
    }
    for (int k = tid; k < V; k += nth) eidx[k] = p.exit_idx[k];
    const T ninf = Num<T>::ninf();
    for (int k = tid; k < cells; k += nth) {
        const int r = k / VS, rem = k - r * VS, w = rem / S, s = rem - w * S;
        const T init = (h0 + r == H - 1 && s == 0) ? log_pi_w[w] : ninf;
        gc[k] = init + log_b[rem];
    }
    __syncthreads();
    publish(gc, p.xch, 0, 0u, h0, nr, H, V, S, eidx);
    int n_pub = 0;
    unsigned last_pub = 0;  // publications so far - 1, the frame of the last

    for (int t = 1; t < p.n_t; ++t) {
        int* bt = p.bts + (size_t)(t - 1) * frame + base_id;
        if (p.mask != nullptr && !p.mask[t]) {  // identity step: self pointers, nothing published
            for (int k = tid; k < cells; k += nth) __stcs(bt + k, base_id + k);
            continue;
        }
        const T* lb = log_b + (size_t)t * VS;
        // the within-word step of the block's rows, while the exits travel.
        // The backpointers go out with streaming stores (__stcs: evicted
        // first), so that they displace as little of hop3 from L2 as they can
        for (int k = tid; k < cells; k += nth) {
            const int r = k / VS, rem = k - r * VS, w = rem / S, s = rem - w * S;
            const T emit = lb[rem];  // issued ahead of the sources' loop
            const T* gr = gc + (size_t)r * VS + w * S;
            const T* a = inner_a + (size_t)w * S * S + s;
            T m = gr[0] + a[0];
            int src = 0;
#pragma unroll 4
            for (int q = 1; q < S; ++q) {
                const T c = gr[q] + a[(size_t)q * S];
                if (c > m) {
                    m = c;
                    src = q;
                }
            }
            if (s == 0 && r < nhop) {  // the hop may still win: finished below
                gn[k] = m;
                src0[r * V + w] = src;
            } else {
                gn[k] = m + emit;
                __stcs(bt + k, base_id + k - s + src);
            }
        }
        // a block that no hop enters (the <s> row alone) reads word 0's
        // column all the same: every block must have read all of a
        // publication before it makes the next (two buffers)
        read_exits(p.xch + ((size_t)(n_pub & 1) * V + (nhop > 0 ? h0 : 0)) * H * W, last_pub,
                   max(nhop, 1) * H * W, reinterpret_cast<unsigned*>(ex));
        __syncthreads();
        // the hop into state 0 of copy (u, w), u = h0 + r: lanes over w,
        // the H sources in order (the first on ties). The column streams
        // from L2 in two register buffers of AHEAD sources each, one loading
        // while the other is compared, so up to 2 * AHEAD loads a thread are
        // in flight: the pass waits on L2's latency, not on its own compares
        for (int k = tid; k < nhop * V; k += nth) {
            const int r = k / V, w = k - r * V, u = h0 + r;
            const T* e = ex + (size_t)r * H;
            const T* col = hop3 + (size_t)u * V + w;
            T best = ninf, buf0[AHEAD], buf1[AHEAD];
            int arg = 0;
            load_sources(buf0, col, 0, H, V);
            for (int h = 0; h < H; h += 2 * AHEAD) {
                load_sources(buf1, col, h + AHEAD, H, V);
                take_sources(best, arg, buf0, e, h, H);
                load_sources(buf0, col, h + 2 * AHEAD, H, V);
                take_sources(best, arg, buf1, e, h + AHEAD, H);
            }
            const int cell = r * VS + w * S;
            T m = gn[cell];
            int b = base_id + cell + src0[r * V + w];
            if (best > m) {
                m = best;
                b = (arg * V + u) * S + eidx[u];
            }
            gn[cell] = m + lb[w * S];
            __stcs(bt + cell, b);
        }
        __syncthreads();
        publish(gn, p.xch, (n_pub + 1) & 1, (unsigned)t, h0, nr, H, V, S, eidx);
        ++n_pub;
        last_pub = (unsigned)t;
        T* tmp = gc;
        gc = gn;
        gn = tmp;
    }

    // the final argmax: grid + final3 at each word's exit state, -inf
    // elsewhere, the first flattened state of the maximum
    T bv = ninf;
    int bi = INT_MAX;
    for (int k = tid; k < cells; k += nth) {
        const int r = k / VS, rem = k - r * VS, w = rem / S, s = rem - w * S;
        const T f = s == eidx[w] ? final3[(size_t)(h0 + r) * V + w] : ninf;
        take_first_max(bv, bi, gc[k] + f, base_id + k);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const T ov = __shfl_xor_sync(0xffffffffu, bv, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
        take_first_max(bv, bi, ov, oi);
    }
    if ((tid & 31) == 0) {
        red_v[tid >> 5] = bv;
        red_i[tid >> 5] = bi;
    }
    __syncthreads();
    if (tid == 0) {
        for (int k = 1; k < nth / 32; ++k) take_first_max(bv, bi, red_v[k], red_i[k]);
        static_cast<T*>(p.part_v)[blockIdx.x] = bv;
        p.part_i[blockIdx.x] = bi;
        __threadfence();
        is_last = atomicAdd(p.done, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (is_last && tid == 0) {
        __threadfence();
        const volatile T* pv = static_cast<volatile T*>(p.part_v);
        const volatile int* pi = p.part_i;
        T v = pv[0];
        int i = pi[0];
        for (int k = 1; k < (int)gridDim.x; ++k) take_first_max(v, i, (T)pv[k], (int)pi[k]);
        *static_cast<T*>(p.score) = v;
        *p.last = i;
    }
}

// Mirrored by lnasr_tpu_torch/ops/trigram.py:forward_smem_bytes.
size_t smem_bytes(int H, int V, int S, int rpb, int itemsize, int route) {
    size_t head = (size_t)rpb * H * itemsize + (size_t)(rpb + 1) * V * sizeof(int);
    if (route == ROUTE_GLOBAL) return head;
    return ((head + 15) & ~(size_t)15) + 2 * (size_t)rpb * V * S * itemsize;
}

template <typename T, int ROUTE>
cudaError_t launch(const Args& a, int blocks, size_t smem, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(trigram_forward_kernel<T, ROUTE>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    void* params[] = {const_cast<Args*>(&a)};
    return cudaLaunchCooperativeKernel((const void*)trigram_forward_kernel<T, ROUTE>, dim3(blocks),
                                       dim3(THREADS), params, smem, stream);
}

}  // namespace

extern "C" int trigram_forward_launch(const void* log_b, const uint8_t* mask, const void* inner_a,
                                      const void* hop3, const void* log_pi_w, const void* final3,
                                      const int* exit_idx, int T, int H, int V, int S,
                                      int is_double, int route, int n_sm, int* bts, void* score,
                                      int* last, unsigned long long* xch, void* rows, void* part_v,
                                      int* part_i, unsigned* done, void* stream) {
    if (T < 1 || V < 1 || S < 1 || H != V + 1 || n_sm < 1) return (int)cudaErrorInvalidValue;
    if (route != ROUTE_SMEM && (route != ROUTE_GLOBAL || rows == nullptr))
        return (int)cudaErrorInvalidValue;
    const int rpb = (H + n_sm - 1) / n_sm;
    const int blocks = (H + rpb - 1) / rpb;
    const int itemsize = is_double ? 8 : 4;
    const size_t smem = smem_bytes(H, V, S, rpb, itemsize, route);
    if (smem + SMEM_STATIC > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    // tag 0xffffffff in every word: no frame's (see the note on the exchange)
    cudaError_t err = cudaMemsetAsync(xch, 0xff, (size_t)2 * V * H * (is_double ? 2 : 1)
                                      * sizeof(unsigned long long), st);
    if (err == cudaSuccess) err = cudaMemsetAsync(done, 0, sizeof(unsigned), st);
    if (err != cudaSuccess) return (int)err;
    Args a{log_b, mask, inner_a, hop3, log_pi_w, final3, exit_idx, bts, score, last, xch, rows,
           part_v, part_i, done, T, H, V, S, rpb};
    if (is_double)
        err = route == ROUTE_SMEM ? launch<double, ROUTE_SMEM>(a, blocks, smem, st)
                                  : launch<double, ROUTE_GLOBAL>(a, blocks, smem, st);
    else
        err = route == ROUTE_SMEM ? launch<float, ROUTE_SMEM>(a, blocks, smem, st)
                                  : launch<float, ROUTE_GLOBAL>(a, blocks, smem, st);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

extern "C" const char* trigram_forward_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
