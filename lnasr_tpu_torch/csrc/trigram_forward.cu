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
// and maxes, 0.163 ms at 67 TFLOP/s. A frame's hop reads all of hop3.
// Frames depend on each other, so the work of a frame is spread over the
// card and the frame-to-frame exchange is kept small. Three routes,
// chosen in Python (ops/trigram.py:trigram_route) by capacity:
//
// - "resident" (float32; the serving graph's route): blocks own ranges of
//   copies, and each keeps the hop3 columns of its copies on chip for the
//   whole launch, part in registers and the rest in shared memory, so that
//   hop3 is read from device memory once a launch. See the note above
//   trigram_resident_kernel below.
// - "smem" and "global" (float64, and float32 past the resident route's
//   capacity): blocks own history rows and stream the (H, V) slabs of
//   hop3 their rows need every frame, from L2 or device memory: 16.6 GB
//   over 509 frames at V = 200, 4.96 ms at HBM's rate. The rest of this
//   note is theirs.
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
//
// A batch. One launch takes B utterances (log_b (B, T, V, S), mask (B, T),
// bts (B, T-1, H, V, S), score and last (B,)) over the graph's one set of
// tables, as the JAX package vmaps the decode into one program
// (decoder.py:1581-1585). Every block steps the B utterances in turn within
// each frame, each with an exchange slab of its own ((B, 2, V, H, W)) and a
// publication count of its own, so that the two-buffer rule above holds
// utterance by utterance under masks that differ by utterance: an
// utterance masked at a frame publishes nothing there and reads nothing,
// whatever the others do. Stepping them in turn puts the other B - 1
// utterances' work between an utterance's publication and its next read,
// which hides the exchange's latency; it does not share the hop pass, which
// each utterance needs whole every frame. One utterance (B = 1) is an
// instantiation of its own (template argument BATCH false) whose code is
// the single decode's. How a batch is cut into launches is
// ops/trigram.py:trigram_cut.

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
constexpr int ROUTE_SMEM = 0, ROUTE_GLOBAL = 1, ROUTE_RESIDENT = 2;
// utterances a launch takes (mirrored in ops/trigram.py): each thread keeps
// every utterance's publication count and last tag in a local array
constexpr int MAX_BATCH = 32;

struct Args {
    const void* log_b;        // (B, T, V, S)
    const uint8_t* mask;      // (B, T) or null
    const void* inner_a;      // (V, S, S)
    const void* hop3;         // (H, V, V)
    const void* log_pi_w;     // (V,)
    const void* final3;       // (H, V)
    const int* exit_idx;      // (V,)
    int* bts;                 // (B, T-1, H, V, S)
    void* score;              // (B,)
    int* last;                // (B,)
    unsigned long long* xch;  // (B, 2, V, H, W) tagged exit words
    void* rows;               // the global route's (B, 2, H, V, S) rows; the resident route's
                              // (B, R_SMAX, H*V) copy states when B > 1; else null
    void* part_v;             // (B, blocks) each block's final maximum
    int* part_i;              // (B, blocks) its first flat state
    unsigned* done;           // blocks finished, zeroed before the launch
    int n_t, H, V, S, rpb, B;  // n_t: frames; B: utterances
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

template <typename T, int ROUTE, bool BATCH>
__global__ void __launch_bounds__(THREADS) trigram_forward_kernel(Args p) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ T red_v[THREADS / 32];
    __shared__ int red_i[THREADS / 32];
    __shared__ bool is_last;
    constexpr int W = Num<T>::W;
    constexpr int AHEAD = sizeof(T) == 4 ? 16 : 8;  // hop sources a register buffer holds

    const int H = p.H, V = p.V, S = p.S, rpb = p.rpb;
    const int nb = BATCH ? p.B : 1;            // utterances, stepped in turn
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
    // the block's rows of two frames, `half` apart: utterance b's at
    // rows0 + b * per_utt
    T* rows0;
    size_t half;
    if (ROUTE == ROUTE_SMEM) {
        const size_t head = ((size_t)rpb * H * sizeof(T) + (size_t)(rpb + 1) * V * sizeof(int)
                             + 15) & ~(size_t)15;
        rows0 = reinterpret_cast<T*>(smem + head);
        half = (size_t)rpb * VS;
    } else {
        rows0 = static_cast<T*>(p.rows) + base_id;
        half = frame;
    }
    const size_t per_utt = 2 * half;
    T* gc = rows0;         // the block's rows at the last valid frame
    T* gn = rows0 + half;  // the next frame's
    for (int k = tid; k < V; k += nth) eidx[k] = p.exit_idx[k];
    const T ninf = Num<T>::ninf();
    for (int b = 0; b < nb; ++b) {
        T* g0 = rows0 + b * per_utt;
        const T* lb0 = log_b + (size_t)b * p.n_t * VS;
        for (int k = tid; k < cells; k += nth) {
            const int r = k / VS, rem = k - r * VS, w = rem / S, s = rem - w * S;
            const T init = (h0 + r == H - 1 && s == 0) ? log_pi_w[w] : ninf;
            g0[k] = init + lb0[rem];
        }
    }
    __syncthreads();
    for (int b = 0; b < nb; ++b)
        publish(rows0 + b * per_utt, p.xch + (size_t)b * 2 * V * H * W, 0, 0u, h0, nr, H, V, S,
                eidx);
    int n_pub = 0;
    unsigned last_pub = 0;  // publications so far - 1, the frame of the last
    // a batch: utterance b's (last_pub << 1) | (n_pub & 1), read and written in its turn
    unsigned pubs[BATCH ? MAX_BATCH : 1];
    if (BATCH)
        for (int b = 0; b < nb; ++b) pubs[b] = 0;

    for (int t = 1; t < p.n_t; ++t) {
        for (int b = 0; b < nb; ++b) {
            int* bt = p.bts + ((size_t)b * (p.n_t - 1) + (t - 1)) * frame + base_id;
            if (p.mask != nullptr && !p.mask[(size_t)b * p.n_t + t]) {
                // identity step: self pointers, nothing published
                for (int k = tid; k < cells; k += nth) __stcs(bt + k, base_id + k);
                continue;
            }
            if (BATCH) {
                n_pub = pubs[b] & 1;
                last_pub = pubs[b] >> 1;
                gc = rows0 + b * per_utt + n_pub * half;
                gn = rows0 + b * per_utt + (n_pub ^ 1) * half;
            }
            unsigned long long* xch = p.xch + (size_t)b * 2 * V * H * W;  // this utterance's
            const T* lb = log_b + ((size_t)b * p.n_t + t) * VS;
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
            read_exits(xch + ((size_t)(n_pub & 1) * V + (nhop > 0 ? h0 : 0)) * H * W, last_pub,
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
                int from = base_id + cell + src0[r * V + w];
                if (best > m) {
                    m = best;
                    from = (arg * V + u) * S + eidx[u];
                }
                gn[cell] = m + lb[w * S];
                __stcs(bt + cell, from);
            }
            __syncthreads();
            publish(gn, xch, (n_pub + 1) & 1, (unsigned)t, h0, nr, H, V, S, eidx);
            if (BATCH) {
                pubs[b] = (unsigned)t << 1 | ((n_pub + 1) & 1);
            } else {
                ++n_pub;
                last_pub = (unsigned)t;
                T* tmp = gc;
                gc = gn;
                gn = tmp;
            }
        }
    }

    // the final argmax of each utterance: grid + final3 at each word's exit
    // state, -inf elsewhere, the first flattened state of the maximum
    for (int b = 0; b < nb; ++b) {
        if (BATCH) gc = rows0 + b * per_utt + (pubs[b] & 1) * half;
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
            static_cast<T*>(p.part_v)[b * gridDim.x + blockIdx.x] = bv;
            p.part_i[b * gridDim.x + blockIdx.x] = bi;
        }
        if (BATCH) __syncthreads();  // red_v and red_i serve the next utterance
    }
    if (tid == 0) {
        __threadfence();
        is_last = atomicAdd(p.done, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (is_last && tid == 0) {
        __threadfence();
        const volatile T* pv = static_cast<volatile T*>(p.part_v);
        const volatile int* pi = p.part_i;
        for (int b = 0; b < nb; ++b) {
            const int o = b * gridDim.x;
            T v = pv[o];
            int i = pi[o];
            for (int k = 1; k < (int)gridDim.x; ++k)
                take_first_max(v, i, (T)pv[o + k], (int)pi[o + k]);
            static_cast<T*>(p.score)[b] = v;
            p.last[b] = i;
        }
    }
}

// Mirrored by lnasr_tpu_torch/ops/trigram.py:forward_smem_bytes: on the
// "smem" route each of the B utterances keeps its rows of two frames.
size_t smem_bytes(int H, int V, int S, int rpb, int itemsize, int route, int B) {
    size_t head = (size_t)rpb * H * itemsize + (size_t)(rpb + 1) * V * sizeof(int);
    if (route == ROUTE_GLOBAL) return head;
    return ((head + 15) & ~(size_t)15) + 2 * (size_t)B * rpb * V * S * itemsize;
}

// -- the resident route --------------------------------------------------------
//
// hop3 is constant for the whole launch, and the hop into copy (u, w) reads
// only its column hop3[:, u, w]. So the H*V copies (h, w), numbered h*V + w,
// are cut into B = min(SMs, H) contiguous ranges of equal length (the last
// block's range holds the <s> row, whose copies no hop enters, with fewer
// hop copies: a range's cost is its copies' within-word pass, done by one
// thread each, and its hop columns, all walked at once), a thread owns one
// copy, and each block loads the hop columns of its copies once, before
// frame 1: the first R_KR sources of each into registers of the copy's
// thread (statically indexed, fully unrolled), the rest into shared memory
// by cp.async. At V = 200 (H = 202), float32, 132 blocks of at most 308
// copies: 80 sources a column in registers (98.6 KB an SM of its 256 KB),
// 122 and two of -inf padding in shared memory (152.8 KB). hop3 is read
// from device memory once a launch; every frame reads its hop sources on
// chip, four at a time (take4).
//
// B <= H keeps every range at least V copies long: then every exit column
// exit[:, u] (copies h*V + u, one a row) holds a word of every block, and a
// block that has read one column of a publication has read a word of every
// block. That is the invariant that lets the exchange keep two buffers
// (the note on the exchange above; with shorter ranges a block could run
// two publications ahead of one whose words it never reads, and overwrite
// them: tests/test_torch_trigram_kernel.py models both). A block reads one
// column for each hop row in its range (at most 3 at V = 200), and column
// 0 when it owns no hop copy.
//
// A frame, in each block: the first exit words each thread reads of the last
// publication are loaded, so that they fly during the within-word pass; the
// within-word pass (a thread its copy's S states, in shared memory, in
// place: all S read before any is written); the rest of the exit columns;
// a barrier; then the
// exits the hop cannot change (all but state 0 of a hop copy) are published
// at once, so that they travel during the hop pass: the block has read all
// of the last publication, so two buffers still suffice; the hop pass; and
// last the exits at state 0 of hop copies. The exit columns alternate
// between two buffers, so no barrier follows the hop pass. The within-word
// pass writes every backpointer of the frame, state 0's from its within
// source; the hop pass overwrites it where the hop wins. Inner transitions
// and states sit at strides R_ASTRIDE and R_GSTRIDE, odd, so that a warp's
// copies read distinct banks at offsets known to the compiler.
//
// Registers: ptxas allocates warps four at a time, so a block of 10 to 12
// warps gets 168 registers a thread; R_KR = 80 is the most that built with
// no spill (88 and 96 spilled), and a block has 12 warps.
constexpr int R_THREADS = 384;  // a block: one thread for each of its copies
constexpr int R_KR = 80;        // hop sources a thread keeps in registers
constexpr int R_SMAX = 8;       // local states a word has at most on this route
constexpr int R_ASTRIDE = R_SMAX * R_SMAX + 1;  // inner_a[w] at a_s + w * R_ASTRIDE
constexpr int R_GSTRIDE = R_SMAX + 1;           // own copy k's states at grid + k * R_GSTRIDE

// One launch's partition: the same shared-memory carve in every block.
struct Layout {
    int blocks;  // min(SMs, H)
    int nhp;     // most hop copies a block owns
    int ncp;     // most copies a block owns
    int ncol;    // most exit columns a block reads
    int hsp;     // a hop column's sources in shared memory (from R_KR on), 4 mod 8 or 0
};

__host__ __device__ __forceinline__ int pad4(int x) { return (x + 3) & ~3; }

// The first copy of block b: block b owns copies [lo(b), lo(b + 1)) of H*V.
__host__ __device__ __forceinline__ int copy_lo(int b, int blocks, int H, int V) {
    return (int)((long long)H * V * b / blocks);
}

// Mirrored by lnasr_tpu_torch/ops/trigram.py:resident_layout.
Layout resident_layout(int H, int V, int n_sm) {
    Layout l{n_sm < H ? n_sm : H, 0, 0, 0, 0};
    for (int b = 0; b < l.blocks; ++b) {
        const int lo = copy_lo(b, l.blocks, H, V), hi = copy_lo(b + 1, l.blocks, H, V);
        const int n_hop = (hi < V * V ? hi : V * V) - lo;  // its copies of rows h < V
        const int ncol = n_hop > 0 ? (lo + n_hop - 1) / V - lo / V + 1 : 1;
        l.nhp = l.nhp > n_hop ? l.nhp : n_hop;
        l.ncp = l.ncp > hi - lo ? l.ncp : hi - lo;
        l.ncol = l.ncol > ncol ? l.ncol : ncol;
    }
    // rows of 4 mod 8 floats: a quarter warp's float4 loads of its copies'
    // rows fall in 8 distinct 16-byte bank groups
    const int rest = pad4(H - R_KR);
    l.hsp = H <= R_KR ? 0 : rest + (rest % 8 == 0 ? 4 : 0);
    return l;
}

// Mirrored by lnasr_tpu_torch/ops/trigram.py:resident_bytes.
size_t resident_smem_bytes(int V, const Layout& l) {
    return 4 * ((size_t)pad4(V) + pad4(V * R_ASTRIDE) + pad4(l.ncp * R_GSTRIDE)
                + (size_t)2 * l.ncol * (R_KR + l.hsp) + (size_t)l.nhp * l.hsp);
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

// out[(j / H) * ht + j % H] = the float of src[j] once its tag is `tag`,
// for j0 + threadIdx.x, j0 + threadIdx.x + blockDim.x, ... < n: exit columns
// of H words into rows of ht floats. Polled as read_exits polls.
__device__ void read_columns(const unsigned long long* src, unsigned tag, int j0, int n, int H,
                             int ht, float* out) {
    const int nth = blockDim.x;
    for (int base = j0 + threadIdx.x; base < n; base += nth * POLL) {
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
                    const int j = base + q * nth, col = j / H;
                    out[col * ht + j - col * H] = __uint_as_float((unsigned)x[q]);
                    pending &= ~(1u << q);
                }
            }
#pragma unroll
            for (int q = 0; q < POLL; ++q)
                if (pending >> q & 1) x[q] = ld_relaxed(src + base + q * nth);
        }
    }
}

// Word j of read_columns, its first load `x` issued earlier: polled again
// until its tag is `tag`.
__device__ __forceinline__ void finish_word(const unsigned long long* src, unsigned long long x,
                                            unsigned tag, int j, int H, int ht, float* out) {
    for (long long round = 0; (unsigned)(x >> 32) != tag; ++round) {
        if (round > SPIN_LIMIT) __trap();
        x = ld_relaxed(src + j);
    }
    const int col = j / H;
    out[col * ht + j - col * H] = __uint_as_float((unsigned)x);
}

// Sources h .. h + 3 (values c0 .. c3) into the running first maximum
// (best, arg) of the sources before h: the first maximum of each pair, of the
// two pairs, then against the earlier sources, each taken only when strictly
// larger. One compare a step of four waits on the one before.
__device__ __forceinline__ void take4(float& best, int& arg, float c0, float c1, float c2,
                                      float c3, int h) {
    const bool p1 = c1 > c0, p3 = c3 > c2;
    const float v01 = p1 ? c1 : c0, v23 = p3 ? c3 : c2;
    const int i01 = h + p1, i23 = h + 2 + p3;
    const bool p23 = v23 > v01;
    const float v = p23 ? v23 : v01;
    if (v > best) {
        best = v;
        arg = p23 ? i23 : i01;
    }
}

// S backpointers of one copy from `bp`, as int4 streaming stores where S is
// a multiple of 4 (then `dst` is 16-byte aligned), else one by one.
__device__ __forceinline__ void store_pointers(int* dst, const int (&bp)[R_SMAX], int S) {
    if ((S & 3) == 0) {
#pragma unroll
        for (int j = 0; j < R_SMAX; j += 4)
            if (j < S)
                __stcs(reinterpret_cast<int4*>(dst + j), make_int4(bp[j], bp[j + 1], bp[j + 2],
                                                                   bp[j + 3]));
    } else {
#pragma unroll
        for (int j = 0; j < R_SMAX; ++j)
            if (j < S) __stcs(dst + j, bp[j]);
    }
}

template <bool BATCH>
__global__ void __launch_bounds__(R_THREADS, 1) trigram_resident_kernel(Args p, Layout l) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ float rv[R_THREADS / 32];
    __shared__ int ri[R_THREADS / 32];
    __shared__ bool last_block;
    const int H = p.H, V = p.V, S = p.S, VS = V * S;
    const int nb = BATCH ? p.B : 1;  // utterances, stepped in turn
    const int tid = threadIdx.x, blk = blockIdx.x;
    const int c0 = copy_lo(blk, l.blocks, H, V);
    const int n_c = copy_lo(blk + 1, l.blocks, H, V) - c0;  // copies: c0 .. c0 + n_c - 1
    const int n_hop = max(0, min(n_c, V * V - c0));         // hop copies: the first n_hop
    const int u0 = n_hop > 0 ? c0 / V : 0;                  // the first exit column read
    const int n_words = (n_hop > 0 ? (c0 + n_hop - 1) / V - u0 + 1 : 1) * H;  // read a frame
    const int ht = R_KR + l.hsp;                            // a column's padded length
    const size_t VV = (size_t)V * V, frame = (size_t)H * VS;
    const float ninf = -INFINITY;
    const float* log_b = static_cast<const float*>(p.log_b);
    const float* hop3 = static_cast<const float*>(p.hop3);

    int* eidx = reinterpret_cast<int*>(smem);               // [V]
    float* a_s = reinterpret_cast<float*>(eidx + pad4(V));  // inner_a[w, q, j] at w*R_ASTRIDE + q*R_SMAX + j
    float* grid = a_s + pad4(V * R_ASTRIDE);                // copy c0 + k's state j at k*R_GSTRIDE + j
    float* ex = grid + pad4(l.ncp * R_GSTRIDE);             // [2][ncol][ht] exit columns, -inf past H
    float* hs = ex + (size_t)2 * l.ncol * ht;               // [nhp][hsp] hop sources R_KR.. of copy i

    // -- the load: tables, then this block's hop3 columns, once a launch --
    for (int k = tid; k < V; k += R_THREADS) eidx[k] = p.exit_idx[k];
    const float* inner_a = static_cast<const float*>(p.inner_a);
    for (int k = tid; k < V * S * S; k += R_THREADS) {  // divisions here run once a launch
        const int w = k / (S * S), qj = k - w * S * S, q = qj / S;
        a_s[w * R_ASTRIDE + q * R_SMAX + qj - q * S] = inner_a[k];
    }
    for (int k = tid; k < 2 * l.ncol * ht; k += R_THREADS) ex[k] = ninf;
    // this thread's copy c = (hh, w) (when tid < n_c), a hop copy when tid < n_hop
    const bool own = tid < n_c, hopper = tid < n_hop;
    const int c = c0 + min(tid, max(n_c - 1, 0));
    const int hh = c / V, w = c - hh * V;
    float hr[R_KR];  // hop3[h, hh, w], h < R_KR (-inf past H)
#pragma unroll
    for (int h = 0; h < R_KR; ++h) hr[h] = hopper && h < H ? __ldg(hop3 + h * VV + c) : ninf;
    if (hopper) {
        float* col = hs + (size_t)tid * l.hsp;
        for (int q = 0; q < l.hsp; ++q) {
            if (R_KR + q < H) cp_async4(col + q, hop3 + (R_KR + q) * VV + c);
            else col[q] = ninf;
        }
    }
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    const int e_st = eidx[w];                          // its exit state
    const int h_src = hopper ? hh * S + eidx[hh] : 0;  // a hop from history g: g*V*S + h_src
    const int h_ex = (hh - u0) * ht;                   // its exit column's row in ex
    const int xo = w * H + hh;                         // its exit's word in a buffer
    const int self = c * S;
    // its states, state j at g[j * gj]: in shared memory for one utterance;
    // for a batch, utterance b's in a device-memory slab (B, R_SMAX, H*V)
    // that only this thread reads and writes (no other thread needs a
    // fence), a warp's copies side by side so that its loads coalesce
    float* g = grid + tid * R_GSTRIDE;
    const int gj = BATCH ? H * V : 1;
    float* const slab = BATCH ? static_cast<float*>(p.rows) + c : nullptr;
    const size_t slab_utt = (size_t)H * V * R_SMAX;
    const float* a = a_s + w * R_ASTRIDE;

    // frame 0, published with tag 0 (own values: no barrier before it)
    if (own) {
        const float pi = c >= V * V ? static_cast<const float*>(p.log_pi_w)[w] : ninf;
        for (int b = 0; b < nb; ++b) {
            if (BATCH) g = slab + b * slab_utt;
            const float* lw0 = log_b + (size_t)b * p.n_t * VS + w * S;
#pragma unroll
            for (int j = 0; j < R_SMAX; ++j)
                if (j < S) g[j * gj] = (j == 0 ? pi : ninf) + lw0[j];
            st_relaxed(p.xch + (size_t)b * 2 * V * H + xo,
                       (unsigned long long)__float_as_uint(g[e_st * gj]));
        }
    }
    int n_pub = 0;
    unsigned last_pub = 0;  // publications so far - 1, the frame of the last
    // a batch: utterance b's (last_pub << 1) | (n_pub & 1), read and written
    // in its turn; the steps taken, whose parity picks the buffer of ex
    unsigned pubs[BATCH ? MAX_BATCH : 1];
    if (BATCH)
        for (int b = 0; b < nb; ++b) pubs[b] = 0;
    int steps = 0;

    for (int t = 1; t < p.n_t; ++t) {
        for (int b = 0; b < nb; ++b) {
            // this copy's pointers
            int* bt = p.bts + ((size_t)b * (p.n_t - 1) + (t - 1)) * frame + (size_t)self;
            if (p.mask != nullptr && !p.mask[(size_t)b * p.n_t + t]) {
                // identity step: self pointers, nothing published
                if (own) {
                    int bp[R_SMAX];
#pragma unroll
                    for (int j = 0; j < R_SMAX; ++j) bp[j] = self + j;
                    store_pointers(bt, bp, S);
                }
                continue;
            }
            if (BATCH) {
                n_pub = pubs[b] & 1;
                last_pub = pubs[b] >> 1;
                g = slab + b * slab_utt;
            }
            unsigned long long* xch = p.xch + (size_t)b * 2 * V * H;  // this utterance's
            const float* lw = log_b + ((size_t)b * p.n_t + t) * VS + w * S;  // this copy's emissions
            // the first two exit words this thread reads of the last publication:
            // loaded now, so that they fly during the within-word pass
            const unsigned long long* src = xch + ((size_t)(n_pub & 1) * V + u0) * H;
            float* ex_b = ex + (size_t)((BATCH ? steps : n_pub) & 1) * l.ncol * ht;
            unsigned long long x0 = 0, x1 = 0;
            if (tid < n_words) x0 = ld_relaxed(src + tid);
            if (tid + R_THREADS < n_words) x1 = ld_relaxed(src + tid + R_THREADS);
            // -- the within-word pass: state 0 of a hop copy keeps its within
            // value (no emission yet)
            if (own) {
                float gv[R_SMAX];
                int bp[R_SMAX];
#pragma unroll
                for (int q = 0; q < R_SMAX; ++q)
                    if (q < S) gv[q] = g[q * gj];
#pragma unroll
                for (int j = 0; j < R_SMAX; ++j) {
                    if (j < S) {
                        float m = gv[0] + a[j];
                        int src_q = 0;
#pragma unroll
                        for (int q = 1; q < R_SMAX; ++q) {
                            if (q < S) {
                                const float cand = gv[q] + a[q * R_SMAX + j];
                                if (cand > m) {
                                    m = cand;
                                    src_q = q;
                                }
                            }
                        }
                        bp[j] = self + src_q;
                        g[j * gj] = j == 0 && hopper ? m : m + __ldg(lw + j);
                    }
                }
                store_pointers(bt, bp, S);
            }
            // -- the exit columns of the last publication (buffers of ex
            // alternate, so that no barrier is needed after the hop pass)
            if (tid < n_words) finish_word(src, x0, last_pub, tid, H, ht, ex_b);
            if (tid + R_THREADS < n_words)
                finish_word(src, x1, last_pub, tid + R_THREADS, H, ht, ex_b);
            read_columns(src, last_pub, 2 * R_THREADS, n_words, H, ht, ex_b);
            __syncthreads();
            // -- publish the exits the hop cannot change (not at state 0 of a hop
            // copy), so that they travel while the hop pass runs: the block has
            // read all of the last publication, so two buffers still suffice
            unsigned long long* out = xch + (size_t)((n_pub + 1) & 1) * V * H;
            const unsigned long long tag = (unsigned long long)t << 32;
            if (own && (!hopper || e_st != 0))
                st_relaxed(out + xo, tag | __float_as_uint(g[e_st * gj]));
            // -- the hop pass: the H sources of this thread's copy, on chip
            if (hopper) {
                const float emit0 = __ldg(lw);
                const float* e = ex_b + h_ex;
                float bv = ninf;  // the first maximum over the sources so far
                int ba = 0;
#pragma unroll
                for (int h = 0; h < R_KR; h += 4) {
                    const float4 ev = *reinterpret_cast<const float4*>(e + h);
                    take4(bv, ba, ev.x + hr[h], ev.y + hr[h + 1], ev.z + hr[h + 2],
                          ev.w + hr[h + 3], h);
                }
                const float* col = hs + (size_t)tid * l.hsp;
#pragma unroll 2
                for (int q = 0; q < l.hsp; q += 4) {
                    const float4 xv = *reinterpret_cast<const float4*>(col + q);
                    const float4 ev = *reinterpret_cast<const float4*>(e + R_KR + q);
                    take4(bv, ba, ev.x + xv.x, ev.y + xv.y, ev.z + xv.z, ev.w + xv.w, R_KR + q);
                }
                float m = g[0];
                if (bv > m) {  // the hop, only when strictly better than within
                    m = bv;
                    __stcs(bt, ba * VS + h_src);
                }
                g[0] = m + emit0;
                // -- and publish the exit at state 0 of a hop copy
                if (e_st == 0) st_relaxed(out + xo, tag | __float_as_uint(g[0]));
            }
            if (BATCH) {
                pubs[b] = (unsigned)t << 1 | ((n_pub + 1) & 1);
                ++steps;
            } else {
                ++n_pub;
                last_pub = (unsigned)t;
            }
        }
    }

    // the final argmax of each utterance: grid + final3 at each word's exit
    // state, -inf elsewhere; the first flattened state of the maximum
    for (int b = 0; b < nb; ++b) {
        if (BATCH) g = slab + b * slab_utt;
        float bv = ninf;
        int bi = INT_MAX;
        if (own) {
            const float f = static_cast<const float*>(p.final3)[c];
#pragma unroll
            for (int j = 0; j < R_SMAX; ++j)
                if (j < S) take_first_max(bv, bi, g[j * gj] + (j == e_st ? f : ninf), self + j);
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const float ov = __shfl_xor_sync(0xffffffffu, bv, off);
            const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
            take_first_max(bv, bi, ov, oi);
        }
        if ((tid & 31) == 0) {
            rv[tid >> 5] = bv;
            ri[tid >> 5] = bi;
        }
        __syncthreads();
        if (tid == 0) {
            for (int k = 1; k < R_THREADS / 32; ++k) take_first_max(bv, bi, rv[k], ri[k]);
            static_cast<float*>(p.part_v)[b * gridDim.x + blk] = bv;
            p.part_i[b * gridDim.x + blk] = bi;
        }
        if (BATCH) __syncthreads();  // rv and ri serve the next utterance
    }
    if (tid == 0) {
        __threadfence();
        last_block = atomicAdd(p.done, 1u) == gridDim.x - 1;
    }
    __syncthreads();
    if (last_block && tid == 0) {
        __threadfence();
        const volatile float* pv = static_cast<volatile float*>(p.part_v);
        const volatile int* pi = p.part_i;
        for (int b = 0; b < nb; ++b) {
            const int o = b * gridDim.x;
            float v = pv[o];
            int i = pi[o];
            for (int k = 1; k < (int)gridDim.x; ++k)
                take_first_max(v, i, (float)pv[o + k], (int)pi[o + k]);
            static_cast<float*>(p.score)[b] = v;
            p.last[b] = i;
        }
    }
}

template <bool BATCH>
cudaError_t launch_resident(const Args& a, const Layout& l, size_t smem, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(trigram_resident_kernel<BATCH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    void* params[] = {const_cast<Args*>(&a), const_cast<Layout*>(&l)};
    return cudaLaunchCooperativeKernel((const void*)trigram_resident_kernel<BATCH>, dim3(l.blocks),
                                       dim3(R_THREADS), params, smem, stream);
}

template <typename T, int ROUTE, bool BATCH>
cudaError_t launch(const Args& a, int blocks, size_t smem, cudaStream_t stream) {
    cudaError_t err = cudaFuncSetAttribute(trigram_forward_kernel<T, ROUTE, BATCH>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    void* params[] = {const_cast<Args*>(&a)};
    return cudaLaunchCooperativeKernel((const void*)trigram_forward_kernel<T, ROUTE, BATCH>,
                                       dim3(blocks), dim3(THREADS), params, smem, stream);
}

// The row routes' instantiation for one utterance, or for a batch.
template <typename T, int ROUTE>
cudaError_t launch_rows(const Args& a, int blocks, size_t smem, cudaStream_t stream) {
    return a.B > 1 ? launch<T, ROUTE, true>(a, blocks, smem, stream)
                   : launch<T, ROUTE, false>(a, blocks, smem, stream);
}

}  // namespace

// One launch over B utterances (1 <= B <= MAX_BATCH), every array as Args
// lists it, contiguous. `rows` is the global route's scratch, and the
// resident route's copy states when B > 1.
extern "C" int trigram_forward_launch(const void* log_b, const uint8_t* mask, const void* inner_a,
                                      const void* hop3, const void* log_pi_w, const void* final3,
                                      const int* exit_idx, int B, int T, int H, int V, int S,
                                      int is_double, int route, int n_sm, int* bts, void* score,
                                      int* last, unsigned long long* xch, void* rows, void* part_v,
                                      int* part_i, unsigned* done, void* stream) {
    if (B < 1 || B > MAX_BATCH || T < 1 || V < 1 || S < 1 || H != V + 1 || n_sm < 1)
        return (int)cudaErrorInvalidValue;
    if (route != ROUTE_SMEM && route != ROUTE_RESIDENT && (route != ROUTE_GLOBAL || rows == nullptr))
        return (int)cudaErrorInvalidValue;
    if (route == ROUTE_RESIDENT && B > 1 && rows == nullptr) return (int)cudaErrorInvalidValue;
    const int rpb = (H + n_sm - 1) / n_sm;
    const int itemsize = is_double ? 8 : 4;
    Layout l{};
    int blocks;
    size_t smem;
    if (route == ROUTE_RESIDENT) {  // float32, S <= R_SMAX, within its thread counts
        l = resident_layout(H, V, n_sm);
        if (is_double || S > R_SMAX || l.ncp > R_THREADS)
            return (int)cudaErrorInvalidValue;
        blocks = l.blocks;
        smem = resident_smem_bytes(V, l);
    } else {
        blocks = (H + rpb - 1) / rpb;
        smem = smem_bytes(H, V, S, rpb, itemsize, route, B);
    }
    if (smem + SMEM_STATIC > (size_t)SMEM_LIMIT) return (int)cudaErrorInvalidValue;
    const cudaStream_t st = (cudaStream_t)stream;
    // tag 0xffffffff in every word: no frame's (see the note on the exchange)
    cudaError_t err = cudaMemsetAsync(xch, 0xff, (size_t)B * 2 * V * H * (is_double ? 2 : 1)
                                      * sizeof(unsigned long long), st);
    if (err == cudaSuccess) err = cudaMemsetAsync(done, 0, sizeof(unsigned), st);
    if (err != cudaSuccess) return (int)err;
    Args a{log_b, mask, inner_a, hop3, log_pi_w, final3, exit_idx, bts, score, last, xch, rows,
           part_v, part_i, done, T, H, V, S, rpb, B};
    if (route == ROUTE_RESIDENT)
        err = B > 1 ? launch_resident<true>(a, l, smem, st) : launch_resident<false>(a, l, smem, st);
    else if (is_double)
        err = route == ROUTE_SMEM ? launch_rows<double, ROUTE_SMEM>(a, blocks, smem, st)
                                  : launch_rows<double, ROUTE_GLOBAL>(a, blocks, smem, st);
    else
        err = route == ROUTE_SMEM ? launch_rows<float, ROUTE_SMEM>(a, blocks, smem, st)
                                  : launch_rows<float, ROUTE_GLOBAL>(a, blocks, smem, st);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaGetLastError();
}

extern "C" const char* trigram_forward_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
