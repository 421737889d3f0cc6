// The streaming pipeline's decoder stage for Hopper (sm_90a): one launch
// steps the carried trellis vector alpha through every frame of an arrived
// chunk of emissions, in the max-plus semiring (with first-argmax
// backpointers) or the log semiring; a second entry walks the backpointers
// of the whole utterance from the final argmax.
//
// Replaces the decoder stage of lnasr_tpu/parallel/pipeline.py: trellis_step
// (:119-131), scanned over each arrived chunk (:151) inside the tick scan
// (:164), all in the jitted shard_map (:172), which XLA runs as one device
// program; and the walk, one reverse lax.scan (:231-238). No Pallas kernel.
// The port's plain versions are ops/trellis.py:trellis_chunk_plain (a frame
// loop of tensor ops) and pointer_walk_plain (a host loop after one copy),
// which these kernels are held to: the max-plus alpha and pointers and the
// walk bit for bit, the log semiring within G's bars.
//
// trellis_chunk_launch. Row r of the chunk is frame pos0 + r of the
// utterance. Frame 0 gives alpha = log_pi + log_b[0] and the pointers
// arange(N) (JAX's trellis_step, not kernel K's zero row); every other frame
// gives alpha'[j] = max_i(alpha[i] + A[i, j]) + log_b[r, j], each candidate
// formed with one rounding, the maximum taken with a strict > over ascending
// i so that ties keep the first index (the pointer), then the emission
// added: the bits of torch.amax and torch.argmax over the same candidates.
// The log semiring takes torch.logsumexp's shift: m = the maximum, m = 0
// where it is -inf, log(sum_i exp(c_i - m)) + m with the sum accumulated in
// float64, so an all--inf column (left-to-right models, GMMHMM.
// init_left_to_right) gives -inf, never NaN. The pointer rows go straight
// into the caller's slice of the utterance's backpointers when it asks for
// them. float32 and float64; expf/logf and exp/log, no --use_fast_math, no
// atomics.
//
// Three routes, by N and semiring (the host's ops/trellis.py:
// trellis_chunk_route; a route is a launch argument, so a caller can force
// one):
//
// - chunked (the log semiring, N <= 8: the pipeline's scores). Kernel G's
//   time-chunked design (csrc/forward_backward.cu, phases 1-2): the chunk's
//   stepped rows (all of them, or rows 1... when row 0 is frame 0) are cut
//   into C pieces of L (ops/trellis.py:stage_pieces, C ~ L ~ sqrt(rows),
//   C <= 32), a warp a piece. Phase 1: warp c forms its piece's operator
//   product, M_r[i, j] = A[i, j] + log_b[r, j] composed in the
//   (logsumexp, +) semiring from the identity (so -inf entries match the
//   frame loop's), lane (row, col) holding one entry, two rows a lane past
//   N = 5; the piece's emissions stream through two shared-memory tiles of
//   32 rows by cp.async, off the chain. Phase 2: warp 0 carries alpha
//   through the C products, the next product's column read ahead. Only the
//   chunk's final alpha leaves the kernel, so the chain is L + C steps
//   deep (22 at a chunk of 111 rows, not 111). Every value is carried in
//   float64 for both types, exps summed in a fixed pairwise order, and
//   rounded to the working type once, at the end. With pointers asked for,
//   phase 3 replays each piece from the state phase 2 left at its start
//   (lane = state): the candidates are formed in the working type from
//   that state rounded to it, the pointer their first argmax; alpha is
//   still phase 2's, so it has the same bits with and without pointers.
// - warp (N <= 32): one warp, lane j = target state j, the column A[:, j]
//   in registers; a step is N shuffles of alpha, N adds, a balanced
//   (value, index) tree whose ties keep the lower index (kernel K's warp
//   route, csrc/viterbi_trellis.cu:213; N <= 8 exact, 16 and 32 padded
//   with -inf), then the emission's add (the log semiring: N exps and a
//   log on the chain). The emissions of the next group of G rows load into
//   registers while the current group is stepped.
// - block (33 <= N <= 1024): one block, thread j = target j, alpha
//   double-buffered in shared memory (one barrier a step), the column read
//   through L1, a linear scan over i; the next row's emission loads one
//   step ahead.
//
// pointer_walk_launch. The first argmax of alpha by one warp (a strided
// scan, then a (value, index) butterfly keeping the lower index), then
// path[T-1] = that state and path[t] = bt[t+1][path[t+1]] down to t = 0.
// Two routes (ops/trellis.py:walk_route):
//
// - maps (N <= 1024): kernel K's and B's chunk-map backtrace
//   (csrc/viterbi_trellis.cu:143-203). The T - 1 pointer rows are cut into
//   C chunks of L (ops/trellis.py:walk_chunks, C ~ sqrt(2 (T - 1)) while
//   the int16 maps fit); (a) the threads walk chunk c from each end state
//   e at once and record its start state in maps[c][e]; (b) one thread
//   composes the maps from the last chunk down, one shared load a chunk;
//   (c) each chunk is walked again from its known end state and writes its
//   part of the path. The rows are staged into shared memory as int16 while
//   the warp 0 takes the argmax, where T N of them fit (walk_staged), else
//   read through L1. Index-following only, so exact; the chain is 2 L + C
//   deep (90 at T = 999, not 998).
// - chase (N > 1024): one thread chases the pointers through memory, as
//   csrc/trigram_backtrace.cu does.
//
// What bounds them on an H100: at the pipeline's geometry (T = 999 in 9
// chunks of 111, N = 5, float64) a chunk moves 4.4 KB of emissions, 200 B of
// transitions and 2.2 KB of pointers, ~2 ns at 3.35 TB/s, and does
// 2 N^2 + N operations a frame (5 N^2 + 3 N in the log semiring; the
// chunked route's products N times that); neither is the limit. A chunk is
// a chain of dependent steps (shuffles, a tree of compares, two adds; an
// exp and a log more in the log semiring), and the walk a chain of loads,
// so each costs its depth times one step's latency: the designs cut the
// depth and keep loads and stores off the chain.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_INDEX = 1 << 30;  // loses every tie of the final argmax
constexpr int ROUTE_WARP = 0, ROUTE_BLOCK = 1, ROUTE_CHUNKED = 2;  // ops/trellis.py:STAGE_ROUTES
constexpr int CHUNKED_MAX_N = 8;   // the chunked route's states
constexpr int MAX_PIECES = 32;     // the chunked route's pieces (warps of its block), at most
constexpr int TILE = 32;           // the chunked route's rows a shared-memory tile
constexpr int WALK_MAPS = 0, WALK_CHASE = 1;  // ops/trellis.py:WALK_ROUTES
constexpr int WALK_MAX_N = 1024;   // the map route's states: int16 maps

struct Args {
    const void* alpha;   // (N,) the carried vector; unread when row 0 is frame 0
    const void* log_pi;  // (N,)
    const void* log_a;   // (N, N)
    const void* log_b;   // (chunk, N)
    int pos0, chunk, N, log_semiring;
    int piece;           // chunked route: rows a piece (L)
    void* alpha_out;     // (N,)
    int* bt;             // (chunk, N), or null: no pointers asked for
};

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }
__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }

// the log-semiring value of candidates whose maximum is m: the shift, the
// sum of exp(c - shift) in float64, its log in the working type
template <typename R>
__device__ __forceinline__ R shift_of(R m) { return m == -INFINITY ? R(0) : m; }
template <typename R>
__device__ __forceinline__ R lse_close(R m, R shift, double sum) {
    return m == -INFINITY ? m : add_rn(shift, (R)log(sum));
}

// first-index argmax of c[LO..HI) as a balanced tree; ties keep the lower
template <int LO, int HI, typename R, int NMAX>
__device__ __forceinline__ void tree_argmax(const R (&c)[NMAX], R& bv, int& bi) {
    if constexpr (HI - LO == 1) {
        bv = c[LO];
        bi = LO;
    } else {
        constexpr int MID = LO + (HI - LO + 1) / 2;
        R lv, rv;
        int li, ri;
        tree_argmax<LO, MID>(c, lv, li);
        tree_argmax<MID, HI>(c, rv, ri);
        const bool right = rv > lv;
        bv = right ? rv : lv;
        bi = right ? ri : li;
    }
}

// the warp's (value, index) maximum, the lower index on ties, on every lane
template <typename R>
__device__ __forceinline__ void warp_argmax(R& bv, int& bi) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const R ov = __shfl_xor_sync(FULL, bv, off);
        const int oi = __shfl_xor_sync(FULL, bi, off);
        if (ov > bv || (ov == bv && oi < bi)) {
            bv = ov;
            bi = oi;
        }
    }
}

// rows of emissions a group of the warp route: a register each for the
// rows of this group and of the next
template <typename R>
__host__ __device__ constexpr int group() { return sizeof(R) == 4 ? 32 : 16; }

// warp route: NMAX candidates a step (= N when EXACT)
template <typename R, int NMAX, bool EXACT>
__global__ void __launch_bounds__(32) warp_kernel(Args a) {
    constexpr int G = group<R>();
    const int N = EXACT ? NMAX : a.N;
    const int chunk = a.chunk;
    const int lane = threadIdx.x;
    const bool on = lane < N;
    const R NEG_INF = -INFINITY;
    const R* la = static_cast<const R*>(a.log_a);
    const R* lb = static_cast<const R*>(a.log_b);

    R col[NMAX];  // column j = lane of the transition matrix
#pragma unroll
    for (int i = 0; i < NMAX; ++i) col[i] = (on && i < N) ? la[i * N + lane] : NEG_INF;
    const R pi = on ? static_cast<const R*>(a.log_pi)[lane] : NEG_INF;
    R v = (on && a.pos0 > 0) ? static_cast<const R*>(a.alpha)[lane] : NEG_INF;

    R cur[G], nxt[G];
#pragma unroll
    for (int k = 0; k < G; ++k) cur[k] = (on && k < chunk) ? lb[(size_t)k * N + lane] : R(0);
    for (int r0 = 0; r0 < chunk; r0 += G) {
#pragma unroll
        for (int k = 0; k < G; ++k) {
            const int r = r0 + G + k;
            nxt[k] = (on && r < chunk) ? lb[(size_t)r * N + lane] : R(0);
        }
#pragma unroll
        for (int k = 0; k < G; ++k) {
            const int r = r0 + k;
            if (r >= chunk) break;  // uniform across the warp
            R c[NMAX];
#pragma unroll
            for (int i = 0; i < NMAX; ++i) c[i] = add_rn(__shfl_sync(FULL, v, i), col[i]);
            R best;
            int arg;
            tree_argmax<0, NMAX>(c, best, arg);
            if (a.log_semiring) {
                const R shift = shift_of(best);
                double sum = 0.0;
#pragma unroll
                for (int i = 0; i < NMAX; ++i) sum += (double)ex(sub_rn(c[i], shift));
                best = lse_close(best, shift, sum);
            }
            const bool start = a.pos0 + r == 0;  // frame 0: log_pi, pointers to themselves
            v = add_rn(start ? pi : best, cur[k]);
            if (a.bt && on) a.bt[(size_t)r * N + lane] = start ? lane : arg;
        }
#pragma unroll
        for (int k = 0; k < G; ++k) cur[k] = nxt[k];
    }
    if (on) static_cast<R*>(a.alpha_out)[lane] = v;
}

// block route: a thread a target state, alpha double-buffered in shared memory
template <typename R>
__global__ void __launch_bounds__(1024) block_kernel(Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int N = a.N, chunk = a.chunk;
    const int j = threadIdx.x;
    const bool on = j < N;
    R* vbuf = reinterpret_cast<R*>(smem);  // (2, N)
    const R* __restrict__ la = static_cast<const R*>(a.log_a);
    const R* lb = static_cast<const R*>(a.log_b);

    const R pi = on ? static_cast<const R*>(a.log_pi)[j] : R(0);
    R v = 0;
    if (on) vbuf[j] = a.pos0 > 0 ? static_cast<const R*>(a.alpha)[j] : R(-INFINITY);
    R nb = on ? lb[j] : R(0);
    __syncthreads();
    for (int r = 0; r < chunk; ++r) {
        const R* vp = vbuf + (r & 1) * N;
        R* vq = vbuf + ((r + 1) & 1) * N;
        const R cb = nb;
        if (r + 1 < chunk) nb = on ? lb[(size_t)(r + 1) * N + j] : R(0);  // off the chain
        if (on) {
            int arg = j;
            R best = pi;
            if (a.pos0 + r != 0) {
                best = add_rn(vp[0], __ldg(la + j));
                arg = 0;
                for (int i = 1; i < N; ++i) {
                    const R c = add_rn(vp[i], __ldg(la + (size_t)i * N + j));
                    if (c > best) {
                        best = c;
                        arg = i;
                    }
                }
                if (a.log_semiring) {
                    const R shift = shift_of(best);
                    double sum = 0.0;
                    for (int i = 0; i < N; ++i)
                        sum += (double)ex(sub_rn(add_rn(vp[i], __ldg(la + (size_t)i * N + j)),
                                                 shift));
                    best = lse_close(best, shift, sum);
                }
            }
            v = add_rn(best, cb);
            vq[j] = v;
            if (a.bt) a.bt[(size_t)r * N + j] = arg;
        }
        __syncthreads();
    }
    if (on) static_cast<R*>(a.alpha_out)[j] = v;
}

// -- the chunked route: the log semiring as a product scan (N <= 8) --------------

__device__ __forceinline__ void cp_async(float* dst, const float* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async(double* dst, const double* src) {
    const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
__device__ __forceinline__ void cp_wait_all_but_one() {
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}
__device__ __forceinline__ void cp_wait_all() { asm volatile("cp.async.wait_group 0;\n" ::: "memory"); }

// the sum of e[LO..HI) in a fixed pairwise order
template <int LO, int HI, int NN>
__device__ __forceinline__ double pair_sum(const double (&e)[NN]) {
    if constexpr (HI - LO == 1) {
        return e[LO];
    } else {
        constexpr int MID = LO + (HI - LO + 1) / 2;
        return __dadd_rn(pair_sum<LO, MID>(e), pair_sum<MID, HI>(e));
    }
}

// the maximum of x[LO..HI) as a balanced tree
template <int LO, int HI, int NN>
__device__ __forceinline__ double tree_max(const double (&x)[NN]) {
    if constexpr (HI - LO == 1) {
        return x[LO];
    } else {
        constexpr int MID = LO + (HI - LO + 1) / 2;
        const double l = tree_max<LO, MID>(x), r = tree_max<MID, HI>(x);
        return r > l ? r : l;
    }
}

// torch.logsumexp of x[0..NN) in float64: the shift is the maximum, 0 where
// it is -inf (then every term is -inf and so is the result, never NaN)
template <int NN>
__device__ __forceinline__ double lse64(const double (&x)[NN]) {
    const double m = tree_max<0, NN>(x);
    const double shift = m == -INFINITY ? 0.0 : m;
    double e[NN];
#pragma unroll
    for (int i = 0; i < NN; ++i) e[i] = exp(__dsub_rn(x[i], shift));
    return m == -INFINITY ? m : __dadd_rn(shift, log(pair_sum<0, NN>(e)));
}

// One warp's piece: rows [first, first + rows) of the chunk, streamed through
// two tiles of TILE rows in shared memory, tile q into slot q & 1.
template <typename R, int NN>
struct Piece {
    const R* lb;  // the piece's first row of emissions
    R* tiles;     // 2 x TILE x NN of this warp
    int rows, lane;

    __device__ __forceinline__ int tiles_n() const { return (rows + TILE - 1) / TILE; }
    __device__ __forceinline__ int count(int q) const {
        const int left = rows - q * TILE;
        return left < TILE ? left : TILE;
    }
    __device__ __forceinline__ R* slot(int q) const { return tiles + (q & 1) * TILE * NN; }
    // start the copies of tile q into its slot (one commit group)
    __device__ __forceinline__ void issue(int q) const {
        const R* src = lb + (size_t)q * TILE * NN;
        R* dst = slot(q);
        for (int e = lane; e < count(q) * NN; e += 32) cp_async(dst + e, src + e);
        cp_commit();
    }
    // wait for tile q (tile q + 1 may still be in flight)
    __device__ __forceinline__ void wait(int q) const {
        if (q + 1 < tiles_n()) {
            cp_wait_all_but_one();
        } else {
            cp_wait_all();
        }
        __syncwarp();
    }
};

template <typename R, int NN>
__global__ void __launch_bounds__(32 * MAX_PIECES, 1) chunked_kernel(Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int C = blockDim.x / 32, L = a.piece;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const double NEG_INF = -INFINITY;
    double* prod = reinterpret_cast<double*>(smem);  // C x NN x NN: the pieces' products
    double* bound = prod + (size_t)C * NN * NN;      // C x NN: alpha entering piece c
    R* tiles = reinterpret_cast<R*>(bound + (size_t)C * NN);  // C x 2 x TILE x NN
    const R* la = static_cast<const R*>(a.log_a);
    const R* lb = static_cast<const R*>(a.log_b);

    // the stepped rows: all of the chunk's, or rows 1... when row 0 is frame 0
    const int first = a.pos0 == 0 ? 1 : 0;
    Piece<R, NN> pc;
    {
        const int ks = first + warp * L;
        const int left = a.chunk - ks;
        pc.rows = left < 0 ? 0 : (left < L ? left : L);
        pc.lb = lb + (size_t)ks * NN;
    }
    pc.tiles = tiles + (size_t)warp * 2 * TILE * NN;
    pc.lane = lane;
    const int nt = pc.tiles_n();
    const bool resident = nt <= 2;  // phase 3 finds the piece's tiles as phase 1 left them
    if (nt > 0) pc.issue(0);
    if (nt > 1) pc.issue(1);

    // -- phase 1: the piece's product, lane (row, col), RPH rows a half ---------
    {
        constexpr int RPH = 32 / NN;
        constexpr int H = (NN + RPH - 1) / RPH;
        const int col = lane % NN, base = lane - col;
        double m[NN];  // column col of A
#pragma unroll
        for (int i = 0; i < NN; ++i) m[i] = (double)la[i * NN + col];
        double P[H];  // rows h RPH + lane / NN, from the identity
#pragma unroll
        for (int h = 0; h < H; ++h) P[h] = (h * RPH + lane / NN == col) ? 0.0 : NEG_INF;
        for (int q = 0; q < nt; ++q) {
            pc.wait(q);
            const R* tile = pc.slot(q);
            const int cnt = pc.count(q);
            for (int r = 0; r < cnt; ++r) {
                const double bv = (double)tile[r * NN + col];
#pragma unroll
                for (int h = 0; h < H; ++h) {
                    double x[NN];
#pragma unroll
                    for (int i = 0; i < NN; ++i) x[i] = __dadd_rn(__shfl_sync(FULL, P[h], base + i), m[i]);
                    P[h] = __dadd_rn(lse64<NN>(x), bv);
                }
            }
            if (!resident && q + 2 < nt) {
                __syncwarp();
                pc.issue(q + 2);
            }
        }
        double* out = prod + (size_t)warp * NN * NN;
#pragma unroll
        for (int h = 0; h < H; ++h) {
            const int row = h * RPH + lane / NN;
            if (lane < RPH * NN && row < NN) out[row * NN + col] = P[h];
        }
    }
    __syncthreads();

    // -- phase 2: alpha through the products, v'[l] = lse_k(v[k] + P_c[k, l]) ---
    if (warp == 0) {
        const bool on = lane < NN;
        const int l = on ? lane : 0;
        double v = NEG_INF;
        if (on) {
            v = first ? (double)add_rn(static_cast<const R*>(a.log_pi)[lane], lb[lane])
                      : (double)static_cast<const R*>(a.alpha)[lane];
        }
        double nxt[NN];  // the column of the next product, read ahead of the chain
#pragma unroll
        for (int k = 0; k < NN; ++k) nxt[k] = prod[k * NN + l];
        for (int c = 0; c < C; ++c) {
            if (on) bound[c * NN + lane] = v;
            double x[NN];
#pragma unroll
            for (int k = 0; k < NN; ++k) x[k] = nxt[k];
            if (c + 1 < C) {
                const double* pn = prod + (size_t)(c + 1) * NN * NN;
#pragma unroll
                for (int k = 0; k < NN; ++k) nxt[k] = pn[k * NN + l];
            }
#pragma unroll
            for (int k = 0; k < NN; ++k) x[k] = __dadd_rn(__shfl_sync(FULL, v, k), x[k]);
            v = lse64<NN>(x);
        }
        if (on) static_cast<R*>(a.alpha_out)[lane] = (R)v;
        if (a.bt && first && on) a.bt[lane] = lane;  // frame 0 points to itself
    }
    if (!a.bt) return;
    __syncthreads();

    // -- phase 3 (pointers asked for): replay the piece, lane = state ------------
    const bool on = lane < NN;
    R colr[NN];
    double cold[NN];
#pragma unroll
    for (int i = 0; i < NN; ++i) {
        colr[i] = la[i * NN + (on ? lane : 0)];
        cold[i] = (double)colr[i];
    }
    double st = on ? bound[warp * NN + lane] : NEG_INF;
    if (!resident) {
        pc.issue(0);
        if (nt > 1) pc.issue(1);
    }
    int* bt = a.bt + (size_t)(first + warp * L) * NN;
    for (int q = 0; q < nt; ++q) {
        pc.wait(q);
        const R* tile = pc.slot(q);
        const int cnt = pc.count(q);
        for (int r = 0; r < cnt; ++r) {
            const R vr = (R)st;
            R c[NN];
            double x[NN];
#pragma unroll
            for (int i = 0; i < NN; ++i) {
                c[i] = add_rn(__shfl_sync(FULL, vr, i), colr[i]);
                x[i] = __dadd_rn(__shfl_sync(FULL, st, i), cold[i]);
            }
            R best;
            int arg;
            tree_argmax<0, NN>(c, best, arg);
            st = __dadd_rn(lse64<NN>(x), on ? (double)tile[r * NN + lane] : 0.0);
            if (on) bt[(size_t)(q * TILE + r) * NN + lane] = arg;
        }
        if (!resident && q + 2 < nt) {
            __syncwarp();
            pc.issue(q + 2);
        }
    }
}

// shared memory of the chunked route: products, boundaries, tiles
template <typename R, int NN>
size_t chunked_smem(int pieces) {
    return (size_t)pieces * (NN * NN + NN) * sizeof(double) +
           (size_t)pieces * 2 * TILE * NN * sizeof(R);
}

template <typename R, int NN>
int launch_chunked(const Args& a, int pieces, cudaStream_t s) {
    const size_t smem = chunked_smem<R, NN>(pieces);
    cudaError_t err = cudaFuncSetAttribute(chunked_kernel<R, NN>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    chunked_kernel<R, NN><<<1, 32 * pieces, smem, s>>>(a);
    return (int)cudaGetLastError();
}

template <typename R>
int launch_chunk(const Args& a, int route, cudaStream_t s) {
    if (route == ROUTE_CHUNKED) {
        const int first = a.pos0 == 0 ? 1 : 0;
        const int steps = a.chunk - first;
        const int pieces = steps < 1 ? 1 : (steps + a.piece - 1) / a.piece;
        if (!a.log_semiring || a.N > CHUNKED_MAX_N || a.piece < 1 || pieces > MAX_PIECES)
            return (int)cudaErrorInvalidValue;
        switch (a.N) {
            case 1: return launch_chunked<R, 1>(a, pieces, s);
            case 2: return launch_chunked<R, 2>(a, pieces, s);
            case 3: return launch_chunked<R, 3>(a, pieces, s);
            case 4: return launch_chunked<R, 4>(a, pieces, s);
            case 5: return launch_chunked<R, 5>(a, pieces, s);
            case 6: return launch_chunked<R, 6>(a, pieces, s);
            case 7: return launch_chunked<R, 7>(a, pieces, s);
            default: return launch_chunked<R, 8>(a, pieces, s);
        }
    }
    if (route == ROUTE_BLOCK) {
        const int threads = (a.N + 31) / 32 * 32;
        block_kernel<R><<<1, threads, 2 * (size_t)a.N * sizeof(R), s>>>(a);
        return (int)cudaGetLastError();
    }
    if (route != ROUTE_WARP || a.N > 32) return (int)cudaErrorInvalidValue;
#define EXACT_N(n) \
    case n: warp_kernel<R, n, true><<<1, 32, 0, s>>>(a); break;
    switch (a.N) {
        EXACT_N(1) EXACT_N(2) EXACT_N(3) EXACT_N(4) EXACT_N(5) EXACT_N(6) EXACT_N(7) EXACT_N(8)
        default:
            if (a.N <= 16) warp_kernel<R, 16, false><<<1, 32, 0, s>>>(a);
            else warp_kernel<R, 32, false><<<1, 32, 0, s>>>(a);
    }
#undef EXACT_N
    return (int)cudaGetLastError();
}

// -- the walk -------------------------------------------------------------------

// the first argmax of alpha on one warp (lane l scans l, l + 32, ... with a
// strict >, then the butterfly keeps the lower index), on every lane
template <typename R>
__device__ __forceinline__ int first_argmax(const R* __restrict__ alpha, int N, int lane) {
    R bv = lane < N ? alpha[lane] : R(-INFINITY);
    int bi = lane < N ? lane : NO_INDEX;
    for (int i = lane + 32; i < N; i += 32) {
        const R x = alpha[i];
        if (x > bv) {
            bv = x;
            bi = i;
        }
    }
    warp_argmax(bv, bi);
    return bi;
}

// pointer (t, s): the int16 copy in shared memory (STAGED, T N < 2^31),
// else the int32 input through L1
template <bool STAGED>
struct Rows {
    const int16_t* staged;
    const int* global;
    int N;
    __device__ __forceinline__ int operator()(int t, int s) const {
        if constexpr (STAGED) {
            return staged[t * N + s];
        } else {
            return __ldg(global + (size_t)t * N + s);
        }
    }
};

// map route: chunk c covers the pointer rows (c L, min((c + 1) L, T - 1)];
// W chunk walks interleaved a thread in step (a)
template <typename R, bool STAGED, int W>
__global__ void __launch_bounds__(1024) walk_maps_kernel(const R* __restrict__ alpha, int N,
                                                         const int* __restrict__ bt, int T,
                                                         int n_chunks, int L,
                                                         int* __restrict__ path) {
    extern __shared__ __align__(16) unsigned char smem[];
    __shared__ int last;
    int16_t* maps = reinterpret_cast<int16_t*>(smem);  // (C, N): chunk c's start from end e
    int16_t* ends = maps + (size_t)n_chunks * N;       // (C,): chunk c's end state
    int16_t* rows = ends + n_chunks;                   // (T, N) when STAGED
    const int tid = threadIdx.x, nthr = blockDim.x;
    if constexpr (STAGED) {  // row 0 is never read
        const int total = T * N;
#pragma unroll 4
        for (int e = N + tid; e < total; e += nthr) rows[e] = (int16_t)bt[e];
    }
    if (tid < 32) {
        const int s = first_argmax(alpha, N, tid);
        if (tid == 0) {
            last = s;
            path[T - 1] = s;
        }
    }
    __syncthreads();
    const Rows<STAGED> bp{rows, bt, N};
    // (a) each chunk from each end state e at its top row back to frame c L
    const int n_walks = n_chunks * N;
    for (int w0 = 0; w0 < n_walks; w0 += nthr * W) {
        int s[W], top[W], low[W];
#pragma unroll
        for (int q = 0; q < W; ++q) {
            const int w = w0 + tid + nthr * q;
            const int c = w / N;
            s[q] = w - c * N;
            top[q] = w < n_walks ? min((c + 1) * L, T - 1) : 0;
            low[q] = c * L + 1;
        }
#pragma unroll 4
        for (int k = 0; k < L; ++k) {
#pragma unroll
            for (int q = 0; q < W; ++q) {
                const int t = top[q] - k;
                if (t >= low[q]) s[q] = bp(t, s[q]);
            }
        }
#pragma unroll
        for (int q = 0; q < W; ++q) {
            const int w = w0 + tid + nthr * q;
            if (w < n_walks) maps[w] = (int16_t)s[q];
        }
    }
    __syncthreads();
    // (b) each chunk's end state, from the last chunk down
    if (tid == 0 && n_chunks > 0) {
        int e = last;
        ends[n_chunks - 1] = (int16_t)e;
        for (int c = n_chunks - 1; c > 0; --c) {
            e = maps[c * N + e];
            ends[c - 1] = (int16_t)e;
        }
    }
    __syncthreads();
    // (c) the path, every chunk walked again from its end state
    for (int c = tid; c < n_chunks; c += nthr) {
        int s = ends[c];
        const int top = min((c + 1) * L, T - 1), low = c * L + 1;
#pragma unroll 4
        for (int t = top; t >= low; --t) {
            s = bp(t, s);
            path[t - 1] = s;
        }
    }
}

// chase route: the argmax on one warp, then one thread through memory
template <typename R>
__global__ void __launch_bounds__(32) walk_chase_kernel(const R* __restrict__ alpha, int N,
                                                        const int* __restrict__ bt, int T,
                                                        int* __restrict__ path) {
    int s = first_argmax(alpha, N, threadIdx.x);
    if (threadIdx.x != 0) return;
    path[T - 1] = s;
    for (int t = T - 2; t >= 0; --t) {
        s = bt[(size_t)(t + 1) * N + s];
        path[t] = s;
    }
}

template <typename R, bool STAGED, int W>
int launch_maps(const R* alpha, int N, const int* bt, int T, int n_chunks, int L, int threads,
                size_t smem, int* path, cudaStream_t s) {
    cudaError_t err = cudaFuncSetAttribute(walk_maps_kernel<R, STAGED, W>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    walk_maps_kernel<R, STAGED, W><<<1, threads, smem, s>>>(alpha, N, bt, T, n_chunks, L, path);
    return (int)cudaGetLastError();
}

template <typename R, bool STAGED>
int launch_maps(const R* alpha, int N, const int* bt, int T, int n_chunks, int L, int* path,
                cudaStream_t s) {
    const size_t smem = 2 * ((size_t)n_chunks * (N + 1) + (STAGED ? (size_t)T * N : 0));
    const int walks = n_chunks * N;
    const int threads = walks <= 256 ? 256 : (walks >= 1024 ? 1024 : (walks + 31) / 32 * 32);
    if (walks <= threads)
        return launch_maps<R, STAGED, 1>(alpha, N, bt, T, n_chunks, L, threads, smem, path, s);
    if (walks <= 2 * threads)
        return launch_maps<R, STAGED, 2>(alpha, N, bt, T, n_chunks, L, threads, smem, path, s);
    return launch_maps<R, STAGED, 4>(alpha, N, bt, T, n_chunks, L, threads, smem, path, s);
}

template <typename R>
int launch_walk(const R* alpha, int N, const int* bt, int T, int route, int n_chunks, int L,
                int staged, int* path, cudaStream_t s) {
    if (route == WALK_CHASE) {
        walk_chase_kernel<R><<<1, 32, 0, s>>>(alpha, N, bt, T, path);
        return (int)cudaGetLastError();
    }
    if (route != WALK_MAPS || N > WALK_MAX_N || n_chunks < 0 || L < 1 ||
        (long long)n_chunks * L < T - 1 || (staged && (long long)T * N > (1 << 30)))
        return (int)cudaErrorInvalidValue;
    return staged ? launch_maps<R, true>(alpha, N, bt, T, n_chunks, L, path, s)
                  : launch_maps<R, false>(alpha, N, bt, T, n_chunks, L, path, s);
}

}  // namespace

// alpha: the carried (N,) vector, read unless pos0 == 0; pos0: the frame of
// the chunk's row 0; semiring: 0 max, 1 log; route: 0 warp, 1 block,
// 2 chunked; piece: the chunked route's rows a piece; bt: the chunk's
// (chunk, N) int32 pointer rows, or null when they are not wanted
extern "C" int trellis_chunk_launch(const void* alpha, int pos0, const void* log_pi,
                                    const void* log_a, const void* log_b, int chunk, int N,
                                    int semiring, int route, int piece, int is_double,
                                    void* alpha_out, int* bt, void* stream) {
    if (pos0 < 0 || chunk < 1 || N < 1 || N > 1024 || semiring < 0 || semiring > 1)
        return (int)cudaErrorInvalidValue;
    Args a{alpha, log_pi, log_a, log_b, pos0, chunk, N, semiring, piece, alpha_out, bt};
    cudaStream_t s = (cudaStream_t)stream;
    return is_double ? launch_chunk<double>(a, route, s) : launch_chunk<float>(a, route, s);
}

// alpha: the final (N,) vector; bt: the utterance's (T, N) int32 pointers;
// route: 0 maps, 1 chase; n_chunks, piece: the map route's chunks of rows;
// staged: the rows copied into shared memory; path: (T,) int32
extern "C" int pointer_walk_launch(const void* alpha, int N, const int* bt, int T, int route,
                                   int n_chunks, int piece, int staged, int is_double, int* path,
                                   void* stream) {
    if (N < 1 || T < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (is_double)
        return launch_walk(static_cast<const double*>(alpha), N, bt, T, route, n_chunks, piece,
                           staged, path, s);
    return launch_walk(static_cast<const float*>(alpha), N, bt, T, route, n_chunks, piece, staged,
                       path, s);
}

extern "C" const char* trellis_chunk_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
