// Baum-Welch forward-backward recursion for Hopper (sm_90a): alpha, loglik
// and beta of a batch of utterances in one launch, float32 or float64.
//
// Replaces lnasr_tpu/ops/trellis.py:forward_scan (:37) and backward_scan
// (:58): on the TPU they are lax.scans that XLA compiles into one device
// loop under jax.jit (no Pallas kernel); here one launch runs both loops.
// Blocks 0..B-1 run the forward of each utterance and blocks B..2B-1 its
// backward (or only one direction, when the caller asks for one): the two
// directions share nothing, so they run at the same time on different SMs.
//
// Semantics (those of the plain loops, ops/trellis.py:forward_scan_plain and
// backward_scan_plain): alpha[0] = log_pi + log_b[0]; alpha[t, j] =
// lse_i(alpha[t-1, i] + A[i, j]) + log_b[t, j]; loglik = lse(alpha[T-1]);
// beta[T-1] = 0; beta[t, i] = lse_j(A[i, j] + (log_b[t+1, j] + beta[t+1, j]));
// a masked frame t keeps alpha[t] = alpha[t-1], a masked frame t+1 keeps
// beta[t] = beta[t+1]. Both directions are one recursion, out[dst] =
// lse_src(v[src] + M[src, dst]): the forward with M[src, dst] = A[src, dst]
// and v = alpha[t-1], the backward with M[src, dst] = A[dst, src] (A read by
// transposed index, mat<FWD>) and v = log_b[t+1] + beta[t+1]. The logsumexp
// is torch.logsumexp's: m = max, m = 0 where m is infinite, then
// log(sum_src exp(x - m)) + m with the sources in ascending order (on the
// block route for N > 32 the sum is accumulated in float64, see Acc). So an
// all--inf column (left-to-right models are mostly -inf) gives -inf, never
// NaN. expf/logf and exp/log, no --use_fast_math, no atomics: the order of
// every sum is fixed, and two launches on the same input give the same bits.
//
// Routes (ops/trellis.py:fb_route chooses; each also runs the shapes of the
// others, which is how chip_smoke.py checks each route at small N):
//
// - chunked (N <= 8: every EM model and unit).
//   A block of C warps an utterance and direction; the T - 1 steps are cut
//   into C chunks of L (the wrapper's ops/trellis.py:fb_chunks). Phase 1:
//   warp c forms its chunk's operator product in the (logsumexp, +)
//   semiring, the same algebra as lnasr_tpu/parallel/seqscan.py:_chunk_ops
//   (an operator M_t[i, j] = A[i, j] + b[t, j] a valid step, the identity a
//   masked one, so a masked step is skipped); lane (row, col) holds one
//   entry (two rows a lane for N = 6-8), and a step is the lane-per-state
//   step below applied to every row, starting from the identity. Phase 2:
//   warp 0 carries the boundary vector through the C products in shared
//   memory (v_{c+1} = v_c (x) P_c), a C-step chain. Phase 3: warp c replays
//   its L steps from v_c with the lane-per-state step and writes its output
//   rows. The chain is L + C + L steps deep (96 at T = 999, not 998). The
//   chunk's emissions are staged into shared memory by cp.async, 32 frames
//   a tile, two tiles a warp in flight (so T has no capacity limit; a chunk
//   of up to 64 steps stays resident for phase 3), its mask bytes read into
//   a ballot; phase 3 writes its rows into the tile and stores the tile
//   coalesced.
// - warp (N = 9-32): one warp an utterance and direction, lane dst = state
//   dst holds column M[:, dst] in registers, and v[src] comes by
//   __shfl_sync; no barrier in the chain. The emissions and mask bytes of
//   the next STEPS frames are loaded into registers while the current ones
//   are used. The step covers NMAX = 8, 16 or 32 sources, those past N at
//   -inf, which adds exp(-inf) = 0 and so gives the bits of an N-term step.
// - block (N > 32): ceil(N/32) warps (at most 1024 threads, a thread loops
//   over states past that), v double-buffered in shared memory, one
//   __syncthreads a step; M is copied into shared memory where it fits in a
//   block's 227 KB and read through L2 where it does not; v itself is read
//   from the output rows in device memory where even 2 N values do not fit
//   (N > 14,000 at float64). There is no capacity limit on N or T.
//
// What bounds it on an H100: at the flagship sweep (B = 64, T = 999, N = 5,
// float32) it reads 1.3 MB of emissions and writes 2.6 MB of alpha and beta,
// ~1.2 us at 3.35 TB/s, and does ~4 N^2 operations a step and direction
// (N times that in phase 1), far below the fp32 peak. Neither is the limit:
// a step (N shuffles, a max, N exps, a sum, a log) is a chain of dependent
// latencies, so the time is the depth of the chain times one step. The
// warp route walks all T - 1 = 998 steps of a direction in order, on 128
// warps of a 132-SM card; the chunked route cuts the depth to L + C + L and
// spreads each direction over C warps of its own SM.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int STEPS = 8;  // warp route: frames of emissions and mask prefetched at once
constexpr int TILE = 32;  // chunked route: frames a tile (one mask ballot)
constexpr int MAX_CHUNKS = 32;  // chunked route: warps a block
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float ex(float x) { return expf(x); }
__device__ __forceinline__ double ex(double x) { return exp(x); }
__device__ __forceinline__ float lg(float x) { return logf(x); }
__device__ __forceinline__ double lg(double x) { return log(x); }

template <typename S>
__device__ __forceinline__ S neg_inf() { return -(S)INFINITY; }

// the block route's sum of exps: float64 for both types (a sequential sum of
// N > 32 float32 terms drifts by ~N ulps where torch's tree reduction drifts
// by ~log N ulps: at N = 1100 four times the plain loops' error)
typedef double Acc;

// torch.logsumexp's shift: the max, or 0 where the max is infinite
template <typename S>
__device__ __forceinline__ S shift(S m) {
    return (m == (S)INFINITY || m == -(S)INFINITY) ? (S)0 : m;
}

// lse over x[0..NMAX) (entries past the real sources are -inf)
template <typename S, int NMAX>
__device__ __forceinline__ S lse(const S (&x)[NMAX]) {
    S m = x[0];
#pragma unroll
    for (int i = 1; i < NMAX; ++i) m = x[i] > m ? x[i] : m;
    m = shift(m);
    S s = (S)0;
#pragma unroll
    for (int i = 0; i < NMAX; ++i) s += ex(x[i] - m);
    return lg(s) + m;
}

// M[src, dst] of the recursion: A itself for the forward, A transposed (by
// index, no copy) for the backward
template <bool FWD, typename S>
__device__ __forceinline__ S mat(const S* a, int src, int dst, int n) {
    return FWD ? a[(size_t)src * n + dst] : a[(size_t)dst * n + src];
}

struct Args {
    const void* log_pi;  // (N,)
    const void* log_a;   // (N, N), A[src, dst]
    const void* log_b;   // (B, T, N)
    const uint8_t* mask; // (B, T) bool, or null (every frame valid)
    int B, T, N;
    int chunk;           // chunked route: steps a chunk (L)
    int first_dir;       // 0: blocks [0, B) forward, [B, 2B) backward; 1: backward only
    void* alpha;         // (B, T, N)
    void* loglik;        // (B,)
    void* beta;          // (B, T, N)
};

// step k = 1 .. T-1 reads frame f and writes row r
template <bool FWD>
__device__ __forceinline__ int in_frame(int k, int T) { return FWD ? k : T - k; }
template <bool FWD>
__device__ __forceinline__ int out_row(int k, int T) { return FWD ? k : T - 1 - k; }

// -- one warp an utterance and direction, lane = state (N <= 32) --------------
template <typename S, int NMAX, bool FWD>
__device__ __forceinline__ void warp_run(const Args& p, int b) {
    const int N = p.N;
    const int T = p.T;
    const int lane = threadIdx.x;
    const bool on = lane < N;
    const S* A = (const S*)p.log_a;
    const S* lb = (const S*)p.log_b + (size_t)b * T * N;
    const uint8_t* mk = p.mask ? p.mask + (size_t)b * T : nullptr;
    S* out = (S*)(FWD ? p.alpha : p.beta) + (size_t)b * T * N;

    S m[NMAX];  // column dst = lane of M
#pragma unroll
    for (int i = 0; i < NMAX; ++i) m[i] = (on && i < N) ? mat<FWD>(A, i, lane, N) : neg_inf<S>();

    // state: alpha[t-1, lane] (forward) or beta[t+1, lane] (backward)
    S state;
    if (FWD) {
        state = on ? ((const S*)p.log_pi)[lane] + lb[lane] : neg_inf<S>();
        if (on) out[lane] = state;
    } else {
        state = on ? (S)0 : neg_inf<S>();
        if (on) out[(size_t)(T - 1) * N + lane] = state;
    }

    S cur[STEPS], nxt[STEPS];
    bool cur_v[STEPS], nxt_v[STEPS];
#pragma unroll
    for (int q = 0; q < STEPS; ++q) {
        const int k = 1 + q;
        const int f = in_frame<FWD>(k, T);
        cur[q] = (on && k < T) ? lb[(size_t)f * N + lane] : (S)0;
        cur_v[q] = k < T && (mk == nullptr || mk[f] != 0);
    }
    for (int k0 = 1; k0 < T; k0 += STEPS) {
#pragma unroll
        for (int q = 0; q < STEPS; ++q) {
            const int k = k0 + STEPS + q;
            const int f = in_frame<FWD>(k, T);
            nxt[q] = (on && k < T) ? lb[(size_t)f * N + lane] : (S)0;
            nxt_v[q] = k < T && (mk == nullptr || mk[f] != 0);
        }
#pragma unroll
        for (int q = 0; q < STEPS; ++q) {
            const int k = k0 + q;
            if (k >= T) break;  // uniform across the warp
            const S v = FWD ? state : cur[q] + state;  // -inf on the lanes past N
            S x[NMAX];
#pragma unroll
            for (int i = 0; i < NMAX; ++i) x[i] = __shfl_sync(FULL, v, i) + m[i];
            const S r = lse<S, NMAX>(x);
            if (cur_v[q]) state = FWD ? r + cur[q] : r;
            if (on) out[(size_t)out_row<FWD>(k, T) * N + lane] = state;
        }
#pragma unroll
        for (int q = 0; q < STEPS; ++q) {
            cur[q] = nxt[q];
            cur_v[q] = nxt_v[q];
        }
    }
    if (FWD) {
        S x[NMAX];
#pragma unroll
        for (int i = 0; i < NMAX; ++i) x[i] = __shfl_sync(FULL, state, i);
        const S ll = lse<S, NMAX>(x);
        if (lane == 0) ((S*)p.loglik)[b] = ll;
    }
}

template <typename S, int NMAX>
__global__ void __launch_bounds__(32) fb_warp(Args p) {
    const int dir = p.first_dir + blockIdx.x / p.B;
    const int b = blockIdx.x % p.B;
    if (dir == 0) {
        warp_run<S, NMAX, true>(p, b);
    } else {
        warp_run<S, NMAX, false>(p, b);
    }
}

// -- a block of C warps an utterance and direction, time in chunks (N <= 8) ----

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

// One warp's chunk, steps [ks, ks + steps), streamed through two tiles of
// TILE frames in shared memory. Tile q holds the steps [ks + q TILE, ...):
// their frames are one run of memory starting at frame lo(q), in frame
// order; step k sits at row (in_frame(k) - lo), and bit row of the tile's
// ballot says whether that frame is valid.
template <typename S, int NN, bool FWD>
struct Chunk {
    const S* lb;          // this utterance's log_b (T, NN)
    const uint8_t* mk;    // this utterance's mask (T), or null
    S* tiles;             // 2 x TILE x NN of this warp
    int T, ks, steps, lane;
    uint8_t raw0, raw1;   // this lane's mask byte of the tile in each slot

    __device__ __forceinline__ int tiles_n() const { return (steps + TILE - 1) / TILE; }
    __device__ __forceinline__ int count(int q) const {
        const int left = steps - q * TILE;
        return left < TILE ? left : TILE;
    }
    __device__ __forceinline__ int lo(int q) const {
        const int k0 = ks + q * TILE;
        return FWD ? k0 : T - (k0 + count(q) - 1);
    }
    __device__ __forceinline__ S* slot(int q) const { return tiles + (q & 1) * TILE * NN; }

    // start the copies of tile q into its slot (one commit group)
    __device__ __forceinline__ void issue(int q) {
        const int cnt = count(q), f0 = lo(q);
        S* dst = slot(q);
        const S* src = lb + (size_t)f0 * NN;
        for (int e = lane; e < cnt * NN; e += 32) cp_async(dst + e, src + e);
        cp_commit();
        const uint8_t r = lane < cnt ? (mk == nullptr ? (uint8_t)1 : mk[f0 + lane]) : (uint8_t)0;
        if (q & 1) {
            raw1 = r;
        } else {
            raw0 = r;
        }
    }
    // wait for tile q (tile q + 1 may still be in flight); its valid bits
    __device__ __forceinline__ unsigned wait(int q) {
        if (q + 1 < tiles_n()) {
            cp_wait_all_but_one();
        } else {
            cp_wait_all();
        }
        __syncwarp();
        return __ballot_sync(FULL, ((q & 1) ? raw1 : raw0) != 0);
    }
    __device__ __forceinline__ int row(int q, int r) const {
        return FWD ? r : count(q) - 1 - r;  // the r-th step of tile q
    }
};

template <typename S, int NN, bool FWD>
__device__ __forceinline__ void chunk_run(const Args& p, int b, unsigned char* smem_raw) {
    const int T = p.T, L = p.chunk;
    const int C = blockDim.x / 32;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const S* A = (const S*)p.log_a;
    S* tiles = (S*)smem_raw;                        // C x 2 x TILE x NN
    S* prod = tiles + (size_t)C * 2 * TILE * NN;    // C x NN x NN: chunk products
    S* bound = prod + (size_t)C * NN * NN;          // C x NN: state entering chunk c
    S* out = (S*)(FWD ? p.alpha : p.beta) + (size_t)b * T * NN;

    Chunk<S, NN, FWD> ch;
    ch.lb = (const S*)p.log_b + (size_t)b * T * NN;
    ch.mk = p.mask ? p.mask + (size_t)b * T : nullptr;
    ch.tiles = tiles + (size_t)warp * 2 * TILE * NN;
    ch.T = T;
    ch.ks = 1 + warp * L;
    {
        const int end = ch.ks + L < T ? ch.ks + L : T;
        ch.steps = end > ch.ks ? end - ch.ks : 0;
    }
    ch.lane = lane;
    ch.raw0 = ch.raw1 = 0;
    const int nt = ch.tiles_n();
    const bool resident = nt <= 2;  // phase 3 finds the chunk's tiles as phase 1 left them
    if (nt > 0) ch.issue(0);
    if (nt > 1) ch.issue(1);

    // the state entering chunk 0: alpha[0] (forward) or beta[T-1] = 0
    S v0 = neg_inf<S>();
    if (warp == 0 && lane < NN) {
        v0 = FWD ? ((const S*)p.log_pi)[lane] + ch.lb[lane] : (S)0;
    }

    // -- phase 1: the chunk's product, lane (row, col), RPH rows a half --------
    {
        constexpr int RPH = 32 / NN;
        constexpr int H = (NN + RPH - 1) / RPH;
        const int col = lane % NN, base = lane - col;
        S m[NN];
#pragma unroll
        for (int i = 0; i < NN; ++i) m[i] = mat<FWD>(A, i, col, NN);
        S R[H];  // rows h RPH + lane / NN, starting from the identity
#pragma unroll
        for (int h = 0; h < H; ++h) {
            R[h] = (h * RPH + lane / NN == col) ? (S)0 : neg_inf<S>();
        }
        for (int q = 0; q < nt; ++q) {
            const unsigned bits = ch.wait(q);
            const S* tile = ch.slot(q);
            const int cnt = ch.count(q);
            for (int r = 0; r < cnt; ++r) {
                const int rw = ch.row(q, r);
                if (!((bits >> rw) & 1u)) continue;  // the identity (uniform across the warp)
                const S bv = tile[rw * NN + col];
#pragma unroll
                for (int h = 0; h < H; ++h) {
                    const S v = FWD ? R[h] : R[h] + bv;
                    S x[NN];
#pragma unroll
                    for (int i = 0; i < NN; ++i) x[i] = __shfl_sync(FULL, v, base + i) + m[i];
                    const S rr = lse<S, NN>(x);
                    R[h] = FWD ? rr + bv : rr;
                }
            }
            if (!resident && q + 2 < nt) {
                __syncwarp();
                ch.issue(q + 2);
            }
        }
        // prod[c][row * NN + col]: the forward's P[row, col]; the backward's
        // product Q transposed (row = dst of the next chunk's state)
        S* pc = prod + (size_t)warp * NN * NN;
#pragma unroll
        for (int h = 0; h < H; ++h) {
            const int rw = h * RPH + lane / NN;
            if (lane < RPH * NN && rw < NN) pc[rw * NN + col] = R[h];
        }
    }
    __syncthreads();

    // -- phase 2: the boundary chain, v_{c+1}[l] = lse_k(v_c[k] + prod_c[k, l]) --
    if (warp == 0) {
        const int l = lane < NN ? lane : 0;
        S v = v0;
        for (int c = 0; c < C; ++c) {
            if (lane < NN) bound[c * NN + lane] = v;
            const S* pc = prod + (size_t)c * NN * NN;
            S x[NN];
#pragma unroll
            for (int k = 0; k < NN; ++k) x[k] = __shfl_sync(FULL, v, k) + pc[k * NN + l];
            v = lse<S, NN>(x);
        }
    }
    __syncthreads();

    // -- phase 3: replay the chunk from its boundary, lane = state -------------
    const bool on = lane < NN;
    S m[NN];
#pragma unroll
    for (int i = 0; i < NN; ++i) m[i] = mat<FWD>(A, i, on ? lane : 0, NN);
    S state = on ? bound[warp * NN + lane] : neg_inf<S>();
    if (warp == 0 && on) out[(size_t)(FWD ? 0 : T - 1) * NN + lane] = state;
    if (!resident) {
        ch.issue(0);
        ch.issue(1);
    }
    for (int q = 0; q < nt; ++q) {
        const unsigned bits = ch.wait(q);
        S* tile = ch.slot(q);
        const int cnt = ch.count(q);
        for (int r = 0; r < cnt; ++r) {
            const int rw = ch.row(q, r);
            const S bv = on ? tile[rw * NN + lane] : (S)0;
            if ((bits >> rw) & 1u) {
                const S v = FWD ? state : bv + state;  // -inf on the lanes past N
                S x[NN];
#pragma unroll
                for (int i = 0; i < NN; ++i) x[i] = __shfl_sync(FULL, v, i) + m[i];
                const S rr = lse<S, NN>(x);
                state = FWD ? rr + bv : rr;
            }
            if (on) tile[rw * NN + lane] = state;  // the output row of this step
        }
        __syncwarp();
        // the tile's frames f hold alpha[f] (forward) or beta[f - 1] (backward)
        S* dst = out + (size_t)(ch.lo(q) - (FWD ? 0 : 1)) * NN;
        for (int e = lane; e < cnt * NN; e += 32) dst[e] = tile[e];
        if (!resident && q + 2 < nt) {
            __syncwarp();
            ch.issue(q + 2);
        }
    }
    if (FWD && warp == C - 1) {
        S x[NN];
#pragma unroll
        for (int i = 0; i < NN; ++i) x[i] = __shfl_sync(FULL, state, i);
        const S ll = lse<S, NN>(x);
        if (lane == 0) ((S*)p.loglik)[b] = ll;
    }
}

template <typename S, int NN>
__global__ void __launch_bounds__(32 * MAX_CHUNKS, 1) fb_chunk(Args p) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int dir = p.first_dir + blockIdx.x / p.B;
    const int b = blockIdx.x % p.B;
    if (dir == 0) {
        chunk_run<S, NN, true>(p, b, smem_raw);
    } else {
        chunk_run<S, NN, false>(p, b, smem_raw);
    }
}

// -- a block an utterance and direction (N > 32) --------------------------------
// VSMEM: v double-buffered in shared memory (else read from the output rows);
// MSMEM: M copied into shared memory (else read through L2)
template <typename S, bool FWD, bool VSMEM, bool MSMEM>
__device__ __forceinline__ void block_run(const Args& p, int b, S* smem) {
    const int N = p.N, T = p.T;
    const int tid = threadIdx.x, nthr = blockDim.x;
    const S* lb = (const S*)p.log_b + (size_t)b * T * N;
    const uint8_t* mk = p.mask ? p.mask + (size_t)b * T : nullptr;
    S* out = (S*)(FWD ? p.alpha : p.beta) + (size_t)b * T * N;
    S* vbuf = smem;                               // (2, N) when VSMEM
    S* msh = smem + (VSMEM ? 2 * (size_t)N : 0);  // (N, N) when MSMEM: M[src, dst]
    const S* A = (const S*)p.log_a;
    if (MSMEM) {
        for (size_t e = tid; e < (size_t)N * N; e += nthr) {
            msh[e] = mat<FWD>(A, (int)(e / N), (int)(e % N), N);
        }
    }
    auto M = [&](int i, int j) -> S { return MSMEM ? msh[(size_t)i * N + j] : mat<FWD>(A, i, j, N); };

    for (int j = tid; j < N; j += nthr) {
        if (FWD) {
            const S a0 = ((const S*)p.log_pi)[j] + lb[j];
            out[j] = a0;
            if (VSMEM) vbuf[j] = a0;
        } else {
            out[(size_t)(T - 1) * N + j] = (S)0;
            if (VSMEM) vbuf[j] = lb[(size_t)(T - 1) * N + j] + (S)0;
        }
    }
    __syncthreads();

    for (int k = 1; k < T; ++k) {
        const int f = in_frame<FWD>(k, T), r = out_row<FWD>(k, T);
        const int prev = FWD ? r - 1 : r + 1;  // the state's row (= f for the backward)
        const S* vin = vbuf + (size_t)((k - 1) & 1) * N;
        S* vout = vbuf + (size_t)(k & 1) * N;
        const bool valid = mk == nullptr || mk[f] != 0;
        for (int j = tid; j < N; j += nthr) {
            S nw;
            if (valid) {
                // v[i]: alpha[t-1, i], or log_b[t+1, i] + beta[t+1, i]
                auto v = [&](int i) -> S {
                    if (VSMEM) return vin[i];
                    return FWD ? out[(size_t)prev * N + i]
                               : lb[(size_t)f * N + i] + out[(size_t)prev * N + i];
                };
                S mx = neg_inf<S>();
                for (int i = 0; i < N; ++i) {
                    const S x = v(i) + M(i, j);
                    mx = x > mx ? x : mx;
                }
                mx = shift(mx);
                Acc s = 0.0;
                for (int i = 0; i < N; ++i) s += (Acc)ex(v(i) + M(i, j) - mx);
                const S rr = (S)lg(s) + mx;
                nw = FWD ? rr + lb[(size_t)f * N + j] : rr;
            } else {
                nw = out[(size_t)prev * N + j];  // this thread's own store of the last step
            }
            out[(size_t)r * N + j] = nw;
            if (VSMEM) vout[j] = FWD ? nw : lb[(size_t)r * N + j] + nw;
        }
        __syncthreads();
    }
    if (FWD && tid == 0) {
        const S* last = out + (size_t)(T - 1) * N;
        S mx = neg_inf<S>();
        for (int i = 0; i < N; ++i) mx = last[i] > mx ? last[i] : mx;
        mx = shift(mx);
        Acc s = 0.0;
        for (int i = 0; i < N; ++i) s += (Acc)ex(last[i] - mx);
        ((S*)p.loglik)[b] = (S)lg(s) + mx;
    }
}

template <typename S, bool VSMEM, bool MSMEM>
__global__ void __launch_bounds__(1024) fb_block(Args p) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int dir = p.first_dir + blockIdx.x / p.B;
    const int b = blockIdx.x % p.B;
    if (dir == 0) {
        block_run<S, true, VSMEM, MSMEM>(p, b, (S*)smem_raw);
    } else {
        block_run<S, false, VSMEM, MSMEM>(p, b, (S*)smem_raw);
    }
}

template <typename S, int NMAX>
int launch_warp(const Args& p, int blocks, cudaStream_t s) {
    fb_warp<S, NMAX><<<blocks, 32, 0, s>>>(p);
    return (int)cudaGetLastError();
}

template <typename K>
int allow_smem(K kernel, size_t smem) {
    if (smem <= 48 * 1024) return 0;
    return (int)cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                     (int)smem);
}

template <typename S, bool VSMEM, bool MSMEM>
int launch_block(const Args& p, int blocks, size_t smem, cudaStream_t s) {
    const int err = allow_smem(fb_block<S, VSMEM, MSMEM>, smem);
    if (err) return err;
    const int threads = p.N >= 1024 ? 1024 : (p.N + 31) / 32 * 32;
    fb_block<S, VSMEM, MSMEM><<<blocks, threads, smem, s>>>(p);
    return (int)cudaGetLastError();
}

template <typename S, int NN>
int launch_chunk(const Args& p, int blocks, cudaStream_t s) {
    const int steps = p.T - 1;
    const int C = steps > 0 ? (steps + p.chunk - 1) / p.chunk : 1;
    if (C > MAX_CHUNKS) return (int)cudaErrorInvalidValue;
    const size_t smem = ((size_t)C * 2 * TILE * NN + (size_t)C * NN * NN + (size_t)C * NN) * sizeof(S);
    const int err = allow_smem(fb_chunk<S, NN>, smem);
    if (err) return err;
    fb_chunk<S, NN><<<blocks, 32 * C, smem, s>>>(p);
    return (int)cudaGetLastError();
}

// route: 0 warp (N <= 32), 1 block with v and M in shared memory, 2 block
// with v in shared memory and M through L2, 3 block with both in device
// memory, 4 chunked (N <= 8) (ops/trellis.py:fb_route chooses; a route whose
// shared memory exceeds the card's limit fails at launch)
template <typename S>
int launch(const Args& p, int route, int blocks, cudaStream_t s) {
    const int N = p.N;
    const size_t vec = 2 * (size_t)N * sizeof(S), sq = (size_t)N * N * sizeof(S);
    switch (route) {
        case 0: break;
        case 1: return launch_block<S, true, true>(p, blocks, vec + sq, s);
        case 2: return launch_block<S, true, false>(p, blocks, vec, s);
        case 3: return launch_block<S, false, false>(p, blocks, 0, s);
        case 4: {
            if (p.chunk < 1) return (int)cudaErrorInvalidValue;
#define CHUNK_N(n) \
    case n: return launch_chunk<S, n>(p, blocks, s);
            switch (N) {
                CHUNK_N(1) CHUNK_N(2) CHUNK_N(3) CHUNK_N(4) CHUNK_N(5) CHUNK_N(6) CHUNK_N(7)
                CHUNK_N(8)
                default: return (int)cudaErrorInvalidValue;
            }
#undef CHUNK_N
        }
        default: return (int)cudaErrorInvalidValue;
    }
    if (N <= 8) return launch_warp<S, 8>(p, blocks, s);  // forced (fb_route: chunked)
    if (N <= 16) return launch_warp<S, 16>(p, blocks, s);
    if (N <= 32) return launch_warp<S, 32>(p, blocks, s);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// dirs: 1 forward (alpha, loglik), 2 backward (beta), 3 both in one launch.
// chunk: steps a chunk on the chunked route (ignored by the others). mask may
// be null.
extern "C" int forward_backward_launch(const void* log_pi, const void* log_a, const void* log_b,
                                       const uint8_t* mask, int B, int T, int N, int dirs,
                                       int route, int chunk, int is_double, void* alpha,
                                       void* loglik, void* beta, void* stream) {
    if (B < 1 || T < 1 || N < 1 || dirs < 1 || dirs > 3) return (int)cudaErrorInvalidValue;
    const bool fwd = dirs & 1, bwd = dirs & 2;
    if ((fwd && (log_pi == nullptr || alpha == nullptr || loglik == nullptr)) ||
        (bwd && beta == nullptr) || log_a == nullptr || log_b == nullptr)
        return (int)cudaErrorInvalidValue;
    Args p{log_pi, log_a, log_b, mask, B, T, N, chunk, fwd ? 0 : 1, alpha, loglik, beta};
    const int blocks = B * ((fwd ? 1 : 0) + (bwd ? 1 : 0));
    cudaStream_t s = (cudaStream_t)stream;
    return is_double ? launch<double>(p, route, blocks, s) : launch<float>(p, route, blocks, s);
}

extern "C" const char* forward_backward_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
