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
// lse_src(v[src] + M[src, dst]): the forward with M = A and v = alpha[t-1],
// the backward with M = A^T (the wrapper passes log_at, A transposed) and
// v = log_b[t+1] + beta[t+1]. The logsumexp is torch.logsumexp's: m = max,
// m = 0 where m is infinite, then log(sum_src exp(x - m)) + m with the
// sources in ascending order (on the block route for N > 32 the sum is
// accumulated in float64, see Acc). So an all--inf column (left-to-right models
// are mostly -inf) gives -inf, never NaN. expf/logf and exp/log, no
// --use_fast_math, no atomics: the order of every sum is fixed, and two
// launches on the same input give the same bits.
//
// Routes. N <= 32 (every EM path: N = 2-8 in the models and units): a block
// is one warp, lane dst = state dst holds column M[:, dst] in registers, and
// v[src] comes by __shfl_sync; no barrier in the chain. The emissions and
// mask bytes of the next STEPS frames are loaded into registers while the
// current ones are used, so no step waits on device memory. N <= 8 is a
// template argument (the step is N shuffles, N exps, one log); 16 and 32 run
// the same step with the lanes past N at -inf, which adds exp(-inf) = 0 and
// so gives the same bits. N > 32: ceil(N/32) warps (at most 1024 threads, a
// thread loops over states past that), v double-buffered in shared memory,
// one __syncthreads a step; M is copied into shared memory where it fits in
// a block's 227 KB and read through L2 where it does not; v itself is read
// from the output rows in device memory where even 2 N values do not fit
// (N > 14,000 at float64). There is no capacity limit on N. The wrapper
// picks the route (ops/trellis.py:fb_route); any block route also runs any
// N, which is how chip_smoke.py checks each route at small N.
//
// What bounds it on an H100: at the flagship sweep (B = 64, T = 999, N = 5,
// float32) it reads 1.3 MB of emissions and writes 2.6 MB of alpha and beta,
// ~1.2 us at 3.35 TB/s, and does ~4 N^2 operations a step and direction,
// far below the fp32 peak. Neither is the limit: each direction is a chain
// of T - 1 = 998 dependent steps (N shuffles, a max, N exps, a sum, a log),
// so its time is the latency of one step times T - 1, and the two chains of
// an utterance overlap.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int STEPS = 8;  // frames of emissions and mask prefetched at once
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

struct Args {
    const void* log_pi;  // (N,)
    const void* log_a;   // (N, N): M of the forward, M[src * N + dst] = A[src, dst]
    const void* log_at;  // (N, N): M of the backward, A transposed
    const void* log_b;   // (B, T, N)
    const uint8_t* mask; // (B, T) bool, or null (every frame valid)
    int B, T, N;
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
template <typename S, int NMAX, bool EXACT, bool FWD>
__device__ __forceinline__ void warp_run(const Args& p, int b) {
    const int N = EXACT ? NMAX : p.N;
    const int T = p.T;
    const int lane = threadIdx.x;
    const bool on = lane < N;
    const S* M = (const S*)(FWD ? p.log_a : p.log_at);
    const S* lb = (const S*)p.log_b + (size_t)b * T * N;
    const uint8_t* mk = p.mask ? p.mask + (size_t)b * T : nullptr;
    S* out = (S*)(FWD ? p.alpha : p.beta) + (size_t)b * T * N;

    S m[NMAX];  // column dst = lane of M
#pragma unroll
    for (int i = 0; i < NMAX; ++i) m[i] = (on && i < N) ? M[i * N + lane] : neg_inf<S>();

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

template <typename S, int NMAX, bool EXACT>
__global__ void __launch_bounds__(32) fb_warp(Args p) {
    const int dir = p.first_dir + blockIdx.x / p.B;
    const int b = blockIdx.x % p.B;
    if (dir == 0) {
        warp_run<S, NMAX, EXACT, true>(p, b);
    } else {
        warp_run<S, NMAX, EXACT, false>(p, b);
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
    S* msh = smem + (VSMEM ? 2 * (size_t)N : 0);  // (N, N) when MSMEM
    const S* Mg = (const S*)(FWD ? p.log_a : p.log_at);
    if (MSMEM) {
        for (size_t e = tid; e < (size_t)N * N; e += nthr) msh[e] = Mg[e];
    }
    const S* M = MSMEM ? msh : Mg;

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
                    const S x = v(i) + M[(size_t)i * N + j];
                    mx = x > mx ? x : mx;
                }
                mx = shift(mx);
                Acc s = 0.0;
                for (int i = 0; i < N; ++i) s += (Acc)ex(v(i) + M[(size_t)i * N + j] - mx);
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

template <typename S, int NMAX, bool EXACT>
int launch_warp(const Args& p, int blocks, cudaStream_t s) {
    fb_warp<S, NMAX, EXACT><<<blocks, 32, 0, s>>>(p);
    return (int)cudaGetLastError();
}

template <typename S, bool VSMEM, bool MSMEM>
int launch_block(const Args& p, int blocks, size_t smem, cudaStream_t s) {
    if (smem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(fb_block<S, VSMEM, MSMEM>,
                                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               (int)smem);
        if (err != cudaSuccess) return (int)err;
    }
    const int threads = p.N >= 1024 ? 1024 : (p.N + 31) / 32 * 32;
    fb_block<S, VSMEM, MSMEM><<<blocks, threads, smem, s>>>(p);
    return (int)cudaGetLastError();
}

// route: 0 warp (N <= 32), 1 block with v and M in shared memory, 2 block
// with v in shared memory and M through L2, 3 block with both in device
// memory (ops/trellis.py:fb_route chooses; a route whose shared memory
// exceeds the card's limit fails at launch)
template <typename S>
int launch(const Args& p, int route, int blocks, cudaStream_t s) {
    const int N = p.N;
    const size_t vec = 2 * (size_t)N * sizeof(S), mat = (size_t)N * N * sizeof(S);
    switch (route) {
        case 0: break;
        case 1: return launch_block<S, true, true>(p, blocks, vec + mat, s);
        case 2: return launch_block<S, true, false>(p, blocks, vec, s);
        case 3: return launch_block<S, false, false>(p, blocks, 0, s);
        default: return (int)cudaErrorInvalidValue;
    }
#define EXACT_N(n) \
    case n: return launch_warp<S, n, true>(p, blocks, s);
    switch (N) {
        EXACT_N(1) EXACT_N(2) EXACT_N(3) EXACT_N(4) EXACT_N(5) EXACT_N(6) EXACT_N(7) EXACT_N(8)
        default: break;
    }
#undef EXACT_N
    if (N <= 16) return launch_warp<S, 16, false>(p, blocks, s);
    if (N <= 32) return launch_warp<S, 32, false>(p, blocks, s);
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// dirs: 1 forward (alpha, loglik), 2 backward (beta), 3 both in one launch.
// log_at is A transposed (needed for the backward). mask may be null.
extern "C" int forward_backward_launch(const void* log_pi, const void* log_a, const void* log_at,
                                       const void* log_b, const uint8_t* mask, int B, int T,
                                       int N, int dirs, int route, int is_double, void* alpha,
                                       void* loglik, void* beta, void* stream) {
    if (B < 1 || T < 1 || N < 1 || dirs < 1 || dirs > 3) return (int)cudaErrorInvalidValue;
    const bool fwd = dirs & 1, bwd = dirs & 2;
    if ((fwd && (log_pi == nullptr || alpha == nullptr || loglik == nullptr)) ||
        (bwd && (log_at == nullptr || beta == nullptr)) || log_b == nullptr)
        return (int)cudaErrorInvalidValue;
    Args p{log_pi, log_a, log_at, log_b, mask, B, T, N, fwd ? 0 : 1, alpha, loglik, beta};
    const int blocks = B * ((fwd ? 1 : 0) + (bwd ? 1 : 0));
    cudaStream_t s = (cudaStream_t)stream;
    return is_double ? launch<double>(p, route, blocks, s) : launch<float>(p, route, blocks, s);
}

extern "C" const char* forward_backward_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
