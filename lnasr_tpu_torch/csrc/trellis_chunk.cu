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
// Two routes, by N (the host's ops/trellis.py:trellis_chunk_route):
//
// - warp (N <= 32): one warp, lane j = target state j, the column A[:, j]
//   in registers; a step is N shuffles of alpha, N adds, a balanced
//   (value, index) tree whose ties keep the lower index (kernel K's warp
//   route, csrc/viterbi_trellis.cu:213; N <= 8 exact, 16 and 32 padded
//   with -inf), then the emission's add. The emissions of the next group
//   of G rows load into registers while the current group is stepped.
// - block (33 <= N <= 1024): one block, thread j = target j, alpha
//   double-buffered in shared memory (one barrier a step), the column read
//   through L1, a linear scan over i; the next row's emission loads one
//   step ahead.
//
// pointer_walk_launch. The first argmax of alpha by one warp (a strided
// scan, then a (value, index) butterfly keeping the lower index), then
// path[T-1] = that state and path[t] = bt[t+1][path[t+1]] down to t = 0.
// For N <= 32 the lanes hold the pointer rows of a group of 32 frames
// (lane k: column k), loaded ahead of the walk, and a step is one shuffle
// from the lane the path stands on, so the chain of T - 1 steps waits on no
// load; past 32 states one thread chases the pointers through memory, as
// csrc/trigram_backtrace.cu does.
//
// What bounds them on an H100: at the pipeline's geometry (T = 999 in 9
// chunks of 111, N = 5, float64) a chunk moves 4.4 KB of emissions, 200 B of
// transitions and 2.2 KB of pointers, ~2 ns at 3.35 TB/s, and does
// 2 N^2 + N operations a frame; neither is the limit. A chunk is a chain of
// 111 dependent steps (shuffles, a tree of compares, two adds; an exp and a
// log more in the log semiring), and the walk a chain of 998 shuffles, so
// each costs its depth times one step's latency: the design keeps loads
// and stores off the chain.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_INDEX = 1 << 30;  // loses every tie of the final argmax
constexpr int WALK_ROWS = 32;      // the walk's pointer rows held a group, N <= 32

struct Args {
    const void* alpha;   // (N,) the carried vector; unread when row 0 is frame 0
    const void* log_pi;  // (N,)
    const void* log_a;   // (N, N)
    const void* log_b;   // (chunk, N)
    int pos0, chunk, N, log_semiring;
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

template <typename R>
int launch_chunk(const Args& a, cudaStream_t s) {
    if (a.N > 32) {
        const int threads = (a.N + 31) / 32 * 32;
        block_kernel<R><<<1, threads, 2 * (size_t)a.N * sizeof(R), s>>>(a);
        return (int)cudaGetLastError();
    }
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

// the walk: the first argmax of alpha on one warp, then the pointer chase
template <typename R>
__global__ void __launch_bounds__(32) walk_kernel(const R* __restrict__ alpha, int N,
                                                  const int* __restrict__ bt, int T,
                                                  int* __restrict__ path) {
    const int lane = threadIdx.x;
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
    int s = bi;  // the same on every lane
    if (lane == 0) path[T - 1] = s;
    if (N > 32) {  // one thread through memory
        if (lane == 0)
            for (int t = T - 2; t >= 0; --t) {
                s = bt[(size_t)(t + 1) * N + s];
                path[t] = s;
            }
        return;
    }
    // rows hi, hi-1, ..., hi-31 of a group: lane k holds column k of each,
    // the next group's loaded while this one is walked
    int cur[WALK_ROWS], nxt[WALK_ROWS];
#pragma unroll
    for (int q = 0; q < WALK_ROWS; ++q) {
        const int row = T - 1 - q;
        cur[q] = (lane < N && row >= 1) ? bt[(size_t)row * N + lane] : 0;
    }
    for (int hi = T - 1; hi >= 1; hi -= WALK_ROWS) {
#pragma unroll
        for (int q = 0; q < WALK_ROWS; ++q) {
            const int row = hi - WALK_ROWS - q;
            nxt[q] = (lane < N && row >= 1) ? bt[(size_t)row * N + lane] : 0;
        }
        int mine = 0;  // lane q: path[hi - q - 1]
#pragma unroll
        for (int q = 0; q < WALK_ROWS; ++q) {
            if (hi - q < 1) break;  // uniform across the warp
            s = __shfl_sync(FULL, cur[q], s);
            mine = lane == q ? s : mine;
        }
        if (hi - lane >= 1) path[hi - lane - 1] = mine;
#pragma unroll
        for (int q = 0; q < WALK_ROWS; ++q) cur[q] = nxt[q];
    }
}

}  // namespace

// alpha: the carried (N,) vector, read unless pos0 == 0; pos0: the frame of
// the chunk's row 0; semiring: 0 max, 1 log; bt: the chunk's (chunk, N)
// int32 pointer rows, or null when they are not wanted
extern "C" int trellis_chunk_launch(const void* alpha, int pos0, const void* log_pi,
                                    const void* log_a, const void* log_b, int chunk, int N,
                                    int semiring, int is_double, void* alpha_out, int* bt,
                                    void* stream) {
    if (pos0 < 0 || chunk < 1 || N < 1 || N > 1024 || semiring < 0 || semiring > 1)
        return (int)cudaErrorInvalidValue;
    Args a{alpha, log_pi, log_a, log_b, pos0, chunk, N, semiring, alpha_out, bt};
    cudaStream_t s = (cudaStream_t)stream;
    return is_double ? launch_chunk<double>(a, s) : launch_chunk<float>(a, s);
}

// alpha: the final (N,) vector; bt: the utterance's (T, N) int32 pointers;
// path: (T,) int32
extern "C" int pointer_walk_launch(const void* alpha, int N, const int* bt, int T, int is_double,
                                   int* path, void* stream) {
    if (N < 1 || T < 1) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (is_double)
        walk_kernel<double><<<1, 32, 0, s>>>(static_cast<const double*>(alpha), N, bt, T, path);
    else
        walk_kernel<float><<<1, 32, 0, s>>>(static_cast<const float*>(alpha), N, bt, T, path);
    return (int)cudaGetLastError();
}

extern "C" const char* trellis_chunk_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
