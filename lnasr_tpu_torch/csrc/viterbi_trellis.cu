// The masked Viterbi trellis behind every HMM decode, for Hopper (sm_90a):
// the max-plus forward with first-index argmax backpointers, the final
// argmax and the backtrace, for a batch of sequences in one launch.
//
// Replaces lnasr_tpu/ops/trellis.py:92-141 viterbi_scan: its forward
// lax.scan (:126) and its backtrace lax.scan (:138), which XLA runs as one
// device program inside the JAX package's jitted HMM decodes
// (lnasr_tpu/models/hmm.py:228-247, gmmhmm.py:345-353, vmapped over the
// batch). No Pallas kernel. The port's plain version is a T-step loop of
// tensor ops and T - 1 single-element gathers
// (ops/trellis.py:viterbi_scan_plain), which this kernel is held to bit
// for bit: scores, backpointers, path and score.
//
// The semantics kept: v[0] = log_pi + log_b[0]; a step is
// v'[j] = max_i(v[i] + A[i, j]) + log_b[t, j], the max first, then the
// add; the backpointer is the FIRST i reaching the max; a masked frame
// keeps v and points every state to itself; the final argmax is taken on
// v + log_final (v alone without it), the first index again, so an
// all -inf column gives state 0. Adds are __fadd_rn/__dadd_rn (no
// multiply, so nothing to contract), max and argmax are exact, so every
// output equals the plain loop's. float32 and float64.
//
// What bounds it: at the GMM-HMM decode (B = 64, T = 999, N = 5) it needs
// the emissions of the frames its masks keep (0.84 MB at the seeded ragged
// lengths, 1.3 MB unmasked) and 64 KB of mask and writes 2.6 MB of trellis
// and backpointers and 0.26 MB of path, about 1.1 us at 3.35 TB/s, and does
// 2 N^2 operations an utterance-frame, far less. Neither is the limit:
// each sequence is a chain of T - 1 dependent steps, so the time is a
// step's latency times T. The design keeps a step short and everything
// else off the chain.
//
// Two routes (ops/trellis.py:viterbi_trellis_route):
//
// - warp (N <= 32): a block of one warp a sequence, lane j = state j, the
//   column A[:, j] in registers. A step is N shuffles of v, N adds, a
//   balanced (value, index) tree whose ties keep the lower index (N <= 8
//   is a template argument; 16 and 32 pad with -inf), the emission's add
//   and the mask's select, with no branch: kernel B's step and one select.
//   The frames run in groups of G (32 at float32, 16 at float64) aligned
//   to frame 0. The next group's emissions (a register each) and mask
//   (lane k loads frame t0 + G + k's byte; one ballot a group makes the
//   group's bits, a step tests its bit) load while the current group is
//   stepped. A step writes its trellis row and int8 backpointers to shared
//   memory; at the group's end the warp copies the group's G N values of
//   each to the outputs as coalesced stores. The int8 backpointers of the
//   whole sequence stay on chip where T N bytes fit (VITERBI_BP_SMEM,
//   ON_CHIP: the backtrace reads them there), else a group's.
// - block (33 <= N <= 1024): a block a sequence, thread j = target j, v
//   double-buffered in shared memory (one barrier a step), the column read
//   through L1; a linear scan over i with a strict > keeps the first
//   index. The final argmax is a warp butterfly, then one over the warps.
//
// The backtrace composes maps instead of walking T - 1 dependent loads
// (kernel B's scheme, csrc/viterbi.cu): the T - 1 steps are cut into C
// chunks of K (ops/trellis.py:viterbi_chunks; K = 32 while the maps fit
// in shared memory); (1) the threads walk every chunk from each of its N
// end states at once, WALKS walks a thread interleaved, and record each
// chunk's start state per end state; (2) thread 0 composes the chunk maps
// from the last frame back, one shared load a chunk; (3) the threads walk
// the chunks again in parallel from their known end states and write the
// path. Index-following only, so exact; the dependent depth is about
// 2K + C loads instead of T - 1.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int WALKS = 8;   // chunk walks interleaved a thread
constexpr unsigned FULL = 0xffffffffu;
constexpr int NO_INDEX = 1 << 30;  // loses every tie of the final argmax

struct Args {
    const void* log_pi;     // (N,)
    const void* log_a;      // (N, N)
    const void* log_b;      // (B, T, N)
    const uint8_t* mask;    // (B, T) bool, or null: every frame valid
    const void* log_final;  // (N,), or null
    int T, N, on_chip, n_chunks, chunk;
    void* scores;  // (B, T, N)
    int* backptr;  // (B, T, N)
    int* path;     // (B, T)
    void* score;   // (B,)
};

__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

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

// backpointer (t, s): the int8 copy in shared memory, else the int32 output
// this block wrote (read after a barrier, never through the read-only path)
struct BpRead {
    const int8_t* on_chip;
    const int* global;
    int N;
    __device__ __forceinline__ int operator()(int t, int s) const {
        const size_t at = (size_t)t * N + s;
        return on_chip ? (int)on_chip[at] : global[at];
    }
};

template <bool BLOCK>
__device__ __forceinline__ void barrier() {
    if constexpr (BLOCK) __syncthreads(); else __syncwarp();
}

// The path below frame T - 1 from the final state `last` (path[T - 1] is
// the caller's). Chunk c covers steps (c K, min((c + 1) K, T - 1)].
template <bool BLOCK>
__device__ void backtrace(const BpRead& bp, int T, int N, int n_chunks, int K, int last,
                          int16_t* maps, int16_t* ends, int* pb, int tid, int nthreads) {
    // (1) each chunk from each end state e at its top step back to frame c K
    const int n_walks = n_chunks * N;
    for (int w0 = 0; w0 < n_walks; w0 += nthreads * WALKS) {
        int s[WALKS], top[WALKS], low[WALKS];
#pragma unroll
        for (int q = 0; q < WALKS; ++q) {
            const int w = w0 + tid + nthreads * q;
            const int c = w / N;
            s[q] = w - c * N;
            top[q] = w < n_walks ? min((c + 1) * K, T - 1) : 0;
            low[q] = c * K + 1;
        }
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
#pragma unroll
            for (int q = 0; q < WALKS; ++q) {
                const int t = top[q] - k;
                if (t >= low[q]) s[q] = bp(t, s[q]);
            }
        }
#pragma unroll
        for (int q = 0; q < WALKS; ++q) {
            const int w = w0 + tid + nthreads * q;
            if (w < n_walks) maps[w] = (int16_t)s[q];
        }
    }
    barrier<BLOCK>();
    // (2) each chunk's end state, from the last frame back
    if (tid == 0 && n_chunks > 0) {
        int e = last;
        ends[n_chunks - 1] = (int16_t)e;
        for (int c = n_chunks - 1; c > 0; --c) {
            e = maps[c * N + e];
            ends[c - 1] = (int16_t)e;
        }
    }
    barrier<BLOCK>();
    // (3) the path, the chunks walked again in parallel from their end states
    for (int c0 = 0; c0 < n_chunks; c0 += nthreads * WALKS) {
        int s[WALKS], top[WALKS], low[WALKS];
#pragma unroll
        for (int q = 0; q < WALKS; ++q) {
            const int c = c0 + tid + nthreads * q;
            s[q] = c < n_chunks ? ends[c] : 0;
            top[q] = c < n_chunks ? min((c + 1) * K, T - 1) : 0;
            low[q] = c * K + 1;
        }
#pragma unroll 4
        for (int k = 0; k < K; ++k) {
#pragma unroll
            for (int q = 0; q < WALKS; ++q) {
                const int t = top[q] - k;
                if (t >= low[q]) {
                    s[q] = bp(t, s[q]);
                    pb[t - 1] = s[q];
                }
            }
        }
    }
}

// frames a group of the warp route: a register each for the emissions of
// this group and of the next
template <typename R>
__host__ __device__ constexpr int group() { return sizeof(R) == 4 ? 32 : 16; }

// warp route: NMAX candidates a step (= N when EXACT); ON_CHIP: the int8
// backpointers of every frame in shared memory, else of a group
template <typename R, int NMAX, bool EXACT, bool ON_CHIP>
__global__ void __launch_bounds__(32) warp_kernel(Args a) {
    constexpr int G = group<R>();
    extern __shared__ __align__(16) unsigned char smem[];
    const int N = EXACT ? NMAX : a.N;
    const int Tn = a.T;
    const int lane = threadIdx.x;
    const int b = blockIdx.x;
    const bool on = lane < N;
    const R NEG_INF = -INFINITY;
    R* stage = reinterpret_cast<R*>(smem);                            // (G, N) a group's rows
    int16_t* maps = reinterpret_cast<int16_t*>(stage + (size_t)G * N);  // (n_chunks, N) starts
    int16_t* ends = maps + (size_t)a.n_chunks * N;                   // (n_chunks,) end states
    int8_t* bp8 = reinterpret_cast<int8_t*>(ends + a.n_chunks);     // (T, N) ON_CHIP, else (G, N)
    const R* pi = static_cast<const R*>(a.log_pi);
    const R* la = static_cast<const R*>(a.log_a);
    const R* lf = static_cast<const R*>(a.log_final);
    const R* lb = static_cast<const R*>(a.log_b) + (size_t)b * Tn * N;
    const uint8_t* mk = a.mask ? a.mask + (size_t)b * Tn : nullptr;
    R* sc = static_cast<R*>(a.scores) + (size_t)b * Tn * N;
    int* bp = a.backptr + (size_t)b * Tn * N;
    int* pb = a.path + (size_t)b * Tn;

    R col[NMAX];  // column j = lane of the transition matrix
#pragma unroll
    for (int i = 0; i < NMAX; ++i) col[i] = (on && i < N) ? la[i * N + lane] : NEG_INF;
    R v = on ? add_rn(pi[lane], lb[lane]) : NEG_INF;  // frame 0

    R cur[G], nxt[G];
#pragma unroll
    for (int k = 0; k < G; ++k) cur[k] = (on && k < Tn) ? lb[(size_t)k * N + lane] : R(0);
    // lane k: the mask byte of frame t0 + k, kept raw until the group's
    // ballot (a compare right after the load would wait for it)
    int mcur = (mk && lane < G && lane < Tn) ? mk[lane] : 1;
    for (int t0 = 0; t0 < Tn; t0 += G) {
#pragma unroll
        for (int k = 0; k < G; ++k) {
            const int t = t0 + G + k;
            nxt[k] = (on && t < Tn) ? lb[(size_t)t * N + lane] : R(0);
        }
        const int tm = t0 + G + lane;
        const int mnxt = (mk && lane < G && tm < Tn) ? mk[tm] : 1;
        // bit k: frame t0 + k is valid; frame 0 is no step (v kept, pointer 0)
        const unsigned bits = __ballot_sync(FULL, mcur != 0) & (t0 == 0 ? ~1u : FULL);
        const int self0 = t0 == 0 ? 0 : lane;
        int8_t* bps = ON_CHIP ? bp8 + (size_t)t0 * N : bp8;
#pragma unroll
        for (int k = 0; k < G; ++k) {
            const int t = t0 + k;
            if (t >= Tn) break;  // uniform across the warp
            R c[NMAX];
#pragma unroll
            for (int i = 0; i < NMAX; ++i) c[i] = add_rn(__shfl_sync(FULL, v, i), col[i]);
            R best;
            int arg;
            tree_argmax<0, NMAX>(c, best, arg);
            const R nv = add_rn(best, cur[k]);
            // a masked frame: v kept, every state its own pointer
            const bool valid = (bits >> k) & 1u;
            v = valid ? nv : v;
            arg = valid ? arg : (k == 0 ? self0 : lane);
            if (on) {
                stage[k * N + lane] = v;
                bps[k * N + lane] = (int8_t)arg;
            }
        }
        __syncwarp();
        // the group's trellis rows and backpointers, coalesced
        const int cnt = min(G, Tn - t0) * N;
        R* scg = sc + (size_t)t0 * N;
        int* bpg = bp + (size_t)t0 * N;
#pragma unroll 4
        for (int i = lane; i < cnt; i += 32) {
            scg[i] = stage[i];
            bpg[i] = bps[i];
        }
        __syncwarp();
#pragma unroll
        for (int k = 0; k < G; ++k) cur[k] = nxt[k];
        mcur = mnxt;
    }

    // final state: the first argmax of v (+ log_final); score: its value
    R bv = (on && lf) ? add_rn(v, lf[lane]) : v;
    int bi = lane;
    warp_argmax(bv, bi);
    if (lane == 0) {
        static_cast<R*>(a.score)[b] = bv;
        pb[Tn - 1] = bi;
    }
    __syncwarp();  // every lane's backpointer stores visible to the warp
    backtrace<false>(BpRead{ON_CHIP ? bp8 : nullptr, bp, N}, Tn, N, a.n_chunks, a.chunk, bi, maps,
                     ends, pb, lane, 32);
}

// block route: a thread a target state, v double-buffered in shared memory
template <typename R>
__global__ void __launch_bounds__(1024) block_kernel(Args a) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int N = a.N, Tn = a.T;
    const int j = threadIdx.x, nthreads = blockDim.x;
    const int b = blockIdx.x;
    const bool on = j < N;
    const R NEG_INF = -INFINITY;
    R* vbuf = reinterpret_cast<R*>(smem);               // (2, N)
    R* red_v = vbuf + 2 * N;                            // (32,) the warps' maxima
    int* red_i = reinterpret_cast<int*>(red_v + 32);    // (32,) their states, [32] the last
    int16_t* maps = reinterpret_cast<int16_t*>(red_i + 33);
    int16_t* ends = maps + (size_t)a.n_chunks * N;
    const R* pi = static_cast<const R*>(a.log_pi);
    const R* __restrict__ la = static_cast<const R*>(a.log_a);
    const R* lf = static_cast<const R*>(a.log_final);
    const R* lb = static_cast<const R*>(a.log_b) + (size_t)b * Tn * N;
    const uint8_t* mk = a.mask ? a.mask + (size_t)b * Tn : nullptr;
    R* sc = static_cast<R*>(a.scores) + (size_t)b * Tn * N;
    int* bp = a.backptr + (size_t)b * Tn * N;
    int* pb = a.path + (size_t)b * Tn;

    R v = on ? add_rn(pi[j], lb[j]) : NEG_INF;
    if (on) {
        vbuf[j] = v;
        sc[j] = v;
        bp[j] = 0;
    }
    R nb = (on && Tn > 1) ? lb[N + j] : R(0);
    bool nvalid = (mk && Tn > 1) ? mk[1] != 0 : true;
    __syncthreads();
    for (int t = 1; t < Tn; ++t) {
        const R* vp = vbuf + ((t - 1) & 1) * N;
        R* vq = vbuf + (t & 1) * N;
        const R cb = nb;
        const bool valid = nvalid;
        if (t + 1 < Tn) {  // the next frame's emission and mask, off the chain
            nb = on ? lb[(size_t)(t + 1) * N + j] : R(0);
            nvalid = mk ? mk[t + 1] != 0 : true;
        }
        if (on) {
            R best = add_rn(vp[0], __ldg(la + j));
            int arg = 0;
            for (int i = 1; i < N; ++i) {
                const R c = add_rn(vp[i], __ldg(la + (size_t)i * N + j));
                if (c > best) {
                    best = c;
                    arg = i;
                }
            }
            R nv = add_rn(best, cb);
            if (!valid) {
                nv = v;
                arg = j;
            }
            v = nv;
            vq[j] = nv;
            sc[(size_t)t * N + j] = nv;
            bp[(size_t)t * N + j] = arg;
        }
        __syncthreads();
    }

    R bv = on ? (lf ? add_rn(v, lf[j]) : v) : NEG_INF;
    int bi = j;
    warp_argmax(bv, bi);
    const int warp = j >> 5, n_warps = nthreads >> 5;
    if ((j & 31) == 0) {
        red_v[warp] = bv;
        red_i[warp] = bi;
    }
    __syncthreads();
    if (warp == 0) {
        bv = j < n_warps ? red_v[j] : NEG_INF;
        bi = j < n_warps ? red_i[j] : NO_INDEX;
        warp_argmax(bv, bi);
        if (j == 0) {
            static_cast<R*>(a.score)[b] = bv;
            pb[Tn - 1] = bi;
            red_i[32] = bi;
        }
    }
    __syncthreads();  // also makes every thread's backpointer stores visible
    backtrace<true>(BpRead{nullptr, bp, N}, Tn, N, a.n_chunks, a.chunk, red_i[32], maps, ends,
                    pb, j, nthreads);
}

size_t map_bytes(const Args& a) { return 2 * (size_t)a.n_chunks * (a.N + 1); }

template <typename R, int NMAX, bool EXACT, bool ON_CHIP>
int launch_warp_at(const Args& a, int B, cudaStream_t s) {
    const size_t rows = (size_t)group<R>() * a.N;
    const size_t smem = rows * sizeof(R) + map_bytes(a) + (ON_CHIP ? (size_t)a.T * a.N : rows);
    cudaError_t err = cudaFuncSetAttribute(warp_kernel<R, NMAX, EXACT, ON_CHIP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    warp_kernel<R, NMAX, EXACT, ON_CHIP><<<B, 32, smem, s>>>(a);
    return (int)cudaGetLastError();
}

template <typename R, int NMAX, bool EXACT>
int launch_warp(const Args& a, int B, cudaStream_t s) {
    return a.on_chip ? launch_warp_at<R, NMAX, EXACT, true>(a, B, s)
                     : launch_warp_at<R, NMAX, EXACT, false>(a, B, s);
}

template <typename R>
int launch_warp_route(const Args& a, int B, cudaStream_t s) {
#define EXACT_N(n) \
    case n: return launch_warp<R, n, true>(a, B, s);
    switch (a.N) {
        EXACT_N(1) EXACT_N(2) EXACT_N(3) EXACT_N(4) EXACT_N(5) EXACT_N(6) EXACT_N(7) EXACT_N(8)
        default: break;
    }
#undef EXACT_N
    if (a.N <= 16) return launch_warp<R, 16, false>(a, B, s);
    return launch_warp<R, 32, false>(a, B, s);
}

template <typename R>
int launch_block(const Args& a, int B, cudaStream_t s) {
    const int threads = (a.N + 31) / 32 * 32;
    const size_t smem = (2 * (size_t)a.N + 32) * sizeof(R) + 33 * sizeof(int) + map_bytes(a);
    cudaError_t err = cudaFuncSetAttribute(block_kernel<R>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    block_kernel<R><<<B, threads, smem, s>>>(a);
    return (int)cudaGetLastError();
}

}  // namespace

// route: 0 warp (N <= 32), 1 block (N <= 1024); on_chip: the warp route's
// int8 backpointer copy in shared memory (ops/trellis.py:viterbi_on_chip);
// n_chunks, chunk: the backtrace's chunks (ops/trellis.py:viterbi_chunks)
extern "C" int viterbi_trellis_launch(const void* log_pi, const void* log_a, const void* log_b,
                                      const void* mask, const void* log_final, int B, int T,
                                      int N, int route, int on_chip, int n_chunks, int chunk,
                                      int is_double, void* scores, int* backptr, int* path,
                                      void* score, void* stream) {
    if (B < 1 || T < 1 || N < 1 || N > 1024 || route < 0 || route > 1 || (route == 0 && N > 32)
        || (on_chip && route != 0) || n_chunks < 0 || chunk < 1
        || (long long)n_chunks * chunk < T - 1)
        return (int)cudaErrorInvalidValue;
    Args a{log_pi, log_a, log_b, static_cast<const uint8_t*>(mask), log_final, T, N, on_chip,
           n_chunks, chunk, scores, backptr, path, score};
    cudaStream_t s = (cudaStream_t)stream;
    if (route == 0)
        return is_double ? launch_warp_route<double>(a, B, s) : launch_warp_route<float>(a, B, s);
    return is_double ? launch_block<double>(a, B, s) : launch_block<float>(a, B, s);
}

extern "C" const char* viterbi_trellis_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
