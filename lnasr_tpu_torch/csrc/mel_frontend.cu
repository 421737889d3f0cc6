// Fused mel frontend for Hopper (sm_90a): framing -> Hamming window ->
// real FFT power spectrum -> mel energies + total frame energy.
//
// Replaces lnasr_tpu/ops/mfcc_pallas.py:mel_frontend_pallas (kernel bodies
// _make_kernel_radix4 / _make_kernel_radix2 / _make_kernel). The TPU kernel
// runs the DFT as split-bf16 GEMMs through a radix ladder sized for the
// 128-lane MXU; none of that carries over. Here a block takes one utterance
// and a tile of consecutive frames: it reads the tile's signal span from
// device memory once (16-byte loads) into shared memory, and only the
// (n_mels + 1) outputs per frame leave the SM.
//
// The real fft_n-point DFT is an H = fft_n/2-point complex FFT of
// z[m] = x[2m] + i x[2m+1], followed by the split step
//   X[k] = E[k] + W^k O[k],  E = (Z[k] + conj Z[H-k]) / 2,
//                            O = (Z[k] - conj Z[H-k]) / 2i,
// with twiddles taken from float64 on the host. Mel sums run over each
// filter's nonzero support only (weights packed by the host), which is the
// same sum as the dense product.
//
// Two routes, picked by geometry before the launch (ops/mel_frontend.py:
// fft_plan):
//
// - fft_n 256, 512, 1024, 2048: one warp per frame. The H points live in
//   registers, P = H/32 a lane (lane l holds z[l + 32m]), and the FFT runs
//   as Stockham passes of radix 8, 4 or 2 in registers (256 = 8*8*4, 128 =
//   4*4*4*2, 512 = 8*8*8, 1024 = 8*8*4*4): a pass twiddles each lane's
//   butterfly inputs, runs the radix-R DFT in registers and stores its
//   outputs in natural Stockham order to a warp-private plane of shared
//   memory, from which the next pass loads its inputs again as z[l + 32m].
//   The planes hold one pad element after every 16 (pad below): every
//   load and the stores of all passes but the second (2-way; 4-way at
//   fft_n 256) are free of bank conflicts, and a load's address is a
//   per-lane base plus a constant. Passes exchange with __syncwarp() only: after the block's one
//   load of its span there is no __syncthreads(). Pass twiddles come from a
//   per-pass table staged in shared memory, indexed [r * Ns + s] so that a
//   warp's reads are consecutive or broadcasts. Each lane then takes the
//   split step and power for bins l, l + 32, ... (lane 0 also H), the frame
//   energy is the lanes' partial sums plus a shuffle tree, and each lane
//   sums the mel filters l, l + 32, ... over their support, from weights
//   staged once per block. Frames per block (4 to 24) are chosen by the caller
//   from B * T, so that a short batch still spreads over the SMs.
//
//   This route computes in float64 from the windowing (float32 samples,
//   the float64 window) to the mel sums, and rounds each output once. In
//   float32 any FFT loses the lowest mel filter: after
//   pre-emphasis its single bin can sit 60-70 dB under the frame's
//   spectrum, and an fp32 FFT's (or its split step's) absolute error, a
//   few ulps of the large bins, is then a relative error of 1e-4 to 1e-3
//   there; the log and DCT carry it into every cepstrum. An fp32 version
//   of this design, emulated in NumPy with the card's FMA rounding on the
//   serving step's signals, came out farther from a float64 oracle than
//   the first port's radix-2 FFT; in float64 the kernel is nearer it than
//   the plain fp32 chain. The H100 runs float64 at half the fp32 rate,
//   which the instruction count, not the arithmetic, decides here.
// - every other power of two: the first port's block-wide radix-2 FFT in
//   shared memory in float32, eight frames a block.
//
// What bounds it on an H100: at the serving shape (B=64, 10 s, T=999) it
// reads 41 MB of signal and writes 10.5 MB, 15 us at 3.35 TB/s; the FFT
// form needs about 16 kFLOP per frame, ~1 GFLOP in all, also ~15 us at
// 67 TFLOP/s fp32 (30 us at the 34 TFLOP/s of float64). The warp route's
// instruction count (about 500 warp instructions a frame: loads, three
// passes, four exchanges, split, mel) is what it spends beyond that.
//
// Compiled without --use_fast_math.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr double SQRT1_2 = 0.70710678118654752440;

// ---- warp-per-frame route ---------------------------------------------------

// The radix plan of an H-point FFT (mirrored by ops/mel_frontend.py:fft_plan)
__host__ __device__ constexpr int plan_passes(int h) { return (h == 256 || h == 512) ? 3 : 4; }
__host__ __device__ constexpr int plan_radix(int h, int p) {
    return h == 128 ? (p < 3 ? 4 : 2) : h == 256 ? (p < 2 ? 8 : 4) : h == 512 ? 8 : (p < 2 ? 8 : 4);
}
// Ns of pass p: the product of the radices before it
__host__ __device__ constexpr int plan_stride(int h, int p) {
    int s = 1;
    for (int q = 0; q < p; ++q) s *= plan_radix(h, q);
    return s;
}
// offset of pass p's twiddles W_{Ns R}^{r s} (r < R, s < Ns) in the table;
// pass 0 has none (Ns = 1)
__host__ __device__ constexpr int plan_tw_offset(int h, int p) {
    int o = 0;
    for (int q = 1; q < p; ++q) o += plan_radix(h, q) * plan_stride(h, q);
    return o;
}

// element i of a warp's plane of doubles: one pad element after every 16
// (tests/test_torch_frontend_fft.py:padded); lane + 32m maps to a per-lane
// base plus a constant, so the loads cost no index arithmetic
__device__ __forceinline__ int pad(int i) { return i + (i >> 4); }
template <int H> __host__ __device__ constexpr int plane_size() { return H + H / 16; }

__device__ __forceinline__ void cmul(double& ar, double& ai, double2 w) {
    const double r = ar * w.x - ai * w.y;
    ai = ar * w.y + ai * w.x;
    ar = r;
}

// 4-point DFT (W_4 = -i) of y0..y3 into Y0..Y3
__device__ __forceinline__ void dft4(double y0r, double y0i, double y1r, double y1i, double y2r,
                                     double y2i, double y3r, double y3i, double& o0r, double& o0i,
                                     double& o1r, double& o1i, double& o2r, double& o2i,
                                     double& o3r, double& o3i) {
    const double c0r = y0r + y2r, c0i = y0i + y2i;
    const double c1r = y0r - y2r, c1i = y0i - y2i;
    const double c2r = y1r + y3r, c2i = y1i + y3i;
    const double c3r = y1i - y3i, c3i = y3r - y1r;  // (y1 - y3)(-i)
    o0r = c0r + c2r; o0i = c0i + c2i;
    o2r = c0r - c2r; o2i = c0i - c2i;
    o1r = c1r + c3r; o1i = c1i + c3i;
    o3r = c1r - c3r; o3i = c1i - c3i;
}

// radix-R DFT (forward, W_R = exp(-2 pi i / R)) in place on v[c + r * C]
template <int R, int C, int P>
__device__ __forceinline__ void dft(double (&vr)[P], double (&vi)[P], int c) {
    if constexpr (R == 2) {
        const double ar = vr[c], ai = vi[c], br = vr[c + C], bi = vi[c + C];
        vr[c] = ar + br; vi[c] = ai + bi;
        vr[c + C] = ar - br; vi[c + C] = ai - bi;
    } else if constexpr (R == 4) {
        dft4(vr[c], vi[c], vr[c + C], vi[c + C], vr[c + 2 * C], vi[c + 2 * C], vr[c + 3 * C],
             vi[c + 3 * C], vr[c], vi[c], vr[c + C], vi[c + C], vr[c + 2 * C], vi[c + 2 * C],
             vr[c + 3 * C], vi[c + 3 * C]);
    } else {
        static_assert(R == 8, "radix 2, 4 or 8");
        // a_n = x_n + x_{n+4} -> X0, X2, X4, X6; b_n = (x_n - x_{n+4}) W8^n -> X1, X3, X5, X7
        const double a0r = vr[c] + vr[c + 4 * C], a0i = vi[c] + vi[c + 4 * C];
        const double a1r = vr[c + C] + vr[c + 5 * C], a1i = vi[c + C] + vi[c + 5 * C];
        const double a2r = vr[c + 2 * C] + vr[c + 6 * C], a2i = vi[c + 2 * C] + vi[c + 6 * C];
        const double a3r = vr[c + 3 * C] + vr[c + 7 * C], a3i = vi[c + 3 * C] + vi[c + 7 * C];
        const double b0r = vr[c] - vr[c + 4 * C], b0i = vi[c] - vi[c + 4 * C];
        const double d1r = vr[c + C] - vr[c + 5 * C], d1i = vi[c + C] - vi[c + 5 * C];
        const double d2r = vr[c + 2 * C] - vr[c + 6 * C], d2i = vi[c + 2 * C] - vi[c + 6 * C];
        const double d3r = vr[c + 3 * C] - vr[c + 7 * C], d3i = vi[c + 3 * C] - vi[c + 7 * C];
        const double b1r = (d1r + d1i) * SQRT1_2, b1i = (d1i - d1r) * SQRT1_2;     // W8
        const double b2r = d2i, b2i = -d2r;                                        // W8^2 = -i
        const double b3r = (d3i - d3r) * SQRT1_2, b3i = -(d3r + d3i) * SQRT1_2;    // W8^3
        dft4(a0r, a0i, a1r, a1i, a2r, a2i, a3r, a3i, vr[c], vi[c], vr[c + 2 * C], vi[c + 2 * C],
             vr[c + 4 * C], vi[c + 4 * C], vr[c + 6 * C], vi[c + 6 * C]);
        dft4(b0r, b0i, b1r, b1i, b2r, b2i, b3r, b3i, vr[c + C], vi[c + C], vr[c + 3 * C],
             vi[c + 3 * C], vr[c + 5 * C], vi[c + 5 * C], vr[c + 7 * C], vi[c + 7 * C]);
    }
}

// Stockham passes PASS.. of the H-point FFT; on entry lane l holds
// z[l + 32m] in (vr[m], vi[m]); on return Z[k] is in the planes at pad(k)
template <int H, int PASS>
__device__ __forceinline__ void fft_passes(double (&vr)[H / 32], double (&vi)[H / 32],
                                           double* pr, double* pi, const double2* tw, int lane) {
    constexpr int P = H / 32;
    constexpr int R = plan_radix(H, PASS);
    constexpr int NS = plan_stride(H, PASS);
    constexpr int TW = plan_tw_offset(H, PASS);
    constexpr int C = P / R;  // butterflies a lane
#pragma unroll
    for (int c = 0; c < C; ++c) {
        const int j = lane + 32 * c;
        const int s = j & (NS - 1);
        if constexpr (PASS > 0) {
#pragma unroll
            for (int r = 1; r < R; ++r) cmul(vr[c + r * C], vi[c + r * C], tw[TW + r * NS + s]);
        }
        dft<R, C>(vr, vi, c);
        const int d = (j / NS) * NS * R + s;
#pragma unroll
        for (int r = 0; r < R; ++r) {
            const int w = pad(d + r * NS);
            pr[w] = vr[c + r * C];
            pi[w] = vi[c + r * C];
        }
    }
    __syncwarp();
    if constexpr (PASS + 1 < plan_passes(H)) {
#pragma unroll
        for (int m = 0; m < P; ++m) {
            const int w = pad(lane + 32 * m);
            vr[m] = pr[w];
            vi[m] = pi[w];
        }
        __syncwarp();
        fft_passes<H, PASS + 1>(vr, vi, pr, pi, tw, lane);
    }
}

// the split step and power of bin k (0 <= k <= H) from the planes; cs[k]
// = (cos, sin)(2 pi k / fft_n)
template <int H>
__device__ __forceinline__ double split_power(const double* pr, const double* pi,
                                              const double2* cs, int k) {
    const int ka = pad(k & (H - 1)), kb = pad((H - k) & (H - 1));
    const double ar = pr[ka], ai = pi[ka], br = pr[kb], bi = pi[kb];
    const double er = 0.5 * (ar + br), ei = 0.5 * (ai - bi);
    const double orr = 0.5 * (ai + bi), oi = -0.5 * (ar - br);
    const double2 w = cs[k];
    const double xr = er + (w.x * orr + w.y * oi);
    const double xi = ei + (w.x * oi - w.y * orr);
    return (xr * xr + xi * xi) * (1.0 / (2 * H));
}

// shared memory of a block of the warp route, in bytes: the float64 parts
// (twiddles, window, each warp's planes, mel weights), then the filters'
// supports, then the signal span at a 16-byte boundary
template <int H>
size_t warp_smem_bytes(int warps, int fpb, int frame_step, int n_mels, int nnz) {
    size_t used = 16 * ((size_t)plan_tw_offset(H, plan_passes(H)) + H + 1)
                  + 8 * (2 * (size_t)H + (size_t)warps * 2 * plane_size<H>() + nnz)
                  + 4 * 3 * (size_t)n_mels;
    used = (used + 15) & ~(size_t)15;
    return used + 4 * ((size_t)(fpb - 1) * frame_step + 2 * H + 3);
}

template <int H>
__global__ void __launch_bounds__(256)
mel_frontend_warp(const float* __restrict__ y,        // (B, S) pre-emphasized
                  int S, int T, int frame_len, int frame_step, int fpb,
                  const double* __restrict__ window,  // (frame_len,)
                  const double2* __restrict__ tw64,   // pass twiddles, then (cos, sin)(2 pi k / fft_n), k <= H
                  const double* __restrict__ mel_w,   // (nnz,) each filter's support weights
                  int nnz,
                  const int* __restrict__ mel_lo,     // (n_mels,) first nonzero bin
                  const int* __restrict__ mel_hi,     // (n_mels,) last nonzero bin + 1
                  const int* __restrict__ mel_off,    // (n_mels,) offset in mel_w
                  int n_mels,
                  float* __restrict__ mel,            // (B, T, n_mels)
                  float* __restrict__ energy)         // (B, T)
{
    constexpr int P = H / 32;
    constexpr int FFT_N = 2 * H;
    constexpr int NTW = plan_tw_offset(H, plan_passes(H));
    extern __shared__ __align__(16) unsigned char smem_raw[];
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int warps = blockDim.x >> 5;
    const int b = blockIdx.y;
    const int t0 = blockIdx.x * fpb;

    double2* tw_s = reinterpret_cast<double2*>(smem_raw);  // NTW + H + 1
    double2* cs_s = tw_s + NTW;                             // split twiddles
    double* win = reinterpret_cast<double*>(tw_s + NTW + H + 1);  // FFT_N, 0 past frame_len
    constexpr int PLANE = plane_size<H>();
    double* planes = win + FFT_N;                           // warps x (re | im)
    double* w_s = planes + warps * 2 * PLANE;               // nnz
    int* lo_s = reinterpret_cast<int*>(w_s + nnz);         // n_mels
    int* hi_s = lo_s + n_mels;
    int* off_s = hi_s + n_mels;
    const size_t used = reinterpret_cast<unsigned char*>(off_s + n_mels) - smem_raw;
    float* region = reinterpret_cast<float*>(smem_raw + ((used + 15) & ~(size_t)15));

    for (int i = tid; i < NTW + H + 1; i += blockDim.x) tw_s[i] = tw64[i];
    for (int i = tid; i < nnz; i += blockDim.x) w_s[i] = mel_w[i];
    for (int i = tid; i < FFT_N; i += blockDim.x) win[i] = i < frame_len ? window[i] : 0.0;
    for (int i = tid; i < n_mels; i += blockDim.x) {
        lo_s[i] = mel_lo[i];
        hi_s[i] = mel_hi[i];
        off_s[i] = mel_off[i];
    }

    // the tile's signal span, zero past S (the reference's tail pad) and
    // past the last frame's fft_n window; seg shares the source's alignment
    // mod 16 bytes, so the body moves as float4
    const long base = (long)t0 * frame_step;
    const float* src = y + (size_t)b * S + base;
    const int span = (fpb - 1) * frame_step + FFT_N;
    const long rest = (long)S - base;
    const int valid = rest < 0 ? 0 : (rest < span ? (int)rest : span);
    const int mis = (int)((reinterpret_cast<uintptr_t>(src) >> 2) & 3);
    float* seg = region + mis;
    const int head = min((4 - mis) & 3, valid);
    const int nvec = (valid - head) >> 2;
    for (int i = tid; i < head; i += blockDim.x) seg[i] = src[i];
    const float4* src4 = reinterpret_cast<const float4*>(src + head);
    float4* seg4 = reinterpret_cast<float4*>(seg + head);
    for (int i = tid; i < nvec; i += blockDim.x) seg4[i] = src4[i];
    for (int i = head + 4 * nvec + tid; i < valid; i += blockDim.x) seg[i] = src[i];
    for (int i = valid + tid; i < span; i += blockDim.x) seg[i] = 0.0f;
    __syncthreads();

    double* pr = planes + warp * 2 * PLANE;
    double* pi = pr + PLANE;
    for (int f = warp; f < fpb; f += warps) {
        const int t = t0 + f;
        if (t >= T) break;  // uniform across the warp
        const int fo = f * frame_step;
        // windowed samples, in float64 with the float64 window
        double vr[P], vi[P];
        if (((mis + fo) & 1) == 0) {  // sample pairs 8-byte aligned
#pragma unroll
            for (int m = 0; m < P; ++m) {
                const int n = 2 * (lane + 32 * m);
                const float2 s2 = *reinterpret_cast<const float2*>(seg + fo + n);
                const double2 w2 = *reinterpret_cast<const double2*>(win + n);
                vr[m] = (double)s2.x * w2.x;
                vi[m] = (double)s2.y * w2.y;
            }
        } else {
#pragma unroll
            for (int m = 0; m < P; ++m) {
                const int n = 2 * (lane + 32 * m);
                const double2 w2 = *reinterpret_cast<const double2*>(win + n);
                vr[m] = (double)seg[fo + n] * w2.x;
                vi[m] = (double)seg[fo + n + 1] * w2.y;
            }
        }
        fft_passes<H, 0>(vr, vi, pr, pi, tw_s, lane);

        // split and power of bins lane + 32m (and H on lane 0), then the
        // power over the re plane, unpadded
        double pw[P];
        double part = 0.0;
#pragma unroll
        for (int m = 0; m < P; ++m) {
            pw[m] = split_power<H>(pr, pi, cs_s, lane + 32 * m);
            part += pw[m];
        }
        const double p_h = lane == 0 ? split_power<H>(pr, pi, cs_s, H) : 0.0;
        part += p_h;
        __syncwarp();
#pragma unroll
        for (int m = 0; m < P; ++m) pr[lane + 32 * m] = pw[m];
        if (lane == 0) pr[H] = p_h;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) part += __shfl_xor_sync(FULL, part, off);
        __syncwarp();

        const size_t row = (size_t)b * T + t;
        for (int m = lane; m < n_mels; m += 32) {
            const int lo = lo_s[m], hi = hi_s[m];
            const double* w = w_s + off_s[m] - lo;
            double acc = 0.0;
            for (int k = lo; k < hi; ++k) acc += w[k] * pr[k];
            mel[row * n_mels + m] = (float)acc;
        }
        if (lane == 0) energy[row] = (float)part;
        __syncwarp();  // the power is read before the next frame's stores
    }
}

// ---- generic route: block-wide radix-2 FFT in shared memory -----------------

constexpr int FRAMES = 8;    // frames per block
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
mel_frontend_generic(const float* __restrict__ y, int S, int T, int frame_len, int frame_step,
                     int half, int log2_half, const double* __restrict__ window,
                     const double2* __restrict__ cs,  // (cos, sin)(2 pi k / fft_n), k <= half
                     const double* __restrict__ mel_w, const int* __restrict__ mel_lo,
                     const int* __restrict__ mel_hi, const int* __restrict__ mel_off, int n_mels,
                     float* __restrict__ mel, float* __restrict__ energy)
{
    extern __shared__ float smem[];
    const int bins = half + 1;
    const int seg_len = (FRAMES - 1) * frame_step + frame_len;
    float* seg = smem;                          // seg_len
    float* zre = seg + seg_len;                 // FRAMES * half
    float* zim = zre + FRAMES * half;           // FRAMES * half
    float* pw = zim + FRAMES * half;            // FRAMES * bins
    float* twc = pw + FRAMES * bins;            // bins
    float* tws = twc + bins;                    // bins

    const int b = blockIdx.y;
    const int t0 = blockIdx.x * FRAMES;
    const int tid = threadIdx.x;
    const float inv_n = 1.0f / (float)(2 * half);
    const float* yb = y + (size_t)b * S;

    // 1. the tile's signal span (zero past S: the reference's tail pad)
    const long base = (long)t0 * frame_step;
    for (int i = tid; i < seg_len; i += THREADS) {
        long g = base + i;
        seg[i] = g < S ? yb[g] : 0.0f;
    }
    for (int k = tid; k < bins; k += THREADS) {
        twc[k] = (float)cs[k].x;  // rounded once from float64
        tws[k] = (float)cs[k].y;
    }
    __syncthreads();

    // 2. window, zero-pad to fft_n, pack even/odd samples as one complex
    //    sequence, stored in bit-reversed order for the in-place DIT FFT
    for (int idx = tid; idx < FRAMES * half; idx += THREADS) {
        int f = idx >> log2_half;
        int m = idx & (half - 1);
        int n0 = 2 * m, n1 = 2 * m + 1;
        const float* fr = seg + f * frame_step;
        float x0 = n0 < frame_len ? fr[n0] * (float)window[n0] : 0.0f;
        float x1 = n1 < frame_len ? fr[n1] * (float)window[n1] : 0.0f;
        int r = log2_half ? (int)(__brev((unsigned)m) >> (32 - log2_half)) : 0;
        zre[f * half + r] = x0;
        zim[f * half + r] = x1;
    }
    __syncthreads();

    // 3. radix-2 butterflies; W_half^j = W_fft_n^(2j), so the stage twiddle
    //    index into the fft_n table is j * (fft_n / span)
    for (int s = 1; s <= log2_half; ++s) {
        const int hs = 1 << (s - 1);
        const int tw_stride = (2 * half) >> s;
        for (int idx = tid; idx < FRAMES * (half >> 1); idx += THREADS) {
            int f = idx / (half >> 1);
            int q = idx - f * (half >> 1);
            int pos = q & (hs - 1);
            int i0 = f * half + ((q >> (s - 1)) << s) + pos;
            int i1 = i0 + hs;
            float c = twc[pos * tw_stride];
            float sn = tws[pos * tw_stride];
            float ar = zre[i1], ai = zim[i1];
            float tr = c * ar + sn * ai;       // (c - i sn) * (ar + i ai)
            float ti = c * ai - sn * ar;
            float ur = zre[i0], ui = zim[i0];
            zre[i0] = ur + tr;
            zim[i0] = ui + ti;
            zre[i1] = ur - tr;
            zim[i1] = ui - ti;
        }
        __syncthreads();
    }

    // 4. split the half-size complex spectrum into the real DFT; power
    for (int idx = tid; idx < FRAMES * bins; idx += THREADS) {
        int f = idx / bins;
        int k = idx - f * bins;
        int ka = k & (half - 1);              // k mod half (Z[half] = Z[0])
        int kb = (half - k) & (half - 1);
        float ar = zre[f * half + ka], ai = zim[f * half + ka];
        float br = zre[f * half + kb], bi = zim[f * half + kb];
        float er = 0.5f * (ar + br), ei = 0.5f * (ai - bi);
        float orr = 0.5f * (ai + bi), oi = -0.5f * (ar - br);
        float c = twc[k], sn = tws[k];
        float xr = er + (c * orr + sn * oi);
        float xi = ei + (c * oi - sn * orr);
        pw[idx] = (xr * xr + xi * xi) * inv_n;
    }
    __syncthreads();

    // 5. mel energies over each filter's support, total energy over all bins
    const int outs = n_mels + 1;
    for (int idx = tid; idx < FRAMES * outs; idx += THREADS) {
        int f = idx / outs;
        int m = idx - f * outs;
        int t = t0 + f;
        if (t >= T) continue;
        const float* p = pw + f * bins;
        float acc = 0.0f;
        if (m < n_mels) {
            const double* w = mel_w + mel_off[m] - mel_lo[m];
            for (int k = mel_lo[m]; k < mel_hi[m]; ++k) acc += (float)w[k] * p[k];
            mel[((size_t)b * T + t) * n_mels + m] = acc;
        } else {
            for (int k = 0; k < bins; ++k) acc += p[k];
            energy[(size_t)b * T + t] = acc;
        }
    }
}

size_t generic_smem_bytes(int frame_len, int frame_step, int half) {
    size_t seg_len = (size_t)(FRAMES - 1) * frame_step + frame_len;
    size_t bins = half + 1;
    return sizeof(float) * (seg_len + 2 * (size_t)FRAMES * half + FRAMES * bins + 2 * bins);
}

template <int H>
int launch_warp(const float* y, int B, int S, int T, int frame_len, int frame_step, int fpb,
                const double* window, const double* tw64, const double* mel_w, int nnz,
                const int* mel_lo, const int* mel_hi, const int* mel_off, int n_mels, float* mel,
                float* energy, cudaStream_t stream) {
    if (fpb < 1) return (int)cudaErrorInvalidValue;
    const int warps = fpb < 8 ? fpb : 8;
    size_t smem = warp_smem_bytes<H>(warps, fpb, frame_step, n_mels, nnz);
    cudaError_t err = cudaFuncSetAttribute(
        mel_frontend_warp<H>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((T + fpb - 1) / fpb, B);
    mel_frontend_warp<H><<<grid, warps * 32, smem, stream>>>(
        y, S, T, frame_len, frame_step, fpb, window, reinterpret_cast<const double2*>(tw64),
        mel_w, nnz, mel_lo, mel_hi, mel_off, n_mels, mel, energy);
    return (int)cudaGetLastError();
}

}  // namespace

// fpb: frames per block of the warp route (its warps = min(fpb, 8)); the
// generic route takes eight a block and ignores it. tw64: the warp route's
// pass twiddles (none on the generic route), then the split twiddles.
extern "C" int mel_frontend_launch(const float* y, int B, int S, int T,
                                   int frame_len, int frame_step, int half, int log2_half,
                                   int fpb, const double* window, const double* tw64,
                                   const double* mel_w, int nnz, const int* mel_lo,
                                   const int* mel_hi, const int* mel_off, int n_mels,
                                   float* mel, float* energy, void* stream) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (half) {
        case 128:
            return launch_warp<128>(y, B, S, T, frame_len, frame_step, fpb, window, tw64,
                                    mel_w, nnz, mel_lo, mel_hi, mel_off, n_mels, mel, energy, s);
        case 256:
            return launch_warp<256>(y, B, S, T, frame_len, frame_step, fpb, window, tw64,
                                    mel_w, nnz, mel_lo, mel_hi, mel_off, n_mels, mel, energy, s);
        case 512:
            return launch_warp<512>(y, B, S, T, frame_len, frame_step, fpb, window, tw64,
                                    mel_w, nnz, mel_lo, mel_hi, mel_off, n_mels, mel, energy, s);
        case 1024:
            return launch_warp<1024>(y, B, S, T, frame_len, frame_step, fpb, window, tw64,
                                    mel_w, nnz, mel_lo, mel_hi, mel_off, n_mels, mel, energy, s);
        default: break;
    }
    size_t smem = generic_smem_bytes(frame_len, frame_step, half);
    cudaError_t err = cudaFuncSetAttribute(
        mel_frontend_generic, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((T + FRAMES - 1) / FRAMES, B);
    mel_frontend_generic<<<grid, THREADS, smem, s>>>(
        y, S, T, frame_len, frame_step, half, log2_half, window,
        reinterpret_cast<const double2*>(tw64), mel_w, mel_lo,
        mel_hi, mel_off, n_mels, mel, energy);
    return (int)cudaGetLastError();
}

extern "C" const char* mel_frontend_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
