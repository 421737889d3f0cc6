// Fused mel frontend for Hopper (sm_90a): framing -> Hamming window ->
// real FFT power spectrum -> mel energies + total frame energy.
//
// Replaces lnasr_tpu/ops/mfcc_pallas.py:mel_frontend_pallas (kernel bodies
// _make_kernel_radix4 / _make_kernel_radix2 / _make_kernel). The TPU kernel
// runs the DFT as split-bf16 GEMMs through a radix ladder sized for the
// 128-lane MXU; none of that carries over. Here each block takes one
// utterance and a tile of FRAMES frames and keeps the whole chain in shared
// memory: the signal span of the tile is read from device memory once, the
// frames, spectra and power never leave the SM, and only the (n_mels + 1)
// outputs per frame are written.
//
// The real fft_n-point DFT is computed as an fft_n/2-point complex radix-2
// FFT of z[m] = x[2m] + i x[2m+1], followed by the standard split step
//   X[k] = E[k] + W^k O[k],  E = (Z[k] + conj Z[H-k]) / 2,
//                            O = (Z[k] - conj Z[H-k]) / 2i,
// all in fp32 with twiddles rounded once from float64 on the host.
// Mel sums run over each filter's nonzero support only (bounds from the
// host), which is the same sum as the dense product.
//
// What bounds it on an H100: at the serving shape (B=64, 10 s, T=999) it
// reads 41 MB of signal and writes 10.5 MB, 15 us at 3.35 TB/s. The FFT
// form needs about 16 kFLOP per frame (5 H log2 H for the FFT, one multiply
// per windowed sample, ~14 per bin for the split and power, 2 per nonzero
// filter weight, 1 per energy bin), about 1 GFLOP in all, also ~15 us at
// 67 TFLOP/s fp32: the two bounds are within a few percent of each other
// (chip_smoke.py computes both from the run's shapes). A direct DFT against
// a cos/sin table would need ~410 kFLOP per frame (26 GFLOP, ~0.4 ms),
// which is why the kernel takes the FFT form. In practice the butterflies
// are bound by shared-memory traffic and the barriers between stages; that
// is for a later tuning pass.
//
// Compiled without --use_fast_math: the plain PyTorch chain it is held
// against (power_spectrum(method="matmul") @ fbank.T) is full fp32.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int FRAMES = 8;    // frames per block
constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
mel_frontend_kernel(const float* __restrict__ y,        // (B, S) pre-emphasized
                    int S, int T, int frame_len, int frame_step,
                    int half, int log2_half,            // fft_n / 2, log2(fft_n / 2)
                    const float* __restrict__ window,   // (frame_len,)
                    const float* __restrict__ tw_cos,   // (half + 1,) cos(2 pi k / fft_n)
                    const float* __restrict__ tw_sin,   // (half + 1,) sin(2 pi k / fft_n)
                    const float* __restrict__ fbank,    // (n_mels, half + 1)
                    const int* __restrict__ mel_lo,     // (n_mels,) first nonzero bin
                    const int* __restrict__ mel_hi,     // (n_mels,) last nonzero bin + 1
                    int n_mels,
                    float* __restrict__ mel,            // (B, T, n_mels)
                    float* __restrict__ energy)         // (B, T)
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
        twc[k] = tw_cos[k];
        tws[k] = tw_sin[k];
    }
    __syncthreads();

    // 2. window, zero-pad to fft_n, pack even/odd samples as one complex
    //    sequence, stored in bit-reversed order for the in-place DIT FFT
    for (int idx = tid; idx < FRAMES * half; idx += THREADS) {
        int f = idx >> log2_half;
        int m = idx & (half - 1);
        int n0 = 2 * m, n1 = 2 * m + 1;
        const float* fr = seg + f * frame_step;
        float x0 = n0 < frame_len ? fr[n0] * window[n0] : 0.0f;
        float x1 = n1 < frame_len ? fr[n1] * window[n1] : 0.0f;
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
            const float* w = fbank + (size_t)m * bins;
            for (int k = mel_lo[m]; k < mel_hi[m]; ++k) acc += w[k] * p[k];
            mel[((size_t)b * T + t) * n_mels + m] = acc;
        } else {
            for (int k = 0; k < bins; ++k) acc += p[k];
            energy[(size_t)b * T + t] = acc;
        }
    }
}

size_t smem_bytes(int frame_len, int frame_step, int half) {
    size_t seg_len = (size_t)(FRAMES - 1) * frame_step + frame_len;
    size_t bins = half + 1;
    return sizeof(float) * (seg_len + 2 * (size_t)FRAMES * half + FRAMES * bins + 2 * bins);
}

}  // namespace

extern "C" int mel_frontend_launch(const float* y, int B, int S, int T,
                                   int frame_len, int frame_step, int half, int log2_half,
                                   const float* window, const float* tw_cos,
                                   const float* tw_sin, const float* fbank,
                                   const int* mel_lo, const int* mel_hi, int n_mels,
                                   float* mel, float* energy, void* stream) {
    size_t smem = smem_bytes(frame_len, frame_step, half);
    cudaError_t err = cudaFuncSetAttribute(
        mel_frontend_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    dim3 grid((T + FRAMES - 1) / FRAMES, B);
    mel_frontend_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
        y, S, T, frame_len, frame_step, half, log2_half, window, tw_cos, tw_sin,
        fbank, mel_lo, mel_hi, n_mels, mel, energy);
    return (int)cudaGetLastError();
}

extern "C" const char* mel_frontend_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}
