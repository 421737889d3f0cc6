// WebRTC-style GMM voice activity detector — fresh float C++ implementation
// of the classic WebRTC VAD algorithm (the reference ships the upstream
// fixed-point C library under third/pywvad/libfvad plus a
// float re-derivation in wvad.py): downsample 16 kHz -> 8 kHz, split the
// band into six sub-bands (80 Hz-250-500-1000-2000-3000-4000 Hz) with
// allpass half-band filters, take log sub-band energies, then run a
// two-Gaussian noise/speech likelihood-ratio test per band with online
// model adaptation, minimum-energy tracking, and hangover smoothing.
//
// The framework pairs this streaming host-side detector with a vectorized
// JAX port for offline batch segmentation (lnasr_tpu/vad/webrtc.py); tests
// cross-check the two.

#include "vad_webrtc.h"

#include <algorithm>
#include <cmath>

namespace lnasr {

namespace {

// All constants are the published WebRTC tables, converted from their
// Q-formats to float (as the reference's float port does, wvad.py:14-50).
constexpr float kAllPassUpper = 20972.0f / 32768.0f;
constexpr float kAllPassLower = 5571.0f / 32768.0f;
constexpr float kHpZero[3] = {6631.0f / 16384.0f, -13262.0f / 16384.0f,
                              6631.0f / 16384.0f};
constexpr float kHpPole[3] = {16384.0f / 16384.0f, -7756.0f / 16384.0f,
                              5620.0f / 16384.0f};
constexpr float kBandOffsets[6] = {368.0f / 16, 368.0f / 16, 272.0f / 16,
                                   176.0f / 16, 176.0f / 16, 176.0f / 16};
constexpr float kMinEnergy = 10.0f;
constexpr float kSpectrumWeight[6] = {6, 8, 10, 12, 14, 16};
constexpr float kNoiseUpdate = 655.0f / 32768.0f;
constexpr float kSpeechUpdate = 6554.0f / 32768.0f;
constexpr float kBackEta = 154.0f / 256.0f;
constexpr float kMinimumDifference[6] = {544.0f / 32, 544.0f / 32, 576.0f / 32,
                                         576.0f / 32, 576.0f / 32, 576.0f / 32};
constexpr float kMinimumMean[2] = {640.0f / 128, 768.0f / 128};
constexpr float kMaximumNoise[6] = {9216.0f / 128, 9088.0f / 128, 8960.0f / 128,
                                    8832.0f / 128, 8704.0f / 128, 8576.0f / 128};
constexpr float kMaximumSpeech[6] = {11392.0f / 128, 11392.0f / 128,
                                     11520.0f / 128, 11520.0f / 128,
                                     11520.0f / 128, 11520.0f / 128};
constexpr float kNoiseWeights[12] = {34, 62, 72, 66, 53, 25,
                                     94, 66, 56, 62, 75, 103};
constexpr float kSpeechWeights[12] = {48, 82, 45, 87, 50, 47,
                                      80, 46, 83, 41, 78, 81};
constexpr float kNoiseMeans[12] = {6738, 4892, 7065, 6715, 6771, 3369,
                                   7646, 3863, 7820, 7266, 5020, 4362};
constexpr float kSpeechMeans[12] = {8306, 10085, 10078, 11823, 11843, 6309,
                                    9473, 9571, 10879, 7581, 8180, 7483};
constexpr float kNoiseStds[12] = {378, 1064, 493, 582, 688, 593,
                                  474, 697, 475, 688, 421, 455};
constexpr float kSpeechStds[12] = {555, 505, 567, 524, 585, 1231,
                                   509, 828, 492, 1540, 1079, 850};
constexpr float kMinStd = 384.0f / 128.0f;
constexpr int kMaxSpeechFrames = 6;
constexpr float kSmoothingDown = 6553.0f / 32768.0f;
constexpr float kSmoothingUp = 32439.0f / 32768.0f;
constexpr float kCompVar = 22005.0f / 1024.0f;

// {overhang1, overhang2, local, global} for 10 ms frames, modes 0..3.
constexpr int kModeTable[4][4] = {
    {8, 14, 24, 57}, {8, 14, 37, 100}, {6, 9, 82, 285}, {6, 9, 94, 1100}};

inline float GaussianProbability(float x, float mean, float std) {
  const float q = (x - mean) * (x - mean) / (2.0f * std * std);
  return (q < kCompVar) ? std::exp(-q) / std : 0.0f;
}

}  // namespace

WebRtcStyleVad::WebRtcStyleVad() {
  SetMode(0);
  Reset();
}

void WebRtcStyleVad::SetMode(int mode) {
  mode = std::min(std::max(mode, 0), 3);
  Configure(kModeTable[mode][0], kModeTable[mode][1],
            static_cast<float>(kModeTable[mode][2]),
            static_cast<float>(kModeTable[mode][3]));
}

void WebRtcStyleVad::Configure(int oh1, int oh2, float local_thr,
                               float global_thr) {
  over_hang_max1_ = oh1;
  over_hang_max2_ = oh2;
  local_threshold_ = local_thr;
  global_threshold_ = global_thr;
}

void WebRtcStyleVad::Reset() {
  for (int i = 0; i < kNumGaussians * kNumChannels; ++i) {
    // tables are Gaussian-major (g * kNumChannels + ch), Q7 means / Q7 stds
    noise_means_[i] = kNoiseMeans[i] / 128.0f;
    speech_means_[i] = kSpeechMeans[i] / 128.0f;
    noise_stds_[i] = kNoiseStds[i] / 128.0f;
    speech_stds_[i] = kSpeechStds[i] / 128.0f;
  }
  frame_count_ = 0;
  over_hang_ = 0;
  speech_run_ = 0;
  for (auto& v : low_values_) v.fill(10000.0f / 16.0f);
  for (auto& v : value_ages_) v.fill(0);
  mean_values_.fill(1600.0f / 16.0f);
  downsample_state_.fill(0.0f);
  for (auto& v : upper_state_) v.fill(0.0f);
  for (auto& v : lower_state_) v.fill(0.0f);
  hp_state_.fill(0.0f);
  ds32_state_.fill(0.0f);
  fir48_hist_.fill(0.0f);
}

namespace {

// Allpass-pair halfband lowpass with 2:1 decimation (wvad.py:225-259);
// outputs truncate toward zero like the int16 conversion in the float port.
void HalfbandDecimate(const float* in, int n, float* out, float* state) {
  float s0 = state[0];
  float s1 = state[1];
  for (int k = 0; k < n / 2; ++k) {
    const float x0 = in[2 * k];
    const float x1 = in[2 * k + 1];
    const float a0 = (s0 + kAllPassUpper * x0) * 0.5f;
    s0 = x0 - kAllPassUpper * a0 * 2.0f;
    const float a1 = (s1 + kAllPassLower * x1) * 0.5f;
    s1 = x1 - kAllPassLower * a1 * 2.0f;
    out[k] = std::trunc(a0 + a1);
  }
  state[0] = s0;
  state[1] = s1;
}

// Anti-alias FIR for the 48 kHz -> 16 kHz decimation (the reference C
// library resamples 48 kHz input down to the 8 kHz analysis band with its
// fixed-point resampler chain, libfvad vad_core.c:629-652; here a Kaiser
// windowed sinc at 7 kHz cutoff feeds the same halfband 16->8 stage).
const std::array<float, WebRtcStyleVad::kFir48Taps>& Fir48Coeffs() {
  static const std::array<float, WebRtcStyleVad::kFir48Taps> coeffs = [] {
    std::array<float, WebRtcStyleVad::kFir48Taps> c{};
    constexpr int taps = WebRtcStyleVad::kFir48Taps;
    const double fc = 7000.0 / 48000.0;
    const double beta = 8.0;
    const double denom = std::cyl_bessel_i(0.0, beta);
    double sum = 0.0;
    for (int i = 0; i < taps; ++i) {
      const double m = i - (taps - 1) / 2.0;
      const double s =
          (m == 0.0) ? 2.0 * fc : std::sin(2.0 * M_PI * fc * m) / (M_PI * m);
      const double r = 2.0 * i / (taps - 1) - 1.0;
      const double w = std::cyl_bessel_i(0.0, beta * std::sqrt(1.0 - r * r));
      c[i] = static_cast<float>(s * w / denom);
      sum += c[i];
    }
    for (auto& v : c) v = static_cast<float>(v / sum);
    return c;
  }();
  return coeffs;
}

// Streaming 3:1 FIR decimation; hist carries the last kFir48Taps-1 inputs.
void FirDecimate3(const float* in, int n, float* out, float* hist) {
  constexpr int taps = WebRtcStyleVad::kFir48Taps;
  constexpr int h = taps - 1;
  const auto& c = Fir48Coeffs();
  float ext[480 + h];
  std::copy(hist, hist + h, ext);
  std::copy(in, in + n, ext + h);
  for (int m = 0; m < n / 3; ++m) {
    const float* base = ext + 3 * m;
    float acc = 0.0f;
    for (int t = 0; t < taps; ++t) acc += base[t] * c[taps - 1 - t];
    out[m] = std::trunc(acc);
  }
  std::copy(in + n - h, in + n, hist);
}

}  // namespace

void WebRtcStyleVad::Downsample(const int16_t* in, float* out) {
  float f16[kFrameLen16k];
  for (int i = 0; i < kFrameLen16k; ++i) f16[i] = static_cast<float>(in[i]);
  HalfbandDecimate(f16, kFrameLen16k, out, downsample_state_.data());
}

namespace {

// Second-order allpass y(n) = x(n-2) - c*y(n-2) + c*x(n), two-deep state.
inline float AllPassStep(float x, float c, float* s) {
  const float y = s[0] + c * x;
  s[0] = s[1];
  s[1] = x - c * y;
  return y;
}

// One halfband split with decimation: y_hp/y_lp get n/2 samples each.
// Both allpass branches run over every sample; the highpass/lowpass parts
// combine the lower branch's odd outputs with the upper branch's even
// outputs (QMF pair — wvad.py:160-191).
void SplitFilter(const float* x, int n, float* state_upper, float* state_lower,
                 float* y_hp, float* y_lp) {
  for (int i = 0; i < n; i += 2) {
    const float a0_even = AllPassStep(x[i], kAllPassUpper, state_upper);
    AllPassStep(x[i + 1], kAllPassUpper, state_upper);
    AllPassStep(x[i], kAllPassLower, state_lower);
    const float a1_odd = AllPassStep(x[i + 1], kAllPassLower, state_lower);
    y_hp[i / 2] = 0.5f * (a1_odd - a0_even);
    y_lp[i / 2] = 0.5f * (a1_odd + a0_even);
  }
}

void HighPass80(const float* x, int n, float* state, float* y) {
  for (int i = 0; i < n; ++i) {
    const float yi = kHpZero[0] * x[i] + kHpZero[1] * state[0] +
                     kHpZero[2] * state[1] - kHpPole[1] * state[2] -
                     kHpPole[2] * state[3];
    state[1] = state[0];
    state[0] = x[i];
    state[3] = state[2];
    state[2] = yi;
    y[i] = yi;
  }
}

float LogEnergy(const float* x, int n, float offset, float* total_energy) {
  double energy = 0.0;
  for (int i = 0; i < n; ++i) energy += static_cast<double>(x[i]) * x[i];
  float log_energy;
  if (energy > 0.0) {
    log_energy = 10.0f * std::log10(static_cast<float>(energy)) + offset;
  } else {
    return offset;  // silent band contributes only its offset
  }
  if (*total_energy <= kMinEnergy) {
    if (energy >= 16384.0) {
      *total_energy += kMinEnergy + 1.0f;
    } else {
      *total_energy += static_cast<float>(energy);
    }
  }
  return log_energy;
}

}  // namespace

float WebRtcStyleVad::CalculateFeatures(const float* frame8k, float* features) {
  float total_energy = 0.0f;
  // working buffers sized for the deepest level
  float a[40], b[40], c[20], d[20], e[10], f[10], g[5], h[5];

  // 0-4 kHz -> (2-4 kHz, 0-2 kHz)
  SplitFilter(frame8k, 80, upper_state_[0].data(), lower_state_[0].data(), a, b);
  // 2-4 kHz -> (3-4 kHz, 2-3 kHz)
  SplitFilter(a, 40, upper_state_[1].data(), lower_state_[1].data(), c, d);
  features[5] = LogEnergy(c, 20, kBandOffsets[5], &total_energy);
  features[4] = LogEnergy(d, 20, kBandOffsets[4], &total_energy);
  // 0-2 kHz -> (1-2 kHz, 0-1 kHz)
  SplitFilter(b, 40, upper_state_[2].data(), lower_state_[2].data(), c, d);
  features[3] = LogEnergy(c, 20, kBandOffsets[3], &total_energy);
  // 0-1 kHz -> (0.5-1 kHz, 0-0.5 kHz)
  SplitFilter(d, 20, upper_state_[3].data(), lower_state_[3].data(), e, f);
  features[2] = LogEnergy(e, 10, kBandOffsets[2], &total_energy);
  // 0-0.5 kHz -> (0.25-0.5 kHz, 0-0.25 kHz)
  SplitFilter(f, 10, upper_state_[4].data(), lower_state_[4].data(), g, h);
  features[1] = LogEnergy(g, 5, kBandOffsets[1], &total_energy);
  // remove 0-80 Hz, keep 80-250 Hz
  float hp[5];
  HighPass80(h, 5, hp_state_.data(), hp);
  features[0] = LogEnergy(hp, 5, kBandOffsets[0], &total_energy);
  return total_energy;
}

float WebRtcStyleVad::FindMinimum(float value, int ch) {
  // Track the 16 smallest band energies over the last ~100 frames and
  // smooth their low quantile into a running noise-floor mean
  // (wvad.py:336-383).
  auto& lows = low_values_[ch];
  auto& ages = value_ages_[ch];
  for (int k = 0; k < 16; ++k) {
    if (ages[k] != 100) {
      ++ages[k];
    } else {
      for (int j = k; j < 15; ++j) {
        lows[j] = lows[j + 1];
        ages[j] = ages[j + 1];
      }
      ages[15] = 101;
      lows[15] = 10000.0f / 16.0f;
    }
  }
  for (int k = 0; k < 16; ++k) {
    if (value < lows[k]) {
      for (int j = 15; j > k; --j) {
        lows[j] = lows[j - 1];
        ages[j] = ages[j - 1];
      }
      lows[k] = value;
      ages[k] = 1;
      break;
    }
  }
  float median = 1600.0f / 16.0f;
  if (frame_count_ > 2) {
    median = lows[2];
  } else if (frame_count_ > 0) {
    median = lows[0];
  }
  float alpha = 0.0f;
  if (frame_count_ > 0) {
    alpha = (median < mean_values_[ch]) ? kSmoothingDown : kSmoothingUp;
  }
  mean_values_[ch] = (alpha + 1.0f / 32768.0f) * mean_values_[ch] +
                     (1.0f - alpha) * median + 16384.0f / 524288.0f;
  return mean_values_[ch];
}

int WebRtcStyleVad::GmmDecision(const float* features, float total_power) {
  int vadflag = 0;
  float ngprvec[kNumGaussians][kNumChannels] = {};
  float sgprvec[kNumGaussians][kNumChannels] = {};

  if (total_power > kMinEnergy) {
    float sum_llr = 0.0f;
    for (int ch = 0; ch < kNumChannels; ++ch) {
      float noise_prob[kNumGaussians], speech_prob[kNumGaussians];
      for (int g = 0; g < kNumGaussians; ++g) {
        const int idx = g * kNumChannels + ch;
        noise_prob[g] = (kNoiseWeights[idx] / 128.0f) *
                        GaussianProbability(features[ch], noise_means_[idx],
                                            noise_stds_[idx]);
        speech_prob[g] = (kSpeechWeights[idx] / 128.0f) *
                         GaussianProbability(features[ch], speech_means_[idx],
                                             speech_stds_[idx]);
      }
      const float h0 = noise_prob[0] + noise_prob[1];
      const float h1 = speech_prob[0] + speech_prob[1];
      // log2 likelihood ratio with the fixed-point port's saturation
      const float shift0 = (h0 <= 0.0f) ? 31.0f : (31.0f - 27.0f - std::log2(h0));
      const float shift1 = (h1 <= 0.0f) ? 31.0f : (31.0f - 27.0f - std::log2(h1));
      const float llr = shift0 - shift1;
      sum_llr += llr * kSpectrumWeight[ch];
      if (llr * 4.0f > local_threshold_) vadflag = 1;
      if (h0 > 0.0f) {
        ngprvec[0][ch] = noise_prob[0] / h0;
        ngprvec[1][ch] = 1.0f - ngprvec[0][ch];
      } else {
        ngprvec[0][ch] = 1.0f;
      }
      if (h1 > 0.0f) {
        sgprvec[0][ch] = speech_prob[0] / h1;
        sgprvec[1][ch] = 1.0f - sgprvec[0][ch];
      }
    }
    if (sum_llr >= global_threshold_) vadflag = 1;

    // online model adaptation (wvad.py:496-561)
    for (int ch = 0; ch < kNumChannels; ++ch) {
      const float feature_min = FindMinimum(features[ch], ch);
      auto weighted_mean = [ch](const std::array<float, 12>& means,
                                const float* weights, float offset) {
        float acc = 0.0f;
        for (int g = 0; g < kNumGaussians; ++g) {
          const int idx = g * kNumChannels + ch;
          acc += (means[idx] + offset) * (weights[idx] / 128.0f);
        }
        return acc;
      };
      float noise_global_mean = weighted_mean(noise_means_, kNoiseWeights, 0.0f);

      for (int g = 0; g < kNumGaussians; ++g) {
        const int idx = g * kNumChannels + ch;
        const float nmk = noise_means_[idx];
        const float nsk = noise_stds_[idx];
        const float smk = speech_means_[idx];
        const float ssk = speech_stds_[idx];
        const float delta_n = (features[ch] - nmk) / (nsk * nsk);
        const float delta_s = (features[ch] - smk) / (ssk * ssk);

        float updated = nmk + kBackEta * (feature_min - noise_global_mean);
        if (vadflag == 0) updated += kNoiseUpdate * ngprvec[g][ch] * delta_n;
        noise_means_[idx] = std::max(static_cast<float>(g + 5),
                                     std::min(updated, 72.0f + g - ch));

        if (vadflag > 0) {
          float sm = smk + kSpeechUpdate * sgprvec[g][ch] * delta_s;
          speech_means_[idx] = std::max(kMinimumMean[g],
                                        std::min(sm, (12800.0f + 640.0f) / 128.0f));
          float ss = ssk + sgprvec[g][ch] *
                               (delta_s * (features[ch] - smk) - 1.0f) * 0.1f / ssk;
          speech_stds_[idx] = std::max(ss, kMinStd);
        } else {
          float ns = nsk + ngprvec[g][ch] *
                               (delta_n * (features[ch] - nmk) - 1.0f) / nsk;
          noise_stds_[idx] = std::max(ns, kMinStd);
        }
      }

      // keep the models separated, and keep their global means in range;
      // note the separation offsets are added *into* the means (the
      // original's WeightedAverage mutates its input array)
      noise_global_mean = weighted_mean(noise_means_, kNoiseWeights, 0.0f);
      float speech_global_mean = weighted_mean(speech_means_, kSpeechWeights, 0.0f);
      const float diff = speech_global_mean - noise_global_mean;
      if (diff < kMinimumDifference[ch]) {
        const float t = kMinimumDifference[ch] - diff;
        for (int g = 0; g < kNumGaussians; ++g) {
          speech_means_[g * kNumChannels + ch] += 0.8f * t;
          noise_means_[g * kNumChannels + ch] -= 0.2f * t;
        }
        speech_global_mean = weighted_mean(speech_means_, kSpeechWeights, 0.0f);
        noise_global_mean = weighted_mean(noise_means_, kNoiseWeights, 0.0f);
      }
      if (speech_global_mean > kMaximumSpeech[ch]) {
        const float excess = speech_global_mean - kMaximumSpeech[ch];
        for (int g = 0; g < kNumGaussians; ++g)
          speech_means_[g * kNumChannels + ch] -= excess;
      }
      if (noise_global_mean > kMaximumNoise[ch]) {
        const float excess = noise_global_mean - kMaximumNoise[ch];
        for (int g = 0; g < kNumGaussians; ++g)
          noise_means_[g * kNumChannels + ch] -= excess;
      }
    }
    ++frame_count_;
  }

  // hangover hysteresis (wvad.py:566-580): values >= 2 mark hangover frames
  if (vadflag == 0) {
    if (over_hang_ > 0) {
      vadflag = 2 + over_hang_;
      --over_hang_;
    }
    speech_run_ = 0;
  } else {
    ++speech_run_;
    if (speech_run_ > kMaxSpeechFrames) {
      speech_run_ = kMaxSpeechFrames;
      over_hang_ = over_hang_max2_;
    } else {
      over_hang_ = over_hang_max1_;
    }
  }
  return vadflag;
}

int WebRtcStyleVad::Process(const int16_t* frame) {
  return ProcessAtRate(frame, 16000);
}

int WebRtcStyleVad::ProcessAtRate(const int16_t* frame, int sample_rate_hz) {
  float frame8k[kFrameLen16k / 2];
  switch (sample_rate_hz) {
    case 8000:
      // already the analysis band (libfvad vad_core.c:694-700)
      for (int i = 0; i < 80; ++i) frame8k[i] = static_cast<float>(frame[i]);
      break;
    case 16000:
      Downsample(frame, frame8k);
      break;
    case 32000: {
      // halfband 32 -> 16, then the standard 16 -> 8 stage
      float f32[320], f16[160];
      for (int i = 0; i < 320; ++i) f32[i] = static_cast<float>(frame[i]);
      HalfbandDecimate(f32, 320, f16, ds32_state_.data());
      HalfbandDecimate(f16, 160, frame8k, downsample_state_.data());
      break;
    }
    case 48000: {
      // FIR 3:1 to 16 kHz, then the standard 16 -> 8 stage
      float f48[480], f16[160];
      for (int i = 0; i < 480; ++i) f48[i] = static_cast<float>(frame[i]);
      FirDecimate3(f48, 480, f16, fir48_hist_.data());
      HalfbandDecimate(f16, 160, frame8k, downsample_state_.data());
      break;
    }
    default:
      return -1;
  }
  float features[kNumChannels];
  const float total_power = CalculateFeatures(frame8k, features);
  return GmmDecision(features, total_power);
}

}  // namespace lnasr
