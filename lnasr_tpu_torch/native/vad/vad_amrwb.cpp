// AMR-WB-style voice activity detector (streaming, host-side).
//
// Fresh C++ implementation of the classic AMR-WB VAD algorithm (3GPP TS
// 26.194; the reference wraps a float port of it in
// third/pyvad/src/wb_vad.c): a 12-sub-band half-band
// filterbank over 256-sample frames, per-band signal levels with lookahead
// compensation, an adaptive background-noise estimate with stationarity
// control, an SNR-vs-adaptive-threshold intermediate decision, and
// burst/hangover smoothing.
//
// This is the native streaming path of the framework's VAD subsystem; the
// batch/offline path runs in JAX (lnasr_tpu/vad). Exposed through the C ABI
// in vad_api.cpp for ctypes.

#include "vad_amrwb.h"

#include <algorithm>
#include <cmath>
#include <cstring>

namespace lnasr {

namespace {

// Filterbank coefficients (AMR-WB spec constants).
constexpr float kCoeff3 = 0.407806f;
constexpr float kCoeff5A = 0.670013f;
constexpr float kCoeff5B = 0.195007f;

// Background-noise update rates.
constexpr float kAlphaUpNormal = 1.0f - 0.95f;
constexpr float kAlphaDownNormal = 1.0f - 0.936f;
constexpr float kAlphaUpForced = 1.0f - 0.985f;
constexpr float kAlphaDownForced = 1.0f - 0.943f;
constexpr float kAlphaDownStat = 1.0f - 0.95f;
constexpr float kAlphaStatNormal = 1.0f - 0.9f;
constexpr float kAlphaStatFast = 1.0f - 0.5f;

constexpr float kNoiseMin = 40.0f;
constexpr float kNoiseMax = 20000.0f;
constexpr float kNoiseInit = 150.0f;

// VAD threshold shaping (SCALE = 128).
constexpr float kScale = 128.0f;
constexpr float kThrMin = 1.6f * kScale;
constexpr float kThrHigh = 6.0f * kScale;
constexpr float kThrLow = 1.7f * kScale;
constexpr float kNoiseP1 = 31744.0f;
constexpr float kNoiseP2 = 19786.0f;
constexpr float kNoiseSlope = (kThrLow - kThrHigh) / (kNoiseP2 - kNoiseP1);
constexpr float kSpChMin = -0.75f * kScale;
constexpr float kSpChMax = 0.75f * kScale;
constexpr float kSpP1 = 22527.0f;
constexpr float kSpP2 = 17832.0f;
constexpr float kSpSlope = (kSpChMax - kSpChMin) / (kSpP2 - kSpP1);

// Hangover / burst shaping.
constexpr int kHangHigh = 12;
constexpr int kHangLow = 2;
constexpr float kHangP1 = kThrLow;
constexpr float kHangSlope =
    static_cast<float>(kHangLow - kHangHigh) / ((4.0f * kScale) - kHangP1);
constexpr int kBurstHigh = 8;
constexpr int kBurstLow = 3;
constexpr float kBurstP1 = kThrHigh;
constexpr float kBurstSlope =
    static_cast<float>(kBurstLow - kBurstHigh) / (kThrLow - kBurstP1);

// Stationarity detection.
constexpr int kStatCount = 20;
constexpr float kStatThrLevel = 184.0f;
constexpr float kStatThr = 1000.0f;

// Speech-level estimation.
constexpr int kSpEstCount = 80;
constexpr int kSpActivityCount = 25;
constexpr float kAlphaSpeech = 1.0f - 0.85f;
constexpr float kNomLevel = 2050.0f;
constexpr float kMinSpeechLevel1 = kNomLevel * 0.063f;
constexpr float kMinSpeechLevel2 = kNomLevel * 0.2f;
constexpr float kMinSpeechSnr = 0.125f;

inline float ilog2_scaled(float x) {
  // -1024 * log2(x / 2^31): the spec's inverse-log measure of level.
  return -1024.0f * std::log2(x / 2147483648.0f);
}

}  // namespace

AmrWbVad::AmrWbVad() { Reset(); }

void AmrWbVad::Reset() {
  pitch_tone_reg_ = 0;
  decision_reg_ = 0;
  hang_count_ = 0;
  burst_count_ = 0;
  stat_count_ = 0;
  for (auto& pair : mem5_) pair.fill(0.0f);
  mem3_.fill(0.0f);
  bckr_est_.fill(kNoiseInit);
  old_level_.fill(kNoiseInit);
  ave_level_.fill(kNoiseInit);
  sub_level_.fill(0.0f);
  level_.fill(0.0f);
  sp_est_count_ = 0;
  sp_max_ = 0.0f;
  sp_max_count_ = 0;
  speech_level_ = kNomLevel;
  prev_frame_power_ = 0.0;
  pow_low_ = 30000.0f;
  pow_pitch_tone_thr_ = 686080.0f;
}

// Half-band split: fifth-order allpass pair, in-place on two samples.
void AmrWbVad::Split5(float& even, float& odd, float mem[2]) {
  const float t0 = even - kCoeff5A * mem[0];
  const float low = mem[0] + kCoeff5A * t0;
  mem[0] = t0;
  const float t1 = odd - kCoeff5B * mem[1];
  const float high = mem[1] + kCoeff5B * t1;
  mem[1] = t1;
  even = 0.5f * (low + high);
  odd = 0.5f * (low - high);
}

// Third-order variant.
void AmrWbVad::Split3(float& even, float& odd, float& mem) {
  const float t = odd - kCoeff3 * mem;
  const float branch = mem + kCoeff3 * t;
  mem = t;
  odd = 0.5f * (even - branch);
  even = 0.5f * (even + branch);
}

float AmrWbVad::BandLevel(const float* buf, int band, float* carry) const {
  // Per-band signal level as a scaled absolute sum over the band's
  // decimated samples, with the last `lookahead` samples carried into the
  // next frame (group-delay compensation).
  struct Layout {
    int stride, offset, head, total;
    float scale;
  };
  static const Layout kLayout[12] = {
      {32, 0, kFrameLen / 32 - 6, kFrameLen / 32, 2.0f},
      {32, 16, kFrameLen / 32 - 6, kFrameLen / 32, 2.0f},
      {32, 24, kFrameLen / 32 - 6, kFrameLen / 32, 2.0f},
      {32, 8, kFrameLen / 32 - 6, kFrameLen / 32, 2.0f},
      {16, 12, kFrameLen / 16 - 12, kFrameLen / 16, 1.0f},
      {16, 4, kFrameLen / 16 - 12, kFrameLen / 16, 1.0f},
      {16, 6, kFrameLen / 16 - 12, kFrameLen / 16, 1.0f},
      {16, 14, kFrameLen / 16 - 12, kFrameLen / 16, 1.0f},
      {8, 2, kFrameLen / 8 - 24, kFrameLen / 8, 0.5f},
      {8, 3, kFrameLen / 8 - 24, kFrameLen / 8, 0.5f},
      {8, 7, kFrameLen / 8 - 24, kFrameLen / 8, 0.5f},
      {4, 1, kFrameLen / 4 - 48, kFrameLen / 4, 0.25f},
  };
  const Layout& lay = kLayout[band];
  double tail = 0.0;
  for (int i = lay.head; i < lay.total; ++i) {
    tail += std::fabs(buf[lay.stride * i + lay.offset]);
  }
  tail *= 2.0;
  double level = tail + *carry / lay.scale;
  *carry = static_cast<float>(tail * lay.scale);
  for (int i = 0; i < lay.head; ++i) {
    level += 2.0 * std::fabs(buf[lay.stride * i + lay.offset]);
  }
  return static_cast<float>(level * lay.scale);
}

void AmrWbVad::FilterBank(const int16_t* frame, float* level) {
  float buf[kFrameLen];
  for (int i = 0; i < kFrameLen; ++i) buf[i] = frame[i] * 0.5f;

  for (int i = 0; i < kFrameLen / 2; ++i)
    Split5(buf[2 * i], buf[2 * i + 1], mem5_[0].data());
  for (int i = 0; i < kFrameLen / 4; ++i) {
    Split5(buf[4 * i], buf[4 * i + 2], mem5_[1].data());
    Split5(buf[4 * i + 1], buf[4 * i + 3], mem5_[2].data());
  }
  for (int i = 0; i < kFrameLen / 8; ++i) {
    Split5(buf[8 * i], buf[8 * i + 4], mem5_[3].data());
    Split5(buf[8 * i + 2], buf[8 * i + 6], mem5_[4].data());
    Split3(buf[8 * i + 3], buf[8 * i + 7], mem3_[0]);
  }
  for (int i = 0; i < kFrameLen / 16; ++i) {
    Split3(buf[16 * i + 0], buf[16 * i + 8], mem3_[1]);
    Split3(buf[16 * i + 4], buf[16 * i + 12], mem3_[2]);
    Split3(buf[16 * i + 6], buf[16 * i + 14], mem3_[3]);
  }
  for (int i = 0; i < kFrameLen / 32; ++i) {
    Split3(buf[32 * i + 0], buf[32 * i + 16], mem3_[4]);
    Split3(buf[32 * i + 8], buf[32 * i + 24], mem3_[5]);
  }
  for (int band = 0; band < kNumBands; ++band) {
    level[band] = BandLevel(buf, band, &sub_level_[band]);
  }
}

void AmrWbVad::UpdateStationarity(const float* level) {
  if ((pitch_tone_reg_ & 0x7c00) == 0x7c00) {
    stat_count_ = kStatCount;
  } else if ((decision_reg_ & 0x7f80) == 0) {
    stat_count_ = kStatCount;
  } else {
    float ratio_sum = 0.0f;
    for (int i = 0; i < kNumBands; ++i) {
      float hi = std::max(level[i], ave_level_[i]);
      float lo = std::min(level[i], ave_level_[i]);
      hi = std::max(hi, kStatThrLevel);
      lo = std::max(lo, kStatThrLevel);
      ratio_sum += hi / lo * 64.0f;
    }
    if (ratio_sum > kStatThr) {
      stat_count_ = kStatCount;
    } else if ((decision_reg_ & 0x4000) != 0 && stat_count_ != 0) {
      --stat_count_;
    }
  }
  float alpha = kAlphaStatNormal;
  if (stat_count_ == kStatCount) {
    alpha = 1.0f;
  } else if ((decision_reg_ & 0x4000) == 0) {
    alpha = kAlphaStatFast;
  }
  for (int i = 0; i < kNumBands; ++i) {
    ave_level_[i] += alpha * (level[i] - ave_level_[i]);
  }
}

void AmrWbVad::UpdateNoiseEstimate(const float* level) {
  UpdateStationarity(level);
  float alpha_up = kAlphaUpNormal;
  float alpha_down = kAlphaDownNormal;
  float additive = 2.0f;
  if ((decision_reg_ & 0x7800) != 0) {
    if (stat_count_ == 0) {
      alpha_up = kAlphaUpForced;
      alpha_down = kAlphaDownForced;
    } else {
      alpha_up = 0.0f;
      alpha_down = kAlphaDownStat;
      additive = 0.0f;
    }
  }
  for (int i = 0; i < kNumBands; ++i) {
    const float delta = old_level_[i] - bckr_est_[i];
    if (delta < 0.0f) {
      bckr_est_[i] = std::max(kNoiseMin, bckr_est_[i] - 2.0f + alpha_down * delta);
    } else {
      bckr_est_[i] = std::min(kNoiseMax, bckr_est_[i] + additive + alpha_up * delta);
    }
  }
  std::memcpy(old_level_.data(), level, sizeof(float) * kNumBands);
}

int AmrWbVad::Hangover(bool low_power, int hang_len, int burst_len) {
  if (low_power) {
    burst_count_ = 0;
    hang_count_ = 0;
    return 0;
  }
  if ((decision_reg_ & 0x4000) != 0) {
    if (++burst_count_ >= burst_len) hang_count_ = hang_len;
    return 1;
  }
  burst_count_ = 0;
  if (hang_count_ > 0) {
    --hang_count_;
    return 1;
  }
  return 0;
}

int AmrWbVad::Decision(const float* level, double frame_power) {
  double snr_sum = 0.0;
  for (int i = 0; i < kNumBands; ++i) {
    const float r = level[i] / bckr_est_[i];
    snr_sum += static_cast<double>(r) * r;
  }
  double noise_acc = 0.0;
  for (int i = 1; i < kNumBands; ++i) noise_acc += bckr_est_[i];
  const float noise_level = static_cast<float>(noise_acc / 16.0);

  const float snr_guard = noise_level * kMinSpeechSnr * 8.0f;
  if (speech_level_ < snr_guard) speech_level_ = snr_guard;

  const float inoise = ilog2_scaled(noise_level);
  const float ispeech = ilog2_scaled(speech_level_ - snr_guard);

  float thr = kNoiseSlope * (inoise - kNoiseP1) + kThrHigh;
  float sp_adjust = kSpChMin + kSpSlope * (ispeech - kSpP1);
  sp_adjust = std::min(std::max(sp_adjust, kSpChMin), kSpChMax);
  float vad_thr = std::max(thr + sp_adjust, kThrMin);

  decision_reg_ = static_cast<uint16_t>(decision_reg_ >> 1);
  if (snr_sum > vad_thr * kNumBands / 128.0f) {
    decision_reg_ |= 0x4000;
  }
  const bool low_power = frame_power < pow_low_;
  UpdateNoiseEstimate(level);

  int hang_len = static_cast<int>(kHangSlope * (vad_thr - kHangP1) - 0.5f) + kHangHigh;
  hang_len = std::max(hang_len, kHangLow);
  const int burst_len =
      static_cast<int>(kBurstSlope * (vad_thr - kBurstP1) - 0.5f) + kBurstHigh;
  return Hangover(low_power, hang_len, burst_len);
}

void AmrWbVad::EstimateSpeechLevel(float in_level) {
  if (kSpActivityCount > kSpEstCount - sp_est_count_ + sp_max_count_) {
    sp_est_count_ = 0;
    sp_max_ = 0.0f;
    sp_max_count_ = 0;
  }
  ++sp_est_count_;
  if (((decision_reg_ & 0x4000) != 0 || in_level > speech_level_) &&
      in_level > kMinSpeechLevel1) {
    sp_max_ = std::max(sp_max_, in_level);
    if (++sp_max_count_ >= kSpActivityCount) {
      const float avg = sp_max_ * 0.5f;
      if (avg > kMinSpeechLevel2) {
        speech_level_ += kAlphaSpeech * (avg - speech_level_);
      }
      sp_max_ = 0.0f;
      sp_max_count_ = 0;
      sp_est_count_ = 0;
    }
  }
}

void AmrWbVad::PitchToneDetection(float pitch_gain) {
  pitch_tone_reg_ = static_cast<uint16_t>(pitch_tone_reg_ >> 1);
  if (pitch_gain > 0.65f) pitch_tone_reg_ |= 0x4000;
}

int AmrWbVad::Process(const int16_t* frame, double* power_sum_out) {
  double power = 0.0;
  for (int i = 0; i < kFrameLen; ++i) {
    power += static_cast<double>(frame[i]) * frame[i];
  }
  power *= 2.0;
  const double pow_sum = power + prev_frame_power_;
  prev_frame_power_ = power;
  if (pow_sum < pow_pitch_tone_thr_) {
    pitch_tone_reg_ &= 0x1fff;
  }
  FilterBank(frame, level_.data());
  const int flag = Decision(level_.data(), pow_sum);
  double level_acc = 0.0;
  for (int i = 1; i < kNumBands; ++i) level_acc += level_[i];
  EstimateSpeechLevel(static_cast<float>(level_acc / 16.0));
  if (power_sum_out != nullptr) *power_sum_out = pow_sum;
  return flag;
}

}  // namespace lnasr
