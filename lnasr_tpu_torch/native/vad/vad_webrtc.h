// WebRTC-style GMM voice activity detector (float arithmetic, streaming).
// See vad_webrtc.cpp. Feed 10 ms frames of 16-bit PCM at 8/16/32/48 kHz
// (80/160/320/480 samples).
#ifndef LNASR_NATIVE_VAD_WEBRTC_H_
#define LNASR_NATIVE_VAD_WEBRTC_H_

#include <array>
#include <cstdint>

namespace lnasr {

class WebRtcStyleVad {
 public:
  static constexpr int kFrameLen16k = 160;  // 10 ms @ 16 kHz
  static constexpr int kNumChannels = 6;
  static constexpr int kNumGaussians = 2;
  static constexpr int kFir48Taps = 48;  // 48 kHz -> 16 kHz anti-alias FIR

  // 10 ms of audio at any supported rate; 0 for unsupported rates.
  static constexpr int FrameLenFor(int sample_rate_hz) {
    return (sample_rate_hz == 8000 || sample_rate_hz == 16000 ||
            sample_rate_hz == 32000 || sample_rate_hz == 48000)
               ? sample_rate_hz / 100
               : 0;
  }

  WebRtcStyleVad();

  // Aggressiveness modes 0..3 (quality .. very aggressive), using the
  // standard 10 ms-frame thresholds.
  void SetMode(int mode);
  // Raw thresholds: overhang maxima and local/global likelihood-ratio
  // thresholds (the knobs the reference exposes via reset(k1,k2,kl,kg),
  // third/pywvad/pywvad.pyx:11-23).
  void Configure(int over_hang_max1, int over_hang_max2, float local_thr,
                 float global_thr);
  void Reset();

  // One 10 ms frame @16 kHz -> 0 (noise) or >=1 (speech; values >1 encode
  // hangover frames, matching the reference float port wvad.py:567-580).
  int Process(const int16_t* frame);

  // Rate-dispatching entry like the reference C library's per-rate
  // functions (libfvad vad_core.c:629-694): the frame is 10 ms at
  // sample_rate_hz in {8000, 16000, 32000, 48000}; higher rates are
  // decimated to the 8 kHz analysis band first. Returns -1 for an
  // unsupported rate.
  int ProcessAtRate(const int16_t* frame, int sample_rate_hz);

 private:
  void Downsample(const int16_t* in, float* out);  // 160 -> 80 samples
  float CalculateFeatures(const float* frame8k, float* features);
  float FindMinimum(float value, int ch);
  int GmmDecision(const float* features, float total_power);

  // model state
  std::array<float, kNumGaussians * kNumChannels> noise_means_;
  std::array<float, kNumGaussians * kNumChannels> speech_means_;
  std::array<float, kNumGaussians * kNumChannels> noise_stds_;
  std::array<float, kNumGaussians * kNumChannels> speech_stds_;
  int frame_count_ = 0;
  int over_hang_ = 0;
  int speech_run_ = 0;
  std::array<std::array<float, 16>, kNumChannels> low_values_;
  std::array<std::array<int, 16>, kNumChannels> value_ages_;
  std::array<float, kNumChannels> mean_values_;
  // filter state
  std::array<float, 2> downsample_state_;
  std::array<std::array<float, 2>, 5> upper_state_;
  std::array<std::array<float, 2>, 5> lower_state_;
  std::array<float, 4> hp_state_;
  // multi-rate front states: 32 kHz -> 16 kHz halfband, and the
  // 48 kHz -> 16 kHz decimate-by-3 FIR history
  std::array<float, 2> ds32_state_;
  std::array<float, kFir48Taps - 1> fir48_hist_;
  // thresholds
  int over_hang_max1_ = 8;
  int over_hang_max2_ = 14;
  float local_threshold_ = 24.0f;
  float global_threshold_ = 57.0f;
};

}  // namespace lnasr

#endif  // LNASR_NATIVE_VAD_WEBRTC_H_
