// AMR-WB-style VAD (see vad_amrwb.cpp). Streaming: feed 256-sample frames
// of 16-bit PCM; state persists across frames.
#ifndef LNASR_NATIVE_VAD_AMRWB_H_
#define LNASR_NATIVE_VAD_AMRWB_H_

#include <array>
#include <cstdint>

namespace lnasr {

class AmrWbVad {
 public:
  static constexpr int kFrameLen = 256;
  static constexpr int kNumBands = 12;

  AmrWbVad();
  void Reset();

  // Returns 1 for speech, 0 for noise; optionally reports the two-frame
  // power sum used by the low-power gate.
  int Process(const int16_t* frame, double* power_sum_out);

  // Signals-with-high-pitch-gain hint from an outer pitch tracker.
  void PitchToneDetection(float pitch_gain);

  void set_pow_low(float v) { pow_low_ = v; }
  void set_pow_pitch_tone_thr(float v) { pow_pitch_tone_thr_ = v; }

 private:
  static void Split5(float& even, float& odd, float mem[2]);
  static void Split3(float& even, float& odd, float& mem);
  float BandLevel(const float* buf, int band, float* carry) const;
  void FilterBank(const int16_t* frame, float* level);
  void UpdateStationarity(const float* level);
  void UpdateNoiseEstimate(const float* level);
  int Hangover(bool low_power, int hang_len, int burst_len);
  int Decision(const float* level, double frame_power);
  void EstimateSpeechLevel(float in_level);

  uint16_t pitch_tone_reg_ = 0;
  uint16_t decision_reg_ = 0;
  int hang_count_ = 0;
  int burst_count_ = 0;
  int stat_count_ = 0;
  std::array<std::array<float, 2>, 5> mem5_{};
  std::array<float, 6> mem3_{};
  std::array<float, kNumBands> bckr_est_{};
  std::array<float, kNumBands> old_level_{};
  std::array<float, kNumBands> ave_level_{};
  std::array<float, kNumBands> sub_level_{};
  std::array<float, kNumBands> level_{};
  int sp_est_count_ = 0;
  float sp_max_ = 0.0f;
  int sp_max_count_ = 0;
  float speech_level_ = 0.0f;
  double prev_frame_power_ = 0.0;
  float pow_low_ = 30000.0f;
  float pow_pitch_tone_thr_ = 686080.0f;
};

}  // namespace lnasr

#endif  // LNASR_NATIVE_VAD_AMRWB_H_
