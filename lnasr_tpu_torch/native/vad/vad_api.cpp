// C ABI for the native VAD detectors, consumed via ctypes from
// lnasr_tpu/vad/native.py. Plain create/reset/process/destroy lifecycle;
// batch entry points loop frames internally so Python pays one FFI call per
// utterance, not per frame.

#include <cstdint>

#include "vad_amrwb.h"
#include "vad_webrtc.h"

extern "C" {

// ---- WebRTC-style GMM VAD (160-sample / 10 ms frames @ 16 kHz) ----------

void* lnasr_wvad_create() { return new lnasr::WebRtcStyleVad(); }

void lnasr_wvad_destroy(void* h) {
  delete static_cast<lnasr::WebRtcStyleVad*>(h);
}

void lnasr_wvad_reset(void* h) { static_cast<lnasr::WebRtcStyleVad*>(h)->Reset(); }

void lnasr_wvad_set_mode(void* h, int mode) {
  static_cast<lnasr::WebRtcStyleVad*>(h)->SetMode(mode);
}

void lnasr_wvad_configure(void* h, int oh1, int oh2, float local_thr,
                          float global_thr) {
  static_cast<lnasr::WebRtcStyleVad*>(h)->Configure(oh1, oh2, local_thr,
                                                    global_thr);
}

int lnasr_wvad_process_frame(void* h, const int16_t* frame) {
  return static_cast<lnasr::WebRtcStyleVad*>(h)->Process(frame);
}

// Processes n_samples/160 whole frames; returns the number of frames.
int lnasr_wvad_process(void* h, const int16_t* samples, int64_t n_samples,
                       int32_t* flags_out) {
  auto* vad = static_cast<lnasr::WebRtcStyleVad*>(h);
  const int64_t n_frames = n_samples / lnasr::WebRtcStyleVad::kFrameLen16k;
  for (int64_t i = 0; i < n_frames; ++i) {
    flags_out[i] = vad->Process(samples + i * lnasr::WebRtcStyleVad::kFrameLen16k);
  }
  return static_cast<int>(n_frames);
}

// Rate-dispatching batch entry: 10 ms frames at 8/16/32/48 kHz (the
// reference's per-rate functions, libfvad vad_core.c:629-694). Returns the
// number of processed frames, or -1 for an unsupported rate.
int lnasr_wvad_process_rate(void* h, const int16_t* samples, int64_t n_samples,
                            int sample_rate_hz, int32_t* flags_out) {
  auto* vad = static_cast<lnasr::WebRtcStyleVad*>(h);
  const int frame_len = lnasr::WebRtcStyleVad::FrameLenFor(sample_rate_hz);
  if (frame_len == 0) return -1;
  const int64_t n_frames = n_samples / frame_len;
  for (int64_t i = 0; i < n_frames; ++i) {
    flags_out[i] = vad->ProcessAtRate(samples + i * frame_len, sample_rate_hz);
  }
  return static_cast<int>(n_frames);
}

// ---- AMR-WB-style VAD (256-sample frames) -------------------------------

void* lnasr_awb_create() { return new lnasr::AmrWbVad(); }

void lnasr_awb_destroy(void* h) { delete static_cast<lnasr::AmrWbVad*>(h); }

void lnasr_awb_reset(void* h) { static_cast<lnasr::AmrWbVad*>(h)->Reset(); }

void lnasr_awb_set_pow_low(void* h, float v) {
  static_cast<lnasr::AmrWbVad*>(h)->set_pow_low(v);
}

void lnasr_awb_set_pow_pitch_tone_thr(void* h, float v) {
  static_cast<lnasr::AmrWbVad*>(h)->set_pow_pitch_tone_thr(v);
}

void lnasr_awb_pitch_tone(void* h, float gain) {
  static_cast<lnasr::AmrWbVad*>(h)->PitchToneDetection(gain);
}

int lnasr_awb_process_frame(void* h, const int16_t* frame, double* power_sum) {
  return static_cast<lnasr::AmrWbVad*>(h)->Process(frame, power_sum);
}

int lnasr_awb_process(void* h, const int16_t* samples, int64_t n_samples,
                      int32_t* flags_out, double* power_out) {
  auto* vad = static_cast<lnasr::AmrWbVad*>(h);
  const int64_t n_frames = n_samples / lnasr::AmrWbVad::kFrameLen;
  for (int64_t i = 0; i < n_frames; ++i) {
    double p = 0.0;
    flags_out[i] = vad->Process(samples + i * lnasr::AmrWbVad::kFrameLen, &p);
    if (power_out != nullptr) power_out[i] = p;
  }
  return static_cast<int>(n_frames);
}

}  // extern "C"
