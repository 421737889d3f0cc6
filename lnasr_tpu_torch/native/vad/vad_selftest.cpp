// Standalone self-test harness for the native VAD detectors, built with
// ASan/UBSan by the test suite (tests/test_native_sanitize.py) to catch
// memory and UB errors that Python-side tests cannot see.
//
// Feeds deterministic pseudo-audio (tones + noise + silence + full-scale
// extremes) through both detectors across resets and mode changes, and
// checks basic invariants. Exit code 0 = clean.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <vector>

#include "vad_amrwb.h"
#include "vad_webrtc.h"

namespace {

uint32_t rng_state = 0x12345678u;

int16_t noise() {
  rng_state = rng_state * 1664525u + 1013904223u;
  return static_cast<int16_t>((rng_state >> 16) % 2001) - 1000;
}

std::vector<int16_t> make_audio(int n) {
  std::vector<int16_t> out(n);
  for (int i = 0; i < n; ++i) {
    const double t = i / 16000.0;
    const int phase = (i / 4000) % 4;
    double v = 0.0;
    if (phase == 0) {
      v = 9000.0 * std::sin(2 * M_PI * 440.0 * t) + noise();
    } else if (phase == 1) {
      v = noise() * 0.2;
    } else if (phase == 2) {
      v = (i % 2 == 0) ? 32767.0 : -32768.0;  // full-scale worst case
    } else {
      v = 6000.0 * std::sin(2 * M_PI * 150.0 * t) *
          std::sin(2 * M_PI * 3.0 * t);
    }
    out[i] = static_cast<int16_t>(std::max(-32768.0, std::min(32767.0, v)));
  }
  return out;
}

}  // namespace

int main() {
  const auto audio = make_audio(16000 * 4);
  int failures = 0;

  // WebRTC-style detector across all modes, with a mid-stream reset
  for (int mode = 0; mode < 4; ++mode) {
    lnasr::WebRtcStyleVad vad;
    vad.SetMode(mode);
    int speech = 0;
    const int frames = static_cast<int>(audio.size()) / 160;
    for (int f = 0; f < frames; ++f) {
      if (f == frames / 2) vad.Reset();
      const int flag = vad.Process(audio.data() + f * 160);
      if (flag < 0) {
        std::fprintf(stderr, "webrtc mode %d: negative flag %d\n", mode, flag);
        ++failures;
      }
      speech += flag > 0;
    }
    std::fprintf(stderr, "webrtc mode %d: %d/%d speech frames\n", mode, speech,
                 frames);
  }

  // multi-rate entries (8/16/32/48 kHz) over the same pseudo-audio
  for (const int rate : {8000, 16000, 32000, 48000}) {
    lnasr::WebRtcStyleVad vad;
    const int frame_len = lnasr::WebRtcStyleVad::FrameLenFor(rate);
    const int frames = static_cast<int>(audio.size()) / frame_len;
    int speech = 0;
    for (int f = 0; f < frames; ++f) {
      const int flag = vad.ProcessAtRate(audio.data() + f * frame_len, rate);
      if (flag < 0) {
        std::fprintf(stderr, "webrtc %d Hz: bad flag %d\n", rate, flag);
        ++failures;
      }
      speech += flag > 0;
    }
    std::fprintf(stderr, "webrtc %d Hz: %d/%d speech frames\n", rate, speech,
                 frames);
  }
  {
    lnasr::WebRtcStyleVad vad;
    int16_t dummy[480] = {};
    if (vad.ProcessAtRate(dummy, 44100) != -1) {
      std::fprintf(stderr, "webrtc: unsupported rate not rejected\n");
      ++failures;
    }
  }

  // AMR-WB detector with threshold changes and pitch-tone hints
  {
    lnasr::AmrWbVad vad;
    vad.set_pow_low(1e8f);
    const int frames = static_cast<int>(audio.size()) / 256;
    int speech = 0;
    for (int f = 0; f < frames; ++f) {
      if (f % 7 == 0) vad.PitchToneDetection(0.9f);
      double power = -1.0;
      const int flag = vad.Process(audio.data() + f * 256, &power);
      if (flag != 0 && flag != 1) {
        std::fprintf(stderr, "amrwb: bad flag %d\n", flag);
        ++failures;
      }
      if (power < 0.0) {
        std::fprintf(stderr, "amrwb: negative power %f\n", power);
        ++failures;
      }
      speech += flag;
    }
    vad.Reset();
    std::fprintf(stderr, "amrwb: %d/%d speech frames\n", speech, frames);
  }

  if (failures) {
    std::fprintf(stderr, "FAILED: %d invariant violations\n", failures);
    return 1;
  }
  std::fprintf(stderr, "OK\n");
  return 0;
}
