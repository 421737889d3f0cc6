"""ctypes bindings to the native (C++) streaming VAD detectors.

The port's own copy of the JAX package's ``vad/native.py``. The sources
are the port's byte-for-byte copies under ``lnasr_tpu_torch/native/vad/``;
the shared library is compiled with ``g++`` at first use (never on
import) into the git-ignored ``lnasr_tpu_torch/_build/``
(:func:`lnasr_tpu_torch._build.build_native_vad`). The detectors run on
the host: a caller feeds int16 samples and gets per-frame flags back.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import numpy as np

from lnasr_tpu_torch import _build

_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_build.build_native_vad())
        i16p = np.ctypeslib.ndpointer(np.int16, flags="C_CONTIGUOUS")
        i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")

        lib.lnasr_wvad_create.restype = ctypes.c_void_p
        lib.lnasr_wvad_destroy.argtypes = [ctypes.c_void_p]
        lib.lnasr_wvad_reset.argtypes = [ctypes.c_void_p]
        lib.lnasr_wvad_set_mode.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.lnasr_wvad_configure.argtypes = [
            ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_float,
        ]
        lib.lnasr_wvad_process.argtypes = [ctypes.c_void_p, i16p, ctypes.c_int64, i32p]
        lib.lnasr_wvad_process.restype = ctypes.c_int
        lib.lnasr_wvad_process_rate.argtypes = [
            ctypes.c_void_p, i16p, ctypes.c_int64, ctypes.c_int, i32p,
        ]
        lib.lnasr_wvad_process_rate.restype = ctypes.c_int

        lib.lnasr_awb_create.restype = ctypes.c_void_p
        lib.lnasr_awb_destroy.argtypes = [ctypes.c_void_p]
        lib.lnasr_awb_reset.argtypes = [ctypes.c_void_p]
        lib.lnasr_awb_set_pow_low.argtypes = [ctypes.c_void_p, ctypes.c_float]
        lib.lnasr_awb_set_pow_pitch_tone_thr.argtypes = [ctypes.c_void_p, ctypes.c_float]
        lib.lnasr_awb_pitch_tone.argtypes = [ctypes.c_void_p, ctypes.c_float]
        lib.lnasr_awb_process.argtypes = [
            ctypes.c_void_p, i16p, ctypes.c_int64, i32p, f64p,
        ]
        lib.lnasr_awb_process.restype = ctypes.c_int
        _lib = lib
    return _lib


class WebRtcVad:
    """Streaming WebRTC-style GMM VAD over 10 ms frames.

    ``sample_rate`` may be 8000, 16000 (default), 32000 or 48000 Hz; the
    higher rates are decimated to the 8 kHz analysis band in native code.
    ``mode`` 0..3 selects the standard aggressiveness presets;
    ``configure`` sets the raw thresholds."""

    FRAME_LEN = 160
    SAMPLE_RATES = (8000, 16000, 32000, 48000)

    def __init__(self, mode: int = 0, sample_rate: int = 16000):
        if sample_rate not in self.SAMPLE_RATES:
            raise ValueError(
                f"sample_rate must be one of {self.SAMPLE_RATES}, got {sample_rate}")
        self._lib = _load()
        self._h = self._lib.lnasr_wvad_create()
        self.sample_rate = sample_rate
        self.FRAME_LEN = sample_rate // 100  # 10 ms, shadows the class attribute
        if mode:
            self.set_mode(mode)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.lnasr_wvad_destroy(self._h)
            self._h = None

    def reset(self) -> None:
        self._lib.lnasr_wvad_reset(self._h)

    def set_mode(self, mode: int) -> None:
        self._lib.lnasr_wvad_set_mode(self._h, int(mode))

    def configure(self, over_hang_max1: int, over_hang_max2: int,
                  local_threshold: float, global_threshold: float) -> None:
        self._lib.lnasr_wvad_configure(self._h, int(over_hang_max1), int(over_hang_max2),
                                       float(local_threshold), float(global_threshold))

    def process(self, data: np.ndarray) -> np.ndarray:
        """int16 samples at ``sample_rate`` -> per-10 ms flags (0 noise, 1
        speech, >= 2 hangover frames); trailing samples short of a frame
        are dropped."""
        data = np.ascontiguousarray(data, dtype=np.int16)
        n_frames = len(data) // self.FRAME_LEN
        flags = np.zeros(n_frames, dtype=np.int32)
        if n_frames:
            self._lib.lnasr_wvad_process_rate(self._h, data[: n_frames * self.FRAME_LEN],
                                              n_frames * self.FRAME_LEN, self.sample_rate,
                                              flags)
        return flags


class AmrWbVad:
    """Streaming AMR-WB-style VAD over 256-sample frames at 16 kHz.
    ``process`` returns ``(flags, power_sums)``."""

    FRAME_LEN = 256
    # AMR-WB is a 16 kHz codec: the recognizer's rate guard reads this
    sample_rate = 16000

    def __init__(self):
        self._lib = _load()
        self._h = self._lib.lnasr_awb_create()

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.lnasr_awb_destroy(self._h)
            self._h = None

    def reset(self) -> None:
        self._lib.lnasr_awb_reset(self._h)

    def set_pow_low(self, value: float) -> None:
        self._lib.lnasr_awb_set_pow_low(self._h, float(value))

    def set_pow_pitch_tone_thr(self, value: float) -> None:
        self._lib.lnasr_awb_set_pow_pitch_tone_thr(self._h, float(value))

    def pitch_tone_detection(self, gain: float) -> None:
        self._lib.lnasr_awb_pitch_tone(self._h, float(gain))

    def process(self, data: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        data = np.ascontiguousarray(data, dtype=np.int16)
        n_frames = len(data) // self.FRAME_LEN
        flags = np.zeros(n_frames, dtype=np.int32)
        power = np.zeros(n_frames, dtype=np.float64)
        if n_frames:
            self._lib.lnasr_awb_process(self._h, data[: n_frames * self.FRAME_LEN],
                                        n_frames * self.FRAME_LEN, flags, power)
        return flags, power
