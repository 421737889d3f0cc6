"""Voice activity detection in the port.

- :mod:`lnasr_tpu_torch.vad.native`: the streaming C++ detectors
  (WebRTC-style GMM and AMR-WB filterbank VADs) bound with ctypes, for the
  live host path; built with ``g++`` at first use.
- :mod:`lnasr_tpu_torch.vad.ltsd`: Long-Term Spectral Divergence VAD as a
  torch program on the device, batched over utterances.
- :mod:`lnasr_tpu_torch.vad.webrtc`: the WebRTC-style GMM VAD as a torch
  program on the device (the filter cascade as log-depth scans over the
  signal, the GMM adaptation as a frame loop) for offline segmentation.
"""

from lnasr_tpu_torch.vad.ltsd import VadLtsd
from lnasr_tpu_torch.vad.native import AmrWbVad, WebRtcVad
from lnasr_tpu_torch.vad.webrtc import WebRtcVadTorch

__all__ = ["VadLtsd", "AmrWbVad", "WebRtcVad", "WebRtcVadTorch"]
