"""Long-Term Spectral Divergence (LTSD) VAD as a torch program.

The port of the JAX package's ``vad/ltsd.py``: amplitude spectra per
frame, a noise spectrum from the first two frames, the LTSE (the running
max of amplitudes over frames t-order .. t+order-1) and LTSD = 10
log10(sum(LTSE^2 / noise) / win_size) per frame, optionally adapting the
noise spectrum on frames classified silent.

Framing, FFT and the windowed max run over the whole signal (and over a
leading batch axis: :meth:`VadLtsd.detect_batch`). The adaptive variant is
sequential over frames: a loop of a few tensor ops a frame on the
signal's device, the counterpart of the JAX package's ``lax.scan``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from lnasr_tpu_torch._device import resolve_device
from lnasr_tpu_torch.config import LTSDConfig
from lnasr_tpu_torch.ops.framing import hamming_window, split_frames


class LTSDResult(NamedTuple):
    ltsd: torch.Tensor  # (..., T) per-frame divergence (0 outside the valid band)
    is_speech: torch.Tensor  # (..., T) bool, ltsd > threshold


def _amplitudes(signal: torch.Tensor, config: LTSDConfig, dtype) -> torch.Tensor:
    """``(..., S)`` -> amplitude spectra ``(..., N, win_size // 2 + 1)``,
    after one stride of zeros in front (MATLAB ``buffer()``'s rule)."""
    sig = signal.to(dtype)
    zeros = sig.new_zeros(sig.shape[:-1] + (config.step_size,))
    frames = split_frames(torch.cat([zeros, sig], dim=-1), config.win_size, config.step_size)
    if frames.shape[-2] == 0:  # an empty signal: no frame (an FFT of none can fail)
        return frames.new_zeros(frames.shape[:-1] + (config.win_size // 2 + 1,))
    window = torch.as_tensor(hamming_window(config.win_size), dtype=dtype, device=sig.device)
    return torch.fft.rfft(frames * window, n=config.win_size).abs()


def _valid(n: int, order: int, device) -> torch.Tensor:
    t = torch.arange(n, device=device)
    return (t >= order) & (t < n - order)


def _ltse(amps: torch.Tensor, order: int) -> torch.Tensor:
    """Windowed max over frames t-order .. t+order-1 (an asymmetric
    window, as the reference's slice ``[k-order:k+order]``); 0 outside the
    valid band."""
    shifts = [torch.roll(amps, -d, dims=-2) for d in range(-order, order)]
    ltse = torch.stack(shifts).amax(dim=0)
    valid = _valid(amps.shape[-2], order, amps.device)
    return torch.where(valid[:, None], ltse, torch.zeros((), dtype=amps.dtype,
                                                         device=amps.device))


def _score(ratio: torch.Tensor, config: LTSDConfig) -> torch.Tensor:
    return 10.0 * torch.log10(torch.clamp(ratio / config.win_size, min=1e-30))


def ltsd_scores(signal: torch.Tensor, config: LTSDConfig = LTSDConfig(),
                dtype=torch.float32) -> torch.Tensor:
    """Per-frame LTSD without noise adaptation, ``(..., S)`` -> ``(...,
    N)``: every frame at once."""
    amps = _amplitudes(signal, config, dtype)
    noise = amps[..., :2, :].mean(dim=-2) ** 2
    ltse = _ltse(amps, config.order)
    scores = _score((ltse * ltse / noise[..., None, :]).sum(dim=-1), config)
    valid = _valid(amps.shape[-2], config.order, amps.device)
    return torch.where(valid, scores, torch.zeros((), dtype=scores.dtype, device=scores.device))


def ltsd_scores_adaptive(signal: torch.Tensor, config: LTSDConfig,
                         dtype=torch.float32) -> torch.Tensor:
    """LTSD with the noise spectrum adapted on frames scored below the
    threshold: a frame loop over the valid band (frames outside it score 0
    and leave the noise as it is)."""
    assert config.alpha is not None
    amps = _amplitudes(signal, config, dtype)
    noise = amps[..., :2, :].mean(dim=-2) ** 2
    ltse = _ltse(amps, config.order)
    n = amps.shape[-2]
    alpha = config.alpha
    scores = torch.zeros(amps.shape[:-1], dtype=amps.dtype, device=amps.device)
    for t in range(config.order, n - config.order):
        ltse_t = ltse[..., t, :]
        score = _score((ltse_t * ltse_t / noise).sum(dim=-1), config)
        adapt = score < config.threshold
        adapted = alpha * noise + (1.0 - alpha) * (ltse_t.sum(dim=-1) / config.win_size)[..., None]
        noise = torch.where(adapt[..., None], adapted, noise)
        scores[..., t] = score
    return scores


class VadLtsd:
    """LTSD VAD on one device (CUDA by default): ``detect`` scores one
    signal, ``detect_batch`` a ``(B, S)`` batch; each returns the scores
    and the thresholded decision."""

    def __init__(self, config: LTSDConfig = LTSDConfig(), dtype=torch.float32, device="cuda"):
        self.config = config
        self.dtype = dtype
        self.device = resolve_device(device)

    def detect(self, signal) -> LTSDResult:
        sig = torch.as_tensor(signal, device=self.device)
        if self.config.alpha is None:
            scores = ltsd_scores(sig, self.config, self.dtype)
        else:
            scores = ltsd_scores_adaptive(sig, self.config, self.dtype)
        return LTSDResult(ltsd=scores, is_speech=scores > self.config.threshold)

    def detect_batch(self, signals) -> LTSDResult:
        """``(B, S)`` signals: every op of :meth:`detect` takes the batch
        axis along (the JAX package's ``vmap``)."""
        return self.detect(signals)
