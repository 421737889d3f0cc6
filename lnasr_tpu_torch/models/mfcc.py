"""MFCC frontend: 39-dim features in PyTorch.

Pre-emphasis, 25 ms/10 ms framing with zero-pad, Hamming window, 512-pt
power spectrum (Parseval-scaled), 40-filter mel bank, dB with an eps floor,
per-column mean subtraction (+1e-8), orthonormal DCT-II, cepstra 1..12
mean-normalized, log-energy as the 13th dim, then Δ and ΔΔ to 39 dims —
the JAX package's ``models/mfcc.py``, batched by a leading dimension
instead of ``vmap``. On CUDA tensors the serving path runs the fused mel
frontend kernel (``ops/mel_frontend.py``) and the same epilogue.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from lnasr_tpu_torch._device import resolve_device
from lnasr_tpu_torch.config import MFCCConfig
from lnasr_tpu_torch.ops.framing import (
    frame_mask,
    hamming_window,
    num_frames,
    preemphasis,
    split_frames,
)
from lnasr_tpu_torch.ops.mel_frontend import mel_frontend
from lnasr_tpu_torch.ops.spectral import dct2_ortho_matrix, mel_filterbank, power_spectrum

# dB floor: float64 eps (2**-52), which fp32 represents exactly
_EPS = float(np.finfo(np.float64).eps)


class MFCCResult(NamedTuple):
    power: torch.Tensor  # (..., T, fft_size) frame power spectra
    cepstrum: torch.Tensor  # (..., T, n_mels) mel log-spectra after DCT
    features: torch.Tensor  # (..., T, 39) final features
    mask: torch.Tensor  # (..., T) bool, frames belonging to the real signal


def _masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Mean over the valid frames of ``x (..., T, F)`` -> ``(..., 1, F)``."""
    w = mask.to(x.dtype)[..., None]
    return torch.sum(x * w, dim=-2, keepdim=True) / torch.clamp(
        torch.sum(w, dim=-2, keepdim=True), min=1.0)


def _delta(feat: torch.Tensor, mode: str) -> torch.Tensor:
    """First difference along time. ``compat`` seeds row 0 with
    ``feat[1]`` (the original toolkit's quirk); ``standard`` with
    ``feat[1] - feat[0]``."""
    diff = feat[..., 1:, :] - feat[..., :-1, :]
    head = feat[..., 1:2, :]
    if mode != "compat":
        head = head - feat[..., 0:1, :]
    return torch.cat([head, diff], dim=-2)


def cepstral_epilogue(
    mel_energy: torch.Tensor,
    frame_energy: torch.Tensor,
    mask: torch.Tensor,
    config: MFCCConfig,
    dtype,
    masked_energy: bool,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """dB + mean-norm + DCT + log-energy + deltas: ``mel_energy (..., T,
    n_mels)`` and ``frame_energy (..., T)`` -> ``(cepstrum, features
    (..., T, 39))``. Shared by the plain and the fused frontends."""
    eps = torch.tensor(_EPS, dtype=dtype, device=mel_energy.device)
    mel_energy = torch.where(mel_energy == 0, eps, mel_energy)
    cepstrum = 20.0 * torch.log10(mel_energy)
    if config.mean_norm:
        cepstrum = cepstrum - (_masked_mean(cepstrum, mask) + 1e-8)
    dct_m = torch.as_tensor(dct2_ortho_matrix(config.n_mels), dtype=dtype, device=mel_energy.device)
    cepstrum = cepstrum @ dct_m.T

    feats = cepstrum[..., 1 : 1 + config.n_ceps]
    if config.mean_norm:
        feats = feats - (_masked_mean(feats, mask) + 1e-8)
    if config.energy_floor > 0.0:
        frame_energy = torch.clamp(frame_energy, min=config.energy_floor)
    if masked_energy:
        # padded frames have zero power; keep the log finite there
        frame_energy = torch.where(mask, frame_energy, torch.ones_like(frame_energy))
    log_e = torch.log(frame_energy)[..., None]
    feats = torch.cat([feats, log_e], dim=-1)  # 13
    feats = torch.cat([feats, _delta(feats, config.delta_mode)], dim=-1)  # 26
    base = config.n_ceps + 1
    feats = torch.cat([feats, _delta(feats[..., base : 2 * base], config.delta_mode)], dim=-1)
    return cepstrum, feats


def mfcc_features(
    signal: torch.Tensor,
    config: MFCCConfig = MFCCConfig(),
    length: Optional[torch.Tensor] = None,
    dtype=torch.float32,
) -> MFCCResult:
    """The plain pipeline for ``signal (S,)`` or a padded batch ``(B, S)``
    (int16 or float). ``length`` (a scalar, or ``(B,)``) counts the real
    samples; samples past it are zeroed *after* pre-emphasis, and ``mask``
    marks the frames such a signal produces, so all means are over them."""
    frame_len, frame_step = config.frame_len, config.frame_step
    x = preemphasis(signal.to(dtype), config.preemph)
    t_total = num_frames(x.shape[-1], frame_len, frame_step)

    if length is None:
        mask = torch.ones((*x.shape[:-1], t_total), dtype=torch.bool, device=x.device)
    else:
        length = torch.as_tensor(length, device=x.device)
        keep = torch.arange(x.shape[-1], device=x.device) < length[..., None]
        x = torch.where(keep, x, torch.zeros((), dtype=x.dtype, device=x.device))
        mask = frame_mask(length, t_total, frame_len, frame_step)

    frames = split_frames(x, frame_len, frame_step)  # (..., T, L), unwindowed
    if config.spectrum_method == "matmul":
        power = power_spectrum(frames, config.fft_n, method="matmul")
    else:
        window = torch.as_tensor(hamming_window(frame_len), dtype=dtype, device=x.device)
        power = power_spectrum(frames * window, config.fft_n, method="fft")

    fbank = torch.as_tensor(mel_filterbank(config.n_mels, config.fft_n, config.sample_rate),
                            dtype=dtype, device=x.device)
    mel_energy = power @ fbank.T
    frame_energy = torch.sum(power, dim=-1)
    cepstrum, feats = cepstral_epilogue(
        mel_energy, frame_energy, mask, config, dtype, masked_energy=length is not None
    )
    return MFCCResult(power=power, cepstrum=cepstrum, features=feats, mask=mask)


def mfcc_features_fused(
    signals: torch.Tensor,
    config: MFCCConfig = MFCCConfig(),
    lengths: Optional[torch.Tensor] = None,
    passes: Optional[int] = None,
    dtype=torch.float32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched MFCCs through the fused mel frontend: ``signals (B, S)`` ->
    ``(features (B, T, 39), mask (B, T))``. The mel energies come from
    :func:`~lnasr_tpu_torch.ops.mel_frontend.mel_frontend` (the CUDA kernel
    for CUDA tensors, its plain version for CPU tensors); ``passes``
    defaults to ``config.fused_passes`` and is fp32 either way."""
    if passes is None:
        passes = config.fused_passes
    if lengths is not None:
        lengths = torch.as_tensor(lengths, device=signals.device)
    mel_energy, frame_energy = mel_frontend(signals, config, lengths=lengths, passes=passes)
    t = mel_energy.shape[1]
    if lengths is None:
        mask = torch.ones((signals.shape[0], t), dtype=torch.bool, device=signals.device)
    else:
        mask = frame_mask(lengths, t, config.frame_len, config.frame_step)
    _, feats = cepstral_epilogue(mel_energy.to(dtype), frame_energy.to(dtype), mask, config,
                                 dtype, masked_energy=lengths is not None)
    return feats, mask


def use_fused_frontend(config: MFCCConfig, device: torch.device) -> bool:
    """Whether the serving path takes the fused kernel on ``device``:
    ``"auto"`` on CUDA, ``"fused"`` always (an error on the CPU, where the
    kernel cannot run), ``"xla"`` never."""
    if config.frontend == "fused":
        if torch.device(device).type != "cuda":
            raise ValueError("frontend='fused' runs the CUDA kernel and needs a CUDA device")
        return True
    if config.frontend == "xla":
        return False
    if config.frontend != "auto":
        raise ValueError(f"unknown frontend: {config.frontend!r}")
    return torch.device(device).type == "cuda"


class MFCC:
    """Single-utterance and batched entry points on one device (CUDA by
    default; pass ``device="cpu"`` for the plain path)."""

    def __init__(self, config: MFCCConfig = MFCCConfig(), dtype=torch.float32, device="cuda"):
        self.config = config
        self.dtype = dtype
        self.device = resolve_device(device)
        self.D = config.feature_dim

    def _tensor(self, x) -> torch.Tensor:
        return torch.as_tensor(x, device=self.device)

    def __call__(self, signal) -> MFCCResult:
        """One utterance -> :class:`MFCCResult` (power, cepstrum, features)."""
        return mfcc_features(self._tensor(signal), self.config, None, self.dtype)

    def extract_batch(self, signals, lengths) -> MFCCResult:
        """Batched ``(B, S)`` signals with per-utterance ``lengths`` ->
        field-wise ``(B, ...)`` results with frame masks."""
        return mfcc_features(self._tensor(signals), self.config, self._tensor(lengths), self.dtype)

    def features_fast(self, signals, lengths=None) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Serving-path features: ``signals (S,)`` or ``(B, S)`` ->
        ``(features, mask)`` with features ``(T, D)`` / ``(B, T, D)`` and
        ``mask`` ``None`` when ``lengths`` is ``None``. The fused kernel on
        CUDA (``frontend="auto"``), the plain pipeline on the CPU."""
        signals = self._tensor(signals)
        single = signals.dim() == 1
        if single:
            signals = signals[None]
        if lengths is not None:
            lengths = self._tensor(lengths).reshape(-1)
        if use_fused_frontend(self.config, self.device):
            feats, mask = mfcc_features_fused(signals, self.config, lengths=lengths,
                                              dtype=self.dtype)
        else:
            res = mfcc_features(signals, self.config, lengths, self.dtype)
            feats, mask = res.features, res.mask
        if lengths is None:
            mask = None
        if single:
            return feats[0], (None if mask is None else mask[0])
        return feats, mask
