"""Signal framing, windowing and pre-emphasis.

Frame count ``N = ceil(|len - (L - S)| / S)``, the tail zero-padded to
``N*S + (L - S)``, and the Hamming window ``0.54 - 0.46 cos(2 pi n/(N-1))``
— the same rules as the JAX package's ``ops/framing.py``.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def num_frames(signal_length: int, frame_len: int, frame_step: int) -> int:
    """Frame count for the padding rule ``ceil(|len - (L - S)| / S)``."""
    return int(math.ceil(abs(signal_length - (frame_len - frame_step)) / frame_step))


def pad_length(signal_length: int, frame_len: int, frame_step: int) -> int:
    """Padded signal length so every frame is fully materialized."""
    n = num_frames(signal_length, frame_len, frame_step)
    return n * frame_step + (frame_len - frame_step)


def preemphasis(signal: torch.Tensor, alpha: float) -> torch.Tensor:
    """First-order high-pass: y(0)=x(0), y(t)=x(t) - alpha*x(t-1)."""
    return torch.cat([signal[..., :1], signal[..., 1:] - alpha * signal[..., :-1]], dim=-1)


def split_frames(signal: torch.Tensor, frame_len: int, frame_step: int) -> torch.Tensor:
    """``(..., S)`` -> overlapping frames ``(..., N, frame_len)``, the tail
    zero-padded (or truncated) to :func:`pad_length`. A signal of exactly
    ``frame_len - frame_step`` samples has no frame: ``(..., 0,
    frame_len)``."""
    signal_length = signal.shape[-1]
    if num_frames(signal_length, frame_len, frame_step) == 0:
        return signal.new_zeros((*signal.shape[:-1], 0, frame_len))
    padded = pad_length(signal_length, frame_len, frame_step)
    if padded > signal_length:
        signal = torch.nn.functional.pad(signal, (0, padded - signal_length))
    elif padded < signal_length:
        signal = signal[..., :padded]
    return signal.unfold(-1, frame_len, frame_step)


def hamming_window(frame_len: int, dtype=np.float64) -> np.ndarray:
    """Hamming window as a host-side constant."""
    n = np.arange(frame_len, dtype=dtype)
    return (0.54 - 0.46 * np.cos(2.0 * np.pi * n / (frame_len - 1))).astype(dtype)


def frame_mask(lengths: torch.Tensor, n: int, frame_len: int, frame_step: int) -> torch.Tensor:
    """Boolean mask ``(..., n)`` of the frames each true signal length
    produces (same ceil rule as :func:`num_frames`, at least one frame)."""
    lengths = lengths.to(torch.float64)
    counts = torch.ceil(torch.abs(lengths - (frame_len - frame_step)) / frame_step)
    counts = torch.clamp(counts, min=1).to(torch.int64)
    frame_ids = torch.arange(n, device=lengths.device)
    return frame_ids < counts[..., None]
