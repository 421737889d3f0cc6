"""Fused mel frontend: ``signals (B, S)`` -> ``(mel (B, T, n_mels),
energy (B, T))``.

Counterpart of the JAX package's ``ops/mfcc_pallas.py:mel_frontend_pallas``.
For CUDA tensors :func:`mel_frontend` launches the hand-written kernel of
``csrc/mel_frontend.cu`` (framing, Hamming window, real-FFT power, mel and
total energy in one pass over the signal); for CPU tensors it runs
:func:`mel_frontend_plain`, the plain PyTorch chain the kernel is held
against. Pre-emphasis and length zeroing run in PyTorch before either.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional, Tuple

import numpy as np
import torch

from lnasr_tpu_torch import _build
from lnasr_tpu_torch.config import MFCCConfig
from lnasr_tpu_torch.ops.framing import hamming_window, num_frames, preemphasis, split_frames
from lnasr_tpu_torch.ops.spectral import mel_filterbank, power_spectrum

_P = ctypes.c_void_p
_I = ctypes.c_int
# y, B, S, T, frame_len, frame_step, half, log2_half, window, tw_cos,
# tw_sin, fbank, mel_lo, mel_hi, n_mels, mel, energy, stream
_ARGTYPES = [_P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P, _P, _I, _P, _P, _P]


def check_geometry(cfg: MFCCConfig) -> None:
    """The kernel's geometry rules, checked on every device so a config
    the kernel cannot take fails the same way on the CPU. Unlike the TPU
    kernel, any ``n_mels`` is accepted; ``fft_n`` must be a power of two
    (the radix-2 FFT), which is stricter than the TPU kernel's "even"."""
    n = cfg.fft_n
    if n < 4 or n & (n - 1):
        raise ValueError(f"fft_n must be a power of two >= 4, got {n}")
    if cfg.frame_len > n:
        raise ValueError(f"frame_len {cfg.frame_len} exceeds fft_n {n}")


def preemphasize(signals: torch.Tensor, cfg: MFCCConfig,
                 lengths: Optional[torch.Tensor] = None) -> torch.Tensor:
    """fp32 pre-emphasis, then zero past each length (the reference's
    pre-emphasize-then-zero-pad order)."""
    y = preemphasis(signals.to(torch.float32), cfg.preemph)
    if lengths is not None:
        keep = torch.arange(y.shape[-1], device=y.device)[None, :] < lengths.to(y.device)[:, None]
        y = torch.where(keep, y, torch.zeros((), dtype=y.dtype, device=y.device))
    return y


def mel_frontend_plain(y: torch.Tensor, cfg: MFCCConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain chain on a pre-emphasized ``y (B, S)``: frames ->
    ``power_spectrum(method="matmul")`` -> ``power @ fbank.T`` and
    ``power.sum(-1)``."""
    frames = split_frames(y, cfg.frame_len, cfg.frame_step)
    power = power_spectrum(frames, cfg.fft_n, method="matmul")
    fbank = torch.as_tensor(mel_filterbank(cfg.n_mels, cfg.fft_n, cfg.sample_rate),
                            dtype=power.dtype, device=power.device)
    return power @ fbank.T, power.sum(-1)


@functools.lru_cache(maxsize=None)
def _constants(cfg: MFCCConfig, device: torch.device):
    """Window, twiddles (rounded once from float64), filterbank and each
    filter's nonzero bin range, on ``device``."""
    half = cfg.fft_n // 2
    k = np.arange(half + 1, dtype=np.float64)
    ang = 2.0 * np.pi * k / cfg.fft_n
    fbank = mel_filterbank(cfg.n_mels, cfg.fft_n, cfg.sample_rate)
    nz = fbank != 0
    lo = np.where(nz.any(1), nz.argmax(1), 0)
    hi = np.where(nz.any(1), fbank.shape[1] - nz[:, ::-1].argmax(1), 0)
    f32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float32), device=device)  # noqa: E731
    i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)  # noqa: E731
    return (f32(hamming_window(cfg.frame_len)), f32(np.cos(ang)), f32(np.sin(ang)),
            f32(fbank), i32(lo), i32(hi))


def _launch(y: torch.Tensor, cfg: MFCCConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s = y.shape
    t = num_frames(s, cfg.frame_len, cfg.frame_step)
    mel = torch.empty((b, t, cfg.n_mels), dtype=torch.float32, device=y.device)
    energy = torch.empty((b, t), dtype=torch.float32, device=y.device)
    if b == 0 or t == 0:
        return mel, energy
    window, tw_cos, tw_sin, fbank, lo, hi = _constants(cfg, y.device)
    lib = _build.load("mel_frontend", _ARGTYPES)
    half = cfg.fft_n // 2
    with torch.cuda.device(y.device):  # launch on the tensors' card
        rc = lib.mel_frontend_launch(
            y.data_ptr(), b, s, t, cfg.frame_len, cfg.frame_step, half, half.bit_length() - 1,
            window.data_ptr(), tw_cos.data_ptr(), tw_sin.data_ptr(), fbank.data_ptr(),
            lo.data_ptr(), hi.data_ptr(), cfg.n_mels, mel.data_ptr(), energy.data_ptr(),
            torch.cuda.current_stream(y.device).cuda_stream,
        )
    _build.check(lib, "mel_frontend", rc)
    mel_frontend.launches += 1
    return mel, energy


def mel_frontend(
    signals: torch.Tensor,
    cfg: MFCCConfig = MFCCConfig(),
    lengths: Optional[torch.Tensor] = None,
    passes: int = 6,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched fused frontend: ``signals (B, S)`` -> ``(mel_energy
    (B, T, n_mels), frame_energy (B, T))``, T = ``num_frames(S)``.

    ``passes`` is accepted for parity with the TPU kernel (3 or 6, other
    values raise); both compute in fp32 here. ``lengths (B,)`` zeroes each
    utterance past its length after pre-emphasis. A CUDA tensor goes
    through the CUDA kernel, a CPU tensor through
    :func:`mel_frontend_plain`."""
    if passes not in (3, 6):
        raise ValueError(f"passes must be 3 or 6, got {passes}")
    check_geometry(cfg)
    if signals.dim() != 2:
        raise ValueError(f"signals must be (B, S), got shape {tuple(signals.shape)}")
    y = preemphasize(signals, cfg, lengths).contiguous()
    if y.device.type == "cpu":
        return mel_frontend_plain(y, cfg)
    if y.device.type != "cuda":
        raise ValueError(f"mel_frontend runs on cpu or cuda tensors, got {y.device}")
    return _launch(y, cfg)


mel_frontend.launches = 0  # kernel launches; plain CPU calls do not count
