"""Fused mel frontend: ``signals (B, S)`` -> ``(mel (B, T, n_mels),
energy (B, T))``.

Counterpart of the JAX package's ``ops/mfcc_pallas.py:mel_frontend_pallas``.
For CUDA tensors :func:`mel_frontend` launches the hand-written kernel of
``csrc/mel_frontend.cu`` (framing, Hamming window, real-FFT power, mel and
total energy in one pass over the signal; at fft_n 256 to 2048 one warp a
frame runs the FFT in float64, :func:`fft_plan`); for CPU tensors it runs
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
from lnasr_tpu_torch.ops.factored import sm_count
from lnasr_tpu_torch.ops.framing import hamming_window, num_frames, preemphasis, split_frames
from lnasr_tpu_torch.ops.spectral import mel_filterbank, power_spectrum

_P = ctypes.c_void_p
_I = ctypes.c_int
# y, B, S, T, frame_len, frame_step, half, log2_half, frames per block,
# float64 window, float64 twiddles, float64 mel weights, nnz, mel_lo,
# mel_hi, mel_off, n_mels, mel, energy, stream
_ARGTYPES = [_P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _I, _P, _P, _P, _I, _P, _P, _P]

# the warp-per-frame route's radix plans, by H = fft_n / 2 (csrc:
# plan_radix); other sizes take the block-wide radix-2 route
_PLANS = {128: (4, 4, 4, 2), 256: (8, 8, 4), 512: (8, 8, 8), 1024: (8, 8, 4, 4)}


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


def fft_plan(fft_n: int) -> Optional[Tuple[int, ...]]:
    """The radices of the kernel's warp-per-frame FFT of ``fft_n / 2``
    complex points (Stockham passes, 32 lanes of ``fft_n / 64`` points),
    or ``None`` where the kernel takes its block-wide radix-2 route."""
    return _PLANS.get(fft_n // 2)


def pass_twiddles(plan: Tuple[int, ...]) -> np.ndarray:
    """The warp route's pass twiddles ``(n, 2)`` in float64: for each pass
    p >= 1 with radix R after Ns = prod(plan[:p]) points, ``W_{Ns R}^{r s}``
    as (re, im) at ``[r * Ns + s]``."""
    parts = []
    for p in range(1, len(plan)):
        ns, r = int(np.prod(plan[:p])), plan[p]
        ang = -2.0 * np.pi * np.outer(np.arange(r), np.arange(ns)).ravel() / (ns * r)
        parts.append(np.stack([np.cos(ang), np.sin(ang)], -1))
    return np.concatenate(parts)


def frames_per_block(b: int, t: int, n_sm: int) -> int:
    """Frames a block of the warp route takes: the most of 24, 16 and 8
    that still gives every SM four blocks, else 4 (a segment's B = 1)."""
    for fpb in (24, 16, 8):
        if b * -(-t // fpb) >= 4 * n_sm:
            return fpb
    return 4


def mel_support(fbank: np.ndarray):
    """Each filter's nonzero bins ``[lo, hi)`` and its weights packed
    filter after filter: ``(weights, lo, hi, off)``."""
    nz = fbank != 0
    lo = np.where(nz.any(1), nz.argmax(1), 0)
    hi = np.where(nz.any(1), fbank.shape[1] - nz[:, ::-1].argmax(1), 0)
    off = np.concatenate([[0], np.cumsum(hi - lo)[:-1]])
    weights = np.concatenate([fbank[m, lo[m]:hi[m]] for m in range(len(fbank))] + [np.zeros(0)])
    return weights, lo, hi, off


@functools.lru_cache(maxsize=None)
def _constants(cfg: MFCCConfig, device: torch.device):
    """On ``device``, in float64: the window; the warp route's pass
    twiddles followed by the split twiddles ``(cos, sin)(2 pi k / fft_n)``,
    k <= fft_n / 2 (the block-wide route rounds these to float32); the
    filters' packed weights; and their supports, in int32."""
    half = cfg.fft_n // 2
    k = np.arange(half + 1, dtype=np.float64)
    ang = 2.0 * np.pi * k / cfg.fft_n
    weights, lo, hi, off = mel_support(mel_filterbank(cfg.n_mels, cfg.fft_n, cfg.sample_rate))
    plan = fft_plan(cfg.fft_n)
    tw64 = np.concatenate([pass_twiddles(plan) if plan else np.zeros((0, 2)),
                           np.stack([np.cos(ang), np.sin(ang)], -1)])
    f64 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.float64), device=device)  # noqa: E731
    i32 = lambda a: torch.as_tensor(np.ascontiguousarray(a, np.int32), device=device)  # noqa: E731
    return (f64(hamming_window(cfg.frame_len)), f64(tw64), f64(np.concatenate([weights, [0.0]])),
            len(weights), i32(lo), i32(hi), i32(off))


def _launch(y: torch.Tensor, cfg: MFCCConfig) -> Tuple[torch.Tensor, torch.Tensor]:
    b, s = y.shape
    t = num_frames(s, cfg.frame_len, cfg.frame_step)
    mel = torch.empty((b, t, cfg.n_mels), dtype=torch.float32, device=y.device)
    energy = torch.empty((b, t), dtype=torch.float32, device=y.device)
    if b == 0 or t == 0:
        return mel, energy
    window, tw, weights, nnz, lo, hi, off = _constants(cfg, y.device)
    lib = _build.load("mel_frontend", _ARGTYPES)
    half = cfg.fft_n // 2
    fpb = frames_per_block(b, t, sm_count(y.device))
    with torch.cuda.device(y.device):  # launch on the tensors' card
        rc = lib.mel_frontend_launch(
            y.data_ptr(), b, s, t, cfg.frame_len, cfg.frame_step, half, half.bit_length() - 1,
            fpb, window.data_ptr(), tw.data_ptr(), weights.data_ptr(), nnz, lo.data_ptr(),
            hi.data_ptr(), off.data_ptr(), cfg.n_mels, mel.data_ptr(), energy.data_ptr(),
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
