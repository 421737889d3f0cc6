"""Spectral transforms: windowed DFT/power spectrum, mel filterbank, DCT-II.

The transform matrices are NumPy float64 constants built once on the host.
The mel scale is ``2595 * ln(1 + hz/700)`` (natural log, self-consistent
with its inverse) and the filterbank bins are ``floor((fft_n / fs) * hz)``
triangles, as in the JAX package's ``ops/spectral.py``.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from lnasr_tpu_torch.ops.framing import hamming_window


def mel_from_hz(hz):
    return 2595.0 * np.log(1.0 + np.asarray(hz, dtype=np.float64) / 700.0)


def hz_from_mel(mel):
    return 700.0 * (np.exp(np.asarray(mel, dtype=np.float64) / 2595.0) - 1.0)


@functools.lru_cache(maxsize=None)
def mel_filterbank(n_mels: int, fft_n: int, sample_rate: int) -> np.ndarray:
    """Triangular mel filterbank ``(n_mels, fft_n//2 + 1)``, bin edges
    floored onto the FFT grid."""
    edges_hz = hz_from_mel(np.linspace(mel_from_hz(0.0), mel_from_hz(sample_rate / 2), n_mels + 2))
    bins = np.floor((fft_n / sample_rate) * edges_hz).astype(np.int64)
    fft_size = fft_n // 2 + 1
    fbank = np.zeros((n_mels, fft_size), dtype=np.float64)
    for m in range(1, n_mels + 1):
        lo, mi, hi = int(bins[m - 1]), int(bins[m]), int(bins[m + 1])
        if mi > lo:
            fbank[m - 1, lo:mi] = (np.arange(lo, mi) - lo) / (mi - lo)
        if hi > mi:
            fbank[m - 1, mi:hi] = (hi - np.arange(mi, hi)) / (hi - mi)
    return fbank


@functools.lru_cache(maxsize=None)
def windowed_dft_basis(frame_len: int, fft_n: int, dtype_str: str = "float32"):
    """Real/imag bases ``(C, S)``, each ``(frame_len, fft_n//2+1)``, of the
    zero-padded Hamming-windowed real DFT: ``C[n,k] = w[n] cos(2 pi k n /
    fft_n)``, ``S[n,k] = -w[n] sin(...)``, so ``Re(rfft(w*x)) = x @ C``."""
    dtype = np.dtype(dtype_str)
    n = np.arange(frame_len, dtype=np.float64)[:, None]
    k = np.arange(fft_n // 2 + 1, dtype=np.float64)[None, :]
    ang = 2.0 * np.pi * k * n / fft_n
    w = hamming_window(frame_len)[:, None]
    c = (w * np.cos(ang)).astype(dtype)
    s = (-w * np.sin(ang)).astype(dtype)
    return c, s


def power_spectrum(frames: torch.Tensor, fft_n: int, method: str = "matmul") -> torch.Tensor:
    """Power spectrum ``|rfft(frames, fft_n)|^2 / fft_n`` (Parseval scale).

    ``frames`` is ``(..., frame_len)``: already windowed for ``"fft"``,
    unwindowed for ``"matmul"`` (the basis carries the window). The GEMMs
    run in fp32; the package turns TF32 off (see ``__init__``)."""
    if method == "fft":
        mag = torch.abs(torch.fft.rfft(frames, fft_n))
        return (mag * mag) / fft_n
    if method == "matmul":
        c, s = windowed_dft_basis(frames.shape[-1], fft_n, str(frames.dtype).removeprefix("torch."))
        re = frames @ torch.as_tensor(c, device=frames.device)
        im = frames @ torch.as_tensor(s, device=frames.device)
        return (re * re + im * im) / fft_n
    raise ValueError(f"unknown spectrum method: {method!r}")


@functools.lru_cache(maxsize=None)
def dct2_ortho_matrix(n: int) -> np.ndarray:
    """Orthonormal DCT-II matrix ``D`` with ``dct(x) = x @ D.T`` (equals
    ``scipy.fftpack.dct(x, type=2, norm='ortho')``)."""
    k = np.arange(n, dtype=np.float64)[:, None]
    j = np.arange(n, dtype=np.float64)[None, :]
    d = 2.0 * np.cos(np.pi * k * (2.0 * j + 1.0) / (2.0 * n))
    d[0] *= np.sqrt(1.0 / (4.0 * n))
    d[1:] *= np.sqrt(1.0 / (2.0 * n))
    return d
