"""Long-Term Spectral Divergence (LTSD) VAD as a torch program.

The port of the JAX package's ``vad/ltsd.py``: amplitude spectra per
frame, a noise spectrum from the first two frames, the LTSE (the running
max of amplitudes over frames t-order .. t+order-1) and LTSD = 10
log10(sum(LTSE^2 / noise) / win_size) per frame, optionally adapting the
noise spectrum on frames classified silent.

Framing, FFT and the windowed max run over the whole signal (and over a
leading batch axis: :meth:`VadLtsd.detect_batch`). The adaptive variant is
sequential over frames, the JAX package's ``lax.scan``: for CUDA tensors
:func:`ltsd_noise` runs it in one call of the hand-written kernels of
``csrc/ltsd_noise.cu`` (kernel J: every frame's squares and level over the
whole card, then the recursion, a block of :func:`ltsd_warps` division
warps and a combiner warp an utterance), for CPU tensors
:func:`ltsd_noise_plain` runs it as a frame loop in the kernel's order of
sums, which the kernel is held to bit for bit.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from lnasr_tpu_torch import _build
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


LANES = 32  # a warp
# kernel J's aim: bins a lane, while warps allow, by itemsize: float64's
# IEEE divisions run one after another, so it spreads them over more warps
BINS_A_LANE = {4: 5, 8: 3}
MAX_BINS_A_LANE = 9  # kernel J's registers a lane hold: 31 warps of 9 bins cover MAX_F
MAX_WARPS = 31  # division warps: with the combiner warp a block of 1024 threads
MAX_F = 8192  # frequency bins kernel J takes on the card (a window of 16,382 samples)


def ltsd_warps(f: int, itemsize: int = 4) -> int:
    """Kernel J's division warps an utterance for ``f`` frequency bins of
    ``itemsize`` bytes, which also fix the order of its sums
    (:func:`_lane_sum`): the fewest whose lanes hold at most
    :data:`BINS_A_LANE` bins each, up to 31 (at the default window's 1025
    bins 7 at float32, 11 at float64)."""
    return min(MAX_WARPS, -(-f // (LANES * BINS_A_LANE[itemsize])))


def ltsd_row(f: int, itemsize: int) -> int:
    """Elements of a frame's row in kernel J's scratch for ``f`` bins: the
    squares at the lanes' ``32 W ceil(f / 32 W)`` slots (``W =
    ltsd_warps(f, itemsize)``), then 16 bytes: the frame's level and its
    range flag."""
    lanes = LANES * ltsd_warps(f, itemsize)
    return lanes * -(-f // lanes) + 16 // itemsize


def _lane_sum(x: torch.Tensor) -> torch.Tensor:
    """``x (..., F)`` summed in kernel J's fixed order, on any device, over
    the lanes of its ``W = ltsd_warps(F, x.element_size())`` warps: lane
    L = 32 w + l adds its bins L, L + 32 W, ... in ascending order (bins
    past F add +0), each warp's lanes are added by the XOR butterfly 16, 8,
    4, 2, 1, and the W warps' partials in ascending order of warp. Every
    add is one elementwise IEEE add, so the result does not depend on the
    device or on torch's reduction order."""
    f = x.shape[-1]
    warps = ltsd_warps(f, x.element_size())
    lanes = LANES * warps
    chunks = -(-f // lanes)
    x = torch.nn.functional.pad(x, (0, chunks * lanes - f)).unflatten(-1, (chunks, lanes))
    acc = x[..., 0, :]
    for c in range(1, chunks):
        acc = acc + x[..., c, :]
    acc = acc.unflatten(-1, (warps, LANES))
    h = LANES // 2
    while h:  # lane 0's value of the butterfly
        acc = acc[..., :h] + acc[..., h:2 * h]
        h //= 2
    total = acc[..., 0, 0]
    for w in range(1, warps):
        total = total + acc[..., w, 0]
    return total


def ltsd_noise_plain(ltse: torch.Tensor, noise: torch.Tensor,
                     config: LTSDConfig) -> torch.Tensor:
    """Kernel J's plain version: the adaptive LTSD's frame loop over the
    LTSE ``(..., T, F)`` from the initial noise spectrum ``(..., F)``,
    returning the scores ``(..., T)`` (0 outside the valid band, whose
    frames leave the noise as it is). A frame scores ``10 log10(max(
    sum(ltse^2 / noise) / win, 1e-30))`` and, below the threshold, adapts
    ``noise = alpha noise + (1 - alpha) sum(ltse) / win``. Both sums run in
    :func:`_lane_sum`'s order, the divisions by ``win`` are true divisions
    by a tensor (a CUDA division by a host scalar is a multiplication by its
    reciprocal), and each other op rounds once, so the kernel can repeat
    every bit."""
    assert config.alpha is not None
    n = ltse.shape[-2]
    alpha = config.alpha
    win = torch.tensor(float(config.win_size), dtype=ltse.dtype, device=ltse.device)
    # the state-free part: each frame's adapted level (1 - alpha) sum(ltse) / win
    level = (1.0 - alpha) * (_lane_sum(ltse) / win)
    scores = torch.zeros(ltse.shape[:-1], dtype=ltse.dtype, device=ltse.device)
    for t in range(config.order, n - config.order):
        ltse_t = ltse[..., t, :]
        ratio = _lane_sum(ltse_t * ltse_t / noise)
        score = 10.0 * torch.log10(torch.clamp(ratio / win, min=1e-30))
        adapted = alpha * noise + level[..., t, None]
        noise = torch.where((score < config.threshold)[..., None], adapted, noise)
        scores[..., t] = score
    return scores


_P, _I, _D = ctypes.c_void_p, ctypes.c_int, ctypes.c_double
# the recursion, ltsd_noise_launch: rows, noise, B, T, F, order, warps,
# is_double, win, threshold, alpha, scores, stream
_ARGTYPES = [_P, _P, _I, _I, _I, _I, _I, _I, _D, _D, _D, _P, _P]
# the rows pass, ltsd_noise_rows: ltse, B, T, F, warps, is_double, win,
# one_minus_alpha, rows, stream
_ROWS_ARGTYPES = [_P, _I, _I, _I, _I, _I, _D, _D, _P, _P]


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"the LTSD runs on cpu or cuda tensors, got {x.device}")
    return True


def _library():
    lib = _build.load("ltsd_noise", _ARGTYPES)
    lib.ltsd_noise_rows.argtypes = _ROWS_ARGTYPES
    return lib


def _rows_pass(ltse: torch.Tensor, config: LTSDConfig, rows: torch.Tensor) -> None:
    """Kernel J's first kernel: every frame of the contiguous ``ltse (...,
    T, F)`` (a batch of ``B`` utterances) into its row of ``rows``, scratch
    of ``B T ltsd_row(F)`` elements: the squares, the adapted level and
    whether every square lies where the fast float division is exact."""
    (t, f), dtype = tuple(ltse.shape[-2:]), ltse.dtype
    lib = _library()
    with torch.cuda.device(ltse.device):  # launch on the tensors' card
        rc = lib.ltsd_noise_rows(ltse.data_ptr(), math.prod(ltse.shape[:-2]), t, f,
                                 ltsd_warps(f, dtype.itemsize), int(dtype == torch.float64),
                                 float(config.win_size), 1.0 - config.alpha, rows.data_ptr(),
                                 torch.cuda.current_stream(ltse.device).cuda_stream)
    _build.check(lib, "ltsd_noise", rc)


def _recursion(rows: torch.Tensor, noise: torch.Tensor, config: LTSDConfig,
               scores: torch.Tensor) -> None:
    """Kernel J's second kernel: the recursion over the rows that
    :func:`_rows_pass` wrote, from the contiguous initial noise ``(..., F)``,
    into the scores ``(..., T)``."""
    f, t, dtype = noise.shape[-1], scores.shape[-1], noise.dtype
    lib = _library()
    with torch.cuda.device(noise.device):
        rc = lib.ltsd_noise_launch(rows.data_ptr(), noise.data_ptr(),
                                   math.prod(noise.shape[:-1]), t, f, config.order,
                                   ltsd_warps(f, dtype.itemsize), int(dtype == torch.float64),
                                   float(config.win_size), float(config.threshold),
                                   float(config.alpha), scores.data_ptr(),
                                   torch.cuda.current_stream(noise.device).cuda_stream)
    _build.check(lib, "ltsd_noise", rc)


def _launch(ltse: torch.Tensor, noise: torch.Tensor, config: LTSDConfig) -> torch.Tensor:
    """Kernel J on the card, leading dimensions of ``ltse (..., T, F)`` and
    ``noise (..., F)`` flattened into its batch: its two kernels in order on
    the current stream, the rows pass and the recursion. Every check reads
    shapes, dtypes and devices only."""
    dev, dtype = ltse.device, ltse.dtype
    if (ltse.dim() < 2 or tuple(noise.shape) != tuple(ltse.shape[:-2]) + tuple(ltse.shape[-1:])
            or noise.dtype != dtype or noise.device != dev
            or dtype not in (torch.float32, torch.float64)):
        raise ValueError(f"the LTSD noise kernel takes float32 or float64 ltse (..., T, F) and "
                         f"noise (..., F) of one dtype on one device, got {dtype} "
                         f"{tuple(ltse.shape)} and {noise.dtype} {tuple(noise.shape)} on "
                         f"{noise.device}")
    lead, (t, f) = tuple(ltse.shape[:-2]), tuple(ltse.shape[-2:])
    if f > MAX_F:
        raise ValueError(f"the LTSD noise kernel takes at most {MAX_F} frequency bins (a window "
                         f"of {2 * MAX_F - 2} samples), got {f}")
    b = math.prod(lead)
    scores = torch.empty(lead + (t,), dtype=dtype, device=dev)
    if b > 0:
        rows = torch.empty((b * t * ltsd_row(f, dtype.itemsize),), dtype=dtype, device=dev)
        _rows_pass(ltse.contiguous(), config, rows)
        _recursion(rows, noise.contiguous(), config, scores)
        ltsd_noise.launches += 1
    return scores


def ltsd_noise(ltse: torch.Tensor, noise: torch.Tensor, config: LTSDConfig) -> torch.Tensor:
    """The adaptive LTSD's noise recursion over the LTSE ``(..., T, F)``
    from the initial noise ``(..., F)``: the scores ``(..., T)``. CUDA
    tensors launch kernel J once, its two kernels (float32 or float64;
    anything else raises), CPU tensors run :func:`ltsd_noise_plain`."""
    assert config.alpha is not None
    if not _on_cuda(ltse):
        return ltsd_noise_plain(ltse, noise, config)
    return _launch(ltse, noise, config)


ltsd_noise.launches = 0  # kernel J calls (two kernels each); plain CPU calls do not count


def ltsd_scores_adaptive(signal: torch.Tensor, config: LTSDConfig,
                         dtype=torch.float32) -> torch.Tensor:
    """LTSD with the noise spectrum adapted on frames scored below the
    threshold: the framing, FFT and windowed max over the whole signal,
    then the frame recursion in one call of :func:`ltsd_noise` (kernel J on
    the card)."""
    assert config.alpha is not None
    amps = _amplitudes(signal, config, dtype)
    noise = amps[..., :2, :].mean(dim=-2) ** 2
    return ltsd_noise(_ltse(amps, config.order), noise, config)


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
