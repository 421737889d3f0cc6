"""WebRTC-style GMM VAD as a torch program (offline, whole signal).

The port of the JAX package's ``vad/webrtc.py``: the same float algorithm
as the native detector (``native/vad/vad_webrtc.cpp``).

- The filter frontend (the 16 -> 8 kHz allpass downsampler, the 5-level
  QMF halfband split tree and the 80 Hz biquad) runs over the whole
  signal at once: every IIR section is a log-depth scan of
  :mod:`lnasr_tpu_torch.ops.lfilter`.
- Per-frame band energies are one reshape and reduction, accumulated in
  ``acc_dtype`` (float64 by default, as the JAX package under x64 and
  the native detector's double accumulator).
- The 2-Gaussian noise/speech model adaptation is sequential (the JAX
  package's ``lax.scan``): :func:`gmm_flags` runs all frames in one launch
  of the hand-written kernel of ``csrc/webrtc_gmm.cu`` (kernel I) on CUDA
  tensors, and :func:`gmm_flags_plain`, a loop over 10 ms frames of small
  tensor ops with the state in tensors, on CPU tensors.

Decisions match the native detector's frame for frame on the test audio.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import numpy as np
import torch

from lnasr_tpu_torch import _build
from lnasr_tpu_torch._device import resolve_device
from lnasr_tpu_torch.ops.lfilter import allpass2, biquad, first_order_recurrence

FRAME_LEN_16K = 160

_C_UPPER = 20972.0 / 32768.0
_C_LOWER = 5571.0 / 32768.0
_HP_ZERO = (6631.0 / 16384.0, -13262.0 / 16384.0, 6631.0 / 16384.0)
_HP_POLE = (1.0, -7756.0 / 16384.0, 5620.0 / 16384.0)
_OFFSETS = np.array([368, 368, 272, 176, 176, 176], np.float32) / 16.0
_MIN_ENERGY = 10.0
_SPECTRUM_WEIGHT = np.array([6, 8, 10, 12, 14, 16], np.float32)
_NOISE_UPDATE = 655.0 / 32768.0
_SPEECH_UPDATE = 6554.0 / 32768.0
_BACK_ETA = 154.0 / 256.0
_MIN_DIFF = np.array([544, 544, 576, 576, 576, 576], np.float32) / 32.0
_MIN_MEAN = np.array([640, 768], np.float32) / 128.0
_MAX_NOISE = np.array([9216, 9088, 8960, 8832, 8704, 8576], np.float32) / 128.0
_MAX_SPEECH = np.array([11392, 11392, 11520, 11520, 11520, 11520], np.float32) / 128.0
_NOISE_W = np.array([34, 62, 72, 66, 53, 25, 94, 66, 56, 62, 75, 103],
                    np.float32).reshape(2, 6) / 128.0
_SPEECH_W = np.array([48, 82, 45, 87, 50, 47, 80, 46, 83, 41, 78, 81],
                     np.float32).reshape(2, 6) / 128.0
_NOISE_MEANS = np.array([6738, 4892, 7065, 6715, 6771, 3369,
                         7646, 3863, 7820, 7266, 5020, 4362], np.float32).reshape(2, 6) / 128.0
_SPEECH_MEANS = np.array([8306, 10085, 10078, 11823, 11843, 6309,
                          9473, 9571, 10879, 7581, 8180, 7483], np.float32).reshape(2, 6) / 128.0
_NOISE_STDS = np.array([378, 1064, 493, 582, 688, 593,
                        474, 697, 475, 688, 421, 455], np.float32).reshape(2, 6) / 128.0
_SPEECH_STDS = np.array([555, 505, 567, 524, 585, 1231,
                         509, 828, 492, 1540, 1079, 850], np.float32).reshape(2, 6) / 128.0
_MIN_STD = 384.0 / 128.0
_MAX_SPEECH_FRAMES = 6
_SMOOTH_DOWN = 6553.0 / 32768.0
_SMOOTH_UP = 32439.0 / 32768.0
_COMP_VAR = 22005.0 / 1024.0
_LOW_FILL = 10000.0 / 16.0  # an empty slot of the minimum tracker
_LOW_SLOTS = 16
_LOW_MAX_AGE = 100

# {overhang1, overhang2, local, global} per aggressiveness mode, 10 ms frames
MODE_TABLE = ((8, 14, 24.0, 57.0), (8, 14, 37.0, 100.0),
              (6, 9, 82.0, 285.0), (6, 9, 94.0, 1100.0))


class GmmState(NamedTuple):
    noise_means: torch.Tensor  # (2, 6)
    speech_means: torch.Tensor
    noise_stds: torch.Tensor
    speech_stds: torch.Tensor
    frame_count: torch.Tensor  # () int32
    over_hang: torch.Tensor  # () int32
    speech_run: torch.Tensor  # () int32
    low_values: torch.Tensor  # (6, 16)
    value_ages: torch.Tensor  # (6, 16) int32
    mean_values: torch.Tensor  # (6,)


def initial_gmm_state(dtype=torch.float32, device="cpu") -> GmmState:
    f = lambda x: torch.as_tensor(x, dtype=dtype, device=device)  # noqa: E731
    i = lambda x: torch.as_tensor(x, dtype=torch.int32, device=device)  # noqa: E731
    return GmmState(
        noise_means=f(_NOISE_MEANS), speech_means=f(_SPEECH_MEANS),
        noise_stds=f(_NOISE_STDS), speech_stds=f(_SPEECH_STDS),
        frame_count=i(0), over_hang=i(0), speech_run=i(0),
        low_values=torch.full((6, _LOW_SLOTS), _LOW_FILL, dtype=dtype, device=device),
        value_ages=torch.zeros((6, _LOW_SLOTS), dtype=torch.int32, device=device),
        mean_values=torch.full((6,), 1600.0 / 16.0, dtype=dtype, device=device),
    )


# ---------------------------------------------------------------------------
# Filter frontend: whole-signal scans
# ---------------------------------------------------------------------------


def _downsample(signal: torch.Tensor, state: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """16 kHz -> 8 kHz halfband allpass pair; the output truncated toward
    zero like an int16 conversion."""
    xp = signal.reshape(-1, 2)
    drives = torch.stack([(1.0 - _C_UPPER ** 2) * xp[:, 0], (1.0 - _C_LOWER ** 2) * xp[:, 1]],
                         dim=1)
    coefs = torch.tensor([-_C_UPPER, -_C_LOWER], dtype=signal.dtype, device=signal.device)
    s = first_order_recurrence(coefs, drives, state)
    s_prev = torch.cat([state[None, :], s[:-1]])
    a0 = (s_prev[:, 0] + _C_UPPER * xp[:, 0]) * 0.5
    a1 = (s_prev[:, 1] + _C_LOWER * xp[:, 1]) * 0.5
    return torch.trunc(a0 + a1), s[-1]


def _split(x, upper_state, lower_state):
    """QMF halfband split with decimation: both branches are whole-signal
    allpass2 runs; hp/lp combine the upper branch's even outputs with the
    lower branch's odd outputs."""
    a0, new_upper = allpass2(x, _C_UPPER, (upper_state[0], upper_state[1]))
    a1, new_lower = allpass2(x, _C_LOWER, (lower_state[0], lower_state[1]))
    hp = (a1[1::2] - a0[0::2]) * 0.5
    lp = (a1[1::2] + a0[0::2]) * 0.5
    return hp, lp, torch.stack(new_upper), torch.stack(new_lower)


class FilterState(NamedTuple):
    downsample: torch.Tensor  # (2,)
    upper: torch.Tensor  # (5, 2)
    lower: torch.Tensor  # (5, 2)
    hp: torch.Tensor  # (4,)


def initial_filter_state(dtype=torch.float32, device="cpu") -> FilterState:
    return FilterState(*(torch.zeros(shape, dtype=dtype, device=device)
                         for shape in ((2,), (5, 2), (5, 2), (4,))))


def extract_features(signal: torch.Tensor, state: FilterState, acc_dtype=torch.float64
                     ) -> Tuple[torch.Tensor, torch.Tensor, FilterState]:
    """Whole-signal feature extraction: ``signal (S,)`` float with S a
    multiple of 160 -> per-frame log band energies ``(F, 6)``, the total
    energy ``(F,)`` and the carried filter state. Band energies are
    accumulated in ``acc_dtype``. Equal to running the streaming detector
    frame by frame, since every filter is causal and carries its state."""
    x8, ds_state = _downsample(signal, state.downsample)
    hp2_4, lp0_2, u0, l0 = _split(x8, state.upper[0], state.lower[0])
    b5, b4, u1, l1 = _split(hp2_4, state.upper[1], state.lower[1])
    b3, lp0_1, u2, l2 = _split(lp0_2, state.upper[2], state.lower[2])
    b2, lp0_05, u3, l3 = _split(lp0_1, state.upper[3], state.lower[3])
    b1, lp0_025, u4, l4 = _split(lp0_05, state.upper[4], state.lower[4])
    b0, hp_state = biquad(lp0_025, _HP_ZERO, _HP_POLE, state.hp)

    n_frames = signal.shape[0] // FRAME_LEN_16K
    bands = [b0, b1, b2, b3, b4, b5]
    energies = [(b.reshape(n_frames, -1).to(acc_dtype) ** 2).sum(dim=1).to(signal.dtype)
                for b in bands]
    features = []
    total = torch.zeros((n_frames,), dtype=signal.dtype, device=signal.device)
    for band in (5, 4, 3, 2, 1, 0):
        e = energies[band]
        offset = float(_OFFSETS[band])
        log_e = torch.where(e > 0, 10.0 * torch.log10(torch.clamp(e, min=1e-30)) + offset,
                            torch.full_like(e, offset))
        inc = torch.where(total <= _MIN_ENERGY,
                          torch.where(e >= 16384.0, torch.full_like(e, _MIN_ENERGY + 1.0), e),
                          torch.zeros_like(e))
        total = total + inc
        features.append(log_e)
    features = torch.stack(features[::-1], dim=1)  # (F, 6), channel order 0..5
    new_state = FilterState(downsample=ds_state, upper=torch.stack([u0, u1, u2, u3, u4]),
                            lower=torch.stack([l0, l1, l2, l3, l4]), hp=hp_state)
    return features, total, new_state


# ---------------------------------------------------------------------------
# GMM decision: a loop over frames
# ---------------------------------------------------------------------------


class _Constants(NamedTuple):
    """The GMM step's constants on the signal's device, made once a call:
    a scalar operand of ``torch.where`` would cost a fill launch a use."""

    noise_w: torch.Tensor  # (2, 6)
    speech_w: torch.Tensor
    spectrum_weight: torch.Tensor  # (6,)
    min_diff: torch.Tensor
    min_mean: torch.Tensor  # (2, 1)
    max_noise: torch.Tensor
    max_speech: torch.Tensor
    nm_lo: torch.Tensor  # (2, 1) lower clip of the noise means
    nm_hi: torch.Tensor  # (2, 6) upper clip
    slots: torch.Tensor  # (16,) int64
    low_fill: torch.Tensor  # (6, 16)
    age_fill: torch.Tensor  # (6, 16) int32
    mean_init: torch.Tensor  # (6,)
    zero: torch.Tensor  # () float
    one: torch.Tensor
    c31: torch.Tensor
    smooth_down: torch.Tensor
    smooth_up: torch.Tensor
    zero_i: torch.Tensor  # () int32
    minus_one: torch.Tensor  # () int64


def _constants(dtype, device) -> _Constants:
    f = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=device)  # noqa: E731
    g_idx = np.arange(2, dtype=np.float32)[:, None]
    return _Constants(
        noise_w=f(_NOISE_W), speech_w=f(_SPEECH_W), spectrum_weight=f(_SPECTRUM_WEIGHT),
        min_diff=f(_MIN_DIFF), min_mean=f(_MIN_MEAN[:, None]), max_noise=f(_MAX_NOISE),
        max_speech=f(_MAX_SPEECH), nm_lo=f(g_idx + 5.0),
        nm_hi=f(72.0 + g_idx - np.arange(6, dtype=np.float32)[None, :]),
        slots=torch.arange(_LOW_SLOTS, device=device),
        low_fill=f(np.full((6, _LOW_SLOTS), _LOW_FILL)),
        age_fill=torch.full((6, _LOW_SLOTS), _LOW_MAX_AGE + 1, dtype=torch.int32, device=device),
        mean_init=f(np.full(6, 1600.0 / 16.0)), zero=f(0.0), one=f(1.0), c31=f(31.0),
        smooth_down=f(_SMOOTH_DOWN), smooth_up=f(_SMOOTH_UP),
        zero_i=torch.zeros((), dtype=torch.int32, device=device),
        minus_one=torch.full((), -1, dtype=torch.int64, device=device))


def _age(lows: torch.Tensor, ages: torch.Tensor, c: _Constants
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One frame of aging in the 16-slot minimum tracker, per channel.

    The sequential rule walks the slots in order: a slot whose age is 100
    is evicted (the slots after it shift left, an empty slot enters at the
    end) and the slot that shifted into its place is passed over this
    frame; any other slot it reaches ages by one. So within a run of
    consecutive slots aged 100 every other one is evicted, starting with
    the run's first. Here that is one stable compaction of the kept slots.
    Each eviction appends an empty slot of age 101, which the walk then
    reaches and ages to 102, unless it shifted in right after an eviction:
    only the first, and only when slot 15 itself was evicted. So the ages
    are the walk's, past 100 too (no slot past 100 ever expires)."""
    expired = ages == _LOW_MAX_AGE
    # the last slot before each slot's run of expired slots
    run_start = torch.cummax(torch.where(expired, c.minus_one, c.slots), dim=1).values
    evicted = expired & ((c.slots - run_start) % 2 == 1)
    # a slot right after an evicted one is passed over, the rest age by one
    passed = torch.zeros_like(evicted)
    passed[:, 1:] = evicted[:, :-1]
    aged = ages + (~passed).to(torch.int32)
    order = torch.sort(evicted.to(torch.int32), dim=1, stable=True).indices
    first_empty = _LOW_SLOTS - evicted.sum(dim=1, keepdim=True)
    empty = c.slots >= first_empty
    empty_age = c.age_fill + ((c.slots != first_empty) | ~evicted[:, -1:]).to(torch.int32)
    return (torch.where(empty, c.low_fill, torch.gather(lows, 1, order)),
            torch.where(empty, empty_age, torch.gather(aged, 1, order)))


def _age_walk(lows: torch.Tensor, ages: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential aging walk of the JAX package's tracker, which kernel
    I runs (tests hold it against :func:`_age`; no caller on the main
    path): slot k = 0..15 in turn, each channel on its own, either evicted
    at age 100 (the slots after it shift left, an empty slot of age 101
    enters at the end, and the slot that shifted into k is not visited) or
    aged by one."""
    lows, ages = lows.clone(), ages.clone()
    for k in range(_LOW_SLOTS):
        expired = ages[:, k] == _LOW_MAX_AGE
        shifted_lows = torch.cat([lows[:, k + 1:], torch.full_like(lows[:, :1], _LOW_FILL)], dim=1)
        shifted_ages = torch.cat([ages[:, k + 1:], torch.full_like(ages[:, :1], _LOW_MAX_AGE + 1)],
                                 dim=1)
        lows[:, k:] = torch.where(expired[:, None], shifted_lows, lows[:, k:])
        ages[:, k:] = torch.where(expired[:, None], shifted_ages, ages[:, k:])
        ages[:, k] = torch.where(expired, ages[:, k], ages[:, k] + 1)
    return lows, ages


def _find_minimum(state: GmmState, features: torch.Tensor, c: _Constants):
    """The 16-smallest-over-100-frames minimum tracker, vectorized over
    channels. Returns (lows, ages, smoothed minima)."""
    lows, ages = _age(state.low_values, state.value_ages, c)

    # insert the new value at its sorted position (shift right from there)
    smaller = features[:, None] < lows  # (6, 16)
    has_slot = smaller.any(dim=1, keepdim=True)
    pos = torch.argmax(smaller.to(torch.int32), dim=1, keepdim=True)  # first slot it fits
    at_pos = (c.slots == pos) & has_slot
    shift = (c.slots > pos) & has_slot
    prev_lows = torch.cat([lows[:, :1], lows[:, :-1]], dim=1)
    prev_ages = torch.cat([ages[:, :1], ages[:, :-1]], dim=1)
    lows = torch.where(at_pos, features[:, None], torch.where(shift, prev_lows, lows))
    ages = torch.where(at_pos, 1, torch.where(shift, prev_ages, ages))

    fc = state.frame_count
    median = torch.where(fc > 2, lows[:, 2], torch.where(fc > 0, lows[:, 0], c.mean_init))
    alpha = torch.where(fc > 0, torch.where(median < state.mean_values, c.smooth_down,
                                            c.smooth_up), c.zero)
    mean_values = ((alpha + 1.0 / 32768.0) * state.mean_values
                   + (1.0 - alpha) * median + 16384.0 / 524288.0)
    return lows, ages, mean_values


def gmm_step(state: GmmState, features: torch.Tensor, total_power: torch.Tensor,
             thresholds, c: _Constants) -> Tuple[GmmState, torch.Tensor]:
    """One 10 ms frame of the GMM decision and model adaptation: returns
    the new state and the frame's flag (0 noise, 1 speech, >= 2
    hangover)."""
    oh_max1, oh_max2, local_thr, global_thr = thresholds
    active = total_power > _MIN_ENERGY
    x = features[None]  # (1, 6) against the (2, 6) Gaussians

    def gauss_prob(mean, std):
        q = (x - mean) ** 2 / (2.0 * std * std)
        return torch.where(q < _COMP_VAR, torch.exp(-torch.clamp(q, max=80.0)) / std, c.zero)

    noise_p = c.noise_w * gauss_prob(state.noise_means, state.noise_stds)
    speech_p = c.speech_w * gauss_prob(state.speech_means, state.speech_stds)
    h0 = noise_p.sum(dim=0)  # (6,)
    h1 = speech_p.sum(dim=0)
    shift0 = torch.where(h0 <= 0, c.c31, 31.0 - 27.0 - torch.log2(torch.clamp(h0, min=1e-38)))
    shift1 = torch.where(h1 <= 0, c.c31, 31.0 - 27.0 - torch.log2(torch.clamp(h1, min=1e-38)))
    llr = shift0 - shift1  # log2(h1/h0), saturated like the fixed-point original
    sum_llr = (llr * c.spectrum_weight).sum()
    vadflag = active & ((llr * 4.0 > local_thr).any() | (sum_llr >= global_thr))

    ngpr0 = torch.where(h0 > 0, noise_p[0] / torch.clamp(h0, min=1e-38), c.one)
    ngpr = torch.stack([ngpr0, 1.0 - ngpr0])
    sgpr0 = torch.where(h1 > 0, speech_p[0] / torch.clamp(h1, min=1e-38), c.zero)
    sgpr = torch.stack([sgpr0, torch.where(h1 > 0, 1.0 - sgpr0, c.zero)])

    # ---- adaptation (kept only when the frame had enough power) ----
    lows, ages, mean_values = _find_minimum(state, features, c)
    noise_gmean = (state.noise_means * c.noise_w).sum(dim=0)  # (6,)

    delta_n = (x - state.noise_means) / state.noise_stds ** 2
    delta_s = (x - state.speech_means) / state.speech_stds ** 2

    nm = (state.noise_means
          + torch.where(vadflag, c.zero, _NOISE_UPDATE * ngpr * delta_n)
          + _BACK_ETA * (mean_values - noise_gmean)[None])
    nm = torch.clamp(nm, c.nm_lo, c.nm_hi)

    sm = state.speech_means + _SPEECH_UPDATE * sgpr * delta_s
    sm = torch.clamp(sm, min=c.min_mean).clamp(max=(12800.0 + 640.0) / 128.0)
    sm = torch.where(vadflag, sm, state.speech_means)

    ss = state.speech_stds + sgpr * (
        delta_s * (x - state.speech_means) - 1.0) * 0.1 / state.speech_stds
    ss = torch.where(vadflag, torch.clamp(ss, min=_MIN_STD), state.speech_stds)

    ns = state.noise_stds + ngpr * (
        delta_n * (x - state.noise_means) - 1.0) / state.noise_stds
    ns = torch.where(vadflag, state.noise_stds, torch.clamp(ns, min=_MIN_STD))

    # model separation and drift control; the separation offset goes into
    # the means themselves (the original's WeightedAverage mutates its input)
    noise_gmean = (nm * c.noise_w).sum(dim=0)
    speech_gmean = (sm * c.speech_w).sum(dim=0)
    t_sep = torch.clamp(c.min_diff - (speech_gmean - noise_gmean), min=0.0)
    sm = sm + 0.8 * t_sep[None]
    nm = nm - 0.2 * t_sep[None]
    speech_gmean = (sm * c.speech_w).sum(dim=0)
    noise_gmean = (nm * c.noise_w).sum(dim=0)
    sm = sm - torch.clamp(speech_gmean - c.max_speech, min=0.0)[None]
    nm = nm - torch.clamp(noise_gmean - c.max_noise, min=0.0)[None]

    # hangover hysteresis
    flag_i = vadflag.to(torch.int32)
    hang_flag = ~vadflag & (state.over_hang > 0)
    out_flag = torch.where(hang_flag, state.over_hang + 2, flag_i)
    over_hang = torch.where(
        vadflag,
        torch.where(state.speech_run >= _MAX_SPEECH_FRAMES, oh_max2, oh_max1).to(torch.int32),
        state.over_hang - hang_flag.to(torch.int32))
    speech_run = torch.where(vadflag, torch.clamp(state.speech_run + 1, max=_MAX_SPEECH_FRAMES),
                             c.zero_i)

    keep = lambda new, old: torch.where(active, new, old)  # noqa: E731
    new_state = GmmState(
        noise_means=keep(nm, state.noise_means),
        speech_means=keep(sm, state.speech_means),
        noise_stds=keep(ns, state.noise_stds),
        speech_stds=keep(ss, state.speech_stds),
        frame_count=state.frame_count + active.to(torch.int32),
        over_hang=over_hang,
        speech_run=speech_run,
        low_values=keep(lows, state.low_values),
        value_ages=keep(ages, state.value_ages),
        mean_values=keep(mean_values, state.mean_values),
    )
    return new_state, out_flag


def gmm_flags_plain(features: torch.Tensor, total: torch.Tensor, thresholds,
                    final_state: bool = False):
    """Kernel I's plain version, a loop of :func:`gmm_step` over the frames
    of ``features (F, 6)`` and ``total (F,)`` from the initial state with
    the mode's ``thresholds`` (a row of :data:`MODE_TABLE`): the flags
    ``(F,)`` int32, and with ``final_state`` ``(flags, GmmState)``."""
    dtype, dev = features.dtype, features.device
    consts = _constants(dtype, dev)
    state = initial_gmm_state(dtype, dev)
    flags = []
    for t in range(features.shape[0]):
        state, flag = gmm_step(state, features[t], total[t], thresholds, consts)
        flags.append(flag)
    flags = torch.stack(flags) if flags else torch.zeros(0, dtype=torch.int32, device=dev)
    return (flags, state) if final_state else flags


_P, _I = ctypes.c_void_p, ctypes.c_int
# features, total, F, is_double, oh1, oh2, local_thr, global_thr, flags,
# state_f, state_i, stream
_GMM_ARGTYPES = [_P, _P, _I, _I, _I, _I, ctypes.c_double, ctypes.c_double, _P, _P, _P, _P]
GMM_STATE_VALUES = 4 * 12 + 6 * _LOW_SLOTS + 6  # the kernel's packed float state
GMM_STATE_INTS = 3 + 6 * _LOW_SLOTS


def _unpack_state(f: torch.Tensor, i: torch.Tensor) -> GmmState:
    """The kernel's packed final state as a :class:`GmmState`."""
    means = f[:48].reshape(4, 2, 6)
    return GmmState(noise_means=means[0], speech_means=means[1], noise_stds=means[2],
                    speech_stds=means[3], frame_count=i[0], over_hang=i[1], speech_run=i[2],
                    low_values=f[48:48 + 6 * _LOW_SLOTS].reshape(6, _LOW_SLOTS),
                    value_ages=i[3:].reshape(6, _LOW_SLOTS), mean_values=f[48 + 6 * _LOW_SLOTS:])


def gmm_flags(features: torch.Tensor, total: torch.Tensor, thresholds,
              final_state: bool = False):
    """The GMM decision and adaptation over all frames of ``features (F,
    6)`` and ``total (F,)``: flags ``(F,)`` int32 (0 noise, 1 speech, >= 2
    hangover), and with ``final_state`` ``(flags, GmmState)``. CUDA tensors
    launch kernel I once (float32 or float64; anything else raises), CPU
    tensors run :func:`gmm_flags_plain`."""
    dev = features.device
    if dev.type == "cpu":
        return gmm_flags_plain(features, total, thresholds, final_state)
    if dev.type != "cuda":
        raise ValueError(f"the WebRTC GMM runs on cpu or cuda tensors, got {dev}")
    dtype = features.dtype
    n = features.shape[0] if features.dim() == 2 else -1
    if (features.dim() != 2 or features.shape[1] != 6 or tuple(total.shape) != (n,)
            or total.dtype != dtype or total.device != dev
            or dtype not in (torch.float32, torch.float64)):
        raise ValueError(f"the WebRTC GMM kernel takes float32 or float64 features (F, 6) and "
                         f"total (F,) of one dtype on one device, got {dtype} "
                         f"{tuple(features.shape)} and {total.dtype} {tuple(total.shape)} on "
                         f"{total.device}")
    oh1, oh2, local_thr, global_thr = thresholds
    flags = torch.empty((n,), dtype=torch.int32, device=dev)
    state_f = torch.empty((GMM_STATE_VALUES,), dtype=dtype, device=dev)
    state_i = torch.empty((GMM_STATE_INTS,), dtype=torch.int32, device=dev)
    feats, tot = features.contiguous(), total.contiguous()
    lib = _build.load("webrtc_gmm", _GMM_ARGTYPES)
    with torch.cuda.device(dev):  # launch on the tensors' card
        rc = lib.webrtc_gmm_launch(feats.data_ptr(), tot.data_ptr(), n,
                                   int(dtype == torch.float64), int(oh1), int(oh2),
                                   float(local_thr), float(global_thr), flags.data_ptr(),
                                   state_f.data_ptr(), state_i.data_ptr(),
                                   torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "webrtc_gmm", rc)
    gmm_flags.launches += 1
    return (flags, _unpack_state(state_f, state_i)) if final_state else flags


gmm_flags.launches = 0  # kernel I launches; plain CPU calls do not count


def webrtc_vad_flags(signal: torch.Tensor, mode: int = 0, dtype=torch.float32,
                     acc_dtype=torch.float64) -> torch.Tensor:
    """Offline VAD: int16 samples ``(S,)`` -> per-10 ms flags ``(F,)`` int32
    on the signal's device. The filterbank runs over the whole signal, the
    GMM through :func:`gmm_flags` (kernel I on CUDA, one launch); trailing
    samples short of a frame are dropped, as in the streaming detector."""
    n_frames = signal.shape[0] // FRAME_LEN_16K
    dev = signal.device
    if n_frames == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)
    x = signal[: n_frames * FRAME_LEN_16K].to(dtype)
    features, total, _ = extract_features(x, initial_filter_state(dtype, dev), acc_dtype)
    return gmm_flags(features, total, MODE_TABLE[mode])


class WebRtcVadTorch:
    """Offline WebRTC-style VAD on one device (CUDA by default): whole
    utterances in, per-10 ms flags out, equal to the native detector's.
    Stateless between calls; ``FRAME_LEN`` and ``sample_rate`` let the
    recognizer use it as its detector."""

    FRAME_LEN = FRAME_LEN_16K
    sample_rate = 16000

    def __init__(self, mode: int = 0, dtype=torch.float32, acc_dtype=torch.float64,
                 device="cuda"):
        self.mode = mode
        self.dtype = dtype
        self.acc_dtype = acc_dtype
        self.device = resolve_device(device)

    def process(self, signal) -> np.ndarray:
        """int16 samples -> per-10 ms flags, computed on the detector's
        device and copied back once."""
        sig = torch.as_tensor(np.asarray(signal), device=self.device)
        return webrtc_vad_flags(sig, self.mode, self.dtype, self.acc_dtype).cpu().numpy()
