"""Typed configuration dataclasses of the PyTorch port.

Same fields, defaults and derived properties as the JAX package's
``MFCCConfig``, ``HMMConfig``, ``GMMHMMConfig``, ``NGramConfig``,
``LTSDConfig``, ``MeshConfig`` and ``TrainConfig``;
this package keeps its own copy so it never imports the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MFCCConfig:
    """MFCC frontend geometry: 16 kHz, 25 ms frames, 10 ms stride, 512-pt
    FFT, 40 mel filters, 12 cepstra + log-energy + deltas -> 39 dims.

    ``spectrum_method`` selects the STFT of the plain pipeline:
      - ``"matmul"``: windowed DFT as two fp32 GEMMs;
      - ``"fft"``: ``torch.fft.rfft``.

    ``frontend`` selects the serving-path implementation used by
    :meth:`lnasr_tpu_torch.models.mfcc.MFCC.features_fast`:
      - ``"auto"``: the hand-written CUDA mel frontend for CUDA tensors,
        the plain torch pipeline for CPU tensors;
      - ``"fused"``: always the CUDA kernel (raises on the CPU);
      - ``"xla"``: always the plain torch pipeline (the name is kept
        from the JAX package, where that pipeline is XLA's).
    ``fused_passes`` is kept for API parity; the CUDA kernel computes in
    fp32 for both accepted values (3 and 6).
    """

    sample_rate: int = 16000
    frame_t: float = 25e-3
    frame_stride: float = 10e-3
    preemph: float = 0.97
    fft_n: int = 512
    n_mels: int = 40
    n_ceps: int = 12
    spectrum_method: str = "matmul"
    frontend: str = "auto"
    fused_passes: int = 6
    # "compat" seeds the first delta row with the *second* feature row,
    # as the original toolkit does; "standard" uses features[1]-features[0].
    delta_mode: str = "compat"
    # Floor for the per-frame total power before the log-energy feature;
    # 0.0 gives log(0) = -inf on digital silence.
    energy_floor: float = 0.0
    # Per-utterance cepstral mean subtraction.
    mean_norm: bool = True

    @property
    def frame_len(self) -> int:
        return int(self.sample_rate * self.frame_t)

    @property
    def frame_step(self) -> int:
        return int(self.sample_rate * self.frame_stride)

    @property
    def fft_size(self) -> int:
        return self.fft_n // 2 + 1

    @property
    def feature_dim(self) -> int:
        return (self.n_ceps + 1) * 3  # cepstra + log-energy, with Δ and ΔΔ


@dataclasses.dataclass(frozen=True)
class HMMConfig:
    """Discrete-emission HMM topology (states x symbols)."""

    n_states: int = 2
    n_symbols: int = 3


@dataclasses.dataclass(frozen=True)
class GMMHMMConfig:
    """Continuous GMM-HMM topology.

    ``cov_type`` is ``"diag"`` (the serving path) or ``"full"``.
    ``var_floor`` is the absolute diagonal-variance floor (a scalar or a
    per-dimension tuple); ``var_floor_scale`` > 0 resolves it at
    data-driven init to ``max(var_floor, scale * per-dim data variance)``.
    """

    n_states: int = 5
    n_mix: int = 8
    dim: int = 39
    cov_type: str = "diag"
    min_std: float = 0.01
    var_floor: object = 1e-3
    var_floor_scale: float = 0.05


@dataclasses.dataclass(frozen=True)
class NGramConfig:
    """Katz-backoff n-gram LM (``lnasr/ngram.py:114-254``).

    ``smoothing`` selects the discounting scheme:
      - ``"fixed"``: the reference's constant discount;
      - ``"good-turing"``: count-dependent Katz/Good-Turing discounts for
        counts ``r <= gt_max_count`` (``d_r = (r*/r - A) / (1 - A)``);
        orders whose count-of-counts are too sparse fall back to the
        fixed discount.
    ``open_vocab`` gives the unigram level's freed discount mass to an
    ``<unk>`` class, so out-of-vocabulary words have a probability.
    """

    order: int = 3
    discount: float = 0.7
    add_sentence_bounds: bool = True
    smoothing: str = "fixed"
    gt_max_count: int = 5
    open_vocab: bool = False


@dataclasses.dataclass(frozen=True)
class LTSDConfig:
    """Long-Term Spectral Divergence VAD: window and stride in samples,
    the LTSE order, the decision threshold in dB, and the noise
    adaptation weight (``None``: no adaptation)."""

    sample_rate: int = 16000
    win_size: int = 2048
    step_size: int = 1024
    order: int = 6
    threshold: float = -6.0
    alpha: Optional[float] = None

    @property
    def fft_size(self) -> int:
        return self.win_size // 2 + 1


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Logical rank mesh (:mod:`lnasr_tpu_torch.parallel`). Axes:

    - ``data``: utterance batch (data parallelism; EM stats are summed here)
    - ``seq``: time-chunk axis for long-audio associative-scan parallelism
    - ``model``: GMM component sharding when N*M*D outgrows one device
    """

    data: int = 1
    seq: int = 1
    model: int = 1

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return ("data", "seq", "model")

    @property
    def shape(self) -> Tuple[int, ...]:
        return (self.data, self.seq, self.model)


@dataclasses.dataclass(frozen=True)
class TrainConfig:
    """EM training loop: a budget of ``max_iters`` sweeps, stopping when
    |delta loglik| < ``eps``; ``checkpoint_every`` > 0 with a
    ``checkpoint_dir`` saves the training state every that many sweeps
    (:mod:`lnasr_tpu_torch.utils.checkpoints`)."""

    max_iters: int = 100
    eps: float = 1e-4
    seed: int = 0
    checkpoint_every: int = 0  # 0 disables periodic checkpoints
    checkpoint_dir: Optional[str] = None
