"""The port's main paths.

- :func:`flagship`: the flagship serving step. ``signals (B, S)`` ->
  39-dim MFCCs ``(B, T, 39)`` (fused mel frontend kernel on CUDA) ->
  diagonal-GMM emissions ``log_b (B, T, 5)`` -> batched Viterbi (small-N
  kernel on CUDA) -> ``(path (B, T) int32, score (B,))``, on the 5-state x
  8-mixture x 39-dim model; the counterpart of the JAX package's
  ``__graft_entry__.py:entry``.
- :func:`recognizer_serving`: the recognizer's 1-best segment decode at the
  serving geometry of the JAX package's ``bench.py``
  (``recognizer_serving_measurements``): whole-word models, a bigram LM, a
  bucketed ~5 s segment, through ``Recognizer.decode_segment``. Its N-best
  path is ``recognizer_serving(1000)[0].decode_segment_nbest(segment,
  n=5)``: the factored graph with a dense hop records a word lattice
  (mel frontend and lattice kernels on CUDA) and the host extracts the
  N-best list (at V = 22 the dense graph has no lattice, and N-best
  raises, as in the JAX package).
"""

from __future__ import annotations

import numpy as np
import torch

from lnasr_tpu_torch._device import resolve_device
from lnasr_tpu_torch.config import GMMHMMConfig, MFCCConfig
from lnasr_tpu_torch.convert import params_from_numpy
from lnasr_tpu_torch.models.decoder import SILENCE, DecoderConfig
from lnasr_tpu_torch.models.gmmhmm import GMMHMM, GMMHMMParams
from lnasr_tpu_torch.models.lexicon import Lexicon
from lnasr_tpu_torch.models.mfcc import MFCC
from lnasr_tpu_torch.models.ngram import NGramCounter, NGramModel
from lnasr_tpu_torch.models.recognizer import AcousticModel, LanguageModel, Recognizer
from lnasr_tpu_torch.ops.viterbi import viterbi_batched

MODEL_CONFIG = GMMHMMConfig(n_states=5, n_mix=8, dim=39)
MFCC_CONFIG = MFCCConfig(energy_floor=1e-10)

SERVING_MFCC_CONFIG = MFCCConfig(energy_floor=1e-10, mean_norm=False)
SERVING_DECODER_CONFIG = DecoderConfig(lm_scale=0.5, word_insertion_penalty=-4.0)
SERVING_BUCKET_FRAMES = 128
SERVING_BUCKETS = 4  # a ~5 s segment: a realistic VAD segment's upper bound
SERVING_TRIM = 80  # samples short of the bucket grid, so the decode is masked


def flagship_model(device="cuda", dtype=torch.float32) -> GMMHMM:
    """The flagship GMM-HMM, initialized from seeded random frames."""
    model = GMMHMM(MODEL_CONFIG, dtype=dtype, device=device)
    rng = np.random.default_rng(0)
    return model.init_from_data(rng.normal(scale=10.0, size=(256, MODEL_CONFIG.dim)),
                                torch.Generator().manual_seed(0))


def flagship(device="cuda", dtype=torch.float32, params: GMMHMMParams = None):
    """The serving step ``forward_step(signals) -> (paths, scores)`` on
    ``device``, with ``params`` carried over (else :func:`flagship_model`'s)."""
    dev = resolve_device(device)
    if params is None:
        model = flagship_model(dev, dtype)
    else:
        model = GMMHMM(MODEL_CONFIG, dtype=dtype, device=dev).set_params(params)
    mfcc = MFCC(MFCC_CONFIG, dtype=dtype, device=dev)

    def forward_step(signals):  # (B, S) batch of utterances
        feats, _ = mfcc.features_fast(signals)
        log_b = model.emissions(feats)
        return viterbi_batched(model.log_pi, model.log_a, log_b)

    return forward_step


def entry(device="cuda"):
    """(forward step, example args) on the flagship model."""
    dev = resolve_device(device)
    rng = np.random.default_rng(1)
    example = rng.normal(scale=3000.0, size=(4, 16000)).astype(np.float32)
    return flagship(dev), (torch.as_tensor(example, device=dev),)


def _serving_unit(n, n_mix, log_a, mu, var, device, dtype) -> GMMHMM:
    cfg = GMMHMMConfig(n_states=n, n_mix=n_mix, dim=mu.shape[-1])
    log_pi = np.full(n, -np.log(n))
    log_w = np.full((n, n_mix), -np.log(n_mix))
    params = params_from_numpy(log_a, log_pi, log_w, mu, np.full(mu.shape, var),
                               device=device, dtype=dtype)
    return GMMHMM(cfg, dtype=dtype, device=device).set_params(params)


def serving_segment(seed: int = 0) -> np.ndarray:
    """The seeded speech-like segment of the serving geometry: a harmonic
    voice with a moving pitch and an AM envelope over a noise floor (the
    JAX package's ``bench.py:_make_audio``), ``SERVING_BUCKETS`` buckets of
    ``SERVING_BUCKET_FRAMES`` frames long less ``SERVING_TRIM`` samples
    (81,840 samples, 5.115 s), float32."""
    cfg = SERVING_MFCC_CONFIG
    rng = np.random.default_rng(seed)
    n = SERVING_BUCKETS * SERVING_BUCKET_FRAMES * cfg.frame_step
    t = np.arange(n) / cfg.sample_rate
    f0 = 140.0 + 40.0 * np.sin(2 * np.pi * 0.4 * t)
    base = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 1.7 * t)
    x = np.clip(base * env * 8000.0 + rng.normal(0, 100.0, n), -32768, 32767)
    return x.astype(np.int16)[: n - SERVING_TRIM].astype(np.float32)


def _serving_draws(vocab: int, seed: int):
    """The serving geometry's seeded draws, in order: each word's ``(8, 2,
    39)`` state means, the silence unit's ``(3, 4, 39)`` means and the LM
    corpus of 100 random 4-word sentences."""
    dim = SERVING_MFCC_CONFIG.feature_dim
    rng = np.random.default_rng(seed)
    means = rng.normal(scale=25.0, size=(vocab, dim))
    word_mu = [means[i][None, None, :] + rng.normal(scale=2.0, size=(8, 2, dim))
               for i in range(vocab)]
    sil_mu = rng.normal(scale=5.0, size=(3, 4, dim))
    names = [f"w{i:04d}" for i in range(vocab)]
    corpus = [tuple(["<s>"] + list(rng.choice(names, size=4)) + ["</s>"]) for _ in range(100)]
    return word_mu, sil_mu, corpus


def serving_corpus(vocab: int, seed: int = 0):
    """The sentences :func:`recognizer_serving`'s bigram LM is counted from
    (for a higher-order LM of the same text, e.g. to rescore lattices)."""
    return _serving_draws(vocab, seed)[2]


def recognizer_serving(vocab: int, device="cuda", dtype=torch.float32, seed: int = 0):
    """``(Recognizer, segment)`` at the recognizer's serving geometry:

    - ``vocab`` whole-word units of 8 left-to-right states x 2 mixtures x
      39 dims (diagonal variance 40; means ``N(0, 25^2)`` per word plus
      ``N(0, 2^2)`` per state and mixture) and a 3-state x 4-mixture
      ``<sil>`` unit (variance 80);
    - a bigram LM counted from 100 random 4-word sentences
      (:func:`serving_corpus`);
    - ``DecoderConfig(lm_scale=0.5, word_insertion_penalty=-4.0)``,
      ``mean_norm=False`` MFCCs, ``bucket_frames=128``, ``graph="auto"``:
      at V = 22 the 179-state dense graph, at V = 1000 the factored graph
      with a dense (V, V) hop;
    - the segment of :func:`serving_segment`.

    Weights are random, drawn from ``seed`` with NumPy, so every device
    gets the same model."""
    dev = resolve_device(device)
    n_states = 8
    with np.errstate(divide="ignore"):
        l2r = np.log(np.where(np.eye(n_states) + np.eye(n_states, k=1) > 0, 0.5, 0.0))
    word_mu, sil_mu, corpus = _serving_draws(vocab, seed)
    units = {f"w{i:04d}": _serving_unit(n_states, 2, l2r, mu, 40.0, dev, dtype)
             for i, mu in enumerate(word_mu)}
    units[SILENCE] = _serving_unit(3, 4, np.full((3, 3), -np.log(3)), sil_mu, 80.0, dev, dtype)
    rec = Recognizer(AcousticModel(units, SERVING_MFCC_CONFIG, dtype=dtype, device=dev),
                     Lexicon.whole_word(sorted(units.keys() - {SILENCE})),
                     LanguageModel(NGramModel(NGramCounter(2, corpus))),
                     decoder_config=SERVING_DECODER_CONFIG, graph="auto",
                     bucket_frames=SERVING_BUCKET_FRAMES)
    return rec, serving_segment(seed)
