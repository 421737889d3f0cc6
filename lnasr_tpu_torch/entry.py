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
  raises, as in the JAX package). With ``graph="trigram", lm_order=3``
  (at V = 200) it decodes with the exact trigram graph.
- :func:`streaming_serving`: live serving. A :class:`StreamingRecognizer`
  over :func:`recognizer_serving`'s recognizer and its default native
  WebRTC VAD, and a seeded ~60 s stream of speech-like bursts between
  near-silent gaps, fed in 100 ms chunks (:data:`STREAM_CHUNK`): each
  segment the VAD closes is decoded by ``Recognizer.decode_segment``.
- :func:`training`: the flagship Baum-Welch sweep, the counterpart of the
  JAX package's ``bench_train.py``. B=64 seeded 10 s utterances -> MFCCs
  (fused mel frontend kernel on CUDA, once) -> a step function doing one
  ``gmmhmm_em_step`` sweep of the 5 x 8 x 39 diagonal GMM-HMM, started from
  :func:`flagship_model`'s parameters.
- :func:`unit_training`: isolated-unit training of the V = 22 serving
  geometry's inventory (8-state x 2-mixture word units and a 3-state x
  4-mixture ``<sil>``) from seeded voiced examples, whose features come
  from one batched frontend call, through ``train_unit_models``; it
  returns an :class:`AcousticModel`. :func:`unit_recognizer` decodes with
  it, and :func:`unit_utterance` plants a word sequence in audio.
- :func:`parallel_training`, :func:`parallel_serving`: the training step
  and a batch of serving segments for a rank of a ``parallel/`` mesh
  (each rank runs the mel frontend kernel on its own signals); and
  :func:`dryrun_multichip`, every multi-rank path once at tiny shapes in a
  spawned world, the counterpart of the JAX package's
  ``__graft_entry__.py:dryrun_multichip``.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Sequence, Tuple

import numpy as np
import torch

from lnasr_tpu_torch._device import resolve_device
from lnasr_tpu_torch.config import GMMHMMConfig, MFCCConfig
from lnasr_tpu_torch.convert import params_from_numpy
from lnasr_tpu_torch.models.decoder import SILENCE, DecoderConfig
from lnasr_tpu_torch.models.gmmhmm import GMMHMM, GMMHMMParams, gmmhmm_em_step
from lnasr_tpu_torch.models.lexicon import Lexicon
from lnasr_tpu_torch.models.mfcc import MFCC
from lnasr_tpu_torch.models.ngram import NGramCounter, NGramModel
from lnasr_tpu_torch.models.recognizer import (
    AcousticModel,
    LanguageModel,
    Recognizer,
    StreamingRecognizer,
    train_unit_models,
)
from lnasr_tpu_torch.ops.viterbi import viterbi_batched

MODEL_CONFIG = GMMHMMConfig(n_states=5, n_mix=8, dim=39)
MFCC_CONFIG = MFCCConfig(energy_floor=1e-10)

SERVING_MFCC_CONFIG = MFCCConfig(energy_floor=1e-10, mean_norm=False)
SERVING_DECODER_CONFIG = DecoderConfig(lm_scale=0.5, word_insertion_penalty=-4.0)
SERVING_BUCKET_FRAMES = 128
SERVING_BUCKETS = 4  # a ~5 s segment: a realistic VAD segment's upper bound
SERVING_TRIM = 80  # samples short of the bucket grid, so the decode is masked
STREAM_SECONDS = 60.0  # the live stream's length
STREAM_CHUNK = 1600  # samples a chunk: 100 ms at 16 kHz
TRAIN_BATCH, TRAIN_SECONDS = 64, 10  # the training batch: 64 utterances of 10 s
WORD_UNIT = GMMHMMConfig(n_states=8, n_mix=2, dim=39)
SILENCE_UNIT = GMMHMMConfig(n_states=3, n_mix=4, dim=39)
UNIT_EXAMPLES = 3  # seeded examples of each unit
# the reference's two speech recordings (test/third/data-vad.raw and
# test/data.raw) are 12.6 s and 1.36 s long; recording_pair stands in for them
RECORDING_SECONDS = (12.6, 1.36)
RECORDING_WORDS = 24  # distinct words recording_pair can speak (base pitch up to 1.5 kHz)


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


def _voice(n: int, rng, f_base: float = 140.0, phase: float = 0.0) -> np.ndarray:
    """A harmonic voice with a moving pitch and an AM envelope, over a
    noise floor (the JAX package's ``bench.py:_make_audio``), float64."""
    t = np.arange(n) / SERVING_MFCC_CONFIG.sample_rate
    f0 = f_base + 40.0 * np.sin(2 * np.pi * 0.4 * t)
    base = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in range(1, 6))
    env = 0.5 + 0.5 * np.sin(2 * np.pi * 1.7 * t + phase)
    return base * env * 8000.0 + rng.normal(0, 100.0, n)


def serving_segment(seed: int = 0) -> np.ndarray:
    """The seeded speech-like segment of the serving geometry: a harmonic
    voice with a moving pitch and an AM envelope over a noise floor (the
    JAX package's ``bench.py:_make_audio``), ``SERVING_BUCKETS`` buckets of
    ``SERVING_BUCKET_FRAMES`` frames long less ``SERVING_TRIM`` samples
    (81,840 samples, 5.115 s), float32."""
    cfg = SERVING_MFCC_CONFIG
    rng = np.random.default_rng(seed)
    n = SERVING_BUCKETS * SERVING_BUCKET_FRAMES * cfg.frame_step
    x = np.clip(_voice(n, rng), -32768, 32767)
    return x.astype(np.int16)[: n - SERVING_TRIM].astype(np.float32)


def serving_stream(seed: int = 0) -> np.ndarray:
    """The seeded live stream of :func:`streaming_serving`, int16 at 16
    kHz, about :data:`STREAM_SECONDS` long: speech-like bursts of 0.5 to 5
    s (:func:`serving_segment`'s voice, each with its own pitch and
    envelope phase) between near-silent gaps of 0.3 to 1.2 s (noise of
    standard deviation 30), starting and ending with a gap."""
    sr = SERVING_MFCC_CONFIG.sample_rate
    rng = np.random.default_rng(seed)
    gap = lambda: rng.normal(0, 30.0, int(sr * rng.uniform(0.3, 1.2)))  # noqa: E731
    parts = [gap()]
    n = len(parts[0])
    while n < STREAM_SECONDS * sr:
        burst = _voice(int(sr * rng.uniform(0.5, 5.0)), rng, rng.uniform(100.0, 220.0),
                       rng.uniform(0.0, 2 * np.pi))
        parts += [burst, gap()]
        n += len(burst) + len(parts[-1])
    return np.clip(np.concatenate(parts), -32768, 32767).astype(np.int16)


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


def recognizer_serving(vocab: int, device="cuda", dtype=torch.float32, seed: int = 0,
                       graph: str = "auto", lm_order: int = 2):
    """``(Recognizer, segment)`` at the recognizer's serving geometry:

    - ``vocab`` whole-word units of 8 left-to-right states x 2 mixtures x
      39 dims (diagonal variance 40; means ``N(0, 25^2)`` per word plus
      ``N(0, 2^2)`` per state and mixture) and a 3-state x 4-mixture
      ``<sil>`` unit (variance 80);
    - an ``lm_order``-gram LM (a bigram by default) counted from 100
      random 4-word sentences (:func:`serving_corpus`);
    - ``DecoderConfig(lm_scale=0.5, word_insertion_penalty=-4.0)``,
      ``mean_norm=False`` MFCCs, ``bucket_frames=128``; ``graph="auto"``
      composes the 179-state dense graph at V = 22 and the factored graph
      with a dense (V, V) hop at V = 1000; ``graph="trigram"`` with
      ``lm_order=3`` the history-expanded trigram graph (at V = 200 its
      hop tensor is 202 x 201 x 201 floats, 32.6 MB);
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
                     LanguageModel(NGramModel(NGramCounter(lm_order, corpus))),
                     decoder_config=SERVING_DECODER_CONFIG, graph=graph,
                     bucket_frames=SERVING_BUCKET_FRAMES)
    return rec, serving_segment(seed)


def streaming_serving(vocab: int, device="cuda", seed: int = 0):
    """``(StreamingRecognizer, stream)``: live serving over
    :func:`recognizer_serving`'s recognizer (bucketed segment decodes) with
    the default detector, the native WebRTC VAD in mode 0, and the stream
    of :func:`serving_stream`. Feed it in chunks of :data:`STREAM_CHUNK`
    samples, then ``flush()``."""
    rec, _ = recognizer_serving(vocab, device=device, seed=seed)
    return StreamingRecognizer(rec), serving_stream(seed)


def training_signals(batch: int = TRAIN_BATCH, seconds: float = TRAIN_SECONDS,
                     seed: int = 0) -> np.ndarray:
    """Seeded speech-like noise ``(batch, seconds * 16000)`` float32:
    amplitude-modulated at 1-4 Hz, never digital silence."""
    sr = MFCC_CONFIG.sample_rate
    rng = np.random.default_rng(seed)
    t = np.arange(int(seconds * sr)) / sr
    rate = rng.uniform(1.0, 4.0, size=(batch, 1))
    env = 0.05 + np.clip(np.sin(2 * np.pi * rate * t[None, :]), 0.0, None) ** 2
    return (rng.normal(scale=3000.0, size=(batch, len(t))) * env).astype(np.float32)


class Training(NamedTuple):
    """One training run: ``step(params) -> (params, loglik)`` is one EM
    sweep over ``features (B, T, 39)`` / ``mask (B, T)``, from ``params``."""

    step: Callable
    params: GMMHMMParams
    features: torch.Tensor
    mask: torch.Tensor


def training(device="cuda", dtype=torch.float32, batch: int = TRAIN_BATCH,
             seconds: float = TRAIN_SECONDS, features=None) -> Training:
    """The flagship training step on ``device`` in ``dtype``: the features
    of :func:`training_signals` (one call of the mel frontend kernel on
    CUDA, in float32; or ``features`` as given, cast to ``dtype``) and a
    diagonal ``gmmhmm_em_step`` sweep at its default floors, started from
    :func:`flagship_model`'s parameters."""
    dev = resolve_device(device)
    if features is None:
        signals = torch.as_tensor(training_signals(batch, seconds), device=dev)
        features, _ = MFCC(MFCC_CONFIG, device=dev).features_fast(signals)
    features = torch.as_tensor(features, dtype=dtype, device=dev)
    mask = torch.ones(features.shape[:2], dtype=torch.bool, device=dev)

    def step(params: GMMHMMParams):
        return gmmhmm_em_step(params, features, mask)

    return Training(step, flagship_model(dev, dtype).params, features, mask)


def _unit_f0(i: int) -> float:
    """Word i's base pitch: 90 Hz x 1.13^i (up to 1.2 kHz at i = 21), so the
    harmonics of each word fall in other mel bands than its neighbours'."""
    return 90.0 * 1.13 ** i


def _pcm(x: np.ndarray) -> np.ndarray:
    return np.clip(x, -32768, 32767).astype(np.int16).astype(np.float32)


def unit_signals(vocab: int = 22, seed: int = 0) -> Tuple[List[str], np.ndarray, List[int]]:
    """:data:`UNIT_EXAMPLES` seeded examples of each unit, as one padded
    batch ``(owners, signals (n, S) float32, lengths)``: word ``w{i:04d}``
    is :func:`_voice` at its own base pitch (0.35-0.6 s), ``<sil>`` noise of
    standard deviation 30 (0.3-0.6 s); int16 values as float32."""
    sr = SERVING_MFCC_CONFIG.sample_rate
    rng = np.random.default_rng(seed)
    owners, signals = [], []
    for i in range(vocab):
        for _ in range(UNIT_EXAMPLES):
            owners.append(f"w{i:04d}")
            signals.append(_voice(int(sr * rng.uniform(0.35, 0.6)), rng, _unit_f0(i),
                                  rng.uniform(0.0, 2 * np.pi)))
    for _ in range(UNIT_EXAMPLES):
        owners.append(SILENCE)
        signals.append(rng.normal(0, 30.0, int(sr * rng.uniform(0.3, 0.6))))
    lengths = [len(x) for x in signals]
    padded = np.zeros((len(signals), max(lengths)), np.float32)
    for j, x in enumerate(signals):
        padded[j, : len(x)] = _pcm(x)
    return owners, padded, lengths


def unit_examples(vocab: int = 22, device="cuda", seed: int = 0) -> Dict[str, List[np.ndarray]]:
    """The features (float32, on the host) of :func:`unit_signals`, by
    unit: one batched ``features_fast`` call with lengths (the mel frontend
    kernel once on CUDA)."""
    dev = resolve_device(device)
    owners, padded, lengths = unit_signals(vocab, seed)
    feats, mask = MFCC(SERVING_MFCC_CONFIG, device=dev).features_fast(
        torch.as_tensor(padded, device=dev), lengths=torch.as_tensor(lengths, device=dev))
    feats, n_frames = feats.cpu().numpy(), mask.sum(dim=1).cpu().numpy()
    examples: Dict[str, List[np.ndarray]] = {}
    for name, f, k in zip(owners, feats, n_frames):
        examples.setdefault(name, []).append(f[:k])
    return examples


def unit_training(vocab: int = 22, device="cuda", dtype=torch.float32, seed: int = 0,
                  iters: int = 5, examples=None):
    """``(AcousticModel, examples)``: ``train_unit_models`` over
    :func:`unit_examples` (or ``examples`` as given), ``iters`` sweeps,
    word units of :data:`WORD_UNIT` and ``<sil>`` of :data:`SILENCE_UNIT`,
    on ``device`` in ``dtype``."""
    dev = resolve_device(device)
    if examples is None:
        examples = unit_examples(vocab, dev, seed)
    units = train_unit_models(examples, WORD_UNIT, iters=iters, seed=seed, dtype=dtype,
                              unit_configs={SILENCE: SILENCE_UNIT}, device=dev)
    return AcousticModel(units, SERVING_MFCC_CONFIG, dtype=dtype, device=dev), examples


def unit_recognizer(am: AcousticModel, vocab: int = 22) -> Recognizer:
    """A recognizer over trained units at the serving geometry:
    :func:`recognizer_serving`'s bigram LM, decoder settings and buckets."""
    words = sorted(am.units.keys() - {SILENCE})
    return Recognizer(am, Lexicon.whole_word(words),
                      LanguageModel(NGramModel(NGramCounter(2, serving_corpus(vocab)))),
                      decoder_config=SERVING_DECODER_CONFIG, bucket_frames=SERVING_BUCKET_FRAMES)


def unit_utterance(words: Sequence[str]) -> np.ndarray:
    """The words ``w{i:04d}`` spoken in a row as :func:`unit_examples`
    voices them, each 0.4 s, between near-silent gaps of 0.2 s (seeded),
    int16 values as float32."""
    sr = SERVING_MFCC_CONFIG.sample_rate
    rng = np.random.default_rng(1)
    gap = lambda: rng.normal(0, 30.0, int(0.2 * sr))  # noqa: E731
    parts = [gap()]
    for w in words:
        parts += [_voice(int(0.4 * sr), rng, _unit_f0(int(w[1:])), rng.uniform(0.0, 2 * np.pi)),
                  gap()]
    return _pcm(np.concatenate(parts))


def recording_pair(seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """A seeded stand-in for the reference's two speech recordings, raw
    16 kHz int16 of :data:`RECORDING_SECONDS`, for the harnesses that read
    recordings (``bench/stream.py``, ``bench/wer.py``,
    ``examples/real_audio_demo.py``). Each holds phrases of one to three
    words between noise-floor gaps (standard deviation 30) of 0.4-0.6 s,
    the first gap 0.2-0.4 s and the last one filling the rest. A word
    lasts 0.25-0.4 s and is :func:`unit_signals`' voice at its own base
    pitch (:func:`_unit_f0`), with its envelope's peak in the middle of the
    word. Words come in a seeded order, each spoken once, at most
    :data:`RECORDING_WORDS` of them (about 19 at seed 0)."""
    sr = SERVING_MFCC_CONFIG.sample_rate
    rng = np.random.default_rng(seed)
    order = rng.permutation(RECORDING_WORDS)
    gap = lambda n: rng.normal(0, 30.0, n)  # noqa: E731
    out, spoken = [], 0
    for seconds in RECORDING_SECONDS:
        n_total = int(round(seconds * sr))
        parts = [gap(int(sr * rng.uniform(0.2, 0.4)))]
        n = len(parts[0])
        while True:
            n_words = [int(sr * rng.uniform(0.25, 0.4)) for _ in range(int(rng.integers(1, 4)))]
            n_gap = int(sr * rng.uniform(0.4, 0.6))
            if n + sum(n_words) + n_gap > n_total or spoken + len(n_words) > RECORDING_WORDS:
                break
            for k in n_words:
                phase = np.pi / 2 - 2 * np.pi * 1.7 * k / 2 / sr  # the envelope's peak mid-word
                parts.append(_voice(k, rng, _unit_f0(int(order[spoken])), phase))
                spoken += 1
            parts.append(gap(n_gap))
            n += sum(n_words) + n_gap
        parts.append(gap(n_total - n))
        out.append(np.clip(np.concatenate(parts), -32768, 32767).astype(np.int16))
    return out[0], out[1]


# -- multi-rank paths (parallel/) -------------------------------------------------


def parallel_training(mesh, device="cuda", dtype=torch.float32, batch: int = TRAIN_BATCH,
                      seconds: float = TRAIN_SECONDS, features=None) -> Training:
    """:func:`training` sharded over a rank mesh (call it on every rank):
    this rank's rows of :func:`training_signals`' batch along the mesh's
    ``data`` axis -> MFCCs (the mel frontend kernel once on CUDA; or this
    rank's rows of the global ``features`` as given) -> a data-parallel
    EM step, or a mixture-sharded one when the ``model`` axis is larger
    than 1 (``params`` then this rank's mixture slice), from
    :func:`flagship_model`'s parameters. ``features``/``mask`` are the
    rank's rows."""
    from lnasr_tpu_torch import parallel as P
    from lnasr_tpu_torch.parallel.mesh import local_rows, mesh_axis

    dev = resolve_device(device)
    data = mesh_axis(mesh, "data")
    if features is None:
        signals = local_rows(torch.as_tensor(training_signals(batch, seconds)), data)
        features, _ = MFCC(MFCC_CONFIG, device=dev).features_fast(signals.to(dev))
    else:
        features = local_rows(torch.as_tensor(features), data)
    features = torch.as_tensor(features, dtype=dtype, device=dev)
    mask = torch.ones(features.shape[:2], dtype=torch.bool, device=dev)
    params = flagship_model(dev, dtype).params
    if mesh_axis(mesh, "model").size > 1:
        em = P.make_mp_gmmhmm_em_step(mesh, MODEL_CONFIG)
        params = P.mp_param_specs().local(params, mesh)
    else:
        em = P.make_dp_gmmhmm_em_step(mesh, MODEL_CONFIG)

    def step(p: GMMHMMParams):
        return em(p, features, mask)

    return Training(step, params, features, mask)


class ParallelServing(NamedTuple):
    """A batch of bucketed serving segments: the recognizer, and padded
    ``features (B, T, 39)`` with their ``masks (B, T)``."""

    recognizer: Recognizer
    features: torch.Tensor
    masks: torch.Tensor


def parallel_serving_signals(segments: int = 8, seed: int = 0) -> Tuple[np.ndarray, np.ndarray]:
    """``(batch (segments, n_max) float32, lengths)``: ``segments`` pieces
    of :func:`serving_stream` (seeded offsets, 1.3 to 5.1 s), each
    zero-padded to the recognizer's largest bucket (``SERVING_BUCKETS`` x
    ``SERVING_BUCKET_FRAMES`` frames, ``n_max`` samples)."""
    stream = serving_stream(seed)
    n_max = SERVING_BUCKETS * SERVING_BUCKET_FRAMES * SERVING_MFCC_CONFIG.frame_step
    rng = np.random.default_rng(seed + 1)
    lengths = rng.integers(n_max // 4, n_max - SERVING_TRIM, size=segments)
    starts = rng.integers(0, len(stream) - n_max, size=segments)
    batch = np.zeros((segments, n_max), np.float32)
    for i, (s, n) in enumerate(zip(starts, lengths)):
        batch[i, :n] = stream[s:s + n]
    return batch, lengths


def parallel_serving(vocab: int = 1000, segments: int = 8, device="cuda",
                     seed: int = 0, graph: str = "auto", lm_order: int = 2) -> ParallelServing:
    """The batch a sharded decode serves (``parallel.decode_batch_sharded``):
    :func:`recognizer_serving`'s recognizer (``graph`` and ``lm_order`` as
    there: ``parallel_serving(200, 8, graph="trigram", lm_order=3)`` is the
    trigram graph's batch) and the padded pieces of
    :func:`parallel_serving_signals`, with their features from one batched
    ``features_fast`` call with lengths (the mel frontend kernel once on
    CUDA)."""
    dev = resolve_device(device)
    rec, _ = recognizer_serving(vocab, device=dev, seed=seed, graph=graph, lm_order=lm_order)
    batch, lengths = parallel_serving_signals(segments, seed)
    feats, masks = rec.am.mfcc.features_fast(torch.as_tensor(batch, device=dev),
                                             lengths=torch.as_tensor(lengths, device=dev))
    return ParallelServing(rec, feats, masks)


def _dryrun_rank(seed: int = 0) -> Dict[str, object]:
    """One rank of :func:`dryrun_multichip`."""
    import types

    import torch.distributed as dist

    from lnasr_tpu_torch import parallel as P
    from lnasr_tpu_torch.config import MeshConfig
    from lnasr_tpu_torch.convert import units_from_numpy
    from lnasr_tpu_torch.models.decoder import FactoredDecodingGraph
    from lnasr_tpu_torch.parallel.distributed import local_device

    n = dist.get_world_size()
    dev = local_device()
    rng = np.random.default_rng(seed)
    gen = torch.Generator().manual_seed(seed)
    out: Dict[str, object] = {"backend": dist.get_backend(), "device": str(dev)}

    def finite(name, values):
        values = np.asarray(values, np.float64)
        if not np.isfinite(values).all():
            raise RuntimeError(f"{name} is not finite: {values}")
        out[name] = values.tolist()

    # data-parallel EM over the whole ('data', 'seq', 'model') mesh
    cfg = GMMHMMConfig(n_states=3, n_mix=2, dim=8)
    obs = rng.normal(size=(n * 2, 16, 8)).astype(np.float32)
    mask = np.ones((n * 2, 16), bool)
    model = GMMHMM(cfg, device=dev).init_from_data(obs.reshape(-1, 8), gen)
    finite("dp_em", P.train_data_parallel(model, obs, mask, P.make_mesh(), iters=1))
    even = n % 2 == 0 and n > 1
    if even:  # model-parallel EM: the mixture axis over 'model'
        mp = GMMHMM(cfg, device=dev).init_from_data(obs.reshape(-1, 8), gen)
        finite("mp_em", P.train_model_parallel(mp, obs, mask,
                                               P.make_mesh(MeshConfig(n // 2, 1, 2)), iters=1))
        # sequence-parallel forward and EM over a ('data', 'seq') mesh
        sp_mesh = P.make_mesh(P.mesh_shape_for(n, data=n // 2, seq=2))
        k = cfg.n_states
        log_a = torch.as_tensor(np.log(rng.dirichlet(np.ones(k), size=k)), dtype=torch.float32,
                                device=dev)
        log_pi = torch.as_tensor(np.log(rng.dirichlet(np.ones(k))), dtype=torch.float32,
                                 device=dev)
        log_b = torch.as_tensor(rng.normal(size=(16, k)), dtype=torch.float32, device=dev)
        finite("seq_forward", [float(P.forward_seq_parallel(log_pi, log_a, log_b, sp_mesh)[1])])
        long_obs = rng.normal(size=(19, cfg.dim)).astype(np.float32)  # not divisible by 2
        sp = GMMHMM(cfg, device=dev).init_from_data(long_obs, gen)
        finite("seq_em", P.train_seq_parallel(sp, long_obs, sp_mesh, iters=1))

    # the sharded batch decode over ('data',), dense and backoff hops
    d_cfg = GMMHMMConfig(n_states=2, n_mix=1, dim=4)
    with np.errstate(divide="ignore"):
        d_a = np.log(np.eye(2) * 0.5 + np.eye(2, k=1) * 0.5)
    units = units_from_numpy({f"w{i}": types.SimpleNamespace(
        config=d_cfg, log_a=d_a, log_pi=np.log([0.5, 0.5]), log_w=np.zeros((2, 1)),
        mu=rng.normal(size=(2, 1, 4)), cov=np.ones((2, 1, 4))) for i in range(3)}, device=dev)
    feats = rng.normal(size=(n, 9, 4)).astype(np.float32)
    d_mesh = P.make_mesh(P.mesh_shape_for(n, data=n))
    words = []
    for hop_mode in ("dense", "backoff"):
        graph = FactoredDecodingGraph.build(Lexicon.whole_word(sorted(units)), units, None,
                                            DecoderConfig(loop=True), hop_mode=hop_mode,
                                            device=dev)
        res = P.decode_batch_sharded(graph, feats, np.ones((n, 9), bool), d_mesh)
        finite(f"decode_{hop_mode}", [s for _, _, s in res])
        words.append([w for w, _, _ in res])
    if words[0] != words[1]:
        raise RuntimeError(f"the backoff hop decoded {words[1]}, the dense hop {words[0]}")

    # streaming pipelines over ('stage',): 2 stages, and a deep decode
    if n >= 2:
        k, m, d = cfg.n_states, cfg.n_mix, cfg.dim
        arrays = (np.log(rng.dirichlet(np.ones(k))), np.log(rng.dirichlet(np.ones(k), size=k)),
                  np.log(rng.dirichlet(np.ones(m), size=k)), rng.normal(size=(k, m, d)),
                  rng.uniform(0.5, 2.0, size=(k, m, d)), rng.normal(size=(32, d)))
        args = [torch.as_tensor(x, dtype=torch.float32, device=dev) for x in arrays]
        finite("pipeline_scores", [float(P.streaming_pipeline_scores(
            *args, P.make_stage_mesh(n_stages=2), chunk=8))])
        path, score = P.streaming_pipeline_decode(*args, P.make_stage_mesh(n_stages=min(n, 4)),
                                                  chunk=8)
        if path.shape != (32,):
            raise RuntimeError(f"pipeline path of shape {tuple(path.shape)}")
        finite("pipeline_decode", [float(score)])
    return out


def dryrun_multichip(n_ranks: int, device="cuda") -> List[Dict[str, object]]:
    """Spawn a world of ``n_ranks`` on ``device`` (NCCL when each rank has
    a card of its own, else gloo) and run the multi-rank paths once at tiny
    shapes on every rank, the counterpart of the JAX package's
    ``__graft_entry__.py:dryrun_multichip``: data-parallel EM, and with an
    even world mixture-sharded EM, the sequence-parallel forward and EM
    (T not divisible by the axis), the sharded decode on dense and backoff
    hops (the same words), the 2-stage pipeline's scores and the deep
    pipeline's decode. Raises on a non-finite result or a failed rank;
    returns each rank's summary (backend, device, results)."""
    from lnasr_tpu_torch.parallel.distributed import run_ranks

    return run_ranks(_dryrun_rank, n_ranks, device=device)
