"""The recognizer: VAD -> MFCC -> composed lexicon+LM Viterbi -> text.

The port of the JAX package's ``models/recognizer.py``. Per segment: MFCC
features (the fused mel frontend kernel on CUDA), GMM emissions, and one
Viterbi over the composed word graph
(:mod:`lnasr_tpu_torch.models.decoder`: the dense-graph kernel, the
factored forward and backtrace kernels on CUDA, or the trigram graph's
frame loop of torch ops). N-best decoding records a word lattice instead
(kernel F on CUDA) and searches it on the host
(:mod:`lnasr_tpu_torch.models.lattice`). With ``bucket_frames`` a segment
is padded onto a bucket grid and decoded with a frame mask: one
host->device copy of the samples in, one device->host copy of
``(path, score)`` or of the lattice records out.

:class:`StreamingRecognizer` serves a live stream: chunks of audio in, a
VAD (the native WebRTC-style detector by default) closing segments, each
closed segment decoded as above.

:func:`train_unit_models` trains the acoustic model's units: isolated-unit
Baum-Welch, each unit left-to-right initialized from its own examples.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from lnasr_tpu_torch._device import resolve_device
from lnasr_tpu_torch.config import GMMHMMConfig, MFCCConfig
from lnasr_tpu_torch.models.decoder import (
    SILENCE,
    DecoderConfig,
    DecodingGraph,
    FactoredDecodingGraph,
    TrigramDecodingGraph,
    records_to_host,
    to_host,
)
from lnasr_tpu_torch.models.gmmhmm import GMMHMM, resolve_var_floor
from lnasr_tpu_torch.models.lattice import Hypothesis
from lnasr_tpu_torch.models.lexicon import Lexicon
from lnasr_tpu_torch.models.mfcc import MFCC
from lnasr_tpu_torch.models.ngram import NGramModel, NGramModelARPA
from lnasr_tpu_torch.ops.framing import num_frames


class AcousticModel:
    """MFCC frontend + per-unit GMM-HMMs on one device (CUDA by default).
    ``load``/``save`` use one HDF5 file per unit in a directory, in the
    format of both packages' ``GMMHMM.save``."""

    def __init__(self, unit_models: Optional[Mapping] = None,
                 mfcc_config: MFCCConfig = MFCCConfig(), dtype=torch.float32, device="cuda"):
        self.device = resolve_device(device)
        self.mfcc = MFCC(mfcc_config, dtype=dtype, device=self.device)
        self.units: Dict[str, object] = dict(unit_models or {})
        self.dtype = dtype

    @classmethod
    def load(cls, directory: str, config: GMMHMMConfig, mfcc_config: MFCCConfig = MFCCConfig(),
             dtype=torch.float32, device="cuda") -> "AcousticModel":
        units = {}
        for name in sorted(os.listdir(directory)):
            if name.endswith(".hdf5"):
                units[name[: -len(".hdf5")]] = GMMHMM(config, dtype=dtype, device=device).load(
                    os.path.join(directory, name))
        return cls(units, mfcc_config, dtype, device)

    def save(self, directory: str) -> None:
        os.makedirs(directory, exist_ok=True)
        for unit, model in self.units.items():
            model.save(os.path.join(directory, f"{unit}.hdf5"))

    def features(self, audio) -> torch.Tensor:
        """Serving-path features ``(T, D)`` of one utterance, on the device
        (the fused mel frontend kernel on CUDA, the plain pipeline on the
        CPU)."""
        feats, _ = self.mfcc.features_fast(np.asarray(audio))
        return feats

    def features_batch(self, signals, lengths=None):
        """Batched serving-path features: ``(B, S)`` -> ``((B, T, D), mask)``."""
        return self.mfcc.features_fast(signals, lengths)


class LanguageModel:
    """n-gram LM wrapper, built from an :class:`NGramModel` or an ARPA file."""

    def __init__(self, source):
        if isinstance(source, NGramModel):
            self.ngram = source
        else:
            self.ngram = NGramModel(NGramModelARPA().load(source))


def segment_speech(flags: np.ndarray, frame_len: int, min_gap_frames: int = 10,
                   min_len_frames: int = 5, pad_frames: int = 2) -> List[Tuple[int, int]]:
    """Per-frame VAD flags -> sample-range speech segments: close gaps
    shorter than ``min_gap_frames``, drop bursts shorter than
    ``min_len_frames``, pad the edges."""
    speech = np.asarray(flags) > 0
    if not speech.any():
        return []
    edges = np.flatnonzero(np.diff(np.concatenate([[0], speech.astype(int), [0]])))
    runs = list(zip(edges[::2], edges[1::2]))
    merged: List[List[int]] = []
    for a, b in runs:
        if merged and a - merged[-1][1] < min_gap_frames:
            merged[-1][1] = b
        else:
            merged.append([a, b])
    out = []
    n = len(speech)
    for a, b in merged:
        if b - a < min_len_frames:
            continue
        a = max(0, a - pad_frames)
        b = min(n, b + pad_frames)
        out.append((a * frame_len, b * frame_len))
    return out


@dataclasses.dataclass
class SegmentResult:
    start_s: float
    end_s: float
    words: List[str]
    score: float
    # optional word-level alignment: (word, start_s, end_s) in ABSOLUTE
    # stream seconds (see Recognizer.recognize_segments)
    word_times: Optional[List[Tuple[str, float, float]]] = None


class Recognizer:
    """Composable recognizer: acoustic model, lexicon, optional LM and VAD.
    Runs on the acoustic model's device."""

    # above this many composed states the dense (n_states)^2 matrix loses
    # to the factored (V, S) grid in both memory and per-frame work
    DENSE_STATE_LIMIT = 256

    def __init__(self, am: AcousticModel, lexicon: Lexicon, lm: Optional[LanguageModel] = None,
                 vad=None, decoder_config: DecoderConfig = DecoderConfig(), graph: str = "auto",
                 bucket_frames: int = 0, hop_mode: str = "auto"):
        """``bucket_frames`` > 0 pads each segment so its feature count lands
        on a multiple of the bucket and decodes with a frame mask (requires
        ``mean_norm=False`` MFCC; results equal the unbucketed decode).
        ``graph``: ``"dense"``, ``"factored"``, ``"trigram"`` (exact
        trigram LM by history expansion; needs an LM), or ``"auto"``
        (factored once the composed state count exceeds
        :data:`DENSE_STATE_LIMIT`; an explicit ``hop_mode`` pins it to
        factored). ``hop_mode`` (factored
        only): ``"dense"``, ``"backoff"``, ``"rank1"`` or ``"auto"``.
        ``vad`` is any object with ``process(audio) -> per-frame flags``,
        ``FRAME_LEN`` and ``reset()``."""
        self.am = am
        self.device = am.device
        self.lexicon = lexicon
        self.lm = lm
        self.vad = vad
        self.decoder_config = decoder_config
        self.sample_rate = am.mfcc.config.sample_rate
        vad_rate = getattr(vad, "sample_rate", None)
        if vad_rate is not None and vad_rate != self.sample_rate:
            raise ValueError(
                f"VAD sample rate {vad_rate} != acoustic model rate {self.sample_rate}; "
                f"construct the detector with sample_rate={self.sample_rate}")
        self.bucket_frames = int(bucket_frames)
        if self.bucket_frames and am.mfcc.config.mean_norm:
            raise ValueError(
                "bucket_frames requires an MFCC config with mean_norm=False "
                "(padded frames would shift per-utterance normalization)")
        # a unit named "<sil>" becomes the decoder's background model
        silence = am.units.get(SILENCE)
        if graph == "auto":
            n_states = sum(am.units[u].n for w in lexicon for u in lexicon[w]) + (
                silence.n if silence is not None else 0)
            if hop_mode != "auto":
                graph = "factored"
            else:
                graph = "dense" if n_states <= self.DENSE_STATE_LIMIT else "factored"
        if graph != "factored" and hop_mode != "auto":
            raise ValueError(
                f'hop_mode={hop_mode!r} only applies to graph="factored" (got '
                f"graph={graph!r}); the dense and trigram graphs have no word-hop "
                "realization choice")
        if graph == "trigram":
            if lm is None:
                raise ValueError('graph="trigram" requires a language model')
            self.graph = TrigramDecodingGraph.build(lexicon, am.units, lm.ngram, decoder_config,
                                                    silence_model=silence, dtype=am.dtype,
                                                    device=self.device)
        elif graph in ("dense", "factored"):
            graph_cls = DecodingGraph if graph == "dense" else FactoredDecodingGraph
            kw = {"hop_mode": hop_mode} if graph == "factored" else {}
            self.graph = graph_cls.build(lexicon, am.units,
                                         lm.ngram if lm is not None else None, decoder_config,
                                         silence_model=silence, dtype=am.dtype,
                                         device=self.device, **kw)
        else:
            raise ValueError(f"unknown graph type: {graph!r}")

    def _segments(self, audio: np.ndarray) -> List[Tuple[int, int]]:
        if self.vad is None:
            return [(0, len(audio))]
        # streaming detectors carry state across calls; a fresh utterance
        # must not depend on the previous one
        if hasattr(self.vad, "reset"):
            self.vad.reset()
        flags = self.vad.process(audio)
        return segment_speech(flags, getattr(self.vad, "FRAME_LEN", 160))

    def recognize_segments(self, audio, word_times: bool = False) -> List[SegmentResult]:
        """VAD-segment and decode ``audio``. With ``word_times`` each result
        also carries per-word ``(word, start_s, end_s)`` in absolute stream
        seconds."""
        audio = np.asarray(audio)
        results = []
        sr = float(self.sample_rate)
        for a, b in self._segments(audio):
            if word_times:
                words, score, times = self.decode_segment_aligned(audio[a:b])
                times = [(w, a / sr + t0, a / sr + t1) for w, t0, t1 in times]
            else:
                words, score = self.decode_segment(audio[a:b])
                times = None
            results.append(SegmentResult(start_s=a / sr, end_s=b / sr, words=words,
                                         score=score, word_times=times))
        return results

    def decode_segment_aligned(self, audio_seg):
        """Decode one segment: ``(words, score, word_times)`` with per-word
        ``(word, start_s, end_s)`` relative to the segment."""
        if self.bucket_frames:
            path, score, n_valid = self._decode_segment_padded(audio_seg)
            words = self.graph._path_to_words(path)
        else:
            feats, mask = self._segment_features(audio_seg)
            words, path, score = self.graph.decode(feats, mask)
            n_valid = len(path)
        align = self.graph.path_to_alignment(np.asarray(path), n_frames=n_valid)
        cfg = self.am.mfcc.config
        sr = float(self.sample_rate)
        seg_s = len(np.asarray(audio_seg)) / sr
        times = [(w, a * cfg.frame_step / sr,
                  min(seg_s, (b * cfg.frame_step + cfg.frame_len) / sr))
                 for w, a, b in align]
        return words, score, times

    def _pad_to_bucket(self, audio_seg, dtype=np.float32):
        """Zero-pad a segment onto the bucket grid: ``(padded, n_samples,
        n_valid_frames)``."""
        cfg = self.am.mfcc.config
        audio_seg = np.asarray(audio_seg)
        bucket_samples = self.bucket_frames * cfg.frame_step
        n = len(audio_seg)
        n_pad = max(bucket_samples, -(-n // bucket_samples) * bucket_samples)
        padded = np.zeros(n_pad, dtype=dtype)
        padded[:n] = audio_seg
        return padded, n, num_frames(n, cfg.frame_len, cfg.frame_step)

    def _segment_features(self, audio_seg):
        """Features (+ validity mask when shape-bucketed) for one segment."""
        audio_seg = np.asarray(audio_seg)
        if not self.bucket_frames:
            return self.am.features(audio_seg), None
        padded, n, n_valid = self._pad_to_bucket(audio_seg, dtype=audio_seg.dtype)
        feats = self.am.features(padded)
        return feats, torch.arange(feats.shape[0], device=self.device) < n_valid

    def _segment_arrays(self, padded: torch.Tensor, length: torch.Tensor):
        """The bucketed segment decode on the device: padded samples and the
        real sample count in, ``(path, score)`` tensors out: MFCC (fused
        frontend kernel on CUDA) with the length mask, then the graph's
        decode, with no host round trip in between."""
        feats, mask = self.am.mfcc.features_fast(padded, lengths=length)
        return self.graph.decode_arrays(feats, mask)

    def _upload_bucket(self, audio_seg):
        """The bucket-padded segment on the device: ``(samples, length,
        n_valid_frames)``, the samples in one host->device copy."""
        padded, n, n_valid = self._pad_to_bucket(audio_seg)
        sig = torch.from_numpy(padded).to(self.device)
        return sig, torch.tensor([n], device=self.device), n_valid

    def _decode_segment_padded(self, audio_seg):
        """Bucket-padded decode: ``(path, score, n_valid)``. The samples go
        to the device in one copy and ``(path, score)`` come back in one."""
        sig, length, n_valid = self._upload_bucket(audio_seg)
        path, score = to_host(*self._segment_arrays(sig, length))
        return path, float(score), n_valid

    def _segment_records(self, audio_seg):
        """Bucketed lattice records of one segment as NumPy ``(n_valid, V)``
        arrays ``(exit_score, exit_start, exit_pred)``: the MFCC (fused
        frontend kernel on CUDA) and the records (kernel F) run on the
        device with no host round trip, and the records come back in one
        device->host copy."""
        self.graph._require_loop()
        sig, length, n_valid = self._upload_bucket(audio_seg)
        feats, mask = self.am.mfcc.features_fast(sig, lengths=length)
        recs = self.graph.lattice_records_arrays(feats, mask)
        return records_to_host(*(r[:n_valid] for r in recs))

    def _segment_lattice(self, audio_seg, beam: float):
        """Word lattice of one segment: :meth:`_segment_records` when
        bucketed, the two-step path (:meth:`FactoredDecodingGraph.
        decode_lattice`) otherwise."""
        if not self.bucket_frames:
            feats, mask = self._segment_features(audio_seg)
            return self.graph.decode_lattice(feats, mask, beam=beam)
        return self.graph.lattice_from_records(*self._segment_records(audio_seg), beam=beam)

    def decode_segment(self, audio_seg) -> Tuple[List[str], float]:
        """Features + composed-graph decode of one speech segment."""
        if self.bucket_frames:
            path, score, _ = self._decode_segment_padded(audio_seg)
            return self.graph._path_to_words(path), score
        feats, mask = self._segment_features(audio_seg)
        words, _, score = self.graph.decode(feats, mask)
        return words, score

    def decode_segment_nbest(self, audio_seg, n: int = 5, rescore_lm=None,
                             pool: Optional[int] = None, beam: float = 40.0,
                             with_confidence: bool = False) -> List[Hypothesis]:
        """N-best hypotheses for one speech segment via a word lattice;
        requires the ``"factored"`` graph. ``rescore_lm`` (an
        :class:`NGramModel` or :class:`LanguageModel`, usually of higher
        order than the decoding LM) re-ranks ``pool`` hypotheses (default
        ``4 * n``) with full-history scores; ``with_confidence`` adds each
        surface word's lattice-posterior confidence."""
        if not isinstance(self.graph, FactoredDecodingGraph):
            raise ValueError("N-best decoding needs the factored graph "
                             '(build the Recognizer with graph="factored")')
        lattice = self._segment_lattice(audio_seg, beam)
        if rescore_lm is None:
            hyps = lattice.nbest(n)
        else:
            cfg = self.decoder_config
            hyps = lattice.rescore(getattr(rescore_lm, "ngram", rescore_lm), n=n, pool=pool,
                                   lm_scale=cfg.lm_scale,
                                   word_insertion_penalty=cfg.word_insertion_penalty,
                                   exit_logp=cfg.exit_logp)
        if with_confidence:
            post = lattice.posteriors()
            for h in hyps:
                h.confidence = lattice.confidences(h, post)
        return hyps

    def recognize(self, audio) -> str:
        """Audio in, text out."""
        return " ".join(w for seg in self.recognize_segments(audio) for w in seg.words)

    def recognize_nbest(self, audio, n: int = 5, rescore_lm=None, pool: Optional[int] = None,
                        with_confidence: bool = False) -> List[List[Hypothesis]]:
        """Per-VAD-segment N-best lists (see :meth:`decode_segment_nbest`)."""
        audio = np.asarray(audio)
        return [self.decode_segment_nbest(audio[a:b], n, rescore_lm, pool,
                                          with_confidence=with_confidence)
                for a, b in self._segments(audio)]


@dataclasses.dataclass
class StreamingStats:
    """Observability for a live stream: totals since ``reset``."""

    audio_seconds: float = 0.0     # audio fed in
    segments: int = 0              # segments decoded
    decode_seconds: float = 0.0    # wall time spent in MFCC + Viterbi
    last_latency_s: float = 0.0    # decode wall time of the latest segment
    buffer_samples: int = 0        # current retained-buffer size

    @property
    def rtf(self) -> float:
        """Decode real-time factor (decode wall time / audio time); below 1
        the decoder keeps up with the stream."""
        return self.decode_seconds / max(self.audio_seconds, 1e-12)


class StreamingRecognizer:
    """Incremental recognition: feed audio chunks of any size; speech
    segments are decoded and returned as they close.

    The host-side streaming VAD (the native
    :class:`~lnasr_tpu_torch.vad.native.WebRtcVad` by default) classifies
    every whole 10 ms frame of a chunk in one call; a segment closes after
    ``min_gap_frames`` of silence, its samples are cut with ``pad_frames``
    margins, and :meth:`Recognizer.decode_segment` decodes it (on CUDA:
    one copy of the samples in, one of ``(path, score)`` out).
    :meth:`flush` closes an open segment at the end of the stream.

    Memory is bounded: audio no future segment can use (decoded, or
    silence beyond the ``pad_frames`` look-back) is dropped, so the buffer
    holds O(longest open segment) over an unbounded stream. Per-segment
    decode latency and the stream's real-time factor are kept in
    :attr:`stats`.
    """

    def __init__(self, recognizer: Recognizer, vad=None, min_gap_frames: int = 10,
                 min_len_frames: int = 5, pad_frames: int = 2):
        from lnasr_tpu_torch.vad.native import WebRtcVad

        self.rec = recognizer
        self.sample_rate = recognizer.sample_rate
        self.vad = vad if vad is not None else WebRtcVad(mode=0, sample_rate=self.sample_rate)
        vad_rate = getattr(self.vad, "sample_rate", None)
        if vad_rate is not None and vad_rate != self.sample_rate:
            raise ValueError(f"VAD sample rate {vad_rate} != recognizer rate {self.sample_rate}")
        self.frame_len = getattr(self.vad, "FRAME_LEN", 160)
        self.min_gap = min_gap_frames
        self.min_len = min_len_frames
        self.pad = pad_frames
        self.reset()

    def reset(self) -> None:
        if hasattr(self.vad, "reset"):
            self.vad.reset()
        # frame bookkeeping is in absolute frame indices; the buffer holds
        # the samples from frame self._base_f on
        self._buffer = np.zeros(0, np.int16)
        self._base_f = 0
        self._next_f = 0  # next frame to classify
        self._open_start: Optional[int] = None
        self._last_speech: Optional[int] = None
        self.stats = StreamingStats()

    def _cut_segment(self, start_f: int, end_f: int) -> Optional[SegmentResult]:
        if end_f - start_f < self.min_len:
            return None
        a_f = max(0, start_f - self.pad)
        a = (a_f - self._base_f) * self.frame_len
        b = min(len(self._buffer), (end_f + self.pad - self._base_f) * self.frame_len)
        t0 = time.perf_counter()
        words, score = self.rec.decode_segment(self._buffer[a:b])
        dt = time.perf_counter() - t0
        self.stats.segments += 1
        self.stats.decode_seconds += dt
        self.stats.last_latency_s = dt
        sr = float(self.sample_rate)
        return SegmentResult(start_s=a_f * self.frame_len / sr,
                             end_s=(self._base_f * self.frame_len + b) / sr,
                             words=words, score=score)

    def _trim(self) -> None:
        """Drop buffered audio no future segment can reference: everything
        before the open segment's padded start or, with no open segment,
        before the pad look-back behind the VAD cursor."""
        keep_f = (self._open_start if self._open_start is not None else self._next_f) - self.pad
        keep_f = max(self._base_f, keep_f)
        drop = (keep_f - self._base_f) * self.frame_len
        if drop > 0:
            self._buffer = self._buffer[drop:]
            self._base_f = keep_f
        self.stats.buffer_samples = len(self._buffer)

    def process(self, chunk) -> List[SegmentResult]:
        """Feed samples; returns the segments this chunk closed."""
        chunk = np.asarray(chunk, np.int16)
        self._buffer = np.concatenate([self._buffer, chunk])
        self.stats.audio_seconds += len(chunk) / float(self.sample_rate)
        total_f = self._base_f + len(self._buffer) // self.frame_len
        results: List[SegmentResult] = []
        if self._next_f < total_f:
            # classify every pending whole frame in one detector call
            off = (self._next_f - self._base_f) * self.frame_len
            n_pend = total_f - self._next_f
            out = self.vad.process(self._buffer[off: off + n_pend * self.frame_len])
            flags = out[0] if isinstance(out, tuple) else out  # AMR-WB: (flags, power)
            for i in range(n_pend):
                f = self._next_f + i
                if int(flags[i]) > 0:
                    if self._open_start is None:
                        self._open_start = f
                    self._last_speech = f
                elif (self._open_start is not None and self._last_speech is not None
                      and f - self._last_speech >= self.min_gap):
                    seg = self._cut_segment(self._open_start, self._last_speech + 1)
                    if seg is not None:
                        results.append(seg)
                    self._open_start = None
                    self._last_speech = None
            self._next_f = total_f
        self._trim()
        return results

    def flush(self) -> List[SegmentResult]:
        """End of stream: close and decode any open segment."""
        results = []
        if self._open_start is not None and self._last_speech is not None:
            seg = self._cut_segment(self._open_start, self._last_speech + 1)
            if seg is not None:
                results.append(seg)
        self._open_start = None
        self._last_speech = None
        self._trim()
        return results


def train_unit_models(
    examples: Mapping[str, Sequence[np.ndarray]],
    config: GMMHMMConfig,
    iters: int = 10,
    seed: int = 0,
    dtype=torch.float32,
    verbose: bool = False,
    train_config=None,
    unit_configs: Optional[Mapping[str, GMMHMMConfig]] = None,
    pad_to: Optional[int] = None,
    device="cuda",
) -> Dict[str, GMMHMM]:
    """Isolated-unit training: for each unit (in sorted order, the i-th
    seeded with ``seed + i``), a left-to-right init from its examples and
    batched Baum-Welch over all of them, padded to the longest with masks.

    - The diagonal variance floor is resolved once from the pooled frames
      of every unit (``var_floor_scale`` x per-dim variance, never below
      ``var_floor``), so all units share one floor.
    - ``unit_configs`` overrides the topology per unit, e.g. a few-state,
      many-mixture ``"<sil>"``.
    - ``pad_to`` pads every unit's batch to a common frame count (masks
      keep the padding out of the statistics).
    - ``train_config`` (a :class:`~lnasr_tpu_torch.config.TrainConfig`)
      enables checkpoints, each unit under ``checkpoint_dir/<unit>/``: a
      killed run restarts where it stopped with the same final
      parameters."""
    pooled = np.concatenate([np.asarray(o, np.float64) for obs in examples.values()
                             for o in obs], axis=0)
    dev = resolve_device(device)
    models: Dict[str, GMMHMM] = {}
    for i, (unit, obs_list) in enumerate(sorted(examples.items())):
        unit_config = resolve_var_floor((unit_configs or {}).get(unit, config), pooled)
        model = GMMHMM(unit_config, dtype=dtype, device=dev)
        all_frames = np.concatenate([np.asarray(o) for o in obs_list], axis=0)
        model.init_left_to_right(all_frames, torch.Generator().manual_seed(seed + i))
        t_max = max(o.shape[0] for o in obs_list)
        if pad_to is not None:
            if pad_to < t_max:
                raise ValueError(f"pad_to={pad_to} < longest example ({t_max} frames)")
            t_max = pad_to
        batch = np.zeros((len(obs_list), t_max, unit_config.dim), dtype=np.float64)
        mask = np.zeros((len(obs_list), t_max), dtype=bool)
        for j, o in enumerate(obs_list):
            batch[j, : o.shape[0]] = o
            mask[j, : o.shape[0]] = True
        unit_cfg = train_config
        if train_config is not None and train_config.checkpoint_dir:
            unit_cfg = dataclasses.replace(
                train_config, checkpoint_dir=os.path.join(train_config.checkpoint_dir, unit))
        history = model.train(batch, iters=iters, mask=mask, config=unit_cfg)
        if verbose:
            print(f"unit {unit!r}: loglik {history[0]:.1f} -> {history[-1]:.1f}")
        models[unit] = model
    return models
