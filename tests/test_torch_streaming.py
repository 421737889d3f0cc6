"""The port's StreamingRecognizer against the JAX package's on the same
weights and the same audio.

A tiny whole-word inventory (three tone-burst words and a ``<sil>``
unit) is trained on the JAX side and carried into the port with
``convert.units_from_numpy``, as in ``test_torch_recognizer.py``. Both
streams use their package's native detector, built from the same C++
sources, so segment boundaries must be equal; words must be equal and
scores within 1e-4 relative (the packages' MFCCs differ by up to 0.01).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lnasr_tpu.config import GMMHMMConfig as JGMMHMMConfig
from lnasr_tpu.config import MFCCConfig as JMFCCConfig
from lnasr_tpu.models.decoder import DecoderConfig as JDecoderConfig
from lnasr_tpu.models.gmmhmm import GMMHMM as JGMMHMM
from lnasr_tpu.models.lexicon import Lexicon as JLexicon
from lnasr_tpu.models.ngram import NGramCounter as JNGramCounter
from lnasr_tpu.models.ngram import NGramModel as JNGramModel
from lnasr_tpu.models.recognizer import AcousticModel as JAcousticModel
from lnasr_tpu.models.recognizer import LanguageModel as JLanguageModel
from lnasr_tpu.models.recognizer import Recognizer as JRecognizer
from lnasr_tpu.models.recognizer import StreamingRecognizer as JStreamingRecognizer
from lnasr_tpu.models.recognizer import StreamingStats as JStreamingStats
from lnasr_tpu.vad.native import AmrWbVad as JAmrWbVad
from lnasr_tpu.vad.native import WebRtcVad as JWebRtcVad
from lnasr_tpu_torch.config import MFCCConfig
from lnasr_tpu_torch.convert import units_from_numpy
from lnasr_tpu_torch.models.decoder import DecoderConfig
from lnasr_tpu_torch.models.lexicon import Lexicon
from lnasr_tpu_torch.models.ngram import NGramCounter, NGramModel
from lnasr_tpu_torch.models.recognizer import (
    AcousticModel,
    LanguageModel,
    Recognizer,
    StreamingRecognizer,
    StreamingStats,
)
from lnasr_tpu_torch.vad import AmrWbVad, WebRtcVad

SR = 16000
WORD_F0 = {"low": 220.0, "mid": 560.0, "high": 1400.0}
CORPUS = ["low mid high", "high mid low", "low high", "mid mid low"]
DEC = dict(lm_scale=0.5, word_insertion_penalty=-1.0)
CHUNK = 1234


def _word_audio(word, rng, dur=0.35):
    n = int(SR * dur)
    t = np.arange(n) / SR
    f0 = WORD_F0[word] * (1.0 + 0.01 * rng.normal())
    sig = sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 2 * np.pi)) / k for k in range(1, 4))
    x = (sig * np.hanning(n) * 0.3 + rng.normal(0, 0.01, n)) * 12000
    return np.clip(x, -32768, 32767).astype(np.int16)


def _gap(rng, dur):
    return rng.normal(0, 60.0, int(SR * dur)).astype(np.int16)


def _stream(seed):
    """Utterances of one to three words between 0.6 s gaps."""
    rng = np.random.default_rng(seed)
    parts = [_gap(rng, 0.5)]
    for words in (["low", "mid"], ["high"], ["mid", "low", "high"], ["low"], ["high", "mid"]):
        for w in words:
            parts += [_word_audio(w, rng), _gap(rng, 0.08)]
        parts.append(_gap(rng, 0.6))
    return np.concatenate(parts)


@pytest.fixture(scope="module")
def recognizers():
    """``(jax recognizer, port recognizer)`` on the same units, bucketed."""
    rng = np.random.default_rng(0)
    j_am = JAcousticModel(mfcc_config=JMFCCConfig(energy_floor=1e-10, mean_norm=False),
                          dtype=jnp.float32)
    cfg = JGMMHMMConfig(n_states=3, n_mix=2, dim=39)
    examples = {w: [_word_audio(w, rng) for _ in range(3)] for w in WORD_F0}
    examples["<sil>"] = [_gap(rng, 0.4) for _ in range(3)]
    for k, (name, audios) in enumerate(examples.items()):
        feats = np.concatenate([np.asarray(j_am.mfcc(a).features) for a in audios])
        j_am.units[name] = JGMMHMM(cfg, dtype=jnp.float32).init_left_to_right(
            feats, jax.random.PRNGKey(k))
    t_am = AcousticModel(units_from_numpy(j_am.units, device="cpu"),
                         MFCCConfig(energy_floor=1e-10, mean_norm=False), device="cpu")
    tokens = [tuple(["<s>"] + s.split() + ["</s>"]) for s in CORPUS]
    j = JRecognizer(j_am, JLexicon.whole_word(list(WORD_F0)),
                    JLanguageModel(JNGramModel(JNGramCounter(2, tokens))),
                    decoder_config=JDecoderConfig(**DEC), bucket_frames=64)
    t = Recognizer(t_am, Lexicon.whole_word(list(WORD_F0)),
                   LanguageModel(NGramModel(NGramCounter(2, tokens))),
                   decoder_config=DecoderConfig(**DEC), bucket_frames=64)
    return j, t


def _feed(stream, audio, chunk=CHUNK):
    """Segments and the buffer size after every chunk, then the flush."""
    out, buffers = [], []
    for i in range(0, len(audio), chunk):
        out += stream.process(audio[i: i + chunk])
        buffers.append(stream.stats.buffer_samples)
    return out + stream.flush(), buffers


def _assert_same(ours, ref):
    assert [(s.start_s, s.end_s) for s in ours] == [(s.start_s, s.end_s) for s in ref]
    assert [s.words for s in ours] == [s.words for s in ref]
    for a, b in zip(ours, ref):
        assert a.score == pytest.approx(b.score, rel=1e-4)


def test_stream_matches_jax(recognizers):
    """Fed in 1234-sample chunks, both streams close the same segments
    with the same words, keep the same buffer after every chunk, and
    count the same audio and segments; a reset replay repeats them."""
    j, t = recognizers
    audio = _stream(1)
    js, ts = JStreamingRecognizer(j), StreamingRecognizer(t)
    assert isinstance(ts.vad, WebRtcVad) and isinstance(js.vad, JWebRtcVad)
    ref, ref_buf = _feed(js, audio)
    ours, buf = _feed(ts, audio)
    assert len(ours) >= 4 and any(s.words for s in ours)
    _assert_same(ours, ref)
    assert buf == ref_buf
    assert ts.stats.segments == js.stats.segments == len(ours)
    assert ts.stats.audio_seconds == pytest.approx(js.stats.audio_seconds, rel=1e-12)
    assert ts.stats.audio_seconds == pytest.approx(len(audio) / SR, rel=1e-12)
    assert 0 < ts.stats.last_latency_s <= ts.stats.decode_seconds
    assert ts.stats.rtf == ts.stats.decode_seconds / ts.stats.audio_seconds
    ts.reset()
    assert ts.stats == StreamingStats() and ts.stats.buffer_samples == 0
    again, buf2 = _feed(ts, audio, chunk=4000)
    _assert_same(again, ours)


def test_stream_with_tuple_detector_matches_jax(recognizers):
    """An AMR-WB detector returns ``(flags, power)`` and frames of 256
    samples: both streams unpack it alike."""
    j, t = recognizers
    audio = _stream(2)[: SR * 3]
    ref, _ = _feed(JStreamingRecognizer(j, vad=JAmrWbVad()), audio)
    ours, _ = _feed(StreamingRecognizer(t, vad=AmrWbVad()), audio)
    assert len(ours) >= 1
    _assert_same(ours, ref)


def test_stream_buffer_stays_bounded(recognizers):
    """Three simulated minutes: the retained buffer stays within the
    longest open segment and its pads, not the audio fed."""
    _, t = recognizers
    ts = StreamingRecognizer(t)
    one = _stream(3)
    n_segments, peak = 0, 0
    for _ in range(int(180 * SR / len(one)) + 1):
        segs, buf = _feed(ts, one, chunk=8000)
        n_segments += len(segs)
        peak = max(peak, max(buf))
    assert ts.stats.audio_seconds >= 180.0
    assert n_segments == ts.stats.segments and n_segments > 30
    assert peak < 3 * SR
    assert ts.stats.buffer_samples < 3 * SR


def test_stats_as_jax():
    ours, ref = StreamingStats(), JStreamingStats()
    assert [f for f in vars(ours)] == [f for f in vars(ref)]
    assert ours.rtf == ref.rtf == 0.0
    for s in (ours, ref):
        s.audio_seconds, s.decode_seconds = 10.0, 2.5
    assert ours.rtf == ref.rtf == 0.25


def test_stream_rejects_rate_mismatch(recognizers):
    with pytest.raises(ValueError, match="sample rate"):
        StreamingRecognizer(recognizers[1], vad=WebRtcVad(sample_rate=8000))


def test_recognize_segments_with_native_vad_matches_jax(recognizers):
    j, t = recognizers
    audio = _stream(4)
    j.vad, t.vad = JWebRtcVad(mode=1), WebRtcVad(mode=1)
    try:
        ref = j.recognize_segments(audio, word_times=True)
        ours = t.recognize_segments(audio, word_times=True)
    finally:
        j.vad = t.vad = None
    assert len(ours) >= 2 and any(s.words for s in ours)
    _assert_same(ours, ref)
    for a, b in zip(ours, ref):
        assert [w for w, _, _ in a.word_times] == [w for w, _, _ in b.word_times]
