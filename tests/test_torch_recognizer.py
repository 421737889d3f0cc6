"""The port's recognizer (1-best decode) against the JAX package's on the
same weights and the same audio.

The JAX side builds a tiny whole-word inventory (three tone-burst 'words'
and a ``<sil>`` unit, left-to-right initialized from their MFCCs) and a
bigram LM; the units are carried into the port with
``convert.units_from_numpy``. The two packages' MFCCs differ by up to
0.01 (fp32 reassociation in the DFT/mel/DCT chain), so the emissions
differ slightly: words must be equal, scores within 1e-4 relative, paths
equal on at least 99% of frames, and alignments of one path equal.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from lnasr_tpu.config import GMMHMMConfig as JGMMHMMConfig
from lnasr_tpu.config import MFCCConfig as JMFCCConfig
from lnasr_tpu.models.decoder import DecoderConfig as JDecoderConfig
from lnasr_tpu.models.decoder import FactoredDecodingGraph as JFactored
from lnasr_tpu.models.decoder import TrigramDecodingGraph as JTrigram
from lnasr_tpu.models.gmmhmm import GMMHMM as JGMMHMM
from lnasr_tpu.models.lexicon import Lexicon as JLexicon
from lnasr_tpu.models.ngram import NGramCounter as JNGramCounter
from lnasr_tpu.models.ngram import NGramModel as JNGramModel
from lnasr_tpu.models.recognizer import AcousticModel as JAcousticModel
from lnasr_tpu.models.recognizer import LanguageModel as JLanguageModel
from lnasr_tpu.models.recognizer import Recognizer as JRecognizer
from lnasr_tpu.models.recognizer import segment_speech as j_segment_speech
from lnasr_tpu_torch import entry
from lnasr_tpu_torch.config import GMMHMMConfig, MFCCConfig
from lnasr_tpu_torch.convert import units_from_numpy
from lnasr_tpu_torch.models.decoder import DecoderConfig, DecodingGraph, FactoredDecodingGraph
from lnasr_tpu_torch.models.decoder import TrigramDecodingGraph
from lnasr_tpu_torch.models.decoder import HopFactors
from lnasr_tpu_torch.models.lexicon import Lexicon
from lnasr_tpu_torch.models.ngram import NGramCounter, NGramModel, NGramModelARPA
from lnasr_tpu_torch.models.recognizer import (
    AcousticModel,
    LanguageModel,
    Recognizer,
    segment_speech,
)
from lnasr_tpu_torch.ops.factored import BackoffHop

SR = 16000
WORD_F0 = {"low": 220.0, "mid": 560.0, "high": 1400.0}
CORPUS = ["low mid high", "high mid low", "low high", "mid mid low"]
DEC = dict(lm_scale=0.5, word_insertion_penalty=-1.0)


def _word_audio(word, rng, dur=0.35):
    n = int(SR * dur)
    t = np.arange(n) / SR
    f0 = WORD_F0[word] * (1.0 + 0.01 * rng.normal())
    sig = sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 2 * np.pi)) / k for k in range(1, 4))
    x = (sig * np.hanning(n) * 0.3 + rng.normal(0, 0.01, n)) * 12000
    return np.clip(x, -32768, 32767).astype(np.int16)


def _gap(rng, dur):
    return rng.normal(0, 60.0, int(SR * dur)).astype(np.int16)


def _utterance(words, rng, gap=0.12):
    parts = [_gap(rng, gap)]
    for w in words:
        parts += [_word_audio(w, rng), _gap(rng, gap)]
    return np.concatenate(parts)


class _Vad:
    """A duck-typed detector: energy flags per 10 ms frame."""

    FRAME_LEN = 160
    sample_rate = SR

    def __init__(self):
        self.resets = 0

    def reset(self):
        self.resets += 1

    def process(self, audio):
        frames = np.asarray(audio, np.float64)[: len(audio) // 160 * 160].reshape(-1, 160)
        return (np.sqrt((frames ** 2).mean(axis=1)) > 500.0).astype(np.int32)


@pytest.fixture(scope="module")
def models():
    """``(jax acoustic model, port acoustic model, jax LM, port LM)`` with
    the same units."""
    rng = np.random.default_rng(0)
    j_am = JAcousticModel(mfcc_config=JMFCCConfig(energy_floor=1e-10, mean_norm=False),
                          dtype=jnp.float32)
    cfg = JGMMHMMConfig(n_states=3, n_mix=2, dim=39)
    examples = {w: [_word_audio(w, rng) for _ in range(3)] for w in WORD_F0}
    examples["<sil>"] = [_gap(rng, 0.4) for _ in range(3)]
    units = {}
    for k, (name, audios) in enumerate(examples.items()):
        feats = np.concatenate([np.asarray(j_am.mfcc(a).features) for a in audios])
        units[name] = JGMMHMM(cfg, dtype=jnp.float32).init_left_to_right(
            feats, jax.random.PRNGKey(k))
    j_am.units = units
    t_am = AcousticModel(units_from_numpy(units, device="cpu"),
                         MFCCConfig(energy_floor=1e-10, mean_norm=False), device="cpu")
    tokens = [tuple(["<s>"] + s.split() + ["</s>"]) for s in CORPUS]
    return (j_am, t_am, JLanguageModel(JNGramModel(JNGramCounter(2, tokens))),
            LanguageModel(NGramModel(NGramCounter(2, tokens))))


def _pair(models, **kw):
    j_am, t_am, j_lm, t_lm = models
    j = JRecognizer(j_am, JLexicon.whole_word(list(WORD_F0)), j_lm,
                    decoder_config=JDecoderConfig(**DEC), **kw)
    t = Recognizer(t_am, Lexicon.whole_word(list(WORD_F0)), t_lm,
                   decoder_config=DecoderConfig(**DEC), **kw)
    return j, t


def test_units_carried(models):
    j_am, t_am, _, _ = models
    assert set(t_am.units) == set(j_am.units)
    for name, unit in j_am.units.items():
        got = t_am.units[name]
        assert got.config.n_states == 3 and got.config.var_floor == unit.config.var_floor
        for a, b in zip(got.params, unit.params):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("loop", [True, False])
def test_dense_graph_build_matches_jax(models, loop):
    """The dense composed graph: the same arrays from both builders, with
    the silence word's own arc kept and the LM on the word hops."""
    j_am, t_am, j_lm, t_lm = models
    lex = list(WORD_F0)
    j = JRecognizer(j_am, JLexicon.whole_word(lex), j_lm, graph="dense",
                    decoder_config=JDecoderConfig(loop=loop, **DEC)).graph
    t = Recognizer(t_am, Lexicon.whole_word(lex), t_lm, graph="dense",
                   decoder_config=DecoderConfig(loop=loop, **DEC)).graph
    assert t.words == j.words and t.n_states == j.n_states == 12
    for name in ("log_a", "log_pi", "log_final", "log_w", "mu", "cov"):
        np.testing.assert_array_equal(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                      err_msg=name)
    for name in ("state_word", "word_start", "word_end"):
        np.testing.assert_array_equal(getattr(t, name), np.asarray(getattr(j, name)))


@pytest.mark.parametrize("graph", ["dense", "factored", "trigram"])
@pytest.mark.parametrize("bucket", [0, 64])
def test_decode_matches_jax(models, graph, bucket):
    j, t = _pair(models, graph=graph, bucket_frames=bucket)
    assert type(t.graph).__name__ == type(j.graph).__name__
    rng = np.random.default_rng(5)
    truth = ["low", "mid", "high", "mid", "low"]
    audio = _utterance(truth, rng)
    j_words, j_score, j_times = j.decode_segment_aligned(audio)
    words, score, times = t.decode_segment_aligned(audio)
    assert words == j_words and len(words) >= 4
    assert score == pytest.approx(j_score, rel=1e-4)
    assert [w for w, _, _ in times] == [w for w, _, _ in j_times]
    assert t.decode_segment(audio) == (words, score)
    assert t.recognize(audio) == j.recognize(audio) == " ".join(words)

    # paths on each package's own features; alignments of one path
    j_feats, t_feats = j.am.features(audio), t.am.features(audio)
    assert np.max(np.abs(t_feats.numpy() - j_feats)) < 0.01
    _, j_path, _ = j.graph.decode(j_feats)
    _, path, _ = t.graph.decode(t_feats)
    assert np.mean(path == np.asarray(j_path)) >= 0.99
    assert t.graph.path_to_alignment(path) == j.graph.path_to_alignment(path)
    n = len(path) - 3
    assert t.graph.path_to_alignment(path, n) == j.graph.path_to_alignment(path, n)


def test_vad_segments_match_jax(models):
    j, _ = _pair(models, vad=_Vad(), bucket_frames=64)
    _, t = _pair(models, vad=_Vad(), bucket_frames=64)
    rng = np.random.default_rng(8)
    audio = np.concatenate([_utterance(["high", "low"], rng), _gap(rng, 0.6),
                            _utterance(["mid"], rng)])
    j_segs = j.recognize_segments(audio, word_times=True)
    segs = t.recognize_segments(audio, word_times=True)
    assert t.vad.resets == 1 and len(segs) == len(j_segs) >= 1
    for s, js in zip(segs, j_segs):
        assert (s.start_s, s.end_s, s.words) == (js.start_s, js.end_s, js.words)
        assert s.score == pytest.approx(js.score, rel=1e-4)
        assert [w for w, _, _ in s.word_times] == [w for w, _, _ in js.word_times]
    flags = np.array([0, 0, 1, 1, 1, 0, 1, 1] + [0] * 12 + [1] * 6 + [0, 0])
    kw = dict(frame_len=160, min_gap_frames=3, min_len_frames=3, pad_frames=1)
    assert segment_speech(flags, **kw) == j_segment_speech(flags, **kw)
    assert segment_speech(np.zeros(5), 160) == []
    with pytest.raises(ValueError, match="sample rate"):
        vad = _Vad()
        vad.sample_rate = 8000
        Recognizer(models[1], Lexicon.whole_word(list(WORD_F0)), vad=vad)


def test_selection_rules_match_jax(models, monkeypatch):
    """``graph="auto"`` picks dense up to DENSE_STATE_LIMIT composed
    states and factored above; an explicit hop_mode pins it to factored
    and is refused on the dense graph."""
    for kw in (dict(), dict(hop_mode="backoff"), dict(hop_mode="rank1"),
               dict(graph="factored"), dict(graph="factored", hop_mode="dense")):
        j, t = _pair(models, **kw)
        assert type(t.graph).__name__ == type(j.graph).__name__, kw
        if isinstance(t.graph, FactoredDecodingGraph):
            assert isinstance(t.graph.hop, HopFactors) == (kw.get("hop_mode") in ("backoff",
                                                                                    "rank1"))
            assert t.graph.hop_rank1_only == j.graph.hop_rank1_only
            assert t.graph.hop_pruned_edges == j.graph.hop_pruned_edges
    monkeypatch.setattr(Recognizer, "DENSE_STATE_LIMIT", 11)
    monkeypatch.setattr(JRecognizer, "DENSE_STATE_LIMIT", 11)
    j, t = _pair(models)  # 3 words x 3 states + 3 silence states = 12 > 11
    assert isinstance(t.graph, FactoredDecodingGraph) and isinstance(j.graph, JFactored)
    with pytest.raises(ValueError, match="hop_mode"):
        _pair(models, graph="dense", hop_mode="backoff")
    with pytest.raises(ValueError, match="mean_norm"):
        Recognizer(AcousticModel(models[1].units, MFCCConfig(energy_floor=1e-10), device="cpu"),
                   Lexicon.whole_word(list(WORD_F0)), bucket_frames=64)
    j, t = _pair(models, graph="trigram")
    assert isinstance(t.graph, TrigramDecodingGraph) and isinstance(j.graph, JTrigram)
    assert t.graph.grid_shape == j.graph.grid_shape
    with pytest.raises(ValueError, match="requires a language model"):
        Recognizer(models[1], Lexicon.whole_word(list(WORD_F0)), graph="trigram")


def test_acoustic_model_save_load_across_packages(models, tmp_path):
    j_am, t_am, _, _ = models
    t_am.save(str(tmp_path / "port"))
    j_am.save(str(tmp_path / "jax"))
    cfg = dict(n_states=3, n_mix=2, dim=39)
    from_jax = AcousticModel.load(str(tmp_path / "jax"), GMMHMMConfig(**cfg), device="cpu")
    from_port = JAcousticModel.load(str(tmp_path / "port"), JGMMHMMConfig(**cfg),
                                    dtype=jnp.float32)
    assert set(from_jax.units) == set(from_port.units) == set(WORD_F0) | {"<sil>"}
    for name in WORD_F0:
        for a, b, c in zip(from_jax.units[name].params, from_port.units[name].params,
                           t_am.units[name].params):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            np.testing.assert_array_equal(a.numpy(), c.numpy())


def test_serving_geometry_matches_jax_recognizer(tmp_path):
    """``entry.recognizer_serving`` at V = 22 (179 composed states: the
    dense graph) on the CPU, against a JAX recognizer built from the same
    weights and the same LM (carried through an ARPA file): the bucketed
    segment decode gives the same words and score. V = 300 takes the
    factored graph with a dense hop."""
    rec, seg = entry.recognizer_serving(22, device="cpu")
    assert isinstance(rec.graph, DecodingGraph) and rec.graph.n_states == 179
    assert len(seg) == 81840 and rec.bucket_frames == 128
    padded, n, n_valid = rec._pad_to_bucket(seg)
    assert (len(padded), n, n_valid) == (81920, 81840, 510)

    units = {name: types.SimpleNamespace(
        n=u.n, config=JGMMHMMConfig(n_states=u.n, n_mix=u.m, dim=39),
        **{k: getattr(u, k).numpy() for k in ("log_a", "log_pi", "log_w", "mu", "cov")})
        for name, u in rec.am.units.items()}
    arpa = str(tmp_path / "lm.arpa")
    NGramModelARPA().save(rec.lm.ngram, arpa)
    j_rec = JRecognizer(
        JAcousticModel(units, JMFCCConfig(energy_floor=1e-10, mean_norm=False),
                       dtype=jnp.float32),
        JLexicon(dict(rec.lexicon)), JLanguageModel(arpa),
        decoder_config=JDecoderConfig(lm_scale=0.5, word_insertion_penalty=-4.0),
        bucket_frames=128)
    j_words, j_score = j_rec.decode_segment(seg)
    words, score = rec.decode_segment(seg)
    assert words == j_words
    assert score == pytest.approx(j_score, rel=1e-4)

    big, _ = entry.recognizer_serving(300, device="cpu")
    assert isinstance(big.graph, FactoredDecodingGraph)
    assert big.graph.grid_shape == (301, 8) and big.graph.hop.shape == (301, 301)


def _assert_nbest_close(got, ref, conf=False):
    """The same word lists in the same order; scores within 1e-4 relative
    (the packages' MFCCs differ by fp32 reassociation) and confidences
    within 1e-3."""
    assert [h.words for h in got] == [h.words for h in ref] and len(got) >= 1
    for a, b in zip(got, ref):
        assert a.score == pytest.approx(b.score, rel=1e-4)
        if conf:
            assert len(a.confidence) == len(a.words)
            np.testing.assert_allclose(a.confidence, b.confidence, atol=1e-3)
        else:
            assert a.confidence is None


@pytest.mark.parametrize("bucket", [0, 64])
def test_nbest_matches_jax(models, bucket):
    """``decode_segment_nbest`` through a word lattice: plain, with
    confidences, and rescored with a trigram LM, bucketed and not; the
    1-best equals the 1-best decode."""
    j, t = _pair(models, graph="factored", bucket_frames=bucket)
    rng = np.random.default_rng(11)
    truth = ["low", "mid", "high", "low"]
    audio = _utterance(truth, rng)
    hyps = t.decode_segment_nbest(audio, n=4)
    _assert_nbest_close(hyps, j.decode_segment_nbest(audio, n=4))
    words, score = t.decode_segment(audio)
    assert len(hyps) >= 2 and hyps[0].words == words and len(words) >= len(truth)
    assert hyps[0].score == pytest.approx(score, rel=1e-5)
    _assert_nbest_close(t.decode_segment_nbest(audio, n=3, with_confidence=True),
                        j.decode_segment_nbest(audio, n=3, with_confidence=True), conf=True)
    tokens = [tuple(["<s>"] + s.split() + ["</s>"]) for s in CORPUS]
    tri, j_tri = NGramModel(NGramCounter(3, tokens)), JNGramModel(JNGramCounter(3, tokens))
    got = t.decode_segment_nbest(audio, n=3, rescore_lm=LanguageModel(tri), pool=6)
    _assert_nbest_close(got, j.decode_segment_nbest(audio, n=3, rescore_lm=j_tri, pool=6))
    assert got == t.decode_segment_nbest(audio, n=3, rescore_lm=tri, pool=6)


def test_recognizer_backoff_matches_jax(models):
    """A small ``Recognizer`` with ``hop_mode="backoff"``: its graph takes
    the CSR hop (kernels on a card, their plain versions here) and its
    words and N-best lists equal the JAX recognizer's, which runs the
    jitted scans."""
    j, t = _pair(models, hop_mode="backoff", bucket_frames=64)
    assert isinstance(t.graph._kernel_hop, BackoffHop) and t.graph.has_kernel
    assert len(t.graph._kernel_hop.arc_src) > 0
    rng = np.random.default_rng(5)
    audio = _utterance(["low", "mid", "high", "mid", "low"], rng)
    j_words, j_score = j.decode_segment(audio)
    words, score = t.decode_segment(audio)
    assert words == j_words and len(words) >= 4
    assert score == pytest.approx(j_score, rel=1e-4)
    j_hyps = j.decode_segment_nbest(audio, n=4)
    hyps = t.decode_segment_nbest(audio, n=4)
    assert [h.words for h in hyps] == [h.words for h in j_hyps] and len(hyps) >= 2
    for a, b in zip(hyps, j_hyps):
        assert a.score == pytest.approx(b.score, rel=1e-4)
    assert hyps[0].words == words
    assert set(WORD_F0) >= {w for h in hyps for w in h.words}


def test_recognize_nbest_matches_jax(models):
    """Per-VAD-segment N-best lists, bucketed; the dense graph has no
    lattice and refuses N-best, as in the JAX package."""
    j, _ = _pair(models, graph="factored", vad=_Vad(), bucket_frames=64)
    _, t = _pair(models, graph="factored", vad=_Vad(), bucket_frames=64)
    rng = np.random.default_rng(12)
    audio = np.concatenate([_utterance(["high", "low"], rng), _gap(rng, 0.6),
                            _utterance(["mid"], rng)])
    lists = t.recognize_nbest(audio, n=3, with_confidence=True)
    j_lists = j.recognize_nbest(audio, n=3, with_confidence=True)
    assert t.vad.resets == 1 and len(lists) == len(j_lists) >= 1
    for got, ref in zip(lists, j_lists):
        _assert_nbest_close(got, ref, conf=True)
    assert [h.words for h in lists[0][:1]] == [t.recognize_segments(audio)[0].words]
    dense = _pair(models, graph="dense")[1]
    with pytest.raises(ValueError, match="factored graph"):
        dense.decode_segment_nbest(audio)
    with pytest.raises(ValueError, match="factored graph"):
        dense.recognize_nbest(audio)
