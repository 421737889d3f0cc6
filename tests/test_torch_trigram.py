"""The port's TrigramDecodingGraph against the JAX package's.

Both graphs are built at float64 from the same units (JAX ``GMMHMM`` s
carried into the port with ``convert.units_from_numpy``) and the same
ARPA file, read by each package's own parser. The decode is max-plus
with first-index argmaxes on both sides, so paths must be equal and
scores equal to ``rel=1e-12`` (each package computes its own emissions,
which may differ in the last bits).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lnasr_tpu.config import GMMHMMConfig as JGMMHMMConfig
from lnasr_tpu.models.decoder import DecoderConfig as JDecoderConfig
from lnasr_tpu.models.decoder import TrigramDecodingGraph as JTrigram
from lnasr_tpu.models.gmmhmm import GMMHMM as JGMMHMM
from lnasr_tpu.models.lexicon import Lexicon as JLexicon
from lnasr_tpu.models.ngram import NGramCounter as JNGramCounter
from lnasr_tpu.models.ngram import NGramModel as JNGramModel
from lnasr_tpu.models.ngram import NGramModelARPA as JNGramModelARPA
from lnasr_tpu.models.ngram import Tokenizer as JTokenizer
from lnasr_tpu_torch.convert import units_from_numpy
from lnasr_tpu_torch.models.decoder import (
    DecoderConfig,
    FactoredDecodingGraph,
    TrigramDecodingGraph,
)
from lnasr_tpu_torch.models.lexicon import Lexicon
from lnasr_tpu_torch.models.ngram import NGramCounter, NGramModel, NGramModelARPA

F64 = torch.float64


def _jax_unit(mean_shift, n_states=2, dim=3):
    """A left-to-right JAX unit whose states emit around distinct means."""
    m = JGMMHMM(JGMMHMMConfig(n_states=n_states, n_mix=1, dim=dim), dtype=jnp.float64)
    rng = np.random.default_rng(int(abs(mean_shift * 100)) + 1)
    m.init_left_to_right(rng.normal(size=(max(8, n_states * 4), dim)) + mean_shift,
                         jax.random.PRNGKey(0))
    mu = np.array(m.mu)
    for i in range(n_states):
        mu[i] = mean_shift + i * 0.5
    m.mu = jnp.asarray(mu)
    m.cov = jnp.full_like(m.cov, 0.05)
    return m


def _emit(units, word_units, frames_per_state, rng):
    frames = []
    for unit in word_units:
        mu = np.asarray(units[unit].mu)
        for s in range(units[unit].n):
            frames += [mu[s, 0] + rng.normal(scale=0.05, size=mu.shape[-1])
                       for _ in range(frames_per_state)]
    return np.asarray(frames)


def _lms(corpus, order, tmp_path):
    """The same ARPA file read by both packages: ``(jax LM, port LM)``."""
    model = JNGramModel(JNGramCounter(order, [JTokenizer.get_tokens(s) for s in corpus]))
    path = str(tmp_path / f"lm{order}.arpa")
    JNGramModelARPA().save(model, path)
    return JNGramModel(JNGramModelARPA().load(path)), NGramModel(NGramModelARPA().load(path))


@pytest.fixture(scope="module")
def world():
    units = {"A": _jax_unit(-4.0), "B": _jax_unit(0.0), "C": _jax_unit(4.0),
             "<sil>": _jax_unit(9.0, n_states=3)}
    lex = {"alpha": ("A",), "bravo": ("B",), "charlie": ("C",)}
    return units, units_from_numpy(units, device="cpu", dtype=F64), lex


def _graphs(world, lm_pair, cfg=dict(lm_scale=1.5, word_insertion_penalty=-0.3),
            silence=False, jax_units=None):
    j_units, t_units, lex = world
    if jax_units is not None:
        j_units, t_units = jax_units, units_from_numpy(jax_units, device="cpu", dtype=F64)
    words = {w: u for w, u in lex.items() if u[0] in j_units}
    jg = JTrigram.build(JLexicon(words), j_units, lm_pair[0], JDecoderConfig(**cfg),
                        silence_model=j_units["<sil>"] if silence else None, dtype=jnp.float64)
    tg = TrigramDecodingGraph.build(Lexicon(words), t_units, lm_pair[1], DecoderConfig(**cfg),
                                    silence_model=t_units["<sil>"] if silence else None,
                                    dtype=F64, device="cpu")
    return jg, tg


CORPUS = ["alpha bravo charlie", "charlie alpha bravo", "bravo bravo alpha", "alpha charlie"]


@pytest.mark.parametrize("silence", [False, True])
def test_trigram_graph_matches_jax(world, tmp_path, silence):
    """The built tensors are the JAX package's, and a decode along planted
    words (with silence between them when the graph has it) gives its
    path bitwise and its score to 1e-12."""
    j_units = world[0]
    jg, tg = _graphs(world, _lms(CORPUS, 3, tmp_path), silence=silence)
    assert tg.words == jg.words and tg.grid_shape == jg.grid_shape
    for name in ("hop3", "final3", "log_pi_w", "inner_a"):
        np.testing.assert_array_equal(getattr(tg, name).numpy(), np.asarray(getattr(jg, name)),
                                      err_msg=name)
    rng = np.random.default_rng(30)
    sil = np.asarray(j_units["<sil>"].mu)[0, 0] + rng.normal(scale=0.05, size=(6, 3))
    parts = []
    for w in ["alpha", "charlie", "bravo", "alpha"]:
        parts.append(_emit(j_units, world[2][w], 4, rng))
        if silence:
            parts.append(sil)
    feats = np.concatenate(parts)
    jw, jpath, jscore = jg.decode(feats)
    tw, tpath, tscore = tg.decode(feats)
    assert tw == jw == ["alpha", "charlie", "bravo", "alpha"]
    np.testing.assert_array_equal(tpath, np.asarray(jpath))
    assert tscore == pytest.approx(jscore, rel=1e-12)
    assert tg.path_to_alignment(tpath) == jg.path_to_alignment(np.asarray(jpath))


def test_trigram_ties_match_jax(tmp_path):
    """Identical word models tie every within-word and hop candidate; the
    first-index rules must pick the JAX package's path."""
    units = {u: _jax_unit(1.0) for u in ("A", "B", "C")}
    world = (units, None, {"alpha": ("A",), "bravo": ("B",), "charlie": ("C",)})
    jg, tg = _graphs(world, _lms(["alpha bravo", "bravo charlie", "charlie alpha"], 3, tmp_path),
                     cfg=dict(lm_scale=0.0), jax_units=units)
    feats = _emit(units, ("A", "B", "C"), 3, np.random.default_rng(4))
    _, jpath, jscore = jg.decode(feats)
    _, tpath, tscore = tg.decode(feats)
    np.testing.assert_array_equal(tpath, np.asarray(jpath))
    assert tscore == pytest.approx(jscore, rel=1e-12)


def test_trigram_changes_hypothesis_as_jax():
    """Two acoustically identical words that only the two-word history
    tells apart: both packages' trigram graphs pick the right one."""
    units = {"P": _jax_unit(-6.0), "Q": _jax_unit(-2.0), "A": _jax_unit(2.0),
             "B": _jax_unit(6.0), "C": _jax_unit(6.0)}
    lex = {w.lower(): (w,) for w in units}
    corpus = [JTokenizer.get_tokens(s) for s in ["p a b"] * 10 + ["q a c"] * 12]
    jlm = JNGramModel(JNGramCounter(3, corpus))
    tlm = NGramModel(NGramCounter(3, corpus))
    jg, tg = _graphs((units, None, lex), (jlm, tlm), cfg=dict(lm_scale=1.0), jax_units=units)
    feats = _emit(units, ("P", "A", "B"), 4, np.random.default_rng(31))
    jw, jpath, jscore = jg.decode(feats)
    tw, tpath, tscore = tg.decode(feats)
    assert tw == jw == ["p", "a", "b"]
    np.testing.assert_array_equal(tpath, np.asarray(jpath))
    assert tscore == pytest.approx(jscore, rel=1e-12)


def test_order2_lm_equals_factored_graph(world, tmp_path):
    """With a bigram LM the history expansion is inert: the port's trigram
    graph gives the port's factored graph's words and score."""
    _, t_units, lex = world
    _, tlm = _lms(CORPUS, 2, tmp_path)
    cfg = DecoderConfig(lm_scale=1.5, word_insertion_penalty=-0.3)
    words = {w: u for w, u in lex.items()}
    fact = FactoredDecodingGraph.build(Lexicon(words), t_units, tlm, cfg, dtype=F64,
                                       device="cpu")
    tri = TrigramDecodingGraph.build(Lexicon(words), t_units, tlm, cfg, dtype=F64, device="cpu")
    feats = np.concatenate([_emit(world[0], lex[w], 4, np.random.default_rng(k))
                            for k, w in enumerate(["alpha", "bravo", "charlie"])])
    fw, _, fscore = fact.decode(feats)
    tw, _, tscore = tri.decode(feats)
    assert tw == fw == ["alpha", "bravo", "charlie"]
    assert tscore == pytest.approx(fscore, rel=1e-12, abs=1e-9)


def test_masked_decode_and_batch(world, tmp_path):
    """A bucket-padded decode equals the unpadded one, ``decode_batch``
    equals a loop of ``decode``, and both equal the JAX package's."""
    j_units, _, lex = world
    jg, tg = _graphs(world, _lms(CORPUS, 3, tmp_path), silence=True)
    rng = np.random.default_rng(33)
    utts = [np.concatenate([_emit(j_units, lex[w], 4, rng) for w in seq])
            for seq in (["alpha", "bravo"], ["charlie"], ["bravo", "charlie", "alpha"])]
    t_max = max(len(u) for u in utts) + 5
    batch = rng.normal(size=(len(utts), t_max, 3))
    masks = np.zeros((len(utts), t_max), bool)
    for i, u in enumerate(utts):
        batch[i, : len(u)] = u
        masks[i, : len(u)] = True
    out = tg.decode_batch(batch, masks)
    jout = jg.decode_batch(batch, masks)
    for i, u in enumerate(utts):
        words_u, path_u, score_u = tg.decode(u)
        words_m, path_m, score_m = tg.decode(batch[i], masks[i])
        assert out[i][0] == words_m == words_u == jout[i][0]
        np.testing.assert_array_equal(path_m[: len(u)], path_u)
        np.testing.assert_array_equal(out[i][1], path_m)
        np.testing.assert_array_equal(out[i][1], np.asarray(jout[i][1]))
        # masked frames point to themselves
        assert (path_m[len(u):] == path_m[len(u) - 1]).all()
        assert out[i][2] == score_m == pytest.approx(score_u, rel=1e-12)
        assert out[i][2] == pytest.approx(jout[i][2], rel=1e-12)


def test_budget_guard_suggests_rescoring(world, tmp_path):
    lms = _lms(CORPUS, 3, tmp_path)
    with pytest.raises(ValueError, match="rescore"):
        TrigramDecodingGraph.build(Lexicon(world[2]), world[1], lms[1], DecoderConfig(),
                                   dtype=F64, max_table_bytes=64, device="cpu")
    with pytest.raises(ValueError, match="requires a language model"):
        TrigramDecodingGraph.build(Lexicon(world[2]), world[1], None, DecoderConfig(),
                                   device="cpu")
    g = TrigramDecodingGraph.build(Lexicon(world[2]), world[1], lms[1], DecoderConfig(),
                                   dtype=F64, device="cpu")
    assert g.hop3.shape == (4, 3, 3)
