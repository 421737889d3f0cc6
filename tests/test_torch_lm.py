"""The port's lexicon and n-gram LM against the JAX package: same counts,
the same log10 probabilities and backoff weights, the same dense score
table for the decoder, and ARPA files that each package loads from the
other with identical probabilities."""

import dataclasses

import numpy as np
import pytest

from lnasr_tpu import config as jconfig
from lnasr_tpu.models import decoder as jdec
from lnasr_tpu.models import lexicon as jlex
from lnasr_tpu.models import ngram as jng
from lnasr_tpu_torch import config as tconfig
from lnasr_tpu_torch.models import decoder as tdec
from lnasr_tpu_torch.models import lexicon as tlex
from lnasr_tpu_torch.models import ngram as tng
from lnasr_tpu_torch.utils.text import PUNCTUATION_UNICODE

CORPUS = [
    "我 喜欢 吃 苹果",
    "我 喜欢 吃 香蕉",
    "你 喜欢 吃 苹果 吗",
    "我 不 喜欢 香蕉",
    "苹果 和 香蕉 都 好吃",
]


def _zipf_corpus(seed=0, n_sents=300, vocab=40):
    """Large enough that Good-Turing's count-of-counts are all defined."""
    rng = np.random.default_rng(seed)
    words = [f"w{i}" for i in range(vocab)]
    p = 1.0 / np.arange(1, vocab + 1)
    return [tuple([tng.BOS] + [words[i] for i in rng.choice(vocab, size=8, p=p / p.sum())]
                  + [tng.EOS]) for _ in range(n_sents)]


def _levels(model):
    while model is not None:
        yield model
        model = model.backoff


def _assert_same_model(t_model, j_model):
    for t_lvl, j_lvl in zip(_levels(t_model), _levels(j_model), strict=True):
        assert t_lvl.order == j_lvl.order
        assert t_lvl.prob == j_lvl.prob
        assert t_lvl.prob_bo == j_lvl.prob_bo


@pytest.mark.parametrize("cls", ["NGramConfig"])
def test_config_fields_match(cls):
    j, t = getattr(jconfig, cls)(), getattr(tconfig, cls)()
    assert [f.name for f in dataclasses.fields(j)] == [f.name for f in dataclasses.fields(t)]
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    assert dataclasses.asdict(jdec.DecoderConfig()) == dataclasses.asdict(tdec.DecoderConfig())


def test_tokenizer_and_punctuation():
    from lnasr_tpu.utils.text import PUNCTUATION_UNICODE as J_PUNCT

    assert PUNCTUATION_UNICODE == J_PUNCT
    for s in CORPUS + ["你好，世界。", "a b"]:
        assert tng.Tokenizer.get_tokens(s) == jng.Tokenizer.get_tokens(s)
        assert (tng.Tokenizer.get_tokens(s, add_bounds=False)
                == jng.Tokenizer.get_tokens(s, add_bounds=False))


@pytest.mark.parametrize("order", [1, 2, 3])
@pytest.mark.parametrize("cfg", [
    dict(), dict(smoothing="good-turing"), dict(smoothing="good-turing", gt_max_count=3),
    dict(open_vocab=True), dict(discount=0.5),
])
def test_model_matches_jax(order, cfg):
    tokens = _zipf_corpus() + [jng.Tokenizer.get_tokens(s) for s in CORPUS]
    t_counter, j_counter = tng.NGramCounter(order, tokens), jng.NGramCounter(order, tokens)
    assert t_counter.ngrams == j_counter.ngrams
    t = tng.NGramModel(t_counter, tconfig.NGramConfig(order=order, **cfg))
    j = jng.NGramModel(j_counter, jconfig.NGramConfig(order=order, **cfg))
    _assert_same_model(t, j)
    assert t.vocabulary() == j.vocabulary()
    for sent in tokens[:20]:
        assert t.calc_prob(sent) == j.calc_prob(sent)
        assert t.calc_ppl(sent) == j.calc_ppl(sent)
    oov = ("<s>", "w1", "苹果", "oov", "</s>")  # the -1e300 sentinel, or <unk>
    assert t.calc_prob(oov) == j.calc_prob(oov)
    if order >= 2:
        words = t.vocabulary()[:30] + ["oov"]
        np.testing.assert_array_equal(t.score_table(words), j.score_table(words))
    if order >= 3:
        words = t.vocabulary()[:12]
        np.testing.assert_array_equal(t.score_table_trigram(words), j.score_table_trigram(words))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_arpa_cross_load(tmp_path, writer):
    """An ARPA file written by either package loads in the other (and in
    itself) with identical probabilities and backoff weights."""
    tokens = [jng.Tokenizer.get_tokens(s) for s in CORPUS] + _zipf_corpus(n_sents=60)
    t = tng.NGramModel(tng.NGramCounter(3, tokens))
    j = jng.NGramModel(jng.NGramCounter(3, tokens))
    path = str(tmp_path / "lm.arpa")
    if writer == "port":
        tng.NGramModelARPA().save(t, path)
    else:
        jng.NGramModelARPA().save(j, path)
    t_loaded = tng.NGramModel(tng.NGramModelARPA().load(path))
    j_loaded = jng.NGramModel(jng.NGramModelARPA().load(path))
    _assert_same_model(t_loaded, j_loaded)
    _assert_same_model(t_loaded, t)
    other = str(tmp_path / "again.arpa")
    tng.NGramModelARPA().save(t_loaded, other)
    with open(path, encoding="utf-8") as a, open(other, encoding="utf-8") as b:
        assert a.read() == b.read()
    words = t.vocabulary()
    np.testing.assert_array_equal(t_loaded.score_table(words), j.score_table(words))


def test_arpa_rejects_malformed(tmp_path):
    path = tmp_path / "bad.arpa"
    path.write_text("no data section here\n", encoding="utf-8")
    with pytest.raises(ValueError, match="data"):
        tng.NGramModelARPA().load(str(path))
    path.write_text("\\data\\\nngram 1=1\n\n\\2-grams:\n-1.0\ta b\n\\end\\\n", encoding="utf-8")
    with pytest.raises(ValueError, match="unexpected section"):
        tng.NGramModelARPA().load(str(path))


def test_lexicon_matches_jax(tmp_path):
    text = "# a comment\nhello HH AH L OW\nworld W ER L D  # trailing\nsolo\n\n"
    path = tmp_path / "lex.txt"
    path.write_text(text, encoding="utf-8")
    t, j = tlex.Lexicon.load(str(path)), jlex.Lexicon.load(str(path))
    assert dict(t) == dict(j) and t["solo"] == ("solo",)
    assert t.units() == j.units() and t.map("world") == j.map("world")
    out = tmp_path / "again.txt"
    t.save(str(out))
    assert dict(jlex.Lexicon.load(str(out))) == dict(t)
    ww = tlex.Lexicon.whole_word(["b", "a"])
    assert dict(ww) == dict(jlex.Lexicon.whole_word(["b", "a"])) == {"a": ("a",), "b": ("b",)}
    assert dict(tlex.Lexicon({"x": ["p", "q"]})) == {"x": ("p", "q")}
