"""Katz-backoff n-gram language model with ARPA I/O.

Host-side (CPU) component: LM estimation is counting + dictionary math, not
an accelerator workload. Mirrors the reference's semantics
(``lnasr/ngram.py``): order-n counts with recursively built lower orders,
fixed-discount Katz backoff (0.7), probabilities stored in **log10** for
ARPA compatibility, sentence log-probability and perplexity
``10^(-logP/len)``, and the ARPA text format writer/parser.

Differences from the reference (documented quirks we fix):
  - the ARPA writer does not share mutable class-level section lists
    (``ngram.py:267-271,307`` accumulates across saves in one process);
  - the parser validates section structure and raises on malformed input;
  - :meth:`NGramModel.score_table` exports the LM as dense arrays for
    device-side decoding (vocabulary-indexed log10 probs + backoff weights)
    — the bridge to the decoder in
    :mod:`lnasr_tpu_torch.models.decoder`.

The port's own copy of the JAX package's ``models/ngram.py`` (that
package's ``models/__init__`` imports JAX); ARPA files written by either
load in the other with identical probabilities.
"""

from __future__ import annotations

import math
import re
from collections import Counter, defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

from lnasr_tpu_torch.config import NGramConfig
from lnasr_tpu_torch.utils.text import PUNCTUATION_UNICODE

BOS = "<s>"
EOS = "</s>"
UNK = "<unk>"
NEG_INF = -1e300  # the reference's NInf sentinel (ngram.py:119)


class Tokenizer:
    """Whitespace tokenizer treating CJK punctuation as separators
    (``ngram.py:20-43``)."""

    punctuation = PUNCTUATION_UNICODE

    @classmethod
    def get_tokens(cls, text: str, add_bounds: bool = True) -> Tuple[str, ...]:
        cleaned = "".join(" " if ch in cls.punctuation else ch for ch in text)
        if add_bounds:
            cleaned = f"{BOS} {cleaned} {EOS}"
        return tuple(cleaned.split())


class NGramCounter:
    """Hierarchy of n-gram counts: ``counts[context][word]`` for each order
    down to unigrams (``ngram.py:45-112``)."""

    def __init__(self, order: int, token_seqs: Iterable[Tuple[str, ...]]):
        self.order = order
        self.counts: Dict[Tuple[str, ...], Counter] = defaultdict(Counter)
        token_seqs = list(token_seqs)
        for seq in token_seqs:
            for k in range(order - 1, len(seq)):
                context = tuple(seq[k - order + 1 : k])
                self.counts[context][seq[k]] += 1
        self.backoff: Optional["NGramCounter"] = (
            NGramCounter(order - 1, token_seqs) if order > 1 else None
        )

    @property
    def ngrams(self) -> set:
        return {ctx + (w,) for ctx, c in self.counts.items() for w in c}

    def items(self):
        return self.counts.items()

    def __getitem__(self, context):
        return self.counts[context]


class NGramModel:
    """Katz-backoff model over an :class:`NGramCounter` or a parsed ARPA file.

    ``prob`` maps full n-gram tuples to log10 probabilities; ``prob_bo``
    maps (n-1)-contexts to log10 backoff weights alpha (``ngram.py:114-254``).
    """

    def __init__(self, source, config: NGramConfig = NGramConfig()):
        self.config = config
        self.order = source.order
        if isinstance(source, NGramCounter):
            self.prob: Dict[Tuple[str, ...], float] = {}
            self.prob_bo: Dict[Tuple[str, ...], float] = {}
            self._discounted: Dict[Tuple[str, ...], Dict[str, float]] = {}
            self._estimate(source)
            if self.order > 1:
                self.backoff = NGramModel(source.backoff, config)
                self._estimate_alpha()
            else:
                self.backoff = None
        elif isinstance(source, NGramModelARPA):
            self.prob = dict(source.prob)
            if self.order > 1:
                self.backoff = NGramModel(source.backoff, config)
                # ARPA stores the alpha of n-grams on the (n-1)-gram lines
                self.prob_bo = dict(source.backoff.prob_bo)
            else:
                self.backoff = None
                self.prob_bo = {}
        else:
            raise TypeError(f"cannot build NGramModel from {type(source)!r}")

    # -- estimation ---------------------------------------------------------

    def _gt_discounts(self, counter: NGramCounter) -> Optional[Dict[int, float]]:
        """Katz/Good-Turing discount ratios ``d_r`` for counts ``1..k``.

        Completes the estimator the reference left unfinished
        (``ngram.py:185-200``): with count-of-counts ``N_r`` pooled over all
        contexts at this order, ``r* = (r+1) N_{r+1} / N_r`` and

            d_r = (r*/r - A) / (1 - A),   A = (k+1) N_{k+1} / N_1

        so the total mass freed approximates the Good-Turing estimate of
        unseen mass ``N_1 / total``. Returns ``None`` (caller falls back to
        the fixed discount) when the count-of-counts are too sparse for the
        formula to be defined — any ``N_r = 0`` for ``r <= k+1``, or
        ``A >= 1`` — the standard Katz applicability condition. Individual
        out-of-range ratios from non-monotone ``N_r`` (common on real
        corpora) are clamped to 1 (no discount for that count), the usual
        practical treatment rather than rejecting the whole order.
        """
        k = self.config.gt_max_count
        nr = Counter()
        for _, word_counts in counter.items():
            for cnt in word_counts.values():
                if cnt <= k + 1:
                    nr[cnt] += 1
        if any(nr[r] == 0 for r in range(1, k + 2)):
            return None
        a = (k + 1) * nr[k + 1] / nr[1]
        if a >= 1.0:
            return None
        discounts = {}
        for r in range(1, k + 1):
            r_star = (r + 1) * nr[r + 1] / nr[r]
            d = (r_star / r - a) / (1.0 - a)
            discounts[r] = d if 0.0 < d <= 1.0 else 1.0
        return discounts

    def _estimate(self, counter: NGramCounter) -> None:
        """Discounted probabilities ``d_c * c / sum(c)`` in log10
        (``ngram.py:150-162``): ``d_c`` is the fixed constant
        (``ngram.py:177-183``) or the Good-Turing ratio per count."""
        gt = (
            self._gt_discounts(counter)
            if self.config.smoothing == "good-turing"
            else None
        )
        if self.config.smoothing not in ("fixed", "good-turing"):
            raise ValueError(f"unknown smoothing: {self.config.smoothing!r}")
        fixed = self.config.discount
        for context, word_counts in counter.items():
            total = float(sum(word_counts.values()))
            dist = {}
            for w, cnt in word_counts.items():
                if cnt <= 0:
                    continue
                d = gt.get(cnt, 1.0) if gt is not None else fixed
                dist[w] = d * cnt / total
            if dist:
                self._discounted[context] = dist
        if self.order == 1 and self.config.open_vocab:
            # Open vocabulary: at the unigram level the mass freed by
            # discounting has nowhere to back off to (the reference lets it
            # vanish and raises KeyError on OOV words, ``ngram.py:228-241``);
            # assign it to ``<unk>`` so unigrams sum to 1 and OOV scoring is
            # defined (the standard ARPA convention).
            dist = self._discounted.setdefault((), {})
            beta = 1.0 - sum(dist.values())
            if beta > 0 and UNK not in dist:
                dist[UNK] = beta
        for context, dist in self._discounted.items():
            for w, p in dist.items():
                self.prob[context + (w,)] = math.log10(p) if p > 0 else NEG_INF

    def _estimate_alpha(self) -> None:
        """Backoff weights ``alpha(context) = beta / (1 - sum of backoff mass
        of seen words)`` (``ngram.py:164-175``)."""
        assert self.backoff is not None
        for context, dist in self._discounted.items():
            beta = 1.0 - sum(dist.values())
            seen_backoff_mass = 0.0
            for w in dist:
                seen_backoff_mass += self.backoff._discounted.get(context[1:], {}).get(
                    w, 0.0
                )
            alpha = beta / (1.0 - seen_backoff_mass)
            self.prob_bo[context] = math.log10(alpha) if alpha > 0 else NEG_INF

    # -- scoring ------------------------------------------------------------

    def _log_alpha(self, context: Tuple[str, ...]) -> float:
        return self.prob_bo.get(context, 0.0)

    def logprob(self, word: str, context: Tuple[str, ...]) -> float:
        """log10 P(word | context) with Katz backoff (``ngram.py:228-241``)."""
        ngram = context + (word,)
        if ngram in self.prob:
            return self.prob[ngram]
        if self.order == 1:
            # Unseen unigram: the reference raises KeyError (``ngram.py:241``).
            # If the model carries an ``<unk>`` class (open-vocab training or
            # a loaded ARPA file with <unk>), OOV words score as <unk>;
            # otherwise return the -inf sentinel so decoding stays defined.
            if word != UNK and (UNK,) in self.prob:
                return self.prob[(UNK,)]
            return NEG_INF
        return self._log_alpha(context) + self.backoff.logprob(word, context[1:])

    def calc_prob(self, sentence: Sequence[str]) -> float:
        """Sentence log10-probability (``ngram.py:243-248``)."""
        total = 0.0
        for k in range(self.order - 1, len(sentence)):
            total += self.logprob(sentence[k], tuple(sentence[k - self.order + 1 : k]))
        return total

    def calc_ppl(self, sentence: Sequence[str]) -> float:
        """Perplexity ``10^(-logP/len)`` (``ngram.py:250-254``)."""
        return math.pow(10.0, -self.calc_prob(sentence) / len(sentence))

    # -- device export ------------------------------------------------------

    def vocabulary(self) -> List[str]:
        words = set()
        model = self
        while model is not None:
            for ngram in model.prob:
                words.update(ngram)
            model = model.backoff
        return sorted(words)

    def _level(self, order: int) -> "NGramModel":
        model = self
        while model.order > order:
            model = model.backoff
        if model.order != order:
            raise ValueError(f"model has no order-{order} level")
        return model

    def score_table(self, words: Sequence[str]):
        """Dense bigram score matrix ``S[i, j] = log10 P(words[j] | words[i])``
        (with backoff applied) for device-side LM-weighted Viterbi decoding.
        Requires order >= 2.

        Vectorized: cost is O(V + #seen bigrams) dictionary work plus one
        O(V^2) array broadcast — never an O(V^2) Python loop of recursive
        ``logprob`` calls."""
        import numpy as np

        if self.order < 2:
            raise ValueError("score_table requires a bigram or higher model")
        bigram = self._level(2)
        unigram = bigram.backoff
        idx = {w: i for i, w in enumerate(words)}
        # backed-off default: alpha(w_i) + P(w_j); seen bigrams overwrite
        uni = np.array([unigram.logprob(w, ()) for w in words])
        alpha = np.array([bigram.prob_bo.get((w,), 0.0) for w in words])
        table = alpha[:, None] + uni[None, :]
        for ngram, p in bigram.prob.items():
            i, j = idx.get(ngram[0]), idx.get(ngram[1])
            if i is not None and j is not None:
                table[i, j] = p
        return table

    def score_table_trigram(self, words: Sequence[str]):
        """Dense trigram tensor ``T[i, j, k] = log10 P(words[k] | words[i],
        words[j])`` with Katz backoff applied; requires order >= 3.

        Same vectorized construction as :meth:`score_table`: the backed-off
        default ``alpha2(w_i, w_j) + S2[j, k]`` is one broadcast, then seen
        trigrams overwrite. Memory is O(V^3) — intended for the
        history-expanded decoding graph at classical vocabulary sizes.
        """
        import numpy as np

        if self.order < 3:
            raise ValueError("score_table_trigram requires a trigram model")
        trigram = self._level(3)
        idx = {w: i for i, w in enumerate(words)}
        v = len(words)
        bigram_table = self.score_table(words)
        alpha2 = np.zeros((v, v))
        for ctx, a in trigram.prob_bo.items():
            i, j = idx.get(ctx[0]), idx.get(ctx[1])
            if i is not None and j is not None:
                alpha2[i, j] = a
        table = alpha2[:, :, None] + bigram_table[None, :, :]
        for ngram, p in trigram.prob.items():
            i, j, k = (idx.get(w) for w in ngram)
            if i is not None and j is not None and k is not None:
                table[i, j, k] = p
        return table


class NGramModelARPA:
    """ARPA text format serializer/parser (``ngram.py:256-378``): the
    ``\\data\\`` header with per-order counts, ``\\N-grams:`` sections of
    ``log10prob <tab> w1 .. wN [<tab> log10alpha]`` lines, and ``\\end\\``."""

    DATA = "\\data\\"
    END = "\\end\\"
    _count_re = re.compile(r"ngram (\d+)=(\d+)")
    _section_re = re.compile(r"\\(\d+)-grams:")

    def __init__(self):
        self.order = 0
        self.prob: Dict[Tuple[str, ...], float] = {}
        self.prob_bo: Dict[Tuple[str, ...], float] = {}
        self.backoff: Optional["NGramModelARPA"] = None

    # -- write --------------------------------------------------------------

    def _from_model(self, model: NGramModel) -> None:
        self.order = model.order
        self.prob = dict(model.prob)
        if model.order > 1:
            self.backoff = NGramModelARPA()
            self.backoff._from_model(model.backoff)
            self.backoff.prob_bo = dict(model.prob_bo)
        else:
            self.backoff = None

    def _levels(self) -> List["NGramModelARPA"]:
        """Orders 1..N ascending."""
        levels = []
        node = self
        while node is not None:
            levels.append(node)
            node = node.backoff
        return levels[::-1]

    def _render(self) -> str:
        lines = ["", self.DATA]
        levels = self._levels()
        for lvl in levels:
            lines.append(f"ngram {lvl.order}={len(lvl.prob)}")
        for lvl in levels:
            lines.append("")
            lines.append(f"\\{lvl.order}-grams:")
            for ngram, p in lvl.prob.items():
                line = f"{p}\t{' '.join(ngram)}"
                if ngram in lvl.prob_bo:
                    line += f"\t{lvl.prob_bo[ngram]}"
                lines.append(line)
        lines += ["", self.END, ""]
        return "\n".join(lines)

    def save(self, model: NGramModel, filename: str) -> None:
        self._from_model(model)
        with open(filename, "w", encoding="utf-8") as fp:
            fp.write(self._render())

    # -- read ---------------------------------------------------------------

    def load(self, filename: str) -> "NGramModelARPA":
        with open(filename, "r", encoding="utf-8") as fp:
            lines = [ln.strip() for ln in fp]

        in_data = False
        orders: List[int] = []
        for ln in lines:
            if not ln:
                continue
            if ln == self.DATA:
                in_data = True
            elif in_data:
                m = self._count_re.match(ln)
                if m:
                    orders.append(int(m.group(1)))
                else:
                    break
        if not orders:
            raise ValueError(f"{filename}: no \\data\\ section found")
        self.order = max(orders)

        # build the backoff chain: self is the highest order
        by_order: Dict[int, NGramModelARPA] = {self.order: self}
        node = self
        for order in range(self.order - 1, 0, -1):
            child = NGramModelARPA()
            child.order = order
            node.backoff = child
            by_order[order] = child
            node = child

        current: Optional[NGramModelARPA] = None
        current_n = 0
        for ln in lines:
            if not ln or ln == self.DATA or self._count_re.match(ln):
                continue
            sec = self._section_re.match(ln)
            if sec:
                current_n = int(sec.group(1))
                current = by_order.get(current_n)
                if current is None:
                    raise ValueError(f"{filename}: unexpected section {ln!r}")
                continue
            if ln == self.END:
                break
            if current is None:
                continue
            parts = ln.split()
            if len(parts) < current_n + 1:
                raise ValueError(f"{filename}: malformed n-gram line {ln!r}")
            p = float(parts[0])
            ngram = tuple(parts[1 : current_n + 1])
            current.prob[ngram] = p
            if len(parts) >= current_n + 2:
                current.prob_bo[ngram] = float(parts[current_n + 1])
        return self
