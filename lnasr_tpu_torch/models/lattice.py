"""Word lattices, N-best extraction, and LM rescoring.

The port of the JAX package's ``models/lattice.py``. The factored bigram
search (:class:`~lnasr_tpu_torch.models.decoder.FactoredDecodingGraph`)
records, per frame, each word's best exit score plus that token's span and
predecessor (kernel F on CUDA, :func:`~lnasr_tpu_torch.models.decoder.
factored_lattice_scan` elsewhere). After their one copy to the host those
records form a word lattice whose arcs decompose additively into

    pi_w[w_0] + ac_0 + sum_i (hop[w_{i-1}, w_i] + ac_i) + final_w[w_last]

where ``ac`` is a token's predecessor-independent acoustic score (the
recorded exit score minus the entry mass). N-best hypotheses come from a
k-best Viterbi over the token DAG; any higher-order
:class:`~lnasr_tpu_torch.models.ngram.NGramModel` rescores them by swapping
the bigram hop scores for full-history ones, which reaches trigram
accuracy at vocabularies a history-expanded graph cannot hold.

Host-side NumPy, as in the JAX package; the JSON format
(``"lnasr_tpu-word-lattice-v1"``) is shared, so a lattice saved by either
package loads in the other.
"""

from __future__ import annotations

import dataclasses
import json
import math
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from lnasr_tpu_torch.models.decoder import SILENCE, HopFactors, HostBackoffHop, _has_eos
from lnasr_tpu_torch.models.ngram import BOS, EOS, NGramModel

_LN10 = math.log(10.0)


def _hop_block(hop, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Dense hop block for token-DAG arcs: plain indexing for a (V, V)
    matrix, the O(in-degree) accessor for backoff-factored hops
    (:class:`lnasr_tpu_torch.models.decoder.HostBackoffHop`)."""
    if hasattr(hop, "block"):
        return hop.block(rows, cols)
    return hop[np.ix_(rows, cols)]


def _hop_pair(hop, src: int, dst: int) -> float:
    if hasattr(hop, "pair"):
        return hop.pair(src, dst)
    return float(hop[src, dst])


def _lse_cols(x: np.ndarray) -> np.ndarray:
    """log-sum-exp over axis 0 of a 2-D array; all-(-inf) columns give
    -inf without warnings (the empty-predecessor case)."""
    m = np.max(x, axis=0)
    safe = np.where(np.isfinite(m), m, 0.0)
    with np.errstate(divide="ignore"):
        out = safe + np.log(np.sum(np.exp(x - safe[None, :]), axis=0))
    return np.where(np.isfinite(m), out, m)


def lm_conditional(lm: NGramModel, word: str, context: Tuple[str, ...]) -> float:
    """log10 P(word | context) at the LM level matching ``len(context)+1``
    (truncating longer contexts), so e.g. a one-word context against a
    trigram model scores with its bigram level rather than backing off
    through a missing trigram entry."""
    context = tuple(context[-(lm.order - 1):])
    return lm._level(len(context) + 1).logprob(word, context)


@dataclasses.dataclass(frozen=True)
class WordToken:
    """One word occurrence hypothesis: ``word_id`` spanning frames
    ``[start, end]`` with acoustic score ``ac`` (emissions + within-word
    transitions only; LM/penalty mass lives on the lattice arcs)."""

    word_id: int
    start: int
    end: int
    ac: float


@dataclasses.dataclass
class Hypothesis:
    """An N-best entry: surface words (silence removed), the underlying
    token sequence (silence included), the total path score, and (when
    requested) per-surface-word posterior confidences."""

    words: List[str]
    tokens: List[WordToken]
    score: float
    confidence: Optional[List[float]] = None


class WordLattice:
    """A DAG of :class:`WordToken` built from factored-search exit records.

    Its 1-best path reproduces the Viterbi decode; :meth:`nbest` extracts
    alternatives; :meth:`rescore` re-ranks them under a different (usually
    higher-order) LM using each token's acoustic score.
    """

    def __init__(
        self,
        words: Sequence[str],
        tokens: List[WordToken],
        hop: np.ndarray,
        log_pi_w: np.ndarray,
        log_final_w: np.ndarray,
        n_frames: int,
    ):
        self.words = list(words)
        self.tokens = tokens
        self.hop = hop
        self.log_pi_w = log_pi_w
        self.log_final_w = log_final_w
        self.n_frames = n_frames
        self._by_start: Dict[int, List[int]] = {}
        self._by_end: Dict[int, List[int]] = {}
        for i, tok in enumerate(tokens):
            self._by_start.setdefault(tok.start, []).append(i)
            self._by_end.setdefault(tok.end, []).append(i)
        # flat token columns: the batched (per-frame NumPy) N-best /
        # posterior paths index these instead of Python token objects
        self._tok_word = np.fromiter((t.word_id for t in tokens), np.int64,
                                     len(tokens))
        self._tok_start = np.fromiter((t.start for t in tokens), np.int64,
                                      len(tokens))
        self._tok_end = np.fromiter((t.end for t in tokens), np.int64,
                                    len(tokens))
        self._tok_ac = np.fromiter((t.ac for t in tokens), np.float64,
                                   len(tokens))
        self._word_index: Optional[Dict[int, np.ndarray]] = None

    # -- construction --------------------------------------------------------

    @classmethod
    def from_records(
        cls,
        words: Sequence[str],
        exit_score: np.ndarray,  # (T, V)
        exit_start: np.ndarray,  # (T, V) int
        exit_pred: np.ndarray,  # (T, V) int, -1 = sentence begin
        hop: np.ndarray,  # (V, V)
        log_pi_w: np.ndarray,  # (V,)
        log_final_w: np.ndarray,  # (V,)
        beam: float = 40.0,
        max_tokens_per_frame: Optional[int] = None,
    ) -> "WordLattice":
        """Convert per-frame exit records into word tokens.

        A record ``(t, v)`` becomes the token "word v spans
        ``[exit_start[t, v], t]``"; its acoustic score is the exit score
        minus the recorded entry mass (``pi_w`` at sentence begin, else
        the predecessor's exit score plus the bigram hop). Records outside
        ``beam`` nats of their frame's best, or beyond
        ``max_tokens_per_frame`` by rank, are pruned.
        """
        t_len, _ = exit_score.shape
        tokens: List[WordToken] = []
        for t in range(t_len):
            row = exit_score[t]
            finite = np.isfinite(row)
            if not finite.any():
                continue
            thresh = row[finite].max() - beam
            keep = np.flatnonzero(finite & (row >= thresh))
            if max_tokens_per_frame is not None and len(keep) > max_tokens_per_frame:
                keep = keep[np.argsort(row[keep])[::-1][:max_tokens_per_frame]]
            for v in keep:
                start = int(exit_start[t, v])
                pred = int(exit_pred[t, v])
                if pred < 0:
                    entry = log_pi_w[v]
                else:
                    entry = exit_score[start - 1, pred] + _hop_pair(
                        hop, pred, v
                    )
                ac = float(row[v] - entry)
                if math.isfinite(ac):
                    tokens.append(WordToken(int(v), start, t, ac))
        return cls(words, tokens, hop, log_pi_w, log_final_w, t_len)

    def __len__(self) -> int:
        return len(self.tokens)

    # -- persistence ---------------------------------------------------------

    @staticmethod
    def _encode_scores(x: np.ndarray):
        """Finite floats with ``-inf`` (unreachable arcs) as ``null`` —
        strict-JSON-safe, unlike the ``-Infinity`` literal ``json.dump``
        would otherwise emit (most non-Python parsers reject it)."""
        obj = np.asarray(x, dtype=object)
        obj[~np.isfinite(np.asarray(x, np.float64))] = None
        return obj.tolist()

    @staticmethod
    def _decode_scores(x) -> np.ndarray:
        arr = np.asarray(x, dtype=object)
        none = np.frompyfunc(lambda v: v is None, 1, 1)(arr).astype(bool)
        arr[none] = -np.inf
        return arr.astype(np.float64)

    def save(self, filename: str) -> None:
        """Write the lattice as strict JSON (words, tokens, word-level
        scores) so decoding and rescoring can run in separate processes —
        decode once on device, rescore later with any LM on host.
        Unreachable (-inf) score entries serialize as ``null``."""
        payload = {
            "format": "lnasr_tpu-word-lattice-v1",
            "words": self.words,
            "n_frames": self.n_frames,
            "tokens": [
                [t.word_id, t.start, t.end, t.ac] for t in self.tokens
            ],
            "log_pi_w": self._encode_scores(self.log_pi_w),
            "log_final_w": self._encode_scores(self.log_final_w),
            # backoff-factored hops serialize their factors
            # (O(V + E)); dense hops the matrix - load() rebuilds either
            "hop": (
                {
                    "from_w": self._encode_scores(self.hop.from_w),
                    "uni": self._encode_scores(self.hop.uni),
                    "sil_from": self._encode_scores(self.hop.sil_from),
                    "sil_idx": int(self.hop.sil_idx),
                    "pred": np.asarray(self.hop.pred).tolist(),
                    "val": self._encode_scores(self.hop.val),
                }
                if hasattr(self.hop, "block")
                else self._encode_scores(self.hop)
            ),
        }
        with open(filename, "w", encoding="utf-8") as fp:
            json.dump(payload, fp, allow_nan=False)

    @classmethod
    def load(cls, filename: str) -> "WordLattice":
        def _parse_const(name):  # accept legacy files with -Infinity
            return {"-Infinity": -math.inf, "Infinity": math.inf,
                    "NaN": math.nan}[name]

        with open(filename, encoding="utf-8") as fp:
            payload = json.load(fp, parse_constant=_parse_const)
        if payload.get("format") != "lnasr_tpu-word-lattice-v1":
            raise ValueError(f"{filename}: not a lnasr_tpu word lattice")
        hop = payload["hop"]
        if isinstance(hop, dict):
            hop = HostBackoffHop(HopFactors(
                from_w=cls._decode_scores(hop["from_w"]),
                uni=cls._decode_scores(hop["uni"]),
                sil_from=cls._decode_scores(hop["sil_from"]),
                sil_idx=np.int32(hop["sil_idx"]),
                pred=np.asarray(hop["pred"], np.int32),
                val=cls._decode_scores(hop["val"]),
            ))
        else:
            hop = cls._decode_scores(hop)
        return cls(
            payload["words"],
            [WordToken(w, s, e, a) for w, s, e, a in payload["tokens"]],
            hop,
            cls._decode_scores(payload["log_pi_w"]),
            cls._decode_scores(payload["log_final_w"]),
            int(payload["n_frames"]),
        )

    # -- N-best --------------------------------------------------------------

    def nbest(self, n: int, unique: bool = True) -> List[Hypothesis]:
        """k-best Viterbi over the token DAG, batched per frame.

        Tokens are processed in start-frame order; each keeps its ``n``
        best (score, predecessor, predecessor-rank) entries. One frame is
        ONE NumPy block op — every (current token c, predecessor token p,
        rank r) candidate scores in a (|C|, |P|·n) matrix
        ``entry[p, r] + hop[word_p, word_c] + ac_c`` topped-k by a stable
        argsort — instead of the per-token per-entry Python loops this
        replaces: those were O(tokens x predecessors x n) interpreter
        steps per frame, the serving bottleneck at real vocabularies
        (thousands of tokens x thousands of frames). With ``unique``
        (default), hypotheses rendering to the same word sequence are
        merged keeping the best-scoring one.
        """
        n_tok = len(self.tokens)
        # entry tables: score, predecessor token (-1 = sentence begin,
        # unused rows stay at -inf), predecessor entry rank
        ent_score = np.full((n_tok, n), -np.inf)
        ent_prev = np.full((n_tok, n), -1, np.int64)
        ent_rank = np.full((n_tok, n), -1, np.int64)

        for t in range(self.n_frames):
            curr = self._by_start.get(t)
            if not curr:
                continue
            c_idx = np.asarray(curr, np.int64)
            w_c = self._tok_word[c_idx]
            ac_c = self._tok_ac[c_idx]
            blocks: List[np.ndarray] = []
            prevs: List[np.ndarray] = []
            ranks: List[np.ndarray] = []
            if t == 0:
                blocks.append(self.log_pi_w[w_c][:, None] + ac_c[:, None])
                prevs.append(np.full(1, -1, np.int64))
                ranks.append(np.full(1, -1, np.int64))
            pred = self._by_end.get(t - 1)
            if pred:
                p_idx = np.asarray(pred, np.int64)
                arc = _hop_block(self.hop, self._tok_word[p_idx], w_c)  # (P, C)
                # (C, P, n): entry scores broadcast over candidates
                cand = (
                    arc.T[:, :, None]
                    + ent_score[p_idx][None, :, :]
                    + ac_c[:, None, None]
                )
                blocks.append(cand.reshape(len(c_idx), -1))
                prevs.append(np.repeat(p_idx, n))
                ranks.append(np.tile(np.arange(n, dtype=np.int64), len(p_idx)))
            if not blocks:
                continue
            cand_all = np.concatenate(blocks, axis=1)
            prev_all = np.concatenate(prevs)
            rank_all = np.concatenate(ranks)
            k = min(n, cand_all.shape[1])
            # stable sort on construction order reproduces the tie-breaks
            # of the sequential formulation (first-seen candidate wins)
            order = np.argsort(-cand_all, axis=1, kind="stable")[:, :k]
            ent_score[c_idx, :k] = np.take_along_axis(cand_all, order, axis=1)
            ent_prev[c_idx, :k] = prev_all[order]
            ent_rank[c_idx, :k] = rank_all[order]

        last = self._by_end.get(self.n_frames - 1)
        finals: List[Tuple[float, int, int]] = []
        if last:
            l_idx = np.asarray(last, np.int64)
            fin = self.log_final_w[self._tok_word[l_idx]]
            scores = ent_score[l_idx] + fin[:, None]  # (L, n)
            flat = scores.ravel()
            order = np.argsort(-flat, kind="stable")
            tok_of = np.repeat(l_idx, n)
            rank_of = np.tile(np.arange(n, dtype=np.int64), len(l_idx))
            for o in order:
                if not np.isfinite(flat[o]):
                    break
                finals.append((float(flat[o]), int(tok_of[o]), int(rank_of[o])))

        hyps: List[Hypothesis] = []
        seen: Dict[Tuple[str, ...], int] = {}
        for score, i, r in finals:
            toks: List[WordToken] = []
            while i >= 0:
                toks.append(self.tokens[i])
                i, r = int(ent_prev[i, r]), int(ent_rank[i, r])
            toks.reverse()
            surface = tuple(
                self.words[t.word_id]
                for t in toks
                if self.words[t.word_id] != SILENCE
            )
            if unique:
                if surface in seen:
                    continue
                seen[surface] = 1
            hyps.append(Hypothesis(list(surface), toks, float(score)))
            if len(hyps) >= n:
                break
        return hyps

    # -- posteriors / confidence ---------------------------------------------

    def posteriors(self) -> np.ndarray:
        """Token posterior probabilities by forward-backward over the DAG.

        ``fwd[i]`` sums (log-space) all paths from sentence start through
        token i; ``bwd[i]`` sums all completions after it; the posterior is
        ``exp(fwd + bwd - total)``. Every path enters at exactly one
        frame-0 token and leaves at exactly one final token, so posteriors
        of tokens starting at frame 0 sum to 1, as do those of tokens
        ending at the last frame (tested invariants).

        The mass is restricted to the paths present in the lattice (the
        usual lattice-posterior approximation): tighter beams concentrate
        it, ``beam=inf`` lattices carry everything the bigram search saw.
        """
        n = len(self.tokens)
        fwd = np.full(n, -np.inf)
        bwd = np.full(n, -np.inf)
        for t in range(self.n_frames):
            curr = self._by_start.get(t)
            if not curr:
                continue
            c_idx = np.asarray(curr, np.int64)
            w_c = self._tok_word[c_idx]
            acc = np.full(len(c_idx), -np.inf)
            if t == 0:
                acc = self.log_pi_w[w_c].astype(np.float64)
            pred = self._by_end.get(t - 1)
            if pred:
                p_idx = np.asarray(pred, np.int64)
                arc = _hop_block(self.hop, self._tok_word[p_idx], w_c)  # (P, C)
                acc = np.logaddexp(acc, _lse_cols(fwd[p_idx][:, None] + arc))
            fwd[c_idx] = acc + self._tok_ac[c_idx]
        for t in range(self.n_frames - 1, -1, -1):
            curr = self._by_end.get(t)
            if not curr:
                continue
            c_idx = np.asarray(curr, np.int64)
            w_c = self._tok_word[c_idx]
            acc = np.full(len(c_idx), -np.inf)
            if t == self.n_frames - 1:
                acc = self.log_final_w[w_c].astype(np.float64)
            succ = self._by_start.get(t + 1)
            if succ:
                s_idx = np.asarray(succ, np.int64)
                arc = _hop_block(self.hop, w_c, self._tok_word[s_idx])  # (C, S)
                tail = (self._tok_ac[s_idx] + bwd[s_idx])[None, :]
                acc = np.logaddexp(acc, _lse_cols((arc + tail).T))
            bwd[c_idx] = acc
        last = self._by_end.get(self.n_frames - 1, [])
        if last:
            l_idx = np.asarray(last, np.int64)
            total = _lse_cols(
                (fwd[l_idx] + self.log_final_w[self._tok_word[l_idx]])[:, None]
            )[0]
        else:
            total = -np.inf
        with np.errstate(invalid="ignore"):
            post = np.exp(fwd + bwd - total)
        # float32 search scores can round a certain token to 1 + O(1e-4)
        return np.clip(np.nan_to_num(post, nan=0.0), 0.0, 1.0)

    def _tokens_of_word(self, word_id: int) -> np.ndarray:
        """Token indices carrying ``word_id`` (built once, cached)."""
        if self._word_index is None:
            order = np.argsort(self._tok_word, kind="stable")
            uniq, starts = np.unique(self._tok_word[order], return_index=True)
            splits = np.split(order, starts[1:])
            self._word_index = dict(zip(uniq.tolist(), splits))
        return self._word_index.get(word_id, np.empty(0, np.int64))

    def confidences(self, hypothesis: "Hypothesis",
                    post: Optional[np.ndarray] = None) -> List[float]:
        """Per-surface-word confidence for a hypothesis: the posterior mass
        of all lattice tokens carrying the same word whose span overlaps
        the hypothesis token's span (word-posterior confidence, clipped to
        1). Silence tokens are skipped, matching ``Hypothesis.words``.
        Pass precomputed :meth:`posteriors` to score many hypotheses.

        Same-word tokens come from a cached word-id index and overlap is
        one vectorized span test, so scoring many hypotheses against a
        wide-beam lattice stays linear in the hypothesis length."""
        if post is None:
            post = self.posteriors()
        out: List[float] = []
        for tok in hypothesis.tokens:
            if self.words[tok.word_id] == SILENCE:
                continue
            idx = self._tokens_of_word(tok.word_id)
            sel = idx[
                (self._tok_start[idx] <= tok.end)
                & (self._tok_end[idx] >= tok.start)
            ]
            out.append(min(1.0, float(post[sel].sum())))
        return out

    # -- rescoring -----------------------------------------------------------

    def lm_path_score(
        self,
        tokens: Sequence[WordToken],
        lm: Optional[NGramModel],
        lm_scale: float = 1.0,
        word_insertion_penalty: float = 0.0,
        exit_logp: float = math.log(0.5),
        use_eos: Optional[bool] = None,
        silence_context: str = "keep1",
    ) -> float:
        """Total path score of a token sequence under ``lm`` with the
        decoder's composition rules, at the LM's full order:

        - first word scores ``P(w | <s>)``; a leading silence is free;
        - each later real word costs ``exit_logp + penalty +
          lm_scale * log P(w | history)`` with all available history;
        - entering silence costs ``exit_logp`` only; what survives the
          gap is set by ``silence_context``:

          * ``"keep1"`` (default): one pre-silence word of history — the
            rule of the JAX package's history-expanded
            ``TrigramDecodingGraph``, the richer rescoring objective;
          * ``"reset"``: NO history (next word scores as a unigram) —
            exactly the factored *search's* hop-out-of-silence rule
            (``decoder.py`` ``_word_lm_scores``), so rescoring with the
            search's own bigram LM reproduces the lattice arc scores on
            silence-crossing paths too;

        - sentence end adds ``P(</s> | history)`` when the LM has one.

        With a bigram LM and ``silence_context="reset"`` this reproduces
        the lattice's own arc scores on EVERY path (parity-tested,
        including silence crossings); with the default ``"keep1"`` the
        bigram self-consistency holds on silence-free paths only — an
        intentional objective difference, not an accident. With a
        trigram+ LM it is the rescoring objective. ``use_eos`` defaults
        to whether the LM models sentence end.
        """
        if silence_context not in ("keep1", "reset"):
            raise ValueError(
                f'silence_context must be "keep1" or "reset", '
                f"got {silence_context!r}"
            )
        if use_eos is None and lm is not None:
            use_eos = _has_eos(lm)
        scale = lm_scale * _LN10
        total = sum(t.ac for t in tokens)
        hist: Tuple[str, ...] = (BOS,)
        first = True
        for tok in tokens:
            w = self.words[tok.word_id]
            if w == SILENCE:
                if not first:
                    total += exit_logp
                if silence_context == "reset":
                    hist = ()  # unigram after the gap, as the search
                else:
                    # one word of history survives the gap
                    hist = hist[-1:] if hist and hist[-1] != BOS else (BOS,)
                first = False
                continue
            if first:
                if lm is not None:
                    total += scale * lm_conditional(lm, w, (BOS,))
            else:
                total += exit_logp + word_insertion_penalty
                if lm is not None:
                    total += scale * lm_conditional(lm, w, hist)
            # <s> stays in the history so the second word scores
            # P(w2 | <s>, w1) at full order, as the expanded graph does
            hist = hist + (w,)
            first = False
        if lm is not None and use_eos and hist and hist[-1] != BOS:
            total += scale * lm_conditional(lm, EOS, hist)
        return float(total)

    def rescore(
        self,
        lm: NGramModel,
        n: int = 10,
        pool: Optional[int] = None,
        lm_scale: float = 1.0,
        word_insertion_penalty: float = 0.0,
        exit_logp: float = math.log(0.5),
        use_eos: Optional[bool] = None,
        silence_context: str = "keep1",
    ) -> List[Hypothesis]:
        """Re-rank the lattice's N-best under a (higher-order) LM.

        Extracts ``pool`` hypotheses (default ``4 * n``) with the lattice's
        bigram scores, rescores each with :meth:`lm_path_score`, and
        returns the top ``n`` by the new score. ``silence_context`` picks
        the history rule across silence gaps (see :meth:`lm_path_score`).
        """
        hyps = self.nbest(pool or 4 * n, unique=True)
        rescored = [
            Hypothesis(
                h.words,
                h.tokens,
                self.lm_path_score(
                    h.tokens, lm, lm_scale, word_insertion_penalty,
                    exit_logp, use_eos, silence_context,
                ),
            )
            for h in hyps
        ]
        rescored.sort(key=lambda h: -h.score)
        return rescored[:n]
