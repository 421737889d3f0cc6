"""Connected-word decoding over a lexicon+LM-composed state graph.

The port of the JAX package's ``models/decoder.py`` (1-best decoding).
Each word of the lexicon is composed into one left-to-right GMM-HMM by
concatenating its units' models; word->word hops carry an exit penalty,
scaled bigram LM scores (log10 ARPA scores in nats) and a word-insertion
penalty; sentence-begin/end LM scores sit on the entry vector / final
weights. Two graph realizations share these semantics:

- :class:`DecodingGraph`: one dense ``(n_states, n_states)`` matrix and a
  dense Viterbi (:func:`dense_viterbi`: the kernel of
  ``ops/viterbi_dense.py`` on CUDA, the scan on the CPU). Right for small
  vocabularies, and the parity oracle of the factored form.
- :class:`FactoredDecodingGraph`: states on a ``(V, S)`` word-by-state
  grid; a frame is a batched ``(V, S, S)`` within-word max-plus and a word
  hop reduction (dense ``(V, V)``, backoff factors, or none). The forward
  and the replay backtrace are the wrappers of ``ops/factored.py`` (the
  kernels on CUDA, their plain versions on the CPU) for every hop kind;
  :func:`factored_trellis_scan` is the JAX package's scan, kept as their
  reference.

The factored graph also records word lattices (:meth:`FactoredDecodingGraph.
decode_lattice`): per frame and word the exit record ``(score, start,
pred)``: kernel F of ``ops/factored.py`` on CUDA and its plain version
(:func:`~lnasr_tpu_torch.ops.factored.factored_lattice_scan`) on the CPU,
for every hop kind. The host turns them into a
:class:`~lnasr_tpu_torch.models.lattice.WordLattice` (N-best, posteriors,
LM rescoring).

:class:`TrigramDecodingGraph` decodes with an exact trigram LM by
expanding the factored grid with one word of LM history: kernel H of
``ops/trigram.py`` on CUDA (forward and backtrace, one launch each, the
port of the JAX package's jitted scans) and its plain frame loop on the
CPU.

Graphs are built once on the host (NumPy, float64) and held on one device;
``decode`` reads ``(path, score)`` back with one device->host copy, and the
lattice methods their records with one.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Mapping, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from lnasr_tpu_torch._device import resolve_device
from lnasr_tpu_torch.models.lexicon import Lexicon
from lnasr_tpu_torch.models.ngram import BOS, EOS, NGramModel
from lnasr_tpu_torch.ops.factored import (
    Rank1Hop,
    backoff_hop,
    cut_batch,
    factored_backtrace,
    factored_forward,
    factored_lattice,
    factored_lattice_scan,  # noqa: F401 - the JAX package's name in this module
    hop_entry as _hop_entry,
    sm_count,
)
from lnasr_tpu_torch.ops.gaussian import gmm_emissions_diag, gmm_emissions_full
from lnasr_tpu_torch.ops.trigram import trigram_cut, trigram_viterbi
from lnasr_tpu_torch.ops.viterbi_dense import viterbi_dense


def dense_viterbi(log_pi, log_a, log_b, log_final=None, mask=None):
    """Dense-graph Viterbi: :func:`~lnasr_tpu_torch.ops.viterbi_dense.
    viterbi_dense`, the hand-written kernel on CUDA (masked frames are
    identity steps there too; it raises off float32 or past its capacity)
    and the scan on the CPU. Both give the scan's paths and scores
    bitwise."""
    return viterbi_dense(log_pi, log_a, log_b, mask, log_final)


def to_host(path: torch.Tensor, score: torch.Tensor) -> Tuple[np.ndarray, np.ndarray]:
    """``(path, score)`` as NumPy with ONE device->host copy: float32
    scores ride behind the int32 path as their bit patterns."""
    if path.dtype == torch.int32 and score.dtype == torch.float32:
        buf = torch.cat([path.reshape(-1), score.reshape(-1).view(torch.int32)]).cpu()
        n = path.numel()
        return (buf[:n].reshape(path.shape).numpy(),
                buf[n:].view(torch.float32).reshape(score.shape).numpy())
    return path.cpu().numpy(), score.cpu().numpy()


def _stack_decodes(outs, obs: torch.Tensor, dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-utterance ``(path, score)`` decodes stacked into ``(paths (B, T),
    scores (B,))``; empty tensors for an empty batch."""
    if not outs:
        return (torch.empty((0, obs.shape[1]), dtype=torch.int32, device=obs.device),
                torch.empty((0,), dtype=dtype, device=obs.device))
    return torch.stack([p for p, _ in outs]), torch.stack([s for _, s in outs])


def _batch_results(graph, paths: torch.Tensor, scores: torch.Tensor
                   ) -> List[Tuple[List[str], np.ndarray, float]]:
    """``(words, path, score)`` per utterance, with one device->host copy."""
    paths, scores = to_host(paths, scores)
    return [(graph._path_to_words(paths[b]), paths[b], float(scores[b]))
            for b in range(paths.shape[0])]


def records_to_host(score: torch.Tensor, start: torch.Tensor, pred: torch.Tensor
                    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Lattice records ``(exit_score, exit_start, exit_pred)`` of one shape
    as NumPy with ONE device->host copy: the float32 scores ride beside the
    int32 starts and preds as their bit patterns."""
    buf = torch.stack([score.view(torch.int32), start, pred]).cpu()
    return buf[0].view(torch.float32).numpy(), buf[1].numpy(), buf[2].numpy()


_LN10 = math.log(10.0)

SILENCE = "<sil>"


class HopFactors(NamedTuple):
    """Backoff-factored word-hop scores, the large-vocabulary form of the
    ``(V, V)`` hop matrix (the JAX package's ``HopFactors``). A Katz-backoff
    bigram table is rank-1-plus-sparse, so

        entry[w] = max( max_v(exit[v] + from_w[v]) + uni[w],    # rank-1
                        max_k exit[pred[w, k]] + val[w, k] )    # sparse

    with seen-bigram arcs clamped to at least their backoff estimate.
    ``from_w``/``uni`` fold the exit penalty, LM scale and insertion
    penalty; silence rides ``sil_from``/``sil_idx``; ``pred``/``val`` are
    the per-destination predecessor lists padded to the max in-degree K.
    NumPy arrays from the builder, tensors on a graph (``sil_idx`` an int).
    """

    from_w: object  # (V,) per-source add-on (alpha' + exit + wip)
    uni: object  # (V,) per-destination add-on; -inf at silence
    sil_from: object  # (V,) score of entering silence; -inf if none
    sil_idx: object  # silence word id, -1 when absent
    pred: object  # (V, K) int32 seen-bigram predecessors (padded 0)
    val: object  # (V, K) clamped arc scores (padded -inf)


def _word_lm_scores(
    words: Sequence[str],
    lm: Optional[NGramModel],
    config: "DecoderConfig",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Word-level LM scores shared by the dense and factored graphs:
    ``(log_pi_w, log_final_w, hop)`` in nats: sentence-begin score of each
    word, sentence-end weight at its final state, and the word i -> word j
    hop weight (exit penalty + scaled bigram + insertion penalty; the
    history-losing unigram rule out of silence; silence enterable from any
    real word, never after itself)."""
    v = len(words)
    is_sil = np.array([w == SILENCE for w in words])
    real = [w for w in words if w != SILENCE]
    n_real = len(real)
    scale = config.lm_scale * _LN10

    if lm is None:
        flat = -math.log(n_real)
        pi_w = np.full(v, flat)
        final_w = np.zeros(v)
        hop = np.full((v, v), flat)
        uni = np.full(v, flat)
    else:
        tbl = scale * lm.score_table(list(words) + [BOS, EOS])
        pi_w = tbl[v, :v].copy()  # P(word | <s>)
        final_w = tbl[:v, v + 1].copy() if _has_eos(lm) else np.zeros(v)
        hop = tbl[:v, :v].copy()
        unigram = lm._level(1)
        uni = scale * np.array([unigram.logprob(w, ()) for w in words])

    # hops out of silence lose the word history: back off to unigram
    hop = np.where(is_sil[:, None], uni[None, :], hop)
    hop = hop + config.exit_logp + config.word_insertion_penalty
    # entering silence carries no LM score or insertion penalty
    hop[:, is_sil] = config.exit_logp
    hop[np.ix_(is_sil, is_sil)] = -np.inf  # silence never follows itself
    pi_w[is_sil] = 0.0
    final_w[is_sil] = 0.0
    return pi_w, final_w, hop


def _word_lm_factors(
    words: Sequence[str],
    lm: Optional[NGramModel],
    config: "DecoderConfig",
    max_in_degree: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray, HopFactors, int]:
    """Backoff-factored equivalent of :func:`_word_lm_scores`:
    ``(log_pi_w, log_final_w, HopFactors of NumPy arrays, n_clamped)`` with
    the same composition semantics in O(V + E) memory. ``n_clamped``
    counts seen-bigram arcs raised to their own backoff estimate;
    ``max_in_degree`` keeps each destination's best explicit arcs."""
    v = len(words)
    is_sil = np.array([w == SILENCE for w in words])
    real = [w for w in words if w != SILENCE]
    n_real = len(real)
    scale = config.lm_scale * _LN10
    add = config.exit_logp + config.word_insertion_penalty

    if lm is None:
        flat = -math.log(n_real)
        uni = np.full(v, flat)
        alpha = np.zeros(v)
        pi_w = np.full(v, flat)
        final_w = np.zeros(v)
        edges: List[Tuple[int, int, float]] = []
    else:
        if lm.order < 2:
            raise ValueError("hop factors require a bigram or higher model")
        bigram = lm._level(2)
        unigram = bigram.backoff
        idx = {w: i for i, w in enumerate(words)}
        uni = scale * np.array([unigram.logprob(w, ()) for w in words])
        alpha = scale * np.array([bigram.prob_bo.get((w,), 0.0) for w in words])
        tbl_bos_eos = scale * np.array(
            [[bigram.logprob(w, (BOS,)) for w in words],
             [bigram.logprob(EOS, (w,)) if _has_eos(lm) else 0.0 for w in words]]
        )
        pi_w = tbl_bos_eos[0].copy()
        final_w = tbl_bos_eos[1].copy() if _has_eos(lm) else np.zeros(v)
        edges = []
        for ngram, p in bigram.prob.items():
            i, j = idx.get(ngram[0]), idx.get(ngram[1])
            if i is not None and j is not None and not (is_sil[i] or is_sil[j]):
                edges.append((i, j, scale * p + add))

    from_w = alpha + add
    from_w[is_sil] = add  # unigram rule out of silence (alpha plays no part)
    uni_dst = uni.copy()
    uni_dst[is_sil] = -np.inf  # silence entry rides sil_from instead
    sil_from = np.where(is_sil, -np.inf, config.exit_logp)
    sil_idx = int(np.flatnonzero(is_sil)[0]) if is_sil.any() else -1
    if sil_idx < 0:
        sil_from = np.full(v, -np.inf)
    pi_w = pi_w.copy()
    final_w = final_w.copy()
    pi_w[is_sil] = 0.0
    final_w[is_sil] = 0.0

    # per-destination predecessor lists, clamped to the backoff estimate
    n_clamped = 0
    by_dst: Dict[int, List[Tuple[int, float]]] = {}
    for i, j, val in edges:
        backoff = from_w[i] + uni_dst[j]
        if val < backoff:
            n_clamped += 1
            val = backoff
        by_dst.setdefault(j, []).append((i, val))
    if max_in_degree is not None:
        for j, plist in by_dst.items():
            if len(plist) > max_in_degree:
                plist.sort(key=lambda e: (-e[1], e[0]))
                del plist[max_in_degree:]
    k_max = max((len(p) for p in by_dst.values()), default=1)
    pred = np.zeros((v, k_max), np.int32)
    val_arr = np.full((v, k_max), -np.inf)
    for j, plist in by_dst.items():
        plist.sort()  # by source id: stable, reproducible layout
        for k, (i, val) in enumerate(plist):
            pred[j, k] = i
            val_arr[j, k] = val
    factors = HopFactors(from_w=from_w, uni=uni_dst, sil_from=sil_from,
                         sil_idx=np.int32(sil_idx), pred=pred, val=val_arr)
    return pi_w, final_w, factors, n_clamped


class HostBackoffHop:
    """Host-side (NumPy) accessor with dense-hop semantics over
    :class:`HopFactors`: O(in-degree) lookups per destination under the
    same clamped max semantics as the device search."""

    def __init__(self, factors: HopFactors):
        as_np = lambda x: x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)  # noqa: E731
        self.from_w = as_np(factors.from_w).astype(np.float64)
        self.uni = as_np(factors.uni).astype(np.float64)
        self.sil_from = as_np(factors.sil_from).astype(np.float64)
        self.sil_idx = int(factors.sil_idx)
        self.pred = as_np(factors.pred)
        self.val = as_np(factors.val).astype(np.float64)
        self.shape = (len(self.from_w), len(self.from_w))
        self._dst_map: Dict[int, Dict[int, float]] = {
            j: {int(s): float(x) for s, x in zip(self.pred[j], self.val[j]) if np.isfinite(x)}
            for j in range(self.shape[0])
        }

    def block(self, rows: np.ndarray, cols: np.ndarray) -> np.ndarray:
        """Dense ``(len(rows), len(cols))`` hop block (``rows`` may repeat)."""
        rows = np.asarray(rows)
        cols = np.asarray(cols)
        out = self.from_w[rows][:, None] + self.uni[cols][None, :]
        row_pos: Dict[int, List[int]] = {}
        for i, r in enumerate(rows):
            row_pos.setdefault(int(r), []).append(i)
        for cj, c in enumerate(cols):
            c = int(c)
            if c == self.sil_idx:
                out[:, cj] = self.sil_from[rows]
                continue
            for s, x in self._dst_map.get(c, {}).items():
                for i in row_pos.get(s, ()):
                    out[i, cj] = max(out[i, cj], x)
        return out

    def pair(self, src: int, dst: int) -> float:
        dst = int(dst)
        src = int(src)
        if dst == self.sil_idx:
            return float(self.sil_from[src])
        base = float(self.from_w[src] + self.uni[dst])
        return max(base, self._dst_map.get(dst, {}).get(src, -np.inf))

    def dense(self) -> np.ndarray:
        """Materialize the full matrix (tests / small-V tooling only)."""
        v = self.shape[0]
        return self.block(np.arange(v), np.arange(v))


@dataclasses.dataclass(frozen=True)
class DecoderConfig:
    """Decoding knobs: LM weight, insertion penalty (both in nats), the
    fixed log-probability of leaving a unit's last state, and whether the
    graph loops (connected words) or is single-shot (isolated word)."""

    lm_scale: float = 1.0
    word_insertion_penalty: float = 0.0
    exit_logp: float = math.log(0.5)
    loop: bool = True


def _np64(x) -> np.ndarray:
    """A unit parameter (NumPy array or tensor on any device) as float64."""
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def _emissions(obs, log_w, mu, cov, cov_type):
    if cov_type == "diag":
        return gmm_emissions_diag(obs, log_w, mu, cov)[0]
    return gmm_emissions_full(obs, log_w, mu, cov)[0]


class DecodingGraph:
    """Dense composed decoding graph over a vocabulary of word HMMs, held
    on one device (CUDA by default)."""

    SILENCE = SILENCE

    def __init__(self, words, log_a, log_pi, log_final, state_word, word_start, word_end,
                 emission_params, cov_type: str, dtype=torch.float32, device="cuda"):
        self.words = list(words)
        self.dtype = dtype
        self.device = resolve_device(device)
        self.cov_type = cov_type
        tensor = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=self.device)  # noqa: E731
        self.log_a = tensor(log_a)
        self.log_pi = tensor(log_pi)
        self.log_final = tensor(log_final)
        self.state_word = np.asarray(state_word)
        self.word_start = np.asarray(word_start)
        self.word_end = np.asarray(word_end)
        self.log_w, self.mu, self.cov = (tensor(x) for x in emission_params)

    @classmethod
    def build(cls, lexicon: Lexicon, unit_models: Mapping, lm: Optional[NGramModel] = None,
              config: DecoderConfig = DecoderConfig(), silence_model=None,
              dtype=torch.float32, device="cuda") -> "DecodingGraph":
        """Compose the dense graph. ``unit_models`` maps each pronunciation
        unit to a GMM-HMM (the port's :class:`GMMHMM`, or any object with
        ``n``, ``config.cov_type``, ``log_a``, ``log_w``, ``mu``, ``cov``);
        mixture counts may differ per unit. ``silence_model`` adds a
        background pseudo-word that may sit between and around words and
        never appears in the output."""
        words = sorted(lexicon.keys())
        lexicon = Lexicon({w: lexicon[w] for w in words})
        unit_models = dict(unit_models)
        if silence_model is not None:
            words = words + [cls.SILENCE]
            lexicon[cls.SILENCE] = (cls.SILENCE,)
            unit_models[cls.SILENCE] = silence_model
        cov_type = next(iter(unit_models.values())).config.cov_type

        state_word: List[int] = []
        blocks: List[Tuple[str, object, int]] = []  # (unit, model, word_idx)
        word_first: List[int] = []
        word_last: List[int] = []
        offset = 0
        for wi, word in enumerate(words):
            word_first.append(offset)
            for unit in lexicon[word]:
                model = unit_models[unit]
                blocks.append((unit, model, wi))
                state_word.extend([wi] * model.n)
                offset += model.n
            word_last.append(offset - 1)
        n_states = offset
        word_start = np.zeros(n_states, bool)
        word_end = np.zeros(n_states, bool)
        word_start[np.asarray(word_first)] = True
        word_end[np.asarray(word_last)] = True

        log_w, mu, cov = _stack_mixture_params(
            [_np64(m.log_w) for _, m, _ in blocks], [_np64(m.mu) for _, m, _ in blocks],
            [_np64(m.cov) for _, m, _ in blocks], cov_type)

        log_a = np.full((n_states, n_states), -np.inf)
        pos = 0
        unit_entries: List[int] = []
        for _, model, _ in blocks:
            n = model.n
            log_a[pos: pos + n, pos: pos + n] = _np64(model.log_a)
            unit_entries.append(pos)
            pos += n
        pos = 0
        for bi, (_, model, wi) in enumerate(blocks):  # unit -> next unit within a word
            last = pos + model.n - 1
            if bi + 1 < len(blocks) and blocks[bi + 1][2] == wi:
                log_a[last, unit_entries[bi + 1]] = config.exit_logp
            pos += model.n

        log_pi = np.full(n_states, -np.inf)
        log_final = np.full(n_states, -np.inf)
        pi_w, final_w, hop = _word_lm_scores(words, lm, config)
        first_arr, last_arr = np.asarray(word_first), np.asarray(word_last)
        log_pi[first_arr] = pi_w
        log_final[last_arr] = final_w
        if config.loop:
            # leave the (silence, silence) arc to the silence model itself
            sil = np.array([w == cls.SILENCE for w in words])
            block = log_a[np.ix_(last_arr, first_arr)]
            log_a[np.ix_(last_arr, first_arr)] = np.where(np.outer(sil, sil), block, hop)

        return cls(words, log_a, log_pi, log_final, np.asarray(state_word), word_start,
                   word_end, (log_w, mu, cov), cov_type, dtype, device)

    @property
    def n_states(self) -> int:
        return len(self.state_word)

    def decode_arrays(self, obs: torch.Tensor, mask: Optional[torch.Tensor]):
        """Device decode core: ``(features (T, D), mask (T,) or None) ->
        (path (T,) int32, score ())`` tensors on the graph's device."""
        log_b = _emissions(obs, self.log_w, self.mu, self.cov, self.cov_type)
        return dense_viterbi(self.log_pi, self.log_a, log_b, self.log_final, mask)

    def decode(self, features, mask=None) -> Tuple[List[str], np.ndarray, float]:
        """Viterbi over the composed graph: ``(words, per-frame composed-state
        path, score)``. A new word starts at frame 0 and at every entry-state
        arrival from a word-final state or another word; ``mask (T,)``
        marks valid frames of a shape-bucketed (padded) decode."""
        obs = torch.as_tensor(features, dtype=self.dtype, device=self.device)
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.bool, device=self.device)
        path, score = to_host(*self.decode_arrays(obs, mask))
        return self._path_to_words(path), path, float(score)

    def path_to_alignment(self, path: np.ndarray, n_frames: Optional[int] = None
                          ) -> List[Tuple[str, int, int]]:
        """``(word, start_frame, end_frame)`` per decoded word instance
        (inclusive frames; silence dropped); ``n_frames`` clips the final
        span of a masked decode, whose padded frames self-point."""
        ids = [int(self.state_word[path[0]])]
        starts = [0]
        for t in range(1, len(path)):
            s_prev, s = path[t - 1], path[t]
            if s == s_prev:
                continue
            if self.word_start[s] and (self.state_word[s] != self.state_word[s_prev]
                                       or self.word_end[s_prev]):
                ids.append(int(self.state_word[s]))
                starts.append(t)
        return _assemble_alignment(self.words, ids, starts, n_frames or len(path))

    def _path_to_words(self, path: np.ndarray) -> List[str]:
        return [w for w, _, _ in self.path_to_alignment(path)]


def _assemble_alignment(words: Sequence[str], ids: List[int], starts: List[int],
                        t_len: int) -> List[Tuple[str, int, int]]:
    """Word-instance spans from entry frames; silence dropped after the
    spans are fixed."""
    out = []
    for k, (wid, a) in enumerate(zip(ids, starts)):
        b = (starts[k + 1] - 1) if k + 1 < len(starts) else t_len - 1
        if words[wid] != SILENCE:
            out.append((words[wid], a, b))
    return out


def _has_eos(lm: NGramModel) -> bool:
    node = lm
    while node is not None:
        if any(EOS in ng for ng in node.prob):
            return True
        node = node.backoff
    return False


def _compose_words(lexicon: Lexicon, unit_models: Mapping, silence_model, exit_logp: float):
    """Per-word composition shared by the factored graphs: each word's unit
    HMMs concatenated into one ``(S_w, S_w)`` log-transition block (with
    unit->unit exit hops), and every real state's emission parameters
    stacked in word-major order. Returns ``(words, blocks,
    emission_params, state_offsets)``."""
    words = sorted(lexicon.keys())
    lexicon = Lexicon({w: lexicon[w] for w in words})
    unit_models = dict(unit_models)
    if silence_model is not None:
        words = words + [SILENCE]
        lexicon[SILENCE] = (SILENCE,)
        unit_models[SILENCE] = silence_model

    blocks: List[np.ndarray] = []
    log_w_parts, mu_parts, cov_parts = [], [], []
    state_offsets: List[int] = []
    offset = 0
    for word in words:
        models = [unit_models[u] for u in lexicon[word]]
        s_w = sum(m.n for m in models)
        block = np.full((s_w, s_w), -np.inf)
        pos = 0
        for k, m in enumerate(models):
            n = m.n
            block[pos: pos + n, pos: pos + n] = _np64(m.log_a)
            if k + 1 < len(models):
                block[pos + n - 1, pos + n] = exit_logp
            log_w_parts.append(_np64(m.log_w))
            mu_parts.append(_np64(m.mu))
            cov_parts.append(_np64(m.cov))
            pos += n
        blocks.append(block)
        state_offsets.append(offset)
        offset += s_w
    cov_type = next(iter(unit_models.values())).config.cov_type
    emission_params = _stack_mixture_params(log_w_parts, mu_parts, cov_parts, cov_type)
    return words, blocks, emission_params, state_offsets


def _stack_mixture_params(log_w_parts, mu_parts, cov_parts, cov_type):
    """Stack per-unit mixture parameters along the state axis, padding the
    mixture axis to the largest M with log-weight -inf dummy components
    (zero mean, unit variance / identity covariance)."""
    m_max = max(w.shape[1] for w in log_w_parts)
    ws, ms, cs = [], [], []
    for w, mu, cov in zip(log_w_parts, mu_parts, cov_parts):
        pad = m_max - w.shape[1]
        if pad:
            w = np.pad(w, ((0, 0), (0, pad)), constant_values=-np.inf)
            mu = np.pad(mu, ((0, 0), (0, pad), (0, 0)))
            if cov_type == "diag":
                cov = np.pad(cov, ((0, 0), (0, pad), (0, 0)), constant_values=1.0)
            else:
                d = cov.shape[-1]
                eye = np.broadcast_to(np.eye(d), (cov.shape[0], pad, d, d))
                cov = np.concatenate([cov, eye], axis=1)
        ws.append(w)
        ms.append(mu)
        cs.append(cov)
    return np.concatenate(ws), np.concatenate(ms), np.concatenate(cs)


def _factored_grid_inputs(obs, log_pi_w, log_final_w, exit_idx, state_map, pad_mask,
                          log_w, mu, cov, cov_type):
    """Decode inputs: grid emissions ``(..., T, V, S)`` (-inf at padded
    states), initial grid, termination grid."""
    v_words, s_max = state_map.shape
    log_b_real = _emissions(obs, log_w, mu, cov, cov_type)
    neg = torch.tensor(-math.inf, dtype=log_b_real.dtype, device=log_b_real.device)
    log_b = torch.where(pad_mask, log_b_real[..., state_map], neg)
    pi_grid = torch.full((v_words, s_max), -math.inf, dtype=log_b.dtype, device=log_b.device)
    pi_grid[:, 0] = log_pi_w.to(log_b.dtype)
    final_grid = torch.where(
        torch.arange(s_max, device=log_b.device)[None, :] == exit_idx[:, None],
        log_final_w[:, None].to(log_b.dtype), neg)
    return log_b, pi_grid, final_grid


def factored_trellis_scan(log_b, inner_a, hop, pi_grid, final_grid, exit_idx, mask=None):
    """Reference scan over the factored grid: ``(T, V, S)`` emissions ->
    ``(path (T,) int32 in v*S+s ids, score)``, with backpointers stored in
    the forward (the JAX package's ``factored_trellis_scan``). ``hop=None``
    disables the word loop; masked frames carry the identity operator
    (grid unchanged, self backpointers)."""
    t_len, v_words, s_max = log_b.shape
    dev = log_b.device
    word_base = torch.arange(v_words, dtype=torch.int32, device=dev)[:, None] * s_max
    self_ids = word_base + torch.arange(s_max, dtype=torch.int32, device=dev)[None, :]
    exit_l = exit_idx.long()
    valid = [True] * t_len if mask is None else mask.tolist()

    vgrid = pi_grid + log_b[0]
    bts = []
    for t in range(1, t_len):
        if not valid[t]:
            bts.append(self_ids)
            continue
        within, wsrc = torch.max(vgrid[:, :, None] + inner_a, dim=1)
        bt = word_base + wsrc.to(torch.int32)
        if hop is not None:
            exit_v = torch.gather(vgrid, 1, exit_l[:, None])[:, 0]
            entry, esrc = _hop_entry(exit_v, hop)
            hop_wins = entry > within[:, 0]
            within[:, 0] = torch.maximum(within[:, 0], entry)
            esrc_l = esrc.long()
            bt[:, 0] = torch.where(hop_wins, esrc * s_max + exit_idx[esrc_l].to(torch.int32),
                                   bt[:, 0])
        vgrid = within + log_b[t]
        bts.append(bt)

    # termination is restricted to word-final states
    score, last = torch.max((vgrid + final_grid).reshape(-1), dim=0)
    bt_host = (torch.stack(bts).reshape(t_len - 1, -1).cpu().numpy() if bts
               else np.zeros((0, v_words * s_max), np.int32))
    path = np.empty(t_len, np.int32)
    state = int(last)
    path[-1] = state
    for t in range(t_len - 2, -1, -1):
        state = int(bt_host[t, state])
        path[t] = state
    return torch.as_tensor(path, device=dev), score


class FactoredDecodingGraph:
    """Composed-word Viterbi on a ``(V, S)`` word-by-local-state grid:

      within[v, j] = max_s  v[v, s]   + inner_a[v, s, j]   (batched (V,S,S))
      entry[w]     = max_v  v[v, e_v] + hop[v, w]          ((V, V) reduction)
      new_v        = within with entry merged at local state 0, + emissions

    O(V S^2 + V^2) per frame instead of the dense graph's O((V S)^2), with
    the same words, paths and scores. The forward and the replay backtrace
    are the wrappers of ``ops/factored.py`` (kernels D and E on CUDA, their
    plain versions on the CPU) for every hop kind (:meth:`_decode_grid`):
    backoff factors with sparse edges go to them as a CSR of their finite
    arcs (:class:`~lnasr_tpu_torch.ops.factored.BackoffHop`)."""

    SILENCE = SILENCE
    # "auto" hop_mode switches to backoff factors past this vocabulary,
    # as in the JAX package (O(V^2) hop bytes per frame beyond it)
    DENSE_HOP_LIMIT = 1792

    def __init__(self, words, inner_a, exit_idx, state_map, pad_mask, log_pi_w, log_final_w,
                 hop, emission_params, cov_type: str, dtype=torch.float32, device="cuda"):
        self.words = list(words)
        self.dtype = dtype
        self.device = dev = resolve_device(device)
        self.cov_type = cov_type
        tensor = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)  # noqa: E731
        self.inner_a = tensor(inner_a)
        self.exit_idx = torch.as_tensor(np.asarray(exit_idx), dtype=torch.int32, device=dev)
        self._exit_idx_np = np.asarray(exit_idx)
        self.state_map = torch.as_tensor(np.asarray(state_map), dtype=torch.long, device=dev)
        self.pad_mask = torch.as_tensor(np.asarray(pad_mask), dtype=torch.bool, device=dev)
        self.log_pi_w = tensor(log_pi_w)
        self.log_final_w = tensor(log_final_w)
        # host copies for the lattice layer, so a lattice costs one copy
        self._host_pi_final = (self.log_pi_w.cpu().numpy(), self.log_final_w.cpu().numpy())
        self.hop_t = None  # the dense hop transposed, the kernels' layout
        self._kernel_hop = None
        if hop is None:
            self.hop = None
        elif isinstance(hop, HopFactors):
            self.hop = HopFactors(
                from_w=tensor(hop.from_w), uni=tensor(hop.uni), sil_from=tensor(hop.sil_from),
                sil_idx=int(hop.sil_idx),
                pred=torch.as_tensor(np.asarray(hop.pred), dtype=torch.int32, device=dev),
                val=tensor(hop.val))
        else:
            self.hop = tensor(hop)
            self.hop_t = self.hop.t().contiguous()
            self._kernel_hop = self.hop
        self.hop_clamped = 0  # set by build() in backoff mode
        self.hop_pruned_edges = 0  # set by build() in rank1 mode
        # edge-free factors (rank1 mode, or backoff with no LM) are
        # eligible for the rank-1 kernels
        self.hop_rank1_only = bool(isinstance(hop, HopFactors)
                                   and not np.isfinite(np.asarray(hop.val)).any())
        if self.hop_rank1_only:
            self._kernel_hop = Rank1Hop(self.hop.from_w, self.hop.uni, self.hop.sil_from,
                                        self.hop.sil_idx)
        elif isinstance(hop, HopFactors):  # the finite arcs in CSR by destination
            self._kernel_hop = backoff_hop(self.hop)
        self.log_w, self.mu, self.cov = (tensor(x) for x in emission_params)

    @classmethod
    def build(cls, lexicon: Lexicon, unit_models: Mapping, lm: Optional[NGramModel] = None,
              config: DecoderConfig = DecoderConfig(), silence_model=None,
              dtype=torch.float32, hop_mode: str = "auto",
              hop_max_in_degree: Optional[int] = None,
              device="cuda") -> "FactoredDecodingGraph":
        """Compose the factored graph (same inputs and semantics as
        :meth:`DecodingGraph.build`). ``hop_mode``: ``"dense"`` (the
        ``(V, V)`` matrix), ``"backoff"`` (:class:`HopFactors`, rank-1 plus
        sparse seen bigrams), ``"rank1"`` (the factors with the sparse arcs
        pruned: every hop scores alpha + unigram), or ``"auto"`` (dense up
        to :data:`DENSE_HOP_LIMIT` words, backoff beyond).
        ``hop_max_in_degree`` caps each destination's explicit arcs in
        backoff mode."""
        cov_type = next(iter(unit_models.values())).config.cov_type
        words, blocks, emission_params, state_offsets = _compose_words(
            lexicon, unit_models, silence_model, config.exit_logp)
        v = len(words)
        s_max = max(b.shape[0] for b in blocks)
        inner_a = np.full((v, s_max, s_max), -np.inf)
        state_map = np.zeros((v, s_max), np.int64)
        pad_mask = np.zeros((v, s_max), bool)
        exit_idx = np.zeros(v, np.int64)
        for wi, block in enumerate(blocks):
            s_w = block.shape[0]
            inner_a[wi, :s_w, :s_w] = block
            state_map[wi, :s_w] = state_offsets[wi] + np.arange(s_w)
            pad_mask[wi, :s_w] = True
            exit_idx[wi] = s_w - 1

        # a silence model's own last->first arc lives inside its inner_a
        # block, so the hop stays purely word-level (sil->sil = -inf)
        if hop_mode == "auto":
            hop_mode = "dense" if v <= cls.DENSE_HOP_LIMIT else "backoff"
        n_clamped = n_pruned = 0
        if hop_mode in ("backoff", "rank1"):
            pi_w, final_w, hop, n_clamped = _word_lm_factors(
                words, lm, config, max_in_degree=hop_max_in_degree)
            if hop_mode == "rank1":
                n_pruned = int(np.isfinite(hop.val).sum())
                hop = hop._replace(pred=np.zeros((v, 1), np.int32), val=np.full((v, 1), -np.inf))
        elif hop_mode == "dense":
            pi_w, final_w, hop = _word_lm_scores(words, lm, config)
        else:
            raise ValueError(f"unknown hop_mode: {hop_mode!r}")
        graph = cls(words, inner_a, exit_idx, state_map, pad_mask, pi_w, final_w,
                    hop if config.loop else None, emission_params, cov_type, dtype, device)
        graph.hop_clamped = n_clamped
        graph.hop_pruned_edges = n_pruned
        return graph

    @property
    def n_states(self) -> int:
        return int(self.pad_mask.sum())

    @property
    def grid_shape(self) -> Tuple[int, int]:
        return self.inner_a.shape[0], self.inner_a.shape[1]

    @property
    def has_kernel(self) -> bool:
        """Whether the graph's hop kind has kernels: true for every hop (a
        dense hop, edge-free factors, factors with sparse edges, none)."""
        return self.hop is None or self._kernel_hop is not None

    def host_hop(self):
        """Host-side hop accessor: the dense NumPy matrix, or a
        :class:`HostBackoffHop` over the factors (cached)."""
        if getattr(self, "_host_hop", None) is None:
            if isinstance(self.hop, HopFactors):
                self._host_hop = HostBackoffHop(self.hop)
            else:
                self._host_hop = self.hop.cpu().numpy()
        return self._host_hop

    def _grid_inputs(self, obs):
        return _factored_grid_inputs(obs, self.log_pi_w, self.log_final_w, self.exit_idx,
                                     self.state_map, self.pad_mask, self.log_w, self.mu,
                                     self.cov, self.cov_type)

    def _decode_grid(self, log_b, pi_grid, final_grid, mask):
        """The 1-best decode of one utterance's ``(T, V, S)`` emissions or a
        batch's ``(B, T, V, S)``: the forward and backtrace wrappers for
        every hop kind, kernels D and E on CUDA, one launch each (they
        raise past their capacity or off float32), and their plain versions
        on the CPU."""
        hop = self._kernel_hop
        grids = factored_forward(pi_grid, self.inner_a, self.exit_idx, hop, log_b, mask,
                                 hop_t=self.hop_t)
        return factored_backtrace(grids, self.inner_a, self.exit_idx, hop, final_grid, mask,
                                  hop_t=self.hop_t)

    def decode_arrays(self, obs: torch.Tensor, mask: Optional[torch.Tensor]):
        """Device decode core: ``(features (T, D), mask) -> (path (T,) int32
        in v*S+s ids, score ())`` (:meth:`_decode_grid`); every route gives
        the scan's results."""
        return self._decode_grid(*self._grid_inputs(obs), mask)

    def decode(self, features, mask=None) -> Tuple[List[str], np.ndarray, float]:
        """Viterbi over the factored graph: ``(words, per-frame grid state
        path word*S + local, score)``, with the dense graph's word-recovery
        rule; ``mask (T,)`` marks valid frames (padded frames are identity
        steps)."""
        obs = torch.as_tensor(features, dtype=self.dtype, device=self.device)
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.bool, device=self.device)
        path, score = to_host(*self.decode_arrays(obs, mask))
        return self._path_to_words(path), path, float(score)

    def _batch_pieces(self, log_b, lattice=False) -> List[Tuple[int, int]]:
        """The launches a batch of ``(B, T, V, S)`` emissions takes: on
        CUDA the row ranges of :func:`~lnasr_tpu_torch.ops.factored.
        cut_batch` (one unless the batch is past one launch's capacity), on
        the CPU the whole batch at once."""
        b, t_len, v, s = log_b.shape
        if log_b.device.type != "cuda":
            return [(0, b)] if b else []
        return cut_batch(b, t_len, v, s, self._kernel_hop, sm_count(log_b.device), lattice)

    def decode_batch_arrays(self, features, masks) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device decode of padded ``(B, T, D)`` features with ``(B, T)``
        masks: one emission product for the batch and one batched decode
        (:meth:`_decode_grid`; on CUDA the forward and backtrace kernels
        once each for the batch, or for each piece of :meth:`_batch_pieces`)
        -> ``(paths (B, T) int32, scores (B,))`` on the device."""
        obs = torch.as_tensor(features, dtype=self.dtype, device=self.device)
        masks = torch.as_tensor(masks, dtype=torch.bool, device=self.device)
        log_b, pi_grid, final_grid = self._grid_inputs(obs)
        outs = [self._decode_grid(log_b[i:j], pi_grid, final_grid, masks[i:j])
                for i, j in self._batch_pieces(log_b)]
        if not outs:
            return _stack_decodes([], obs, self.dtype)
        paths, scores = zip(*outs)
        return torch.cat(paths), torch.cat(scores)

    def decode_batch(self, features, masks) -> List[Tuple[List[str], np.ndarray, float]]:
        """:meth:`decode_batch_arrays` with one device->host copy for all
        and each path's words. Identical to looping :meth:`decode`."""
        return _batch_results(self, *self.decode_batch_arrays(features, masks))

    # -- lattices --------------------------------------------------------------

    def _lattice_grid(self, log_b, pi_grid, mask):
        """Records of one utterance's emissions or a batch's, for every hop
        kind:
        :func:`~lnasr_tpu_torch.ops.factored.factored_lattice`, kernel F on
        CUDA (which raises past its capacity or off float32) and its plain
        version on the CPU."""
        return factored_lattice(pi_grid, self.inner_a, self.exit_idx, self._kernel_hop, log_b,
                                mask, hop_t=self.hop_t)

    def lattice_records_arrays(self, obs: torch.Tensor, mask: Optional[torch.Tensor]):
        """Device lattice-record core: ``(features (T, D), mask) ->
        (exit_score, exit_start, exit_pred)`` ``(T, V)`` tensors on the
        graph's device: kernel F on CUDA, its plain version on the CPU
        (:meth:`_lattice_grid`); identical records. Unreachable records stay ``-inf``
        (the port has no finite sentinel to restore)."""
        log_b, pi_grid, _ = self._grid_inputs(obs)
        return self._lattice_grid(log_b, pi_grid, mask)

    def _require_loop(self):
        if self.hop is None:
            raise ValueError("lattice decoding requires a looped graph "
                             "(DecoderConfig(loop=True))")

    def lattice_from_records(self, score: np.ndarray, start: np.ndarray, pred: np.ndarray,
                             beam: float = 40.0, max_tokens_per_frame: Optional[int] = None):
        """A :class:`~lnasr_tpu_torch.models.lattice.WordLattice` from host
        records ``(n_valid, V)`` of this graph."""
        from lnasr_tpu_torch.models.lattice import WordLattice

        return WordLattice.from_records(
            self.words, score, start, pred, self.host_hop(), *self._host_pi_final, beam=beam,
            max_tokens_per_frame=max_tokens_per_frame)

    def decode_lattice(self, features, mask=None, beam: float = 40.0,
                       max_tokens_per_frame: Optional[int] = None):
        """Run the lattice-recording forward and build a word lattice.

        Its best path equals :meth:`decode` (same search, same scores); its
        N-best list and LM rescoring generalize it. ``beam`` keeps, per
        frame, only word-exit records within that many nats of the frame's
        best (``inf`` disables pruning); ``max_tokens_per_frame`` caps each
        frame's surviving records by rank. ``mask (T,)`` marks the valid
        prefix of a padded decode."""
        self._require_loop()
        obs = torch.as_tensor(features, dtype=self.dtype, device=self.device)
        n_valid = obs.shape[0]
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.bool)
            n_valid = int(mask.sum())
            mask = mask.to(self.device)
        recs = self.lattice_records_arrays(obs, mask)
        score, start, pred = records_to_host(*(r[:n_valid] for r in recs))
        return self.lattice_from_records(score, start, pred, beam, max_tokens_per_frame)

    def decode_lattice_batch(self, features, masks, beam: float = 40.0,
                             max_tokens_per_frame: Optional[int] = None):
        """Lattices of a padded ``(B, T, D)`` batch with ``(B, T)`` frame
        masks: one emission product for the batch, one batched record pass
        (on CUDA one launch of kernel F for the batch, or for each piece of
        :meth:`_batch_pieces`), one device->host copy for all. Identical to
        looping :meth:`decode_lattice`."""
        self._require_loop()
        obs = torch.as_tensor(features, dtype=self.dtype, device=self.device)
        masks = torch.as_tensor(masks, dtype=torch.bool)
        n_valid = masks.sum(dim=1).tolist()
        masks = masks.to(self.device)
        log_b, pi_grid, _ = self._grid_inputs(obs)
        recs = [self._lattice_grid(log_b[i:j], pi_grid, masks[i:j])
                for i, j in self._batch_pieces(log_b, lattice=True)]
        if not recs:
            return []
        score, start, pred = records_to_host(*(torch.cat(r) for r in zip(*recs)))
        return [self.lattice_from_records(score[b, :n], start[b, :n], pred[b, :n], beam,
                                          max_tokens_per_frame)
                for b, n in enumerate(n_valid)]

    def path_to_alignment(self, path: np.ndarray, n_frames: Optional[int] = None
                          ) -> List[Tuple[str, int, int]]:
        """``(word, start_frame, end_frame)`` per decoded word instance
        (inclusive frames; silence dropped), see
        :meth:`DecodingGraph.path_to_alignment`."""
        s_max = self.grid_shape[1]
        path = np.asarray(path)
        word_ids, locals_ = path // s_max, path % s_max
        ids = [int(word_ids[0])]
        starts = [0]
        for t in range(1, len(path)):
            if path[t] == path[t - 1]:
                continue
            if locals_[t] == 0 and (word_ids[t] != word_ids[t - 1]
                                    or locals_[t - 1] == self._exit_idx_np[word_ids[t - 1]]):
                ids.append(int(word_ids[t]))
                starts.append(t)
        return _assemble_alignment(self.words, ids, starts, n_frames or len(path))

    def _path_to_words(self, path: np.ndarray) -> List[str]:
        return [w for w, _, _ in self.path_to_alignment(path)]


class TrigramDecodingGraph:
    """Exact trigram-LM decoding by expanding the factored graph with the
    one-word LM history (the JAX package's ``TrigramDecodingGraph``).

    Search states are ``(h, w, s)``: history word h (V words, then one
    sentence-begin slot), current word w, local state s. Within-word
    transitions keep the copy; the word hop moves ``(., u) -> (u, w)`` with
    the full trigram score ``P(w | h, u)``. Sentence begin and end use
    ``P(w | <s>)`` and ``P(</s> | h, w)``. Memory is O(V^2 S) of state and
    O(V^3) for the dense hop: exact decoding for vocabularies of a few
    hundred words. An order-2 LM broadcasts its bigram table over the
    histories, and the search is then the factored bigram graph's.

    With a ``silence_model``, silence is a pseudo-word whose copy keeps the
    pre-silence word as its history slot, so a hop across silence scores
    with the bigram of the pre-silence word.

    The decode is kernel H (``ops/trigram.py``), the port of the JAX
    package's jitted ``lax.scan`` (it has no Pallas kernel): on CUDA one
    launch for the forward, which stores ``(T-1, H*V*S)`` int32
    backpointers, and one for the walk back, so ``(path, score)`` come to
    the host in one copy; on CPU the plain frame loop. A batch
    (:meth:`decode_batch`, the JAX package's vmapped decode) takes one
    launch of each for all its utterances, or one for each piece of
    :func:`~lnasr_tpu_torch.ops.trigram.trigram_cut`.
    """

    SILENCE = SILENCE

    def __init__(self, words, inner_a, exit_idx, state_map, pad_mask, log_pi_w, final3, hop3,
                 emission_params, cov_type: str, dtype=torch.float32, device="cuda"):
        self.words = list(words)
        self.dtype = dtype
        self.device = dev = resolve_device(device)
        self.cov_type = cov_type
        tensor = lambda x: torch.as_tensor(np.asarray(x), dtype=dtype, device=dev)  # noqa: E731
        self.inner_a = tensor(inner_a)
        self.exit_idx = torch.as_tensor(np.asarray(exit_idx), dtype=torch.int64, device=dev)
        self._exit_idx32 = self.exit_idx.to(torch.int32)  # what kernel H reads
        self._exit_idx_np = np.asarray(exit_idx)
        self.state_map = torch.as_tensor(np.asarray(state_map), dtype=torch.long, device=dev)
        self.pad_mask = torch.as_tensor(np.asarray(pad_mask), dtype=torch.bool, device=dev)
        self.log_pi_w = tensor(log_pi_w)
        self.final3 = tensor(final3)
        self.hop3 = tensor(hop3)
        self.log_w, self.mu, self.cov = (tensor(x) for x in emission_params)

    @classmethod
    def build(cls, lexicon: Lexicon, unit_models: Mapping, lm: NGramModel,
              config: DecoderConfig = DecoderConfig(), silence_model=None,
              dtype=torch.float32, max_table_bytes: float = 1 << 30,
              device="cuda") -> "TrigramDecodingGraph":
        """Compose the history-expanded graph (same inputs as
        :meth:`FactoredDecodingGraph.build`; the LM is required). Fails
        before building the ``(V+1, V, V)`` hop tensor when it would exceed
        ``max_table_bytes``."""
        if lm is None:
            raise ValueError("TrigramDecodingGraph requires a language model")
        if not config.loop:
            raise ValueError("history expansion is for connected decoding")
        v_est = len(lexicon) + (1 if silence_model is not None else 0)
        hop_bytes = (v_est + 1) * v_est * v_est * torch.finfo(dtype).bits // 8
        if hop_bytes > max_table_bytes:
            raise ValueError(
                f"trigram history expansion needs a ({v_est + 1}, {v_est}, {v_est}) hop "
                f"tensor ({hop_bytes / 2**20:.0f} MiB > budget {max_table_bytes / 2**20:.0f} "
                "MiB). For this vocabulary decode with FactoredDecodingGraph and rescore the "
                "word lattice with the trigram LM (decode_lattice().rescore(lm): the same "
                "objective, O(V*S^2 + V^2) instead of O(V^3)); or raise max_table_bytes "
                "explicitly.")
        cov_type = next(iter(unit_models.values())).config.cov_type
        words, blocks, emission_params, state_offsets = _compose_words(
            lexicon, unit_models, silence_model, config.exit_logp)
        v = len(words)
        s_max = max(b.shape[0] for b in blocks)
        inner_a = np.full((v, s_max, s_max), -np.inf)
        state_map = np.zeros((v, s_max), np.int64)
        pad_mask = np.zeros((v, s_max), bool)
        exit_idx = np.zeros(v, np.int64)
        for wi, block in enumerate(blocks):
            s_w = block.shape[0]
            inner_a[wi, :s_w, :s_w] = block
            state_map[wi, :s_w] = state_offsets[wi] + np.arange(s_w)
            pad_mask[wi, :s_w] = True
            exit_idx[wi] = s_w - 1

        scale = config.lm_scale * _LN10
        has_eos = _has_eos(lm)
        wip = config.word_insertion_penalty
        # history rows: the V words (silence included), then <s>
        s2 = scale * lm.score_table(list(words) + [BOS, EOS])
        hsel = list(range(v)) + [v]
        if lm.order >= 3:
            t3 = scale * lm.score_table_trigram(list(words) + [BOS, EOS])
            hop3 = t3[hsel][:, :v, :v].copy()
            final3 = t3[hsel][:, :v, v + 1].copy() if has_eos else np.zeros((v + 1, v))
        else:
            hop3 = np.broadcast_to(s2[:v, :v], (v + 1, v, v)).copy()
            final3 = (np.broadcast_to(s2[:v, v + 1], (v + 1, v)).copy()
                      if has_eos else np.zeros((v + 1, v)))
        pi_w = s2[v, :v].copy()
        hop3 = hop3 + config.exit_logp + wip
        if silence_model is not None:
            si = v - 1  # _compose_words appends silence last
            # leaving silence from copy (h, sil): bigram P(w | h), the
            # pre-silence word having survived as the copy's history
            hop3[:, si, :] = s2[hsel, :v] + config.exit_logp + wip
            # a copy whose history is silence scores its next hop with the
            # bigram of its current word
            hop3[si, :, :] = s2[:v, :v] + config.exit_logp + wip
            # entering silence: exit penalty only, no LM or insertion cost
            hop3[:, :, si] = config.exit_logp
            hop3[:, si, si] = -np.inf  # silence never follows itself
            pi_w[si] = 0.0
            final3[:, si] = 0.0
            final3[si, :] = s2[:v, v + 1] if has_eos else 0.0
            final3[si, si] = 0.0
        return cls(words, inner_a, exit_idx, state_map, pad_mask, pi_w, final3, hop3,
                   emission_params, cov_type, dtype, device)

    @property
    def grid_shape(self) -> Tuple[int, int, int]:
        h, v, _ = self.hop3.shape
        return h, v, self.inner_a.shape[1]

    def _decode_log_b(self, log_b: torch.Tensor, mask: Optional[torch.Tensor]):
        """The decode core on grid emissions ``(T, V, S)``: ``(path (T,)
        int32 in (h*V + w)*S + s ids, score ())`` on the graph's device, or
        on a batch's ``(B, T, V, S)`` with ``(B, T)`` masks: ``(paths (B,
        T), scores (B,))``, by :func:`ops.trigram.trigram_viterbi` (kernel
        H's forward and backtrace on CUDA, one launch each; the plain frame
        loop on CPU), with the JAX package's tie rules."""
        return trigram_viterbi(log_b, mask, self.inner_a, self.hop3, self.log_pi_w,
                               self.final3, self._exit_idx32)

    def _grid_log_b(self, obs: torch.Tensor) -> torch.Tensor:
        """Grid emissions ``(..., T, V, S)``, -inf at padded states."""
        log_b_real = _emissions(obs, self.log_w, self.mu, self.cov, self.cov_type)
        neg = torch.tensor(-math.inf, dtype=log_b_real.dtype, device=log_b_real.device)
        return torch.where(self.pad_mask, log_b_real[..., self.state_map], neg)

    def decode_arrays(self, obs: torch.Tensor, mask: Optional[torch.Tensor]):
        """Device decode core: ``(features (T, D), mask (T,) or None) ->
        (path (T,) int32, score ())`` tensors on the graph's device."""
        return self._decode_log_b(self._grid_log_b(obs), mask)

    def decode(self, features, mask=None) -> Tuple[List[str], np.ndarray, float]:
        """Viterbi over the history-expanded graph: ``(words, per-frame
        state path (h*V + w)*S + s, score)``; ``mask (T,)`` marks valid
        frames (padded frames are identity steps)."""
        obs = torch.as_tensor(features, dtype=self.dtype, device=self.device)
        if mask is not None:
            mask = torch.as_tensor(mask, dtype=torch.bool, device=self.device)
        path, score = to_host(*self.decode_arrays(obs, mask))
        return self._path_to_words(path), path, float(score)

    def _batch_pieces(self, log_b: torch.Tensor) -> List[Tuple[int, int]]:
        """The launches a batch of ``(B, T, V, S)`` emissions takes: on CUDA
        the row ranges of :func:`~lnasr_tpu_torch.ops.trigram.trigram_cut`
        (one unless the batch is past one launch's capacity), on the CPU,
        or for an empty batch, the whole batch at once."""
        b, t_len, v, s = log_b.shape
        if log_b.device.type != "cuda" or b == 0:
            return [(0, b)]
        return trigram_cut(b, t_len, v + 1, v, s, log_b.dtype.itemsize, sm_count(log_b.device))

    def decode_batch_arrays(self, features, masks) -> Tuple[torch.Tensor, torch.Tensor]:
        """Device decode of padded ``(B, T, D)`` features with ``(B, T)``
        masks: one emission product for the batch and one batched decode
        (:meth:`_decode_log_b`: on CUDA kernel H's forward and backtrace
        once each for the batch, or for each piece of :meth:`_batch_pieces`;
        the batched frame loop on the CPU) -> ``(paths (B, T) int32, scores
        (B,))`` on the device, each row bitwise its single decode."""
        obs = torch.as_tensor(features, dtype=self.dtype, device=self.device)
        masks = torch.as_tensor(masks, dtype=torch.bool, device=self.device)
        log_b = self._grid_log_b(obs)
        paths, scores = zip(*(self._decode_log_b(log_b[i:j], masks[i:j])
                              for i, j in self._batch_pieces(log_b)))
        return torch.cat(paths), torch.cat(scores)

    def decode_batch(self, features, masks) -> List[Tuple[List[str], np.ndarray, float]]:
        """:meth:`decode_batch_arrays` with one device->host copy for all
        and each path's words. Identical to looping :meth:`decode`."""
        return _batch_results(self, *self.decode_batch_arrays(features, masks))

    def path_to_alignment(self, path: np.ndarray, n_frames: Optional[int] = None
                          ) -> List[Tuple[str, int, int]]:
        """``(word, start_frame, end_frame)`` per decoded word instance
        (inclusive frames; silence dropped), see
        :meth:`DecodingGraph.path_to_alignment`."""
        _, v_words, s_max = self.grid_shape
        path = np.asarray(path)
        copy_ids, locals_ = path // s_max, path % s_max
        word_ids = copy_ids % v_words
        ids = [int(word_ids[0])]
        starts = [0]
        for t in range(1, len(path)):
            if path[t] == path[t - 1]:
                continue
            if locals_[t] == 0 and (copy_ids[t] != copy_ids[t - 1]
                                    or locals_[t - 1] == self._exit_idx_np[word_ids[t - 1]]):
                ids.append(int(word_ids[t]))
                starts.append(t)
        return _assemble_alignment(self.words, ids, starts, n_frames or len(path))

    def _path_to_words(self, path: np.ndarray) -> List[str]:
        return [w for w, _, _ in self.path_to_alignment(path)]
