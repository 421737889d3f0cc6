"""Corpus-scale LM + decode stress, the port of the JAX package's
``bench_corpus.py``.

    python -m lnasr_tpu_torch.bench.corpus [--device cuda] [--sentences 12000] \\
        [--vocab 6000] [--decode-vocab 1000] [--out FILE]

The reference's own tests target THCHS-30 / icwb2-scale data
(``test/ngram-test.py:4-8``); those corpora are not in the repository, so
a synthetic corpus at the same scale drives the same code paths:

1. a ``--sentences`` corpus over a ``--vocab`` word Zipf-distributed
   vocabulary with class-based bigram structure (:func:`make_corpus`);
2. order-3 Katz (fixed discount) and completed-Good-Turing models; the
   held-out perplexity must be finite, and Good-Turing must beat the
   fixed discount;
3. an ARPA round trip: save -> parse -> identical held-out perplexity;
4. the ``score_table`` / ``score_table_trigram`` build times at a
   ``--decode-vocab`` word decode vocabulary;
5. a trained ``--decode-vocab`` word factored-graph decode on the device
   (emissions planted on a corpus sentence; on CUDA the factored forward
   and backtrace kernels), the backoff-factored hop's decode (the scan),
   and lattice N-best (the lattice-recording kernel on CUDA) with
   trigram rescoring.

Prints one JSON line, also to ``--out`` when that is given. A failed
check raises (exit code 1).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time
import types

import numpy as np
import torch

from lnasr_tpu_torch.bench import describe_device, synchronize


def make_corpus(n_sent, vocab_size, rng):
    """Zipf unigram + low-rank bigram structure (class-based chains):
    ``n_sent`` sentences of 3-13 words ``w00000``... with ``<s>``/``</s>``."""
    words = np.array([f"w{i:05d}" for i in range(vocab_size)])
    base_p = 1.0 / (np.arange(1, vocab_size + 1) ** 1.05)
    base_p /= base_p.sum()
    n_classes = 32
    cls = rng.integers(0, n_classes, vocab_size)
    # class transition matrix: each class prefers a few successors
    ct = rng.dirichlet(np.ones(n_classes) * 0.3, size=n_classes)
    sents = []
    for _ in range(n_sent):
        k = int(rng.integers(3, 14))
        sent = []
        c = int(rng.integers(n_classes))
        for _ in range(k):
            c = int(rng.choice(n_classes, p=ct[c]))
            members = np.flatnonzero(cls == c)
            p = base_p[members] / base_p[members].sum()
            sent.append(str(words[rng.choice(members, p=p)]))
        sents.append(tuple(["<s>"] + sent + ["</s>"]))
    return sents


def _check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def run(args) -> dict:
    from lnasr_tpu_torch.config import GMMHMMConfig, NGramConfig
    from lnasr_tpu_torch.models.decoder import DecoderConfig, FactoredDecodingGraph
    from lnasr_tpu_torch.models.lexicon import Lexicon
    from lnasr_tpu_torch.models.ngram import NGramCounter, NGramModel, NGramModelARPA
    from lnasr_tpu_torch.utils.metrics import edit_distance

    device = args.device
    rng = np.random.default_rng(0)
    t0 = time.perf_counter()
    sents = make_corpus(args.sentences, args.vocab, rng)
    held_out, train = sents[:200], sents[200:]
    seen_vocab = sorted({w for s in train for w in s})
    t_corpus = time.perf_counter() - t0
    t0 = time.perf_counter()
    counter = NGramCounter(3, train)
    t_count = time.perf_counter() - t0

    def ppl(model):
        # held-out sentences may contain unseen words; score with
        # open_vocab models, or skip OOV for closed ones
        tot, n = 0.0, 0
        vocab = set(model.vocabulary())
        for s in held_out:
            toks = tuple(w for w in s if w in vocab)
            if len(toks) < 3:
                continue
            tot += model.calc_prob(toks)
            n += len(toks)
        return 10.0 ** (-tot / n)

    out = {"sentences": len(sents), "train_vocab": len(seen_vocab),
           "timings_s": {"corpus_gen": round(t_corpus, 2), "count": round(t_count, 2)}}
    models = {}
    for name, cfg in [("katz_fixed", NGramConfig(order=3, smoothing="fixed")),
                      ("good_turing", NGramConfig(order=3, smoothing="good-turing"))]:
        t0 = time.perf_counter()
        m = NGramModel(counter, cfg)
        dt = time.perf_counter() - t0
        p = ppl(m)
        models[name] = m
        out[name] = {"estimate_s": round(dt, 2), "held_out_ppl": round(p, 2)}
        _check(np.isfinite(p), f"{name} perplexity not finite")
    _check(out["good_turing"]["held_out_ppl"] < out["katz_fixed"]["held_out_ppl"],
           f"Good-Turing ({out['good_turing']}) does not beat the fixed discount "
           f"({out['katz_fixed']})")

    # ARPA round trip at scale
    m = models["good_turing"]
    with tempfile.TemporaryDirectory(prefix="lnasr_corpus_") as tmp:
        arpa_path = os.path.join(tmp, "corpus.lm")
        t0 = time.perf_counter()
        NGramModelARPA().save(m, arpa_path)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        m2 = NGramModel(NGramModelARPA().load(arpa_path))
        t_load = time.perf_counter() - t0
        size_mb = os.path.getsize(arpa_path) / 1e6
    p1, p2 = ppl(m), ppl(m2)
    out["arpa"] = {"save_s": round(t_save, 2), "load_s": round(t_load, 2),
                   "size_mb": round(size_mb, 2), "ppl_before": round(p1, 4),
                   "ppl_after": round(p2, 4),
                   "roundtrip_ok": bool(abs(p1 - p2) < 1e-6 * max(p1, 1.0))}
    _check(out["arpa"]["roundtrip_ok"], f"ARPA ppl drift: {p1} vs {p2}")

    # vectorized score-table builds at decode-vocabulary scale
    decode_words = [w for w in seen_vocab[: args.decode_vocab] if w not in ("<s>", "</s>")]
    t0 = time.perf_counter()
    tbl = m.score_table(decode_words)
    t_tbl = time.perf_counter() - t0
    n3 = min(200, len(decode_words))
    t0 = time.perf_counter()
    m.score_table_trigram(decode_words[:n3])
    t_tbl3 = time.perf_counter() - t0
    out["score_tables"] = {
        "bigram_words": len(decode_words), "bigram_build_s": round(t_tbl, 2),
        "trigram_words": n3, "trigram_build_s": round(t_tbl3, 2),
        "bigram_finite_frac": float(np.isfinite(np.asarray(tbl)).mean()),
    }

    # the trained decode-vocabulary factored-graph decode on the device
    dim, n_states = 8, 3
    v = len(decode_words)
    cfg = GMMHMMConfig(n_states=n_states, n_mix=1, dim=dim)
    # words come in clusters of 4 acoustically confusable neighbours
    # (base mean + small jitter), so the lattice carries real alternatives
    base = rng.normal(scale=30.0, size=(-(-v // 4), dim))
    means = base[np.arange(v) // 4] + rng.normal(scale=0.6, size=(v, dim))
    with np.errstate(divide="ignore"):
        log_a = np.log(np.where(np.eye(n_states) + np.eye(n_states, k=1) > 0,
                                0.5, 0.0)).astype(np.float32)
    units = {
        w: types.SimpleNamespace(
            n=n_states, config=cfg, log_a=log_a,
            log_w=np.zeros((n_states, 1), np.float32),
            mu=(means[i][None, None, :]
                + np.arange(n_states)[:, None, None] * 0.5).astype(np.float32),
            cov=np.full((n_states, 1, dim), 1.0, np.float32),
        )
        for i, w in enumerate(decode_words)
    }
    lex = Lexicon({w: (w,) for w in decode_words})
    dcfg = DecoderConfig(loop=True, lm_scale=1.0)
    t0 = time.perf_counter()
    graph = FactoredDecodingGraph.build(lex, units, m, dcfg, dtype=torch.float32, device=device)
    t_build = time.perf_counter() - t0

    # plant a corpus sentence's word sequence in the emissions, at a noise
    # level that leaves the confusable cluster neighbours alive in the
    # search (real N-best material, not a one-path lattice)
    planted = [w for w in train[0] if w in units][:8]
    if len(planted) < 3:
        planted = decode_words[:5]
    state_map, mu = graph.state_map.cpu().numpy(), graph.mu.cpu().numpy()
    frames = []
    for w in planted:
        wi = graph.words.index(w)
        for s in range(n_states):
            frames += [mu[state_map[wi, s], 0] + rng.normal(scale=1.0, size=dim)] * 4
    frames = torch.as_tensor(np.asarray(frames, np.float32), device=device)
    t0 = time.perf_counter()
    words_out, _, score = graph.decode(frames)
    t_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    words_out, _, score = graph.decode(frames)
    t_decode = time.perf_counter() - t0
    dist, _ = edit_distance(planted, words_out)
    out["decode"] = {
        "vocab": v, "graph_build_s": round(t_build, 2), "first_decode_s": round(t_first, 2),
        "warm_decode_s": round(t_decode, 4), "frames": int(frames.shape[0]),
        "planted_recovered": words_out == planted, "edit_distance_to_planted": int(dist),
        "device": describe_device(device),
    }
    # the 1-best may confuse cluster neighbours (built in on purpose), but
    # every error must stay within the acoustic cluster
    idx = {w: int(w[1:]) for w in decode_words}

    def cluster_ok(ref, hyp):
        extra = [w for w in hyp if w not in ref]
        return all(any(idx[e] // 4 == idx[r] // 4 for r in ref) for e in extra)

    _check(dist <= max(1, len(planted) // 2) and cluster_ok(planted, words_out),
           f"planted {planted}, decoded {words_out}")

    # the backoff-factored hop (the large-vocabulary realization) must
    # decode the same words without a (V, V) matrix
    t0 = time.perf_counter()
    graph_bo = FactoredDecodingGraph.build(lex, units, m, dcfg, dtype=torch.float32,
                                           hop_mode="backoff", device=device)
    t_build_bo = time.perf_counter() - t0
    words_bo, _, _ = graph_bo.decode(frames)
    out["decode"]["backoff_mode"] = {
        "graph_build_s": round(t_build_bo, 2),
        "k_max_in_degree": int(graph_bo.hop.pred.shape[1]),
        "clamped_arcs": graph_bo.hop_clamped,
        "words_match_dense": words_bo == words_out,
    }
    _check(words_bo == words_out, "backoff-mode decode diverged")

    # lattice N-best + trigram rescoring through the same graph: the
    # lattice must carry real alternatives (>= 5 hypotheses) and trigram
    # rescoring must reorder the bigram list
    t0 = time.perf_counter()
    lattice = graph.decode_lattice(frames)
    synchronize(device)
    t_lat = time.perf_counter() - t0
    bigram_hyps = lattice.nbest(50)
    t0 = time.perf_counter()
    hyps = lattice.rescore(m, n=50, pool=200)
    t_rescore50 = time.perf_counter() - t0
    bigram_order = [tuple(h.words) for h in bigram_hyps]
    rescored_order = [tuple(h.words) for h in hyps]
    rank_changed = any(bigram_order.index(w) != i for i, w in enumerate(rescored_order)
                       if w in bigram_order)
    d_res, _ = edit_distance(planted, list(hyps[0].words))
    out["lattice"] = {
        "decode_lattice_s": round(t_lat, 2), "rescore_n50_s": round(t_rescore50, 3),
        "top_matches_planted": hyps[0].words == planted, "n_hyps": len(hyps),
        "n_distinct_bigram_hyps": len(set(bigram_order)),
        "rescoring_reordered": bool(rank_changed), "tokens": len(lattice),
        "planted_in_rescored_list": tuple(planted) in {tuple(h.words) for h in hyps},
        "rescored_top_edit_distance": int(d_res),
    }
    _check(len(hyps) >= 5, f"degenerate N-best: {len(hyps)} hypotheses")
    _check(rank_changed, "trigram rescoring changed no ranks")
    # rescoring with the full trigram must not be worse than the bigram
    # search's 1-best on the planted sequence
    _check(d_res <= dist, f"rescoring hurt: {d_res} vs bigram 1-best {dist}")

    out["metric"] = "corpus-scale LM + 1k-word decode stress"
    out["value"] = out["good_turing"]["held_out_ppl"]
    out["unit"] = "held-out perplexity (order-3 Good-Turing)"
    return out


def main(argv=None) -> int:
    from lnasr_tpu_torch._device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--sentences", type=int, default=12000)
    ap.add_argument("--vocab", type=int, default=6000)
    ap.add_argument("--decode-vocab", type=int, default=1000)
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args(argv)
    args.device = resolve_device(args.device)
    line = json.dumps(run(args))
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fp:
            fp.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
