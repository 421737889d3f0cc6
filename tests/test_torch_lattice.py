"""The port's word lattices (kernel F's CPU path, ``ops/factored.py``; the
scan and lattice methods of ``models/decoder.py``; ``models/lattice.py``)
against the JAX package on identical inputs.

Both packages' graphs are built from the same duck-typed NumPy units and
the same corpus; the JAX package computes the grid emissions once and both
record lattices from them. The records follow the same max-plus adds and
first-index argmaxes, so they are exact: starts and preds equal, scores
bitwise with ``-inf`` at the same places. Lattices built from one set of
records are host NumPy in both packages: tokens equal, hypotheses the same
word lists, scores, posteriors and rescored scores within ``rtol=1e-6``.
The TPU kernel runs in interpret mode at one tiny shape; it carries
unreachable states at a finite -1e30, so its scores are compared clipped
there, as the JAX package's own tests compare them.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lnasr_tpu.config import GMMHMMConfig as JGMMHMMConfig
from lnasr_tpu.models import decoder as jdec
from lnasr_tpu.models.lattice import WordLattice as JWordLattice
from lnasr_tpu.models.lattice import lm_conditional as j_lm_conditional
from lnasr_tpu.models.lexicon import Lexicon as JLexicon
from lnasr_tpu.models.ngram import NGramCounter as JNGramCounter
from lnasr_tpu.models.ngram import NGramModel as JNGramModel
from lnasr_tpu.ops.factored_pallas import factored_lattice_pallas
from lnasr_tpu.ops.trellis_pallas import NEG
from lnasr_tpu_torch.models import decoder as tdec
from lnasr_tpu_torch.models.lattice import WordLattice, WordToken, lm_conditional
from lnasr_tpu_torch.models.lexicon import Lexicon
from lnasr_tpu_torch.models.ngram import NGramCounter, NGramModel
from lnasr_tpu_torch.ops import factored as F

DIM = 5
RTOL = 1e-6


def _unit(mean, n_states, rng):
    with np.errstate(divide="ignore"):
        log_a = np.log(np.where(np.eye(n_states) + np.eye(n_states, k=1) > 0, 0.5, 0.0))
    return types.SimpleNamespace(
        n=n_states, config=JGMMHMMConfig(n_states=n_states, n_mix=1, dim=DIM),
        log_a=log_a.astype(np.float32), log_w=np.zeros((n_states, 1), np.float32),
        mu=(mean[None, None, :] + rng.normal(scale=0.3, size=(n_states, 1, DIM))).astype(np.float32),
        cov=np.full((n_states, 1, DIM), 0.1, np.float32))


def _world(v, hop_mode="dense", loop=True, seed=0, with_sil=True):
    """The same factored graph in both packages plus what built it:
    ``(jax graph, port graph, rng, corpus)``; word lengths 2-4 states."""
    rng = np.random.default_rng(seed)
    means = rng.normal(scale=8.0, size=(v + 1, DIM))
    units = {f"w{i:03d}": _unit(means[i], 2 + i % 3, rng) for i in range(v)}
    names = sorted(units)
    corpus = [tuple(["<s>"] + list(rng.choice(names, size=3)) + ["</s>"]) for _ in range(40)]
    kw = dict(silence_model=_unit(means[v], 2, rng) if with_sil else None, hop_mode=hop_mode)
    cfg = dict(loop=loop, lm_scale=0.7, word_insertion_penalty=-0.5)
    jg = jdec.FactoredDecodingGraph.build(
        JLexicon.whole_word(names), units, JNGramModel(JNGramCounter(2, corpus)),
        jdec.DecoderConfig(**cfg), dtype=jnp.float32, **kw)
    tg = tdec.FactoredDecodingGraph.build(
        Lexicon.whole_word(names), units, NGramModel(NGramCounter(2, corpus)),
        tdec.DecoderConfig(**cfg), device="cpu", **kw)
    return jg, tg, rng, corpus


def _grid_inputs(jg, obs):
    out = jdec._factored_grid_inputs(
        jnp.asarray(obs, jnp.float32), jg.log_pi_w, jg.log_final_w, jg.exit_idx, jg.state_map,
        jg.pad_mask, jg.log_w, jg.mu, jg.cov, jg.cov_type)
    return [np.asarray(x) for x in out]


def _planted(jg, words, rng, noise=1.0):
    """Frames near the model's means along ``words`` (2 per state)."""
    mu = np.asarray(jg.mu)[:, 0]
    sm, pm = np.asarray(jg.state_map), np.asarray(jg.pad_mask)
    frames = []
    for w in words:
        wi = jg.words.index(w)
        for s in np.flatnonzero(pm[wi]):
            frames += [mu[sm[wi, s]] + rng.normal(scale=noise, size=DIM) for _ in range(2)]
    return np.asarray(frames, np.float32)


def _t(x):
    return torch.as_tensor(np.array(x))


def _assert_records_equal(got, ref):
    """Scores bitwise (``-inf`` at the same places), starts and preds exact."""
    g_s, g_st, g_p = (np.asarray(x) for x in got[:3])
    r_s, r_st, r_p = (np.asarray(x) for x in ref[:3])
    assert g_st.dtype == np.int32 and g_p.dtype == np.int32
    np.testing.assert_array_equal(np.isfinite(g_s), np.isfinite(r_s))
    np.testing.assert_array_equal(g_s.view(np.int32), r_s.view(np.int32))
    np.testing.assert_array_equal(g_st, r_st)
    np.testing.assert_array_equal(g_p, r_p)


def _assert_hyps_equal(got, ref):
    assert [h.words for h in got] == [h.words for h in ref]
    assert len(got) > 0
    for a, b in zip(got, ref):
        assert a.score == pytest.approx(b.score, rel=RTOL)
        assert [(x.word_id, x.start, x.end) for x in a.tokens] == [
            (x.word_id, x.start, x.end) for x in b.tokens]


@pytest.mark.parametrize("hop_mode", ["dense", "rank1", "backoff"])
@pytest.mark.parametrize("masked", [False, True])
def test_records_bitwise_vs_jax_scan(hop_mode, masked):
    """The plain version (kernel F's CPU path, with the hop operand the
    kernel would get) and the port's scan (the graph's own hop) against the
    JAX package's ``factored_lattice_scan``, mixed word lengths."""
    jg, tg, rng, _ = _world(9, hop_mode, seed=len(hop_mode) + masked)
    assert F.hop_kind(tg.hop) == ("backoff" if hop_mode == "backoff" else hop_mode)
    t = 41
    obs = rng.normal(scale=8.0, size=(t, DIM)).astype(np.float32)
    log_b, pi_grid, _ = _grid_inputs(jg, obs)
    mask = None
    if masked:  # a bucket's padded tail and one interior gap
        mask = np.arange(t) < 33
        mask[12] = False
    ref = jdec.factored_lattice_scan(jnp.asarray(log_b), jg.inner_a, jg.hop, jnp.asarray(pi_grid),
                                     jg.exit_idx, None if mask is None else jnp.asarray(mask))
    m = None if mask is None else _t(mask)
    scan = tdec.factored_lattice_scan(_t(log_b), tg.inner_a, tg.hop, _t(pi_grid), tg.exit_idx, m)
    _assert_records_equal(scan, ref)
    np.testing.assert_array_equal(scan[3].numpy(), np.asarray(ref[3]))  # v_last
    assert np.isinf(scan[0].numpy()).any() and np.isfinite(scan[0].numpy()).any()
    plain = F.factored_lattice(_t(pi_grid), tg.inner_a, tg.exit_idx, tg._kernel_hop,
                               _t(log_b), m)
    _assert_records_equal(plain, ref)
    assert F.factored_lattice.launches == 0
    # the graph's dispatch on the CPU takes the plain version, which equals
    # the scan on the graph's own hop (on the port's own emissions, which
    # differ from the JAX package's by fp32 reassociation)
    t_log_b, t_pi, _ = tg._grid_inputs(_t(obs))
    _assert_records_equal(tg.lattice_records_arrays(_t(obs), m),
                          tdec.factored_lattice_scan(t_log_b, tg.inner_a, tg.hop, t_pi,
                                                     tg.exit_idx, m))


def test_records_under_exact_ties():
    """Uniform emissions, identical hops, stay == advance: nearly every max
    is a tie (the graph of tests/test_factored_pallas.py's tie test)."""
    v, s, t = 7, 3, 23
    pi = np.full((v, s), -np.inf, np.float32)
    pi[:, 0] = 0.0
    inner = np.full((v, s, s), -np.inf, np.float32)
    for j in range(s):
        inner[:, j, j] = np.log(0.5)
        if j + 1 < s:
            inner[:, j, j + 1] = np.log(0.5)
    exit_idx = np.full(v, s - 1, np.int32)
    hop = np.zeros((v, v), np.float32)
    log_b = np.zeros((t, v, s), np.float32)
    ref = jdec.factored_lattice_scan(jnp.asarray(log_b), jnp.asarray(inner), jnp.asarray(hop),
                                     jnp.asarray(pi), jnp.asarray(exit_idx))
    for hop_t in (_t(hop), F.Rank1Hop(_t(np.zeros(v, np.float32)), _t(np.zeros(v, np.float32)),
                                      _t(np.full(v, -np.inf, np.float32)), -1)):
        got = F.factored_lattice_plain(_t(pi), _t(inner), _t(exit_idx), hop_t, _t(log_b))
        _assert_records_equal(got, ref)
    # integer emissions on a real graph: ties between words and states
    jg, tg, rng, _ = _world(6, "dense", seed=3)
    obs = rng.normal(scale=8.0, size=(30, DIM)).astype(np.float32)
    log_b, pi_grid, _ = _grid_inputs(jg, obs)
    log_b = np.round(log_b / 4.0)
    ref = jdec.factored_lattice_scan(jnp.asarray(log_b), jg.inner_a, jg.hop, jnp.asarray(pi_grid),
                                     jg.exit_idx)
    _assert_records_equal(F.factored_lattice_plain(_t(pi_grid), tg.inner_a, tg.exit_idx, tg.hop,
                                                   _t(log_b)), ref)


def test_plain_vs_pallas_interpret():
    """Against the TPU kernel in interpret mode at one tiny shape: starts
    and preds exact, scores equal once clipped at its finite -1e30."""
    jg, tg, rng, _ = _world(5, "dense", seed=9)
    t = 19
    obs = rng.normal(scale=8.0, size=(t, DIM)).astype(np.float32)
    log_b, pi_grid, _ = _grid_inputs(jg, obs)
    mask = np.arange(t) < 16
    k_s, k_st, k_p = factored_lattice_pallas(jnp.asarray(pi_grid), jg.inner_a, jg.exit_idx, jg.hop,
                                             jnp.asarray(log_b), jnp.asarray(mask), interpret=True)
    s, st, p = F.factored_lattice(_t(pi_grid), tg.inner_a, tg.exit_idx, tg._kernel_hop, _t(log_b),
                                  _t(mask))
    np.testing.assert_array_equal(st.numpy(), np.asarray(k_st))
    np.testing.assert_array_equal(p.numpy(), np.asarray(k_p))
    np.testing.assert_array_equal(np.maximum(s.numpy(), NEG), np.maximum(np.asarray(k_s), NEG))


def _lattice_pair(hop_mode, seed, **kw):
    """One set of JAX records of a planted utterance, turned into a lattice
    by each package (``kw``: ``beam``, ``max_tokens_per_frame``): ``(jax
    lattice, port lattice, jax graph, port graph, corpus)``."""
    jg, tg, rng, corpus = _world(8, hop_mode, seed=seed)
    obs = _planted(jg, ["w001", "w004", "w002", "w006"], rng)
    log_b, pi_grid, _ = _grid_inputs(jg, obs)
    s, st, p, _ = (np.asarray(x) for x in jdec.factored_lattice_scan(
        jnp.asarray(log_b), jg.inner_a, jg.hop, jnp.asarray(pi_grid), jg.exit_idx))
    j_lat = JWordLattice.from_records(jg.words, s, st, p, jg.host_hop(), np.asarray(jg.log_pi_w),
                                      np.asarray(jg.log_final_w), **kw)
    lat = tg.lattice_from_records(s, st, p, **kw)
    return j_lat, lat, jg, tg, corpus


@pytest.mark.parametrize("hop_mode", ["dense", "backoff"])
def test_from_records_nbest_posteriors_match_jax(hop_mode):
    j_lat, lat, _, _, _ = _lattice_pair(hop_mode, seed=21)
    assert len(lat) == len(j_lat) > 10 and lat.n_frames == j_lat.n_frames
    assert [(x.word_id, x.start, x.end) for x in lat.tokens] == [
        (x.word_id, x.start, x.end) for x in j_lat.tokens]
    np.testing.assert_allclose([x.ac for x in lat.tokens], [x.ac for x in j_lat.tokens], rtol=RTOL)
    for n, unique in ((1, True), (5, True), (4, False)):
        _assert_hyps_equal(lat.nbest(n, unique=unique), j_lat.nbest(n, unique=unique))
    assert lat.nbest(1)[0].words == ["w001", "w004", "w002", "w006"]
    post, j_post = lat.posteriors(), j_lat.posteriors()
    np.testing.assert_allclose(post, j_post, rtol=RTOL, atol=1e-12)
    for h, jh in zip(lat.nbest(3), j_lat.nbest(3)):
        np.testing.assert_allclose(lat.confidences(h, post), j_lat.confidences(jh, j_post),
                                   rtol=RTOL)
        np.testing.assert_allclose(lat.confidences(h), j_lat.confidences(jh), rtol=RTOL)
    # no pruning, a tight beam and a per-frame cap
    sizes = []
    for kw in (dict(beam=np.inf), dict(beam=3.0), dict(max_tokens_per_frame=1)):
        a, b = _lattice_pair(hop_mode, seed=21, **kw)[:2]
        assert len(b) == len(a)
        sizes.append(len(a))
        _assert_hyps_equal(a.nbest(3), b.nbest(3))
    assert sizes[0] >= len(lat) >= sizes[1] and sizes[0] > sizes[2]


@pytest.mark.parametrize("order", [2, 3])
@pytest.mark.parametrize("silence_context", ["keep1", "reset"])
def test_rescore_matches_jax(order, silence_context):
    """``rescore`` and ``lm_path_score`` with bigram and trigram LMs
    counted from the graph's corpus, under both silence rules; silence
    tokens sit inside the planted utterance's lattice."""
    j_lat, lat, jg, tg, corpus = _lattice_pair("dense", seed=33)
    assert any(tg.words[x.word_id] == tdec.SILENCE for x in lat.tokens)
    j_lm, lm = JNGramModel(JNGramCounter(order, corpus)), NGramModel(NGramCounter(order, corpus))
    kw = dict(lm_scale=0.7, word_insertion_penalty=-0.5, silence_context=silence_context)
    got, ref = lat.rescore(lm, n=4, **kw), j_lat.rescore(j_lm, n=4, **kw)
    _assert_hyps_equal(got, ref)
    sil = tg.words.index(tdec.SILENCE)
    toks = [WordToken(sil, 0, 3, -1.5)] + lat.nbest(1)[0].tokens + [WordToken(sil, 9, 9, -0.5),
                                                                   WordToken(2, 10, 12, -3.0)]
    for use_eos in (None, False):
        assert lat.lm_path_score(toks, lm, use_eos=use_eos, **kw) == pytest.approx(
            j_lat.lm_path_score(toks, j_lm, use_eos=use_eos, **kw), rel=RTOL)
    for ctx in (("<s>", "w002", "w004"), ("w003",), ()):
        assert lm_conditional(lm, "w001", ctx) == pytest.approx(
            j_lm_conditional(j_lm, "w001", ctx), rel=RTOL)
    with pytest.raises(ValueError, match="silence_context"):
        lat.lm_path_score(toks, lm, silence_context="drop")


@pytest.mark.parametrize("hop_mode", ["dense", "backoff"])
def test_save_load_across_packages(hop_mode, tmp_path):
    """A lattice saved by either package loads in the other: the same
    tokens, N-best and rescoring (backoff hops serialize their factors)."""
    j_lat, lat, _, _, corpus = _lattice_pair(hop_mode, seed=44)
    lm, j_lm = NGramModel(NGramCounter(3, corpus)), JNGramModel(JNGramCounter(3, corpus))
    lat.save(str(tmp_path / "port.lat"))
    j_lat.save(str(tmp_path / "jax.lat"))
    from_port = JWordLattice.load(str(tmp_path / "port.lat"))
    from_jax = WordLattice.load(str(tmp_path / "jax.lat"))
    assert from_port.words == from_jax.words == lat.words
    for a, b in ((from_jax, lat), (from_port, j_lat)):
        assert a.tokens == b.tokens and a.n_frames == b.n_frames
        _assert_hyps_equal(a.nbest(4), b.nbest(4))
    _assert_hyps_equal(from_jax.rescore(lm, n=3), from_port.rescore(j_lm, n=3))
    if hop_mode == "dense":
        np.testing.assert_array_equal(from_jax.hop, lat.hop)
    else:
        np.testing.assert_array_equal(from_jax.hop.dense(), lat.hop.dense())
    (tmp_path / "bad.lat").write_text('{"format": "other"}')
    with pytest.raises(ValueError, match="word lattice"):
        WordLattice.load(str(tmp_path / "bad.lat"))


def test_decode_lattice_and_batch_match_jax():
    """The graph's own lattice decode on features (emissions computed by
    each package: fp32 reassociation, so scores within 1e-5 relative):
    the 1-best equals ``decode``; ``decode_lattice_batch`` equals looping
    ``decode_lattice``; a loop-free graph raises."""
    jg, tg, rng, _ = _world(8, "rank1", seed=55)
    obs = _planted(jg, ["w002", "w005", "w001"], rng, noise=0.5)
    lat, j_lat = tg.decode_lattice(obs), jg.decode_lattice(obs)
    best, j_best = lat.nbest(3), j_lat.nbest(3)
    assert [h.words for h in best] == [h.words for h in j_best]
    words, _, score = tg.decode(obs)
    assert best[0].words == words == ["w002", "w005", "w001"]
    assert best[0].score == pytest.approx(score, rel=1e-5)
    assert best[0].score == pytest.approx(j_best[0].score, rel=1e-5)

    t = len(obs)
    feats = np.stack([obs, np.concatenate([obs[6:], np.zeros((6, DIM), np.float32)])])
    masks = np.stack([np.ones(t, bool), np.arange(t) < t - 6])
    batch = tg.decode_lattice_batch(feats, masks, beam=np.inf)
    j_batch = jg.decode_lattice_batch(feats, masks, beam=np.inf)
    for b in range(2):
        solo = tg.decode_lattice(feats[b], masks[b], beam=np.inf)
        assert batch[b].tokens == solo.tokens and batch[b].n_frames == solo.n_frames
        _assert_hyps_equal(batch[b].nbest(3), solo.nbest(3))
        assert [h.words for h in batch[b].nbest(3)] == [h.words for h in j_batch[b].nbest(3)]
    assert tg.decode_lattice_batch(feats[:0], masks[:0]) == []

    _, loop_free, _, _ = _world(4, "dense", loop=False, seed=1)
    for call in (lambda: loop_free.decode_lattice(obs[:, :DIM]),
                 lambda: loop_free.decode_lattice_batch(feats, masks)):
        with pytest.raises(ValueError, match="looped graph"):
            call()


def test_lattice_kernel_dispatch_and_capacity(monkeypatch):
    """F's capacity rule: the forward's threads and shared-memory test with
    F's own rows and no grid budget; sparse edges as a ``BackoffHop``, not
    as padded rows. Every graph takes the wrapper, whatever its hop kind
    (the plain version on the CPU, counting no launch), which raises for a
    CUDA graph past F's capacity instead of dropping to the scan."""
    calls = []

    def spy(*args, **kw):
        calls.append(F.hop_kind(args[3]))
        return F.factored_lattice(*args, **kw)

    monkeypatch.setattr(tdec, "factored_lattice", spy)
    for hop_mode in ("dense", "rank1", "backoff"):
        _, g, rng, _ = _world(6, hop_mode, seed=1)
        g.lattice_records_arrays(_t(rng.normal(size=(9, DIM)).astype(np.float32)), None)
    assert calls == ["dense", "rank1", "backoff"]
    monkeypatch.undo()
    # a 300-word dense graph: within F's capacity on 132 SMs, past it on 1
    # (300 hop columns of 1.2 KB in one block's shared memory); the CUDA
    # emissions stand in with their device and shape, all the wrapper reads
    # before it refuses
    rng = np.random.default_rng(2)
    units = {f"u{i:03d}": _unit(rng.normal(scale=8.0, size=DIM), 2 + i % 3, rng)
             for i in range(300)}
    big = tdec.FactoredDecodingGraph.build(Lexicon.whole_word(sorted(units)), units, None,
                                           tdec.DecoderConfig(), hop_mode="dense", device="cpu")
    v, s = big.grid_shape
    assert F.lattice_kernel_ok(v, s, big._kernel_hop, 132)
    assert not F.lattice_kernel_ok(v, s, big._kernel_hop, 1)
    cuda_log_b = types.SimpleNamespace(device=torch.device("cuda"), shape=(5, v, s),
                                       dim=lambda: 3)
    monkeypatch.setattr(F, "sm_count", lambda dev: 1)
    with pytest.raises(ValueError, match="past the lattice kernel's capacity"):
        big._lattice_grid(cuda_log_b, torch.zeros(v, s), None)
    assert F.factored_lattice.launches == 0
    dense = torch.zeros(1001, 1001)
    assert F.lattice_kernel_ok(1001, 8, dense, 132)
    assert not F.lattice_kernel_ok(8000, 8, torch.zeros(1, 1), 132)  # hop columns past smem
    rank1 = F.Rank1Hop(*(torch.zeros(16000) for _ in range(3)), -1)
    assert F.lattice_kernel_ok(16000, 8, rank1, 132)
    assert not F.lattice_kernel_ok(20000, 8, rank1, 132)  # 152 words x 8 cells > 1024 threads
    # no grid budget: a segment whose grids D could not store
    assert F.lattice_kernel_ok(16000, 8, None, 132)
    assert not F.factored_kernel_ok(200_000, 16000, 8, None, 132)
    wpb = -(-1001 // 132)
    assert (F.lattice_smem_bytes(1001, 8, wpb, "dense")
            == F.forward_smem_bytes(1001, 8, wpb, "dense") + 4 * (wpb + 4 * wpb * 8))
    _, tb, _, _ = _world(6, "backoff", seed=1)
    assert F.hop_kind(tb.hop) == "backoff" and not F.lattice_kernel_ok(7, 4, tb.hop, 132)
    assert F.lattice_kernel_ok(7, 4, tb._kernel_hop, 132)
    with pytest.raises(ValueError, match="cpu or cuda"):
        F.factored_lattice(torch.zeros(2, 2), torch.zeros(2, 2, 2),
                           torch.zeros(2, dtype=torch.int32), None,
                           torch.zeros(3, 2, 2, device="meta"))
    assert F.factored_lattice.launches == 0
