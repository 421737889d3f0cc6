"""The factored graph's batched decodes (kernels D, E and F with a batch
axis, ``ops/factored.py``; ``FactoredDecodingGraph.decode_batch_arrays``,
``decode_batch`` and ``decode_lattice_batch``) on the CPU, against the
single-utterance calls and the JAX package's vmapped scans.

The batched plain versions step a batch's utterances as one tensor with
the same adds in the same order as one utterance's, so every row is
bitwise the single-utterance call, for every hop kind (none, dense,
rank-1, backoff), with masks that differ by utterance: a full row, a
bucket's padded tail, a row masked after its first frame and one with
interior gaps. On identical float32 emissions they are bitwise the JAX
package's ``factored_trellis_scan`` and ``factored_lattice_scan`` under
``jax.vmap`` (what its ``decode_batch`` and ``decode_lattice_batch`` jit):
paths, scores and records, ``-inf`` at the same unreachable records. The
graphs' own batched decodes run on features, each package computing its
own emissions: words and N-best words equal, scores within 1e-5
relative. ``ops.factored.cut_batch``, the rule that cuts a batch into
launches, is held to the capacity rules it cuts by.
"""

import functools
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lnasr_tpu.config import GMMHMMConfig as JGMMHMMConfig
from lnasr_tpu.models import decoder as jdec
from lnasr_tpu.models.lexicon import Lexicon as JLexicon
from lnasr_tpu.models.ngram import NGramCounter as JNGramCounter
from lnasr_tpu.models.ngram import NGramModel as JNGramModel
from lnasr_tpu_torch.models import decoder as tdec
from lnasr_tpu_torch.models.lexicon import Lexicon
from lnasr_tpu_torch.models.ngram import NGramCounter, NGramModel
from lnasr_tpu_torch.ops import factored as F

DIM = 5
T = 37
KINDS = [("dense", True), ("rank1", True), ("backoff", True), ("dense", False)]  # + no hop


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions are frame loops of small ops: one intra-op thread
    runs them faster than a pool shared with the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _unit(mean, n_states, rng):
    with np.errstate(divide="ignore"):
        log_a = np.log(np.where(np.eye(n_states) + np.eye(n_states, k=1) > 0, 0.5, 0.0))
    return types.SimpleNamespace(
        n=n_states, config=JGMMHMMConfig(n_states=n_states, n_mix=1, dim=DIM),
        log_a=log_a.astype(np.float32), log_w=np.zeros((n_states, 1), np.float32),
        mu=(mean[None, None, :] + rng.normal(scale=0.3, size=(n_states, 1, DIM))).astype(np.float32),
        cov=np.full((n_states, 1, DIM), 0.1, np.float32))


@functools.lru_cache(maxsize=None)
def _world(hop_mode, loop, v=9, seed=4):
    """The same factored graph in both packages (words of 2-4 states, a
    silence word, a bigram LM) and a batch of 4 utterances: ``(jax graph,
    port graph, feats (4, T, DIM), masks (4, T))``. Row 0 is full, row 1
    a bucket's padded tail, row 2 masked after its first frame, row 3 a
    padded tail with interior gaps; rows 0 and 3 are planted words."""
    rng = np.random.default_rng(seed)
    means = rng.normal(scale=8.0, size=(v + 1, DIM))
    units = {f"w{i:03d}": _unit(means[i], 2 + i % 3, rng) for i in range(v)}
    names = sorted(units)
    corpus = [tuple(["<s>"] + list(rng.choice(names, size=3)) + ["</s>"]) for _ in range(40)]
    kw = dict(silence_model=_unit(means[v], 2, rng), hop_mode=hop_mode)
    cfg = dict(loop=loop, lm_scale=0.7, word_insertion_penalty=-0.5)
    jg = jdec.FactoredDecodingGraph.build(
        JLexicon.whole_word(names), units, JNGramModel(JNGramCounter(2, corpus)),
        jdec.DecoderConfig(**cfg), dtype=jnp.float32, **kw)
    tg = tdec.FactoredDecodingGraph.build(
        Lexicon.whole_word(names), units, NGramModel(NGramCounter(2, corpus)),
        tdec.DecoderConfig(**cfg), device="cpu", **kw)
    mu = np.asarray(jg.mu)[:, 0]
    sm, pm = np.asarray(jg.state_map), np.asarray(jg.pad_mask)

    def planted(words):
        rows = [mu[sm[jg.words.index(w), s]] + rng.normal(scale=0.3, size=DIM)
                for w in words for s in np.flatnonzero(pm[jg.words.index(w)]) for _ in range(2)]
        out = rng.normal(scale=8.0, size=(T, DIM))
        out[:min(len(rows), T)] = rows[:T]
        return out

    feats = np.stack([planted(names[1:4] + names[5:6]), rng.normal(scale=8.0, size=(T, DIM)),
                      rng.normal(scale=8.0, size=(T, DIM)), planted(names[6:9])]).astype(np.float32)
    masks = np.ones((4, T), bool)
    masks[1, 29:] = False
    masks[2, 1:] = False
    masks[3, 31:] = False
    masks[3, [4, 11, 12, 13, 20]] = False
    return jg, tg, feats, masks


def _grid_inputs(jg, feats):
    """The JAX package's grid emissions of a batch, row by row (as its
    vmapped decode computes them), as NumPy: ``(log_b (B, T, V, S),
    pi_grid, final_grid)``."""
    rows = [[np.asarray(x) for x in jdec._factored_grid_inputs(
        jnp.asarray(obs, jnp.float32), jg.log_pi_w, jg.log_final_w, jg.exit_idx, jg.state_map,
        jg.pad_mask, jg.log_w, jg.mu, jg.cov, jg.cov_type)] for obs in feats]
    return np.stack([r[0] for r in rows]), rows[0][1], rows[0][2]


@functools.lru_cache(maxsize=None)
def _jax_scans(hop_mode, loop):
    """The JAX package's vmapped scans for one graph, compiled once:
    ``(trellis (log_b, masks) -> (paths, scores), lattice (log_b, masks)
    -> records)``, over one graph as its ``decode_batch`` and
    ``decode_lattice_batch`` map them."""
    jg, _, feats, _ = _world(hop_mode, loop)
    _, pi_grid, final_grid = _grid_inputs(jg, feats[:1])
    pi_grid, final_grid = jnp.asarray(pi_grid), jnp.asarray(final_grid)
    trellis = jax.jit(jax.vmap(lambda lb, m: jdec.factored_trellis_scan(
        lb, jg.inner_a, jg.hop, pi_grid, final_grid, jg.exit_idx, m)))
    lattice = jax.jit(jax.vmap(lambda lb, m: jdec.factored_lattice_scan(
        lb, jg.inner_a, jg.hop, pi_grid, jg.exit_idx, m)[:3])) if loop else None
    return trellis, lattice


def _t(x):
    return torch.as_tensor(np.array(x))


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _same(a, b):
    return np.array_equal(_bits(a), _bits(b))


@pytest.mark.parametrize("hop_mode,loop", KINDS)
def test_batched_plain_rows_are_the_single_calls(hop_mode, loop):
    """Forward grids, paths, scores and lattice records of the batched plain
    versions equal the single-utterance plain calls row by row, bitwise,
    and the wrappers on CPU tensors are those plain versions."""
    jg, tg, feats, masks = _world(hop_mode, loop)
    log_b, pi_grid, final_grid = (_t(x) for x in _grid_inputs(jg, feats))
    hop, ia, ei, m = tg._kernel_hop, tg.inner_a, tg.exit_idx, _t(masks)
    assert F.hop_kind(hop) == (hop_mode if loop else "none")
    grids = F.factored_forward(pi_grid, ia, ei, hop, log_b, m)
    paths, scores = F.factored_backtrace(grids, ia, ei, hop, final_grid, m)
    recs = F.factored_lattice(pi_grid, ia, ei, hop, log_b, m)
    assert grids.shape == log_b.shape and paths.shape == (4, T) and paths.dtype == torch.int32
    assert scores.shape == (4,) and all(r.shape == (4, T, len(tg.words)) for r in recs)
    for b in range(4):
        g1 = F.factored_forward_plain(pi_grid, ia, ei, hop, log_b[b], m[b])
        p1, s1 = F.factored_backtrace_plain(g1, ia, ei, hop, final_grid, m[b])
        r1 = F.factored_lattice_plain(pi_grid, ia, ei, hop, log_b[b], m[b])
        assert _same(grids[b], g1) and _same(paths[b], p1) and _same(scores[b], s1)
        assert all(_same(r[b], x) for r, x in zip(recs, r1))
    # row 2 is masked after its first frame: its grid never moves, its path
    # stays at the final argmax of frame 0
    assert _same(grids[2, -1], grids[2, 0]) and len(set(paths[2].tolist())) == 1
    assert all(_same(r[2, -1], r[2, 0]) for r in recs)
    # the scan decoder (the graph's own hop operand) agrees row by row
    for b in range(4):
        sp, ss = tdec.factored_trellis_scan(log_b[b], ia, tg.hop, pi_grid, final_grid, ei, m[b])
        assert _same(paths[b], sp) and _same(scores[b], ss)
    assert (F.factored_forward.launches, F.factored_backtrace.launches,
            F.factored_lattice.launches) == (0, 0, 0)


@pytest.mark.parametrize("hop_mode,loop", KINDS)
def test_batched_plain_bitwise_vs_jax_vmapped_scans(hop_mode, loop):
    """On the JAX package's own float32 emissions, the batched plain
    versions equal its vmapped ``factored_trellis_scan`` and
    ``factored_lattice_scan`` bitwise: paths, scores, records, ``-inf`` at
    the same unreachable records."""
    jg, tg, feats, masks = _world(hop_mode, loop)
    log_b, pi_grid, final_grid = _grid_inputs(jg, feats)
    trellis, lattice = _jax_scans(hop_mode, loop)
    j_paths, j_scores = (np.asarray(x) for x in trellis(jnp.asarray(log_b), jnp.asarray(masks)))
    hop, ia, ei, m = tg._kernel_hop, tg.inner_a, tg.exit_idx, _t(masks)
    grids = F.factored_forward_plain(_t(pi_grid), ia, ei, hop, _t(log_b), m)
    paths, scores = F.factored_backtrace_plain(grids, ia, ei, hop, _t(final_grid), m)
    np.testing.assert_array_equal(paths.numpy(), j_paths)
    assert _same(scores.numpy(), j_scores)
    if lattice is None:
        return
    j_recs = [np.asarray(x) for x in lattice(jnp.asarray(log_b), jnp.asarray(masks))]
    recs = F.factored_lattice_plain(_t(pi_grid), ia, ei, hop, _t(log_b), m)
    np.testing.assert_array_equal(np.isfinite(recs[0].numpy()), np.isfinite(j_recs[0]))
    assert np.isinf(j_recs[0]).any() and np.isfinite(j_recs[0]).any()
    for got, ref in zip(recs, j_recs):
        assert _same(got.numpy(), ref)
    # the port's scan of one utterance as the batch (its v_last too)
    scan = F.factored_lattice_scan(_t(log_b), ia, tg.hop, _t(pi_grid), ei, m)
    assert scan[3].shape == (4,) + tg.grid_shape
    for got, ref in zip(scan[:3], recs):
        assert _same(got, ref)


@pytest.mark.parametrize("hop_mode,loop", KINDS)
def test_graph_batched_decodes_match_jax(hop_mode, loop, monkeypatch):
    """``decode_batch`` and ``decode_lattice_batch`` on features: one call
    of the batched wrappers for the batch on the CPU; words (and N-best
    words) the JAX package's, scores within 1e-5 relative (each package
    computes its own emissions); rows equal to looping ``decode`` and
    ``decode_lattice``."""
    jg, tg, feats, masks = _world(hop_mode, loop)
    calls = []
    for name in ("factored_forward", "factored_backtrace", "factored_lattice"):
        real = getattr(tdec, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append((_name, tuple(args[4 if _name != "factored_backtrace" else 0].shape)))
            return _real(*args, **kw)

        monkeypatch.setattr(tdec, name, spy)
    got = tg.decode_batch(feats, masks)
    assert calls == [("factored_forward", (4, T) + tg.grid_shape),
                     ("factored_backtrace", (4, T) + tg.grid_shape)]
    ref = jg.decode_batch(feats, masks)
    assert [g[0] for g in got] == [r[0] for r in ref]
    assert any(g[0] for g in got)  # the planted rows decode to words
    for g, r in zip(got, ref):
        assert g[2] == pytest.approx(r[2], rel=1e-5)
    for b in range(4):
        words, path, score = tg.decode(feats[b], masks[b])
        assert got[b][0] == words and np.array_equal(got[b][1], path) and got[b][2] == score
    if not loop:
        return
    calls.clear()
    lats = tg.decode_lattice_batch(feats, masks)
    assert calls == [("factored_lattice", (4, T) + tg.grid_shape)]
    j_lats = jg.decode_lattice_batch(feats, masks)
    for lat, j_lat, b in zip(lats, j_lats, range(4)):
        hyps, j_hyps = lat.nbest(4), j_lat.nbest(4)
        assert [h.words for h in hyps] == [h.words for h in j_hyps]
        assert hyps or b == 2  # a single valid frame completes no word
        for h, j in zip(hyps, j_hyps):
            assert h.score == pytest.approx(j.score, rel=1e-5)
        solo = tg.decode_lattice(feats[b], masks[b])
        assert lat.tokens == solo.tokens
        assert [(h.words, h.score) for h in hyps] == [(h.words, h.score) for h in solo.nbest(4)]


def test_empty_and_single_row_batches():
    """An empty batch decodes to empty tensors and no lattice; a batch of
    one is the single-utterance decode."""
    _, tg, feats, masks = _world("dense", True)
    paths, scores = tg.decode_batch_arrays(feats[:0], masks[:0])
    assert paths.shape == (0, T) and paths.dtype == torch.int32 and scores.shape == (0,)
    assert tg.decode_lattice_batch(feats[:0], masks[:0]) == []
    (words, path, score), = tg.decode_batch(feats[3:], masks[3:])
    assert (words, score) == tg.decode(feats[3], masks[3])[::2] and path.shape == (T,)


def test_cut_batch_by_the_capacity_rules():
    """``cut_batch``: pieces in order and contiguous over the batch, each
    within one launch's rule (shared memory, the grid budget, MAX_BATCH),
    as few as the largest piece allows and as even as they go; nothing for
    an empty batch; a ValueError where one utterance is past the rule."""
    n_sm, t_len = 132, 512
    dense = torch.zeros(1001, 1001)
    rank1 = F.Rank1Hop(*(torch.zeros(5001) for _ in range(3)), 0)
    # the serving batch of 8 fits one launch at V = 1001 (dense) and 5001
    assert F.cut_batch(8, t_len, 1001, 8, dense, n_sm) == [(0, 8)]
    assert F.cut_batch(8, t_len, 5001, 8, rank1, n_sm) == [(0, 8)]
    assert F.cut_batch(0, t_len, 1001, 8, dense, n_sm) == []
    cases = [(64, 1001, dense, False), (64, 5001, rank1, False), (64, 5001, rank1, True),
             (200, 40, None, False), (3, 1001, dense, True), (130, 1001, dense, True)]
    for b, v, hop, lattice in cases:
        pieces = F.cut_batch(b, t_len, v, 8, hop, n_sm, lattice=lattice)
        ok = ((lambda k: F.lattice_kernel_ok(v, 8, hop, n_sm, k)) if lattice else
              (lambda k: F.factored_kernel_ok(t_len, v, 8, hop, n_sm, k)))
        assert pieces[0][0] == 0 and pieces[-1][1] == b
        assert all(a[1] == c[0] for a, c in zip(pieces, pieces[1:]))
        sizes = [j - i for i, j in pieces]
        assert all(ok(k) for k in sizes) and max(sizes) - min(sizes) <= 1
        assert sizes == sorted(sizes, reverse=True) and max(sizes) <= F.MAX_BATCH
        cap = max(k for k in range(1, F.MAX_BATCH + 1) if ok(k))
        assert len(pieces) == -(-b // min(cap, b))
    # by the grid budget (V = 5001: 26 rows of 512 frames a launch), by
    # shared memory (V = 1001 dense: every row's V exits), by MAX_BATCH
    assert F.cut_batch(64, t_len, 5001, 8, rank1, n_sm) == [(0, 22), (22, 43), (43, 64)]
    assert not F.factored_kernel_ok(t_len, 5001, 8, rank1, n_sm, 27)
    assert F.factored_kernel_ok(t_len, 5001, 8, rank1, n_sm, 26)
    assert F.cut_batch(64, t_len, 1001, 8, dense, n_sm) == [(0, 32), (32, 64)]
    assert F.forward_smem_bytes(1001, 8, 8, "dense", batch=42) + 1024 > F.SMEM_LIMIT
    assert len(F.cut_batch(200, t_len, 40, 8, None, n_sm)) == 4
    assert not F.factored_kernel_ok(8, 40, 8, None, n_sm, F.MAX_BATCH + 1)
    with pytest.raises(ValueError, match="past the factored kernels' capacity"):
        F.cut_batch(2, 200_000, 16000, 8, None, n_sm)  # one utterance's grids past 2 GiB
    with pytest.raises(ValueError, match="past the lattice kernel's capacity"):
        F.cut_batch(2, t_len, 8000, 8, torch.zeros(1, 1), n_sm, lattice=True)


def test_batched_shared_memory_and_exchange_grow_with_the_batch():
    """The capacity rule's shared memory and the exchange's slots at B
    utterances: the rows, the exits and the keys grow B-fold, the hop
    columns and inner blocks not; one utterance is the B = 1 case."""
    for kind in ("none", "dense", "rank1", "backoff"):
        n_src = 40 if kind == "backoff" else 0
        one = F.forward_smem_bytes(1001, 8, 8, kind, n_blocks=126, n_src=n_src)
        assert one == F.forward_smem_bytes(1001, 8, 8, kind, n_blocks=126, n_src=n_src, batch=1)
        two = F.forward_smem_bytes(1001, 8, 8, kind, n_blocks=126, n_src=n_src, batch=2)
        fixed = 4 * (8 * 64 + 8) + (4 * 8 * 1001 if kind == "dense" else 0) + (
            4 * 40 if kind == "backoff" else 0)  # inner blocks, exit indices, hop columns, sources
        assert two - one == one - fixed
        lat1 = F.lattice_smem_bytes(1001, 8, 8, kind, 126, n_src)
        assert F.lattice_smem_bytes(1001, 8, 8, kind, 126, n_src, batch=2) - lat1 == lat1 - fixed
        assert F.exchange_slots(1001, kind, 126, 3) == 3 * F.exchange_slots(1001, kind, 126)


def test_cuda_wrappers_refuse_a_batch_past_one_launch(monkeypatch):
    """A CUDA stand-in batch past one launch's rule (MAX_BATCH rows, or a
    dense batch whose exits overflow shared memory) is refused before any
    launch, and the graph's batched decode cuts the same batch instead
    (``_batch_pieces`` on a CUDA stand-in)."""
    _, tg, _, _ = _world("dense", True)
    v, s = tg.grid_shape

    def cuda_log_b(b):
        return types.SimpleNamespace(device=torch.device("cuda"), shape=(b, T, v, s),
                                     dtype=torch.float32, dim=lambda: 4)

    grid = torch.zeros(v, s)
    monkeypatch.setattr(F, "sm_count", lambda dev: 132)
    monkeypatch.setattr(tdec, "sm_count", lambda dev: 132)
    with pytest.raises(ValueError, match="past the factored kernels' capacity"):
        F.factored_forward(grid, tg.inner_a, tg.exit_idx, tg._kernel_hop,
                           cuda_log_b(F.MAX_BATCH + 1))
    with pytest.raises(ValueError, match="past the lattice kernel's capacity"):
        F.factored_lattice(grid, tg.inner_a, tg.exit_idx, tg._kernel_hop,
                           cuda_log_b(F.MAX_BATCH + 1))
    pieces = tg._batch_pieces(cuda_log_b(2 * F.MAX_BATCH + 1))
    assert pieces == F.cut_batch(2 * F.MAX_BATCH + 1, T, v, s, tg._kernel_hop, 132)
    assert len(pieces) == 3 and pieces[-1][1] == 2 * F.MAX_BATCH + 1
    assert F.factored_forward.launches == 0 and F.factored_lattice.launches == 0


def test_kernel_sources_take_the_batch():
    """The C entries of D, E and F take B before T, the exchange header's
    MAX_BATCH is the wrapper's, and D and F index the exchange by
    utterance."""
    import os
    import re

    csrc = os.path.join(os.path.dirname(F.__file__), "..", "csrc")
    read = lambda n: open(os.path.join(csrc, n)).read()  # noqa: E731
    assert re.search(rf"constexpr int MAX_BATCH = {F.MAX_BATCH};", read("factored_exchange.cuh"))
    for name in ("factored_forward", "factored_backtrace", "factored_lattice"):
        sig = re.search(rf'extern "C" int {name}_launch\((.*?)\)\s*{{', read(f"{name}.cu"),
                        re.S).group(1)
        names = [re.split(r"[\s*]+", p.strip())[-1] for p in sig.split(",")]
        assert names[names.index("T") - 1] == "B"
    assert "<<<B, THREADS" in read("factored_backtrace.cu")
