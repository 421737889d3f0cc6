"""The port's factored word-graph decode (the CPU paths of kernels D and E,
``ops/factored.py``, and the scan of ``models/decoder.py``) against the
JAX package on identical float32 inputs.

Both packages' graphs are built from the same duck-typed NumPy units and
the same LM; the JAX package computes the grid emissions once and both
decoders get them, so the comparison is about the trellis alone. Max-plus
is exact and both sides take first-index argmaxes, so paths and scores are
bitwise equal: for the dense hop, the edge-free rank-1 factors and no hop,
with masks and mixed word lengths. The TPU kernels run in interpret mode
at one tiny shape; they map -inf to a finite -1e30, so their grids are
compared at feasible states.
"""

import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lnasr_tpu.config import GMMHMMConfig as JGMMHMMConfig
from lnasr_tpu.models import decoder as jdec
from lnasr_tpu.models.lexicon import Lexicon as JLexicon
from lnasr_tpu.models.ngram import NGramCounter as JNGramCounter
from lnasr_tpu.models.ngram import NGramModel as JNGramModel
from lnasr_tpu.ops.factored_pallas import factored_decode_pallas, factored_forward_pallas
from lnasr_tpu_torch.models import decoder as tdec
from lnasr_tpu_torch.models.lexicon import Lexicon
from lnasr_tpu_torch.models.ngram import NGramCounter, NGramModel
from lnasr_tpu_torch.ops import factored as F

DIM = 5


def _unit(mean, n_states, rng):
    with np.errstate(divide="ignore"):
        log_a = np.log(np.where(np.eye(n_states) + np.eye(n_states, k=1) > 0, 0.5, 0.0))
    return types.SimpleNamespace(
        n=n_states, config=JGMMHMMConfig(n_states=n_states, n_mix=1, dim=DIM),
        log_a=log_a.astype(np.float32), log_w=np.zeros((n_states, 1), np.float32),
        mu=(mean[None, None, :] + rng.normal(scale=0.3, size=(n_states, 1, DIM))).astype(np.float32),
        cov=np.full((n_states, 1, DIM), 0.1, np.float32))


def _graphs(v, hop_mode="dense", loop=True, mixed=True, with_lm=True, with_sil=True, seed=0):
    """The same factored graph in both packages: ``(jax graph, port graph,
    rng)``."""
    rng = np.random.default_rng(seed)
    means = rng.normal(scale=8.0, size=(v + 1, DIM))
    units = {f"w{i:03d}": _unit(means[i], 2 + (i % 3 if mixed else 1), rng) for i in range(v)}
    names = sorted(units)
    sil = _unit(means[v], 2, rng) if with_sil else None
    jlm = tlm = None
    if with_lm:
        corpus = [tuple(["<s>"] + list(rng.choice(names, size=3)) + ["</s>"]) for _ in range(40)]
        jlm, tlm = JNGramModel(JNGramCounter(2, corpus)), NGramModel(NGramCounter(2, corpus))
    kw = dict(silence_model=sil, hop_mode=hop_mode)
    jg = jdec.FactoredDecodingGraph.build(
        JLexicon.whole_word(names), units, jlm, jdec.DecoderConfig(loop=loop, lm_scale=0.7),
        dtype=jnp.float32, **kw)
    tg = tdec.FactoredDecodingGraph.build(
        Lexicon.whole_word(names), units, tlm, tdec.DecoderConfig(loop=loop, lm_scale=0.7),
        device="cpu", **kw)
    return jg, tg, rng


def _grid_inputs(jg, obs):
    """The JAX package's grid emissions, once, as NumPy."""
    out = jdec._factored_grid_inputs(
        jnp.asarray(obs, jnp.float32), jg.log_pi_w, jg.log_final_w, jg.exit_idx, jg.state_map,
        jg.pad_mask, jg.log_w, jg.mu, jg.cov, jg.cov_type)
    return [np.asarray(x) for x in out]


def _t(x):
    return torch.as_tensor(np.array(x))


CASES = [  # (hop_mode, loop, with_lm, with_sil, mixed)
    ("dense", True, True, True, True),
    ("dense", True, True, False, False),
    ("rank1", True, True, True, True),
    ("rank1", True, False, False, True),
    ("dense", False, True, True, True),  # no hop: loop-free graph
]


@pytest.mark.parametrize("hop_mode,loop,with_lm,with_sil,mixed", CASES)
@pytest.mark.parametrize("masked", [False, True])
def test_plain_forward_backtrace_bitwise_vs_jax_scan(hop_mode, loop, with_lm, with_sil, mixed,
                                                      masked):
    jg, tg, rng = _graphs(9, hop_mode, loop, mixed, with_lm, with_sil, seed=len(hop_mode) + loop)
    t = 41
    obs = rng.normal(scale=8.0, size=(t, DIM)).astype(np.float32)
    log_b, pi_grid, final_grid = _grid_inputs(jg, obs)
    mask = None
    if masked:  # a bucket's padded tail and one interior gap
        mask = np.arange(t) < 33
        mask[12] = False
    j_path, j_score = jdec.factored_trellis_scan(
        jnp.asarray(log_b), jg.inner_a, jg.hop, jnp.asarray(pi_grid), jnp.asarray(final_grid),
        jg.exit_idx, None if mask is None else jnp.asarray(mask))
    j_path, j_score = np.asarray(j_path), np.asarray(j_score)
    m = None if mask is None else _t(mask)

    grids = F.factored_forward(_t(pi_grid), tg.inner_a, tg.exit_idx, tg._kernel_hop, _t(log_b), m)
    assert grids.shape == (t,) + tg.grid_shape
    path, score = F.factored_backtrace(grids, tg.inner_a, tg.exit_idx, tg._kernel_hop,
                                       _t(final_grid), m)
    assert path.dtype == torch.int32 and path.shape == (t,)
    np.testing.assert_array_equal(path.numpy(), j_path)
    np.testing.assert_array_equal(score.numpy(), j_score)
    # the port's scan decoder (the graph's own hop operand) agrees too
    s_path, s_score = tdec.factored_trellis_scan(_t(log_b), tg.inner_a, tg.hop, _t(pi_grid),
                                                 _t(final_grid), tg.exit_idx, m)
    np.testing.assert_array_equal(s_path.numpy(), j_path)
    np.testing.assert_array_equal(s_score.numpy(), j_score)


def test_backoff_factors_scan_bitwise_vs_jax():
    """Factors with sparse edges have no kernel: the scan decodes them, in
    both packages, with the same hop-entry argmax rules."""
    jg, tg, rng = _graphs(8, "backoff", seed=4)
    assert F.hop_kind(tg.hop) == "backoff" and not tg.hop_rank1_only
    obs = rng.normal(scale=8.0, size=(35, DIM)).astype(np.float32)
    log_b, pi_grid, final_grid = _grid_inputs(jg, obs)
    mask = np.arange(35) < 30
    j_path, j_score = jdec.factored_trellis_scan(
        jnp.asarray(log_b), jg.inner_a, jg.hop, jnp.asarray(pi_grid), jnp.asarray(final_grid),
        jg.exit_idx, jnp.asarray(mask))
    path, score = tdec.factored_trellis_scan(_t(log_b), tg.inner_a, tg.hop, _t(pi_grid),
                                             _t(final_grid), tg.exit_idx, _t(mask))
    np.testing.assert_array_equal(path.numpy(), np.asarray(j_path))
    assert float(score) == float(j_score)
    # hop entry values and sources on random exits, ties included
    for exit_v in (rng.normal(size=tg.grid_shape[0]), np.zeros(tg.grid_shape[0])):
        exit_v = exit_v.astype(np.float32)
        j_e, j_s = jdec._hop_entry(jnp.asarray(exit_v), jg.hop)
        e, s = F.hop_entry(_t(exit_v), tg.hop)
        np.testing.assert_array_equal(e.numpy(), np.asarray(j_e))
        np.testing.assert_array_equal(s.numpy(), np.asarray(j_s))
    with pytest.raises(ValueError, match="sparse edges"):
        F.factored_backtrace(torch.zeros((3,) + tg.grid_shape), tg.inner_a, tg.exit_idx, tg.hop,
                             _t(final_grid))


@pytest.mark.parametrize("hop_mode,loop", [("dense", True), ("rank1", True), ("dense", False)])
def test_plain_vs_pallas_interpret(hop_mode, loop):
    """Against the TPU kernels in interpret mode, at one tiny shape: the
    forward's grids at feasible states, and the fused decode's path and
    score (the XLA backtrace for the loop-free graph, as the JAX decoder
    dispatches it)."""
    jg, tg, rng = _graphs(5, hop_mode, loop, seed=9)
    t = 19
    obs = rng.normal(scale=8.0, size=(t, DIM)).astype(np.float32)
    log_b, pi_grid, final_grid = _grid_inputs(jg, obs)
    mask = np.arange(t) < 16
    args = (jnp.asarray(pi_grid), jg.inner_a, jg.exit_idx, jg.hop, jnp.asarray(log_b))
    k_grids = np.asarray(factored_forward_pallas(*args, jnp.asarray(mask), interpret=True))
    grids = F.factored_forward(_t(pi_grid), tg.inner_a, tg.exit_idx, tg._kernel_hop, _t(log_b),
                               _t(mask))
    feasible = torch.isfinite(grids).numpy()
    assert feasible.any()
    np.testing.assert_array_equal(grids.numpy()[feasible], k_grids[feasible])
    assert (k_grids[~feasible] <= -1e29).all()
    path, score = F.factored_backtrace(grids, tg.inner_a, tg.exit_idx, tg._kernel_hop,
                                       _t(final_grid), _t(mask))
    if loop:
        k_path, k_score = factored_decode_pallas(*args, jnp.asarray(final_grid),
                                                 jnp.asarray(mask), interpret=True)
    else:
        from lnasr_tpu.ops.factored_pallas import factored_backtrace as j_backtrace

        k_path, k_score = j_backtrace(jnp.asarray(k_grids), jg.inner_a, jg.exit_idx, None,
                                      jnp.asarray(final_grid), jnp.asarray(mask))
    np.testing.assert_array_equal(path.numpy(), np.asarray(k_path))
    assert float(score) == float(k_score)


def test_graph_build_matches_jax():
    """Both builders compose the same arrays, the same clamp and prune
    counts, and the same backoff factors (``_word_lm_factors``)."""
    for hop_mode in ("dense", "backoff", "rank1"):
        jg, tg, _ = _graphs(12, hop_mode, seed=2)
        assert tg.words == jg.words and tg.n_states == jg.n_states
        for name in ("inner_a", "exit_idx", "state_map", "pad_mask", "log_pi_w", "log_final_w",
                     "log_w", "mu", "cov"):
            np.testing.assert_array_equal(getattr(tg, name).numpy(),
                                          np.asarray(getattr(jg, name)), err_msg=name)
        assert (tg.hop_clamped, tg.hop_pruned_edges, tg.hop_rank1_only) == (
            jg.hop_clamped, jg.hop_pruned_edges, jg.hop_rank1_only)
        if hop_mode == "dense":
            np.testing.assert_array_equal(tg.hop.numpy(), np.asarray(jg.hop))
            np.testing.assert_array_equal(tg.host_hop(), np.asarray(jg.host_hop()))
        else:
            for name in ("from_w", "uni", "sil_from", "pred", "val"):
                np.testing.assert_array_equal(getattr(tg.hop, name).numpy(),
                                              np.asarray(getattr(jg.hop, name)), err_msg=name)
            assert tg.hop.sil_idx == int(jg.hop.sil_idx)
            np.testing.assert_array_equal(tg.host_hop().dense(), jg.host_hop().dense())
    assert tg.hop_pruned_edges > 0

    rng = np.random.default_rng(6)
    words = [f"w{i}" for i in range(7)] + [tdec.SILENCE]
    corpus = [tuple(["<s>"] + list(rng.choice(words[:-1], size=4)) + ["</s>"]) for _ in range(30)]
    cfg = dict(lm_scale=0.6, word_insertion_penalty=-1.5)
    for max_in_degree in (None, 2):
        j = jdec._word_lm_factors(words, JNGramModel(JNGramCounter(2, corpus)),
                                  jdec.DecoderConfig(**cfg), max_in_degree)
        t = tdec._word_lm_factors(words, NGramModel(NGramCounter(2, corpus)),
                                  tdec.DecoderConfig(**cfg), max_in_degree)
        np.testing.assert_array_equal(t[0], j[0])
        np.testing.assert_array_equal(t[1], j[1])
        for a, b in zip(t[2], j[2]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
        assert t[3] == j[3]


def test_graph_decode_and_batch_match_jax():
    """The graph's own decode on features (emissions computed by each
    package: fp32 reassociation, so scores within 1e-5 relative) and
    ``decode_batch`` equal to looping ``decode``."""
    jg, tg, rng = _graphs(10, "dense", seed=12)
    mu = np.asarray(jg.mu)[:, 0]
    sm, pm = np.asarray(jg.state_map), np.asarray(jg.pad_mask)
    frames = []
    for w in ("w004", "w001", "w007"):  # a planted word sequence
        wi = jg.words.index(w)
        for s in np.flatnonzero(pm[wi]):
            frames += [mu[sm[wi, s]] + rng.normal(scale=0.05, size=DIM)] * 3
    obs = np.asarray(frames, np.float32)
    j_words, j_path, j_score = jg.decode(obs)
    words, path, score = tg.decode(obs)
    assert words == j_words == ["w004", "w001", "w007"]
    np.testing.assert_array_equal(path, np.asarray(j_path))
    assert score == pytest.approx(j_score, rel=1e-5)
    assert tg.path_to_alignment(path) == jg.path_to_alignment(np.asarray(j_path))
    t = len(obs)
    feats = np.stack([obs, np.concatenate([obs[5:], np.zeros((5, DIM), np.float32)])])
    masks = np.stack([np.ones(t, bool), np.arange(t) < t - 5])
    batch = tg.decode_batch(feats, masks)
    for b in range(2):
        w1, p1, s1 = tg.decode(feats[b], masks[b])
        assert batch[b][0] == w1 and np.array_equal(batch[b][1], p1) and batch[b][2] == s1
    j_batch = jg.decode_batch(feats, masks)
    assert [b[0] for b in batch] == [b[0] for b in j_batch]


def test_kernel_dispatch_and_capacity():
    """The graph's kernels are picked by hop kind alone (``has_kernel``):
    a dense hop, edge-free factors or no hop, never sparse edges. The H100
    rule takes the serving graph (V = 1001, S = 8) and the rank-1 factors
    far past it (up to one thread per cell of a block's ceil(V / SMs)
    words)."""
    for hop_mode, loop, has in (("dense", True, True), ("rank1", True, True),
                                ("dense", False, True), ("backoff", True, False)):
        _, tg, _ = _graphs(6, hop_mode, loop, seed=1)
        assert tg.has_kernel == has
    assert F.factored_kernel_ok(511, 1001, 8, torch.zeros(1001, 1001), 132)
    assert not F.factored_kernel_ok(511, 8000, 8, torch.zeros(1, 1), 132)  # hop columns past smem
    rank1 = F.Rank1Hop(*(torch.zeros(16000) for _ in range(3)), -1)
    assert F.factored_kernel_ok(511, 16000, 8, rank1, 132)
    assert F.factored_kernel_ok(511, 16000, 8, None, 132)
    assert not F.factored_kernel_ok(511, 20000, 8, None, 132)  # 152 words x 8 cells > 1024 threads
    assert not F.factored_kernel_ok(200_000, 16000, 8, None, 132)  # grids past 2 GiB
    _, tb, _ = _graphs(6, "backoff", seed=1)
    assert not F.factored_kernel_ok(100, 7, 4, tb.hop, 132)
    assert F.factored_forward.launches == 0 and F.factored_backtrace.launches == 0


def test_decode_grid_routes_by_hop_kind(monkeypatch):
    """The 1-best decode takes the forward and backtrace wrappers for dense
    and rank-1 hops and the loop-free graph (their plain versions on the
    CPU, counting no launch; results as before, the scan's bitwise) and the
    scan for factors with sparse edges. A CUDA graph past D's capacity (a
    1-SM card) or in float64 raises instead of dropping to the scan."""
    calls = []
    for name in ("factored_forward", "factored_backtrace", "factored_trellis_scan"):
        real = getattr(tdec, name)

        def spy(*args, _real=real, _name=name, **kw):
            calls.append(_name)
            return _real(*args, **kw)

        monkeypatch.setattr(tdec, name, spy)
    routes = {}
    for hop_mode, loop in (("dense", True), ("rank1", True), ("dense", False), ("backoff", True)):
        jg, tg, rng = _graphs(7, hop_mode, loop, seed=3)
        obs = rng.normal(scale=8.0, size=(23, DIM)).astype(np.float32)
        log_b, pi_grid, final_grid = _grid_inputs(jg, obs)
        mask = np.arange(23) < 19
        calls.clear()
        path, score = tg._decode_grid(_t(log_b), _t(pi_grid), _t(final_grid), _t(mask))
        routes[(hop_mode, loop)] = list(calls)
        j_path, j_score = jdec.factored_trellis_scan(
            jnp.asarray(log_b), jg.inner_a, jg.hop, jnp.asarray(pi_grid),
            jnp.asarray(final_grid), jg.exit_idx, jnp.asarray(mask))
        np.testing.assert_array_equal(path.numpy(), np.asarray(j_path))
        np.testing.assert_array_equal(score.numpy(), np.asarray(j_score))
    kernels = ["factored_forward", "factored_backtrace"]
    assert routes == {("dense", True): kernels, ("rank1", True): kernels,
                      ("dense", False): kernels, ("backoff", True): ["factored_trellis_scan"]}
    monkeypatch.undo()

    # a 300-word dense graph: within D's capacity on 132 SMs, past it on 1;
    # the CUDA emissions stand in with their device, dtype and shape, all
    # the wrapper reads before it refuses
    rng = np.random.default_rng(2)
    units = {f"u{i:03d}": _unit(rng.normal(scale=8.0, size=DIM), 2 + i % 3, rng)
             for i in range(300)}
    big = tdec.FactoredDecodingGraph.build(Lexicon.whole_word(sorted(units)), units, None,
                                           tdec.DecoderConfig(), hop_mode="dense", device="cpu")
    v, s = big.grid_shape
    assert F.factored_kernel_ok(5, v, s, big._kernel_hop, 132)
    assert not F.factored_kernel_ok(5, v, s, big._kernel_hop, 1)

    def cuda_log_b(dtype):
        return types.SimpleNamespace(device=torch.device("cuda"), shape=(5, v, s), dtype=dtype,
                                     dim=lambda: 3)

    grid = torch.zeros(v, s)
    monkeypatch.setattr(F, "sm_count", lambda dev: 1)
    with pytest.raises(ValueError, match="past the factored kernels' capacity"):
        big._decode_grid(cuda_log_b(torch.float32), grid, grid, None)
    monkeypatch.setattr(F, "sm_count", lambda dev: 132)
    with pytest.raises(ValueError, match="log_b_grid must be torch.float32"):
        big._decode_grid(cuda_log_b(torch.float64), grid, grid, None)
    assert F.factored_forward.launches == 0 and F.factored_backtrace.launches == 0
