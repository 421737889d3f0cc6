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
    """Factors with sparse edges: the scan decodes them, in both packages,
    with the same hop-entry argmax rules, and the kernels' plain D and E
    take them as a CSR of their finite arcs (``BackoffHop``) with the same
    path and score."""
    jg, tg, rng = _graphs(8, "backoff", seed=4)
    assert F.hop_kind(tg.hop) == "backoff" and not tg.hop_rank1_only
    assert isinstance(tg._kernel_hop, F.BackoffHop) and F.hop_kind(tg._kernel_hop) == "backoff"
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
        e, s = F.hop_entry(_t(exit_v), tg._kernel_hop)  # the CSR: every entry is finite
        assert np.isfinite(e.numpy()).all()
        np.testing.assert_array_equal(e.numpy(), np.asarray(j_e))
        np.testing.assert_array_equal(s.numpy(), np.asarray(j_s))
    grids = F.factored_forward(_t(pi_grid), tg.inner_a, tg.exit_idx, tg._kernel_hop, _t(log_b),
                               _t(mask))
    path, score = F.factored_backtrace(grids, tg.inner_a, tg.exit_idx, tg._kernel_hop,
                                       _t(final_grid), _t(mask))
    np.testing.assert_array_equal(path.numpy(), np.asarray(j_path))
    assert score.numpy().view(np.int32) == np.asarray(j_score).view(np.int32)
    assert F.factored_forward.launches == 0 and F.factored_backtrace.launches == 0


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
        assert t[3] > 0  # the clamp path is exercised (8 clamps at this seed)


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
    """Every hop kind has kernels (``has_kernel``): a dense hop, edge-free
    factors, factors with sparse edges (as a ``BackoffHop``) or no hop. The
    H100 rule takes the serving graph (V = 1001, S = 8) and the rank-1 and
    backoff factors far past it (up to one thread per cell of a block's
    ceil(V / SMs) words); padded factors are the scans' operand, not the
    kernels'."""
    for hop_mode, loop, has in (("dense", True, True), ("rank1", True, True),
                                ("dense", False, True), ("backoff", True, True)):
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
    assert not F.factored_kernel_ok(100, 7, 4, tb.hop, 132)  # padded rows: the scans' operand
    assert F.factored_kernel_ok(100, 7, 4, tb._kernel_hop, 132)
    assert F.factored_forward.launches == 0 and F.factored_backtrace.launches == 0


def test_decode_grid_routes_by_hop_kind(monkeypatch):
    """The 1-best decode takes the forward and backtrace wrappers for every
    hop kind: dense, rank-1 and backoff hops and the loop-free graph (their
    plain versions on the CPU, counting no launch; results the JAX scan's
    bitwise), never the scan. A CUDA graph past D's capacity (a 1-SM card)
    or in float64 raises instead of dropping to the scan."""
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
                      ("dense", False): kernels, ("backoff", True): kernels}
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


# -- kernel E's windowed replay (csrc/factored_backtrace.cu), a NumPy model --


def _take(best, pair):
    """(value, index) argmax merge: the larger value, the smaller index on
    a tie."""
    if best is None or pair[0] > best[0] or (pair[0] == best[0] and pair[1] < best[1]):
        return pair
    return best


def _lane_argmax(cand, vec):
    """First argmax of ``cand`` as kernels F (``vec=1``) and E (``vec=4``)
    reduce it over one warp: lane l carries four (value, index) pairs, each
    over increasing sources with strict >. F: pair k over l + 32k + 128m
    (the tail past the last full 128 into pair 0), starting at (-inf,
    l + 32k). E: lane l loads the float4s l + 32m of the row padded to a
    multiple of 4 with -inf, pair k over their component k, 4 (l + 32m) + k,
    starting at (-inf, 4l + k). The pairs, then the lanes, merge by the
    larger value and, on a tie, the smaller index."""
    n, best = len(cand), None
    if vec == 4:
        cand = np.concatenate([cand, np.full(-n % 4, -np.inf, np.float32)])
    for lane in range(32):
        if vec == 1:
            pairs = [(np.float32(-np.inf), lane + 32 * k) for k in range(4)]
            v = lane
            while v + 96 < n:
                for k in range(4):
                    if cand[v + 32 * k] > pairs[k][0]:
                        pairs[k] = (cand[v + 32 * k], v + 32 * k)
                v += 128
            while v < n:
                if cand[v] > pairs[0][0]:
                    pairs[0] = (cand[v], v)
                v += 32
        else:
            pairs = [(np.float32(-np.inf), 4 * lane + k) for k in range(4)]
            for q in range(lane, len(cand) // 4, 32):
                for k in range(4):
                    if cand[4 * q + k] > pairs[k][0]:
                        pairs[k] = (cand[4 * q + k], 4 * q + k)
        for pair in pairs:
            best = _take(best, pair)
    return best


def _windowed_backtrace(grids, inner_a, exit_idx, hop, final_grid, mask, k):
    """What kernel E computes, step by step: the pre-pass's exit scores;
    termination at the first flat maximum; then windows of ``k`` frames of
    one word. For each frame of a window (a warp each, in parallel) the hop's
    first argmax (``_lane_argmax``, E's float4 lanes; rank-1 adds ``uni[w]``
    after it) and a table row: each local state's predecessor (itself on a
    masked frame, else the first within-word s, or at j = 0 the hop's source
    exit where the hop is strictly larger). One thread walks the table and
    ends the window at a step that leaves the word. Returns ``(path, score,
    windows)`` with each window as ``(first frame, steps, the step that left
    the word or None, whether its first step is masked)``."""
    grids = np.asarray(grids, np.float32)
    ia = np.asarray(inner_a, np.float32)
    ei = np.asarray(exit_idx)
    t_len, v_words, s_max = grids.shape
    kind = F.hop_kind(hop)
    valid = np.ones(t_len, bool) if mask is None else np.asarray(mask, bool)
    exits = grids[:, np.arange(v_words), ei]  # the pre-pass
    flat = (grids[-1] + np.asarray(final_grid, np.float32)).reshape(-1)
    state = int(np.argmax(flat))
    score = flat[state]
    path = np.zeros(t_len, np.int32)
    path[-1] = state
    windows, tau = [], t_len - 1
    while tau >= 1:
        w, steps = state // s_max, min(k, tau)
        lo = w * s_max
        if kind == "dense":
            col = np.asarray(hop, np.float32)[:, w]
        elif kind == "rank1":
            col = np.asarray(hop.sil_from if w == hop.sil_idx else hop.from_w, np.float32)
        tab = np.zeros((steps, s_max), np.int64)
        for i in range(steps):  # warp i, all in parallel in the kernel
            r = grids[tau - i - 1, w]
            hv, hpred = np.float32(-np.inf), -1
            if kind != "none" and valid[tau - i]:
                hv, a = _lane_argmax(exits[tau - i - 1] + col, 4)
                if kind == "rank1" and w != hop.sil_idx:
                    hv = np.float32(hv + np.float32(hop.uni[w]))
                hpred = a * s_max + int(ei[a])
            for j in range(s_max):
                tab[i, j] = lo + j
                if valid[tau - i]:
                    m, sa = r[0] + ia[w, 0, j], 0
                    for s in range(1, s_max):
                        c = r[s] + ia[w, s, j]
                        if c > m:
                            m, sa = c, s
                    tab[i, j] = hpred if j == 0 and hv > m else lo + sa
        cur, end = state, None  # the walk: one thread, no barrier
        for i in range(steps):
            cur = int(tab[i, cur - lo])
            path[tau - i - 1] = cur
            if not lo <= cur < lo + s_max:
                end = i
                break
        windows.append((tau, steps, end, not valid[tau]))
        tau -= steps if end is None else end + 1
        state = cur
    return path, score, windows


def _np_hop(hop):
    if hop is None or torch.is_tensor(hop):
        return None if hop is None else hop.numpy()
    return F.Rank1Hop(*(x.numpy() if torch.is_tensor(x) else x for x in hop))


def _planted_obs(jg, words, durations, rng, noise=0.3):
    """Frames near the means of ``words``, word i spread over
    ``durations[i]`` frames (as evenly as its states allow)."""
    mu = np.asarray(jg.mu)[:, 0]
    sm, pm = np.asarray(jg.state_map), np.asarray(jg.pad_mask)
    frames = []
    for w, d in zip(words, durations):
        wi = jg.words.index(w)
        states = sm[wi][pm[wi]]
        n = len(states)
        for q, st in enumerate(states):
            frames += [mu[st] + rng.normal(scale=noise, size=DIM)
                       for _ in range(d // n + (q < d % n))]
    return np.asarray(frames, np.float32)


def _window_case(name):
    """``(log_b, pi_grid, final_grid, mask, jax hop, port kernel hop,
    inner_a, exit_idx)`` NumPy/port inputs for one case of kernel E's model;
    the JAX package decodes the same arrays."""
    if name == "ties":  # uniform emissions, stay == advance, all hops equal
        v, s, t = 7, 3, 23
        inner = np.full((v, s, s), -np.inf, np.float32)
        for j in range(s):
            inner[:, j, j] = np.log(0.5)
            if j + 1 < s:
                inner[:, j, j + 1] = np.log(0.5)
        pi = np.full((v, s), -np.inf, np.float32)
        pi[:, 0] = 0.0
        mask = np.arange(t) < 20
        mask[7] = False
        return (np.zeros((t, v, s), np.float32), pi, np.zeros((v, s), np.float32), mask,
                jnp.zeros((v, v), jnp.float32), _t(np.zeros((v, v), np.float32)), _t(inner),
                _t(np.full(v, s - 1, np.int32)))
    hop_mode, loop, with_lm = {
        "dense": ("dense", True, True), "rank1-silence": ("rank1", True, True),
        "no-hop": ("dense", False, True), "integer-ties": ("dense", True, True),
        "planted": ("dense", True, False)}[name]
    jg, tg, rng = _graphs(9, hop_mode, loop, with_lm=with_lm, seed=21)
    if name == "planted":  # many word changes, words of 2-33 steps and 64
        words = [jg.words[i] for i in (3, 0, 5, 8, 1, 6, 2, 7, 4, 3, 1, 8, 0, 5)]
        durations = [33, 3, 32, 4, 64, 6, 7, 33, 2, 32, 5, 65, 3, 9]
        obs = _planted_obs(jg, words, durations, rng)
    else:
        obs = rng.normal(scale=8.0, size=(77, DIM)).astype(np.float32)
    log_b, pi_grid, final_grid = _grid_inputs(jg, obs)
    if name == "integer-ties":
        log_b = np.round(log_b / 8.0)
    t = len(obs)
    mask = np.arange(t) < t - 5  # a bucket's tail: the first window starts masked
    mask[[1, t - 38, t - 37, t // 2]] = False  # and gaps inside and at window edges
    return log_b, pi_grid, final_grid, mask, jg.hop, tg._kernel_hop, tg.inner_a, tg.exit_idx


WINDOW_CASES = ["dense", "rank1-silence", "no-hop", "ties", "integer-ties", "planted"]


def _check_window_case(name, k):
    """Kernel E's model on one case, held bitwise (path and score) against
    the plain replay, the JAX package's scan decoder and, for a dense hop or
    none, its ``factored_backtrace``; and ``backtrace_windows`` finds its
    windows from the path. Returns ``(the model's windows, the inputs)``."""
    from lnasr_tpu.ops.factored_pallas import factored_backtrace as j_backtrace

    case = _window_case(name)
    log_b, pi_grid, final_grid, mask, j_hop, hop, inner_a, exit_idx = case
    grids = F.factored_forward_plain(_t(pi_grid), inner_a, exit_idx, hop, _t(log_b), _t(mask))
    path, score, windows = _windowed_backtrace(grids.numpy(), inner_a.numpy(), exit_idx.numpy(),
                                               _np_hop(hop), final_grid, mask, k)
    p_path, p_score = F.factored_backtrace(grids, inner_a, exit_idx, hop, _t(final_grid), _t(mask))
    np.testing.assert_array_equal(path, p_path.numpy())
    assert score.view(np.int32) == p_score.numpy().view(np.int32)
    j_path, j_score = jdec.factored_trellis_scan(
        jnp.asarray(log_b), jnp.asarray(inner_a.numpy()), j_hop, jnp.asarray(pi_grid),
        jnp.asarray(final_grid), jnp.asarray(exit_idx.numpy()), jnp.asarray(mask))
    np.testing.assert_array_equal(path, np.asarray(j_path))
    assert score.view(np.int32) == np.asarray(j_score).view(np.int32)
    if F.hop_kind(hop) != "rank1":
        b_path, b_score = j_backtrace(jnp.asarray(grids.numpy()), jnp.asarray(inner_a.numpy()),
                                      jnp.asarray(exit_idx.numpy()), None if hop is None else j_hop,
                                      jnp.asarray(final_grid), jnp.asarray(mask))
        np.testing.assert_array_equal(path, np.asarray(b_path))
        assert score.view(np.int32) == np.asarray(b_score).view(np.int32)
    assert F.backtrace_windows(path, mask, grids.shape[2], k) == [w[0] for w in windows]
    return windows, case


@pytest.mark.parametrize("name", WINDOW_CASES)
@pytest.mark.parametrize("k", [1, 3, 32])
def test_windowed_backtrace_model_bitwise(name, k):
    """Kernel E's windowed walk, modelled in NumPy, gives the plain
    replay's and the JAX package's path and score bitwise: dense and
    rank-1 hops (with a silence word), no hop, exact ties in the hop argmax
    and within words, masks inside windows and at their first step."""
    windows, case = _check_window_case(name, k)
    assert sum(w[1] if w[2] is None else w[2] + 1 for w in windows) == case[0].shape[0] - 1
    if name == "rank1-silence":
        assert case[5].sil_idx >= 0


@pytest.mark.parametrize("k", [3, 32])
def test_windowed_backtrace_model_edges(k):
    """Across the cases, windows end on a hop at their first and at their
    last step, start on a masked frame, and hold masked frames inside."""
    ends, first_masked, masked_inside = set(), False, False
    for name in WINDOW_CASES:
        windows, case = _check_window_case(name, k)
        mask = case[3]
        for tau, steps, end, masked_first in windows:
            walked = steps if end is None else end + 1
            ends.add(end)
            first_masked |= masked_first
            masked_inside |= not mask[tau - walked + 1:tau].all()
    assert 0 in ends and k - 1 in ends
    assert first_masked and masked_inside


@pytest.mark.parametrize("n", [1, 5, 31, 32, 33, 97, 128, 129, 257, 1001])
@pytest.mark.parametrize("vec", [1, 4])
def test_lane_argmax_takes_the_first_index(n, vec):
    """The four-pair lane reductions of kernels F (strided) and E (float4)
    return torch.max's first index on random values, on integer ties and
    when every candidate is -inf (index 0)."""
    rng = np.random.default_rng(n)
    for cand in (rng.normal(size=n), np.round(rng.normal(size=n)), np.full(n, -np.inf),
                 np.where(rng.random(n) < 0.7, -np.inf, np.round(rng.normal(size=n)))):
        cand = cand.astype(np.float32)
        m, a = torch.max(torch.as_tensor(cand), dim=0)
        assert _lane_argmax(cand, vec) == (cand[int(a)], int(a))
        assert cand[int(a)] == m.numpy() or (np.isinf(m.numpy()) and np.isinf(cand[int(a)]))


def test_backtrace_windows_and_capacity():
    """``backtrace_windows`` counts windows from a path (K steps, or up to a
    step into another word; masked steps keep the word) and the backtrace's
    shared memory enters the capacity rule."""
    s = 4
    path = np.array([0] * 10 + [5] * 3 + [9] * 40, np.int32)  # words 0, 1, 2
    assert F.backtrace_windows(path, None, s, 32) == [52, 20, 12, 9]  # 40 = 32 + 8 in word 2
    assert len(F.backtrace_windows(path, None, s, 1)) == len(path) - 1
    assert F.backtrace_windows(path[:1], None, s) == []
    assert F.backtrace_smem_bytes(1001, 8, "dense") == 4 * (1004 + 64 + 2 * 32 * 8)
    assert F.backtrace_smem_bytes(1001, 8, "none") == 4 * (64 + 2 * 32 * 8)
    # 438 words a forward block on 132 SMs, S = 2: the forward's block fits
    # (876 threads, ~15 KB), E's hop column does not
    v = 57800
    rank1 = F.Rank1Hop(*(torch.zeros(v) for _ in range(3)), -1)
    assert -(-v // 132) * 2 <= F.MAX_THREADS
    assert F.forward_smem_bytes(v, 2, 438, "rank1", n_blocks=132) + 1024 <= F.SMEM_LIMIT
    assert F.backtrace_smem_bytes(v, 2, "rank1") + 1024 > F.SMEM_LIMIT
    assert not F.factored_kernel_ok(16, v, 2, rank1, 132)
    assert F.factored_kernel_ok(16, v, 2, None, v)  # no hop, no column
    # past MAX_BLOCKS blocks the rank-1 kind has no kernel, whatever fits
    v = 2000
    rank1 = F.Rank1Hop(*(torch.zeros(v) for _ in range(3)), -1)
    assert F.factored_kernel_ok(16, v, 2, rank1, v // 2) and F.lattice_kernel_ok(v, 2, rank1, v // 2)
    assert not F.factored_kernel_ok(16, v, 2, rank1, v) and not F.lattice_kernel_ok(v, 2, rank1, v)
    assert F.factored_kernel_ok(16, v, 2, None, v)
