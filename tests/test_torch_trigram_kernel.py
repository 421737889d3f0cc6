"""Kernel H (the exact trigram decode) on the CPU: its plain version, a
NumPy model of the kernel's schedule, and the wrappers' dispatch.

- ``ops.trigram.trigram_viterbi_plain`` (the frame loop the kernel is held
  to bitwise on the card) against the JAX package's jitted ``_decode_fn``
  and ``decode_batch`` of ``TrigramDecodingGraph``, bitwise in path and
  score, at float64 and float32, with and without silence, order-2 and
  order-3 LMs, on the same grid emissions: both packages' emission
  functions are replaced, for the test, by the identity on per-state
  scores, so the two decoders read the same numbers.
- Quantized scores that force each tie rule: the first within-word
  source, the first history on a hop, a hop equal to ``within`` at state 0
  (which does not win), all-``-inf`` columns; masked frames at the start,
  inside and at the end; T = 2, and T = 1 (which the JAX decode refuses)
  against the JAX decode of the same frame and a masked one.
- A NumPy model of what ``csrc/trigram_forward.cu`` and
  ``csrc/trigram_backtrace.cu`` do (blocks owning ``ceil(H / SMs)``
  history rows, the within-word pass that finishes every state but the
  hop targets, the exit columns of the last valid frame, the hop pass over
  the H sources in order, self pointers at masked frames, each block's
  first final maximum merged in block order, the one-thread walk), held
  bitwise against the plain version at several SM counts.
- The wrappers: CPU tensors take the plain version and count no launch;
  a CUDA tensor goes to the kernel or raises (a stand-in, since this
  machine has no card), never to the frame loop. The route rule.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lnasr_tpu.config import GMMHMMConfig as JGMMHMMConfig
from lnasr_tpu.models import decoder as jdec
from lnasr_tpu.models.decoder import DecoderConfig as JDecoderConfig
from lnasr_tpu.models.decoder import TrigramDecodingGraph as JTrigram
from lnasr_tpu.models.gmmhmm import GMMHMM as JGMMHMM
from lnasr_tpu.models.lexicon import Lexicon as JLexicon
from lnasr_tpu.models.ngram import NGramCounter as JNGramCounter
from lnasr_tpu.models.ngram import NGramModel as JNGramModel
from lnasr_tpu.models.ngram import Tokenizer as JTokenizer
from lnasr_tpu_torch.convert import units_from_numpy
from lnasr_tpu_torch.models import decoder as tdec
from lnasr_tpu_torch.models.decoder import DecoderConfig, TrigramDecodingGraph
from lnasr_tpu_torch.models.lexicon import Lexicon
from lnasr_tpu_torch.models.ngram import NGramCounter, NGramModel
from lnasr_tpu_torch.ops import trigram as tri

WORDS = ("alpha", "bravo", "charlie", "delta", "echo")
CORPUS = ["alpha bravo charlie", "charlie alpha bravo delta", "bravo bravo alpha echo",
          "alpha charlie echo delta", "delta echo bravo", "echo alpha"]


def _jax_unit(seed, n_states):
    m = JGMMHMM(JGMMHMMConfig(n_states=n_states, n_mix=1, dim=2), dtype=jnp.float64)
    rng = np.random.default_rng(seed)
    m.init_left_to_right(rng.normal(size=(4 * n_states, 2)) + seed, jax.random.PRNGKey(0))
    return m


@functools.lru_cache(maxsize=None)
def _graphs(order, silence, dtype):
    """The JAX and the port's trigram graphs over five words of 1-3 states
    (and a 4-state silence), an LM of ``order`` counted from CORPUS. Cached,
    so that the tests share each JAX graph's compiled decode (traced with
    the identity emissions: every caller of the JAX graph uses them)."""
    units = {u: _jax_unit(k, 1 + k % 3) for k, u in enumerate("ABCDE")}
    units["<sil>"] = _jax_unit(9, 4)
    lex = {w: ("ABCDE"[k],) for k, w in enumerate(WORDS)}
    toks = [JTokenizer.get_tokens(s) for s in CORPUS]
    cfg = dict(lm_scale=1.3, word_insertion_penalty=-0.4)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    jg = JTrigram.build(JLexicon(lex), units, JNGramModel(JNGramCounter(order, toks)),
                        JDecoderConfig(**cfg), silence_model=units["<sil>"] if silence else None,
                        dtype=jdt)
    t_units = units_from_numpy(units, device="cpu", dtype=torch.float64)
    tg = TrigramDecodingGraph.build(Lexicon(lex), t_units, NGramModel(NGramCounter(order, toks)),
                                    DecoderConfig(**cfg),
                                    silence_model=t_units["<sil>"] if silence else None,
                                    dtype=dtype, device="cpu")
    return jg, tg


@pytest.fixture
def identity_emissions(monkeypatch):
    """Both decoders read their ``obs`` as per-state log-likelihoods."""
    monkeypatch.setattr(jdec, "gmm_emissions_diag", lambda obs, *a: (obs, None))
    monkeypatch.setattr(tdec, "_emissions", lambda obs, *a: obs)


def _scores(rng, t_len, n_real, quantum=None):
    x = rng.normal(scale=3.0, size=(t_len, n_real))
    return np.round(x / quantum) * quantum if quantum else x


def _plain(tg, obs, mask):
    log_b = tg._grid_log_b(torch.as_tensor(obs, dtype=tg.dtype))
    m = None if mask is None else torch.as_tensor(mask)
    return tri.trigram_viterbi_plain(log_b, m, tg.inner_a, tg.hop3, tg.log_pi_w, tg.final3,
                                     tg.exit_idx)


def _jax(jg, obs, mask, **tables):
    args = dict(inner_a=jg.inner_a, hop3=jg.hop3, log_pi_w=jg.log_pi_w, final3=jg.final3)
    args.update({k: jnp.asarray(v, jg.dtype) for k, v in tables.items()})
    path, score = jg._decode_fn(jnp.asarray(obs, jg.dtype),
                                None if mask is None else jnp.asarray(mask), args["inner_a"],
                                args["hop3"], args["log_pi_w"], args["final3"], jg.exit_idx,
                                jg.state_map, jg.pad_mask, jg.log_w, jg.mu, jg.cov)
    return np.asarray(path), np.asarray(score)


def _same(got, ref):
    path, score = got
    np.testing.assert_array_equal(path.numpy(), ref[0])
    assert path.dtype == torch.int32
    assert score.numpy().tobytes() == np.asarray(ref[1], score.numpy().dtype).tobytes()


CASES = [(order, silence, dtype) for order in (2, 3) for silence in (False, True)
         for dtype in (torch.float64, torch.float32)]


@pytest.mark.parametrize("order,silence,dtype", CASES)
def test_plain_matches_jax_decode_fn(identity_emissions, order, silence, dtype):
    """Random and quantized scores, masks at the start, inside and at the
    end, T = 40, 2 and 1: the plain version's path and score are the JAX
    jitted decode's, bit for bit."""
    jg, tg = _graphs(order, silence, dtype)
    n_real = tg.state_map.max().item() + 1
    rng = np.random.default_rng(order * 10 + silence)
    for quantum in (None, 1.0, 0.5):
        obs = _scores(rng, 40, n_real, quantum)
        for mask in (None, np.arange(40) < 33, np.r_[[True] + [False] * 4, [True] * 35],
                     np.r_[[True] * 12, [False] * 5, [True] * 23]):
            _same(_plain(tg, obs, mask), _jax(jg, obs, mask))
    obs = _scores(rng, 2, n_real)
    for mask in (np.ones(2, bool), np.zeros(2, bool)):
        _same(_plain(tg, obs, mask), _jax(jg, obs, mask))
    # T = 1: the JAX decode refuses it (its backpointers' reshape(0, -1)),
    # so it is held to the JAX decode of the same frame followed by a
    # masked one, which keeps the grid
    path, score = _plain(tg, obs[:1], None)
    ref = _jax(jg, obs, np.array([True, False]))
    _same((path, score), (ref[0][:1], ref[1]))


def _tie_tables(tg, rng):
    """Graph tables quantized to a coarse grid so that hops, sources and
    final states tie, with -inf entries kept (and whole hop columns set to
    -inf) so that all-``-inf`` candidate sets occur."""
    hop3 = np.round(tg.hop3.numpy())  # -inf stays -inf
    hop3[:, :, 1] = -np.inf  # no word ever enters word 1 by a hop
    hop3[2] = np.round(rng.normal(size=hop3[2].shape))  # history 2 ties history 0's rows
    hop3[0] = hop3[2]
    inner_a = tg.inner_a.numpy().copy()
    inner_a[inner_a > -np.inf] = 0.0  # every within-word source ties
    return dict(inner_a=inner_a, hop3=hop3, log_pi_w=np.round(tg.log_pi_w.numpy()),
                final3=np.zeros_like(tg.final3.numpy()))


@pytest.mark.parametrize("order,silence,dtype", CASES)
def test_plain_tie_rules_match_jax(identity_emissions, order, silence, dtype):
    """Quantized tables and integer scores force every tie rule (the first
    source, the first history, a hop equal to ``within`` at state 0, the
    first final state, all-``-inf`` columns); the path and score are the
    JAX decode's."""
    jg, tg = _graphs(order, silence, dtype)
    n_real = tg.state_map.max().item() + 1
    rng = np.random.default_rng(7 + order)
    tables = _tie_tables(tg, rng)
    tt = {k: torch.as_tensor(v, dtype=dtype) for k, v in tables.items()}
    for mask in (None, np.r_[[True] * 20, [False] * 3, [True] * 17]):
        obs = _scores(rng, 40, n_real, quantum=1.0)
        log_b = tg._grid_log_b(torch.as_tensor(obs, dtype=dtype))
        m = None if mask is None else torch.as_tensor(mask)
        got = tri.trigram_viterbi_plain(log_b, m, tt["inner_a"], tt["hop3"], tt["log_pi_w"],
                                        tt["final3"], tg.exit_idx)
        _same(got, _jax(jg, obs, mask, **tables))
        # the same ties through the kernel's model
        _same(_model(log_b, m, tt, tg.exit_idx, n_sm=3), _jax(jg, obs, mask, **tables))


@pytest.mark.parametrize("order,silence,dtype", CASES)
def test_graph_decode_batch_matches_jax(identity_emissions, order, silence, dtype):
    """``TrigramDecodingGraph.decode_batch`` (the wrapper on CPU tensors,
    one batched decode) against the JAX ``decode_batch`` (one vmapped
    program): words, paths and scores bitwise, and equal to looping
    ``decode``."""
    jg, tg = _graphs(order, silence, dtype)
    n_real = tg.state_map.max().item() + 1
    rng = np.random.default_rng(3 * order + silence)
    obs = _scores(rng, 3 * 24, n_real).reshape(3, 24, n_real)
    masks = np.arange(24)[None, :] < np.array([24, 17, 1])[:, None]
    out, jout = tg.decode_batch(obs, masks), jg.decode_batch(obs, masks)
    for b in range(3):
        assert out[b][0] == jout[b][0]
        np.testing.assert_array_equal(out[b][1], np.asarray(jout[b][1]))
        assert out[b][2] == jout[b][2]
        words, path, score = tg.decode(obs[b], masks[b])
        assert words == out[b][0] and score == out[b][2]
        np.testing.assert_array_equal(path, out[b][1])


# -- a NumPy model of kernel H --------------------------------------------------


def _model_forward(log_b, mask, inner_a, hop3, log_pi_w, final3, exit_idx, n_sm):
    """What ``csrc/trigram_forward.cu`` computes, block by block and in its
    order, in the working dtype: ``(bts, score, last)``. The exchange is
    modelled by its effect: a block reads the exit columns of the last
    valid frame (``tests/test_torch_exchange.py`` models the tagged words
    for kernel D)."""
    t_len, v, s = log_b.shape
    h = v + 1
    vs = v * s
    rpb = tri.rows_per_block(h, n_sm)
    blocks = -(-h // rpb)
    ninf = log_b.dtype.type(-np.inf)
    grid = np.empty((h, v, s), log_b.dtype)
    for blk in range(blocks):  # frame 0
        for r in range(min(rpb, h - blk * rpb)):
            hh = blk * rpb + r
            for w in range(v):
                for j in range(s):
                    init = log_pi_w[w] if hh == h - 1 and j == 0 else ninf
                    grid[hh, w, j] = init + log_b[0, w, j]
    bts = np.empty((max(t_len - 1, 0), h, v, s), np.int32)
    for t in range(1, t_len):
        if mask is not None and not mask[t]:
            bts[t - 1] = np.arange(h * vs).reshape(h, v, s)
            continue
        exits = grid[:, np.arange(v), exit_idx]  # (H, V) of the last valid frame
        new = np.empty_like(grid)
        for blk in range(blocks):
            h0 = blk * rpb
            nr = min(rpb, h - h0)
            nhop = max(0, min(nr, v - h0))
            src0 = np.zeros((nr, v), np.int64)
            for r in range(nr):  # pass 1: within-word
                for w in range(v):
                    for j in range(s):
                        m, src = grid[h0 + r, w, 0] + inner_a[w, 0, j], 0
                        for q in range(1, s):
                            c = grid[h0 + r, w, q] + inner_a[w, q, j]
                            if c > m:
                                m, src = c, q
                        if j == 0 and r < nhop:
                            new[h0 + r, w, 0] = m
                            src0[r, w] = src
                        else:
                            new[h0 + r, w, j] = m + log_b[t, w, j]
                            bts[t - 1, h0 + r, w, j] = ((h0 + r) * v + w) * s + src
            for r in range(nhop):  # pass 2: the hop, the H sources in order
                u = h0 + r
                for w in range(v):
                    best, arg = exits[0, u] + hop3[0, u, w], 0
                    for hs in range(1, h):
                        c = exits[hs, u] + hop3[hs, u, w]
                        if c > best:
                            best, arg = c, hs
                    m = new[u, w, 0]
                    b = (u * v + w) * s + src0[r, w]
                    if best > m:
                        m, b = best, (arg * v + u) * s + exit_idx[u]
                    new[u, w, 0] = m + log_b[t, w, 0]
                    bts[t - 1, u, w, 0] = b
        grid = new
    parts = []
    for blk in range(blocks):  # each block's first maximum, then block order
        bv, bi = ninf, np.iinfo(np.int32).max
        for k in range(min(rpb, h - blk * rpb) * vs):
            hh, w, j = blk * rpb + k // vs, k % vs // s, k % s
            c = grid[hh, w, j] + (final3[hh, w] if j == exit_idx[w] else ninf)
            if c > bv or (c == bv and blk * rpb * vs + k < bi):
                bv, bi = c, blk * rpb * vs + k
        parts.append((bv, bi))
    score, last = parts[0]
    for pv, pi in parts[1:]:
        if pv > score or (pv == score and pi < last):
            score, last = pv, pi
    return bts, score, last


def _take4(best, arg, c, h):
    """The resident route's step of four hop sources h .. h + 3 (values
    ``c``): the first maximum of each pair, of the pairs, then against the
    sources before, each taken only when strictly larger."""
    i01, i23 = h + int(c[1] > c[0]), h + 2 + int(c[3] > c[2])
    v01, v23 = c[i01 - h], c[i23 - h]
    v, i = (v23, i23) if v23 > v01 else (v01, i01)
    return (v, i) if v > best else (best, arg)


def _resident_model_forward(log_b, mask, inner_a, hop3, log_pi_w, final3, exit_idx, n_sm,
                            kr=tri.RESIDENT_KR):
    """What ``csrc/trigram_forward.cu``'s resident route computes, block by
    block (``ops.trigram.resident_layout``: contiguous ranges of the H*V
    copies ``h*V + w``, a thread a copy), in the working dtype: ``(bts,
    score, last)``. A hop copy's column is split as the kernel splits it,
    sources ``h < kr``
    (registers) and the rest padded with -inf to 4 mod 8 (shared memory),
    walked four at a time (:func:`_take4`) with the running maximum carried
    across the split. The exchange is modelled by its effect: a block reads
    the exit columns of the last valid frame (:func:`_run_resident_exchange`
    models the tagged words)."""
    t_len, v, s = log_b.shape
    h = v + 1
    lay = tri.resident_layout(h, v, n_sm)
    rest = -(-(h - kr) // 4) * 4
    hsp = 0 if h <= kr else rest + (4 if rest % 8 == 0 else 0)
    ninf = log_b.dtype.type(-np.inf)
    flat = grid = np.empty((h * v, s), log_b.dtype)  # copy c = hh*v + w, its s states
    for c in range(h * v):  # frame 0
        w = c % v
        for j in range(s):
            grid[c, j] = (log_pi_w[w] if c >= v * v and j == 0 else ninf) + log_b[0, w, j]
    bts = np.empty((max(t_len - 1, 0), h * v, s), np.int32)
    for t in range(1, t_len):
        if mask is not None and not mask[t]:
            bts[t - 1] = np.arange(h * v * s).reshape(h * v, s)
            continue
        exits = grid[np.arange(h * v), exit_idx[np.arange(h * v) % v]].reshape(h, v)
        new = np.empty_like(grid)
        for b in range(lay.blocks):
            c0, c1 = tri.copy_lo(b, lay.blocks, h, v), tri.copy_lo(b + 1, lay.blocks, h, v)
            for c in range(c0, c1):  # the within-word pass: every state's pointer
                w = c % v
                for j in range(s):
                    m, src = grid[c, 0] + inner_a[w, 0, j], 0
                    for q in range(1, s):
                        cand = grid[c, q] + inner_a[w, q, j]
                        if cand > m:
                            m, src = cand, q
                    bts[t - 1, c, j] = c * s + src
                    new[c, j] = m if j == 0 and c < v * v else m + log_b[t, w, j]
            for c in range(c0, min(c1, v * v)):  # the hop pass: column (u, w)
                u, w = divmod(c, v)
                col = np.full(kr + hsp, ninf, log_b.dtype)
                col[:h] = hop3[:, u, w]
                e = np.full(kr + hsp, ninf, log_b.dtype)
                e[:h] = exits[:, u]
                best, arg = ninf, 0
                for part in (range(0, kr, 4), range(kr, kr + hsp, 4)):  # registers, then smem
                    for hh in part:
                        best, arg = _take4(best, arg, e[hh:hh + 4] + col[hh:hh + 4], hh)
                m = new[c, 0]
                if best > m:
                    m = best
                    bts[t - 1, c, 0] = (arg * v + u) * s + exit_idx[u]
                new[c, 0] = m + log_b[t, w, 0]
        grid = flat = new
    parts = []
    for b in range(lay.blocks):  # each block's first maximum, then block order
        c0, c1 = tri.copy_lo(b, lay.blocks, h, v), tri.copy_lo(b + 1, lay.blocks, h, v)
        bv, bi = ninf, np.iinfo(np.int32).max
        for c in range(c0, c1):
            for j in range(s):
                val = flat[c, j] + (final3.reshape(-1)[c] if j == exit_idx[c % v] else ninf)
                if val > bv or (val == bv and c * s + j < bi):
                    bv, bi = val, c * s + j
        parts.append((bv, bi))
    score, last = parts[0]
    for pv, pi in parts[1:]:
        if pv > score or (pv == score and pi < last):
            score, last = pv, pi
    return bts.reshape(-1, h, v, s), score, last


def _model(log_b, mask, tt, exit_idx, n_sm):
    """``(path, score)`` of the kernels' model as tensors."""
    args = [x.numpy() for x in (log_b, tt["inner_a"], tt["hop3"], tt["log_pi_w"], tt["final3"])]
    bts, score, last = _model_forward(args[0], None if mask is None else mask.numpy(), *args[1:],
                                      exit_idx.numpy(), n_sm)
    path = np.empty(bts.shape[0] + 1, np.int32)  # the one-thread walk
    path[-1] = st = last
    flat = bts.reshape(bts.shape[0], -1)
    for t in range(bts.shape[0] - 1, -1, -1):
        st = flat[t, st]
        path[t] = st
    return torch.as_tensor(path), torch.as_tensor(score)


def _model_case(dtype, n_sm, ties=False):
    """The graph's tables (with ``ties``, :func:`_tie_tables`) and three
    segments of the model tests (random, integer and half-integer scores
    with masks), each with its plain forward."""
    _, tg = _graphs(3, True, dtype)
    rng = np.random.default_rng(n_sm)
    n_real = tg.state_map.max().item() + 1
    tt = {"inner_a": tg.inner_a, "hop3": tg.hop3, "log_pi_w": tg.log_pi_w, "final3": tg.final3}
    if ties:
        tt = {k: torch.as_tensor(x, dtype=dtype) for k, x in _tie_tables(tg, rng).items()}
    for quantum, mask in ((None, None), (1.0, np.r_[[True] * 9, [False] * 4, [True] * 9]),
                          (0.5, np.r_[[False] * 3, [True] * 19])):
        log_b = tg._grid_log_b(torch.as_tensor(_scores(rng, 22, n_real, quantum), dtype=dtype))
        m = None if mask is None else torch.as_tensor(mask)
        args = (log_b, m, tt["inner_a"], tt["hop3"], tt["log_pi_w"], tt["final3"], tg.exit_idx)
        np_args = [x if x is None or isinstance(x, np.ndarray) else x.numpy() for x in args]
        yield tg, tt, args, np_args, tri.trigram_forward_plain(*args)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("n_sm", [1, 2, 3, 132])
def test_kernel_model_matches_plain(identity_emissions, dtype, n_sm):
    """The model of the row routes' kernel, at 1 to 132 SMs (1 to 7 rows a
    block), bitwise equal to the plain version in backpointers, score, the
    final state and the path, with masks and quantized ties."""
    for tg, tt, args, np_args, (bts, score, last) in _model_case(dtype, n_sm):
        mb, ms, ml = _model_forward(*np_args, n_sm)
        np.testing.assert_array_equal(mb, bts.numpy())
        assert ms.tobytes() == score.numpy().tobytes() and ml == int(last)
        _same(_model(args[0], args[1], tt, tg.exit_idx, n_sm), tuple(
            x.numpy() for x in tri.trigram_viterbi_plain(*args)))


@pytest.mark.parametrize("n_sm,kr,ties", [(1, 4, False), (2, 4, False), (3, 4, False),
                                         (132, 4, False), (3, tri.RESIDENT_KR, False),
                                         (2, 4, True), (132, 4, True)])
def test_resident_model_matches_plain(identity_emissions, n_sm, kr, ties):
    """The model of the resident route (float32) at 1 to 132 SMs (1 to 7
    blocks over the 7 x 6 copies; at 7 the last block holds the <s> row
    alone, no hop copy), its hop columns split after 4 sources (registers,
    then shared memory, the maximum carried across) and after the kernel's
    own ``RESIDENT_KR``: bitwise equal to the plain version in
    backpointers, score and the final state, with masks and quantized
    scores, and on the tie tables (ties across histories, within-word
    sources and hops equal to ``within``)."""
    for _, _, _, np_args, (bts, score, last) in _model_case(torch.float32, n_sm, ties):
        mb, ms, ml = _resident_model_forward(*np_args, n_sm, kr)
        np.testing.assert_array_equal(mb, bts.numpy())
        assert ms.tobytes() == score.numpy().tobytes() and ml == int(last)


# -- the wrappers ---------------------------------------------------------------


class _CudaStandIn:
    """A CUDA tensor's device, dtype and shape: all the wrappers read before
    they reach the card."""

    def __init__(self, shape, dtype=torch.float32):
        self.device, self.dtype, self.shape = torch.device("cuda"), dtype, torch.Size(shape)

    def dim(self):
        return len(self.shape)

    def numel(self):
        return int(np.prod(self.shape))


def test_wrappers_dispatch(monkeypatch):
    """CPU tensors take the plain versions and count no launch; a CUDA
    tensor reaches the kernel (here: fails for want of a card) or raises on
    what the kernel does not take, and never runs the frame loop."""
    _, tg = _graphs(3, False, torch.float64)
    rng = np.random.default_rng(0)
    log_b = tg._grid_log_b(torch.as_tensor(rng.normal(size=(6, 2)), dtype=torch.float64))
    args = (log_b, None, tg.inner_a, tg.hop3, tg.log_pi_w, tg.final3, tg.exit_idx)
    tri.trigram_forward.launches = tri.trigram_backtrace.launches = 0
    path, score = tri.trigram_viterbi(*args)
    ref = tri.trigram_viterbi_plain(*args)
    assert torch.equal(path, ref[0]) and torch.equal(score, ref[1])
    assert tri.trigram_forward.launches == tri.trigram_backtrace.launches == 0

    def no_loop(*a, **k):
        raise AssertionError("the frame loop ran for a CUDA tensor")
    monkeypatch.setattr(tri, "trigram_forward_plain", no_loop)
    monkeypatch.setattr(tri, "trigram_backtrace_plain", no_loop)
    t, v, s = 6, 5, 3
    cuda = dict(inner_a=_CudaStandIn((v, s, s)), hop3=_CudaStandIn((v + 1, v, v)),
                log_pi_w=_CudaStandIn((v,)), final3=_CudaStandIn((v + 1, v)),
                exit_idx=_CudaStandIn((v,), torch.int64))
    fwd = lambda lb, **kw: tri.trigram_forward(lb, None, **(cuda | kw))  # noqa: E731
    with pytest.raises(ValueError, match="takes hop3"):
        fwd(_CudaStandIn((t, v, s)), hop3=_CudaStandIn((v, v, v)))
    with pytest.raises(ValueError, match="float32 or float64"):
        fwd(_CudaStandIn((t, v, s), torch.float16))
    with pytest.raises(ValueError, match="is on cpu"):
        fwd(_CudaStandIn((t, v, s)), final3=torch.zeros(v + 1, v))
    with pytest.raises((RuntimeError, AssertionError)):  # the kernel's launch needs a card
        fwd(_CudaStandIn((t, v, s)))
    for route in tri.ROUTES:  # each route, forced, goes to the launch too
        with pytest.raises((RuntimeError, AssertionError)):
            tri._forward(_CudaStandIn((t, v, s)), None, **cuda, route=route)
    assert tri.trigram_forward.route_launches == dict.fromkeys(tri.ROUTES, 0)
    with pytest.raises(ValueError, match="takes int32 bts"):
        tri.trigram_backtrace(_CudaStandIn((t - 1, v + 1, v, s), torch.int64),
                              _CudaStandIn((), torch.int32))
    with pytest.raises((RuntimeError, AssertionError)):
        tri.trigram_backtrace(_CudaStandIn((t - 1, v + 1, v, s), torch.int32),
                              _CudaStandIn((), torch.int32))
    with pytest.raises(ValueError, match="cpu or cuda"):
        tri.trigram_forward(torch.zeros((t, v, s), device="meta"), None, **cuda)
    assert tri.trigram_forward.launches == tri.trigram_backtrace.launches == 0


def test_route_rule(monkeypatch):
    """At float32 ``resident`` (``hop3`` on chip) where it fits, the serving
    graph's V = 200 on an H100's 132 SMs included, then ``global``; never
    ``resident`` at float64, which takes ``smem`` while a block's rows of
    two frames fit its shared memory, then ``global`` (each the faster row
    route at V = 200 on an H100); past the exit columns' capacity a
    ValueError with the numbers, raised by the wrapper before any launch,
    as for a route forced where it does not fit."""
    assert tri.trigram_route(202, 201, 8, 4, 132) == "resident"
    lay = tri.resident_layout(202, 201, 132)
    # 132 blocks of 307-308 copies (all hop copies but the last block's 106),
    # three exit columns at most; columns of 80 sources in registers, then
    # 122 and two of -inf padding in shared memory
    assert lay == tri.ResidentLayout(132, 308, 308, 3, 124)
    assert tri.resident_bytes(202, 201, 132) == 4 * (204 + 13068 + 2772 + 2 * 3 * 204
                                                     + 308 * 124)
    assert tri.route_fits("resident", 202, 201, 8, 4, 132)
    assert not tri.route_fits("resident", 202, 201, 8, 8, 132)  # float64: never
    assert not tri.route_fits("resident", 202, 201, 9, 4, 132)  # S past RESIDENT_SMAX
    assert tri.trigram_route(202, 201, 9, 4, 132) == "global"
    assert tri.trigram_route(202, 201, 8, 8, 132) == "smem"
    assert tri.trigram_route(204, 203, 8, 4, 132) == "resident"
    assert tri.trigram_route(205, 204, 8, 4, 132) == "global"  # past the resident capacity
    for v in (1, 5, 12, 40):  # the small graphs chip_smoke.py forces it on
        assert tri.trigram_route(v + 1, v, 4, 4, 132) == "resident"
        assert tri.resident_layout(v + 1, v, 132).blocks == v + 1
    # 2 rows of 202 exits, 3 x 201 ints; 2 frames of 2 rows of 201 x 8
    assert tri.forward_smem_bytes(202, 201, 8, 4, 132, "smem") == 4032 + 25728
    assert tri.forward_smem_bytes(202, 201, 8, 4, 132, "global") == 4 * 2 * 202 + 4 * 3 * 201
    assert tri.trigram_route(411, 410, 8, 8, 132) == "smem"
    assert tri.trigram_route(412, 411, 8, 8, 132) == "global"
    assert tri.trigram_route(641, 640, 8, 4, 132) == "global"
    assert tri.trigram_route(1866, 1865, 8, 4, 132) == "global"
    assert tri.trigram_route(1564, 1563, 8, 8, 132) == "global"
    for v, itemsize in ((1866, 4), (1564, 8), (4000, 8)):
        with pytest.raises(ValueError, match=r"exit columns of H=\d+ values .* > 232448"):
            tri.trigram_route(v + 1, v, 8, itemsize, 132)
    monkeypatch.setattr(tri, "sm_count", lambda dev: 132)

    def no_launch(*a, **k):
        raise AssertionError("the kernel was built or launched past its capacity")
    monkeypatch.setattr(tri._build, "load", no_launch)
    t, v, s = 4, 1866, 2
    cuda = dict(inner_a=_CudaStandIn((v, s, s)), hop3=_CudaStandIn((v + 1, v, v)),
                log_pi_w=_CudaStandIn((v,)), final3=_CudaStandIn((v + 1, v)),
                exit_idx=_CudaStandIn((v,), torch.int64))
    with pytest.raises(ValueError, match="exit columns"):
        tri.trigram_forward(_CudaStandIn((t, v, s)), None, **cuda)
    t, v, s = 4, 201, 8
    cuda = dict(inner_a=_CudaStandIn((v, s, s), torch.float64),
                hop3=_CudaStandIn((v + 1, v, v), torch.float64),
                log_pi_w=_CudaStandIn((v,), torch.float64),
                final3=_CudaStandIn((v + 1, v), torch.float64),
                exit_idx=_CudaStandIn((v,), torch.int64))
    with pytest.raises(ValueError, match="no route 'resident'"):
        tri._forward(_CudaStandIn((t, v, s), torch.float64), None, **cuda, route="resident")


# -- a model of kernel H's exit exchange -------------------------------------------

STALE = 0xFFFFFFFF  # the tag the launcher fills the exchange with: no frame's


class ProtocolError(AssertionError):
    pass


def _exchange_block(b, rpb, h, v, w_words, mask, slots, taken, rule):
    """One block of ``csrc/trigram_forward.cu``'s frame loop as a generator,
    one load or store of one 64-bit word a step: publish its rows' exits at
    frame 0 and every valid frame (the k-th publication into buffer k & 1,
    each exit ``w_words`` words tagged with its frame), and before each
    valid step poll the columns of its hop rows (or, with ``rule ==
    "column"``, word 0's column when no hop enters its rows) until every
    tag is the last publication's. An exit's value is ``(frame, h, u)``."""
    h0 = b * rpb
    nr = min(rpb, h - h0)
    nhop = max(0, min(nr, v - h0))

    def publish(buf, t):
        for r in range(nr):
            for u in range(v):
                for q in range(w_words):
                    slots[buf][u][h0 + r][q] = (t, (t, h0 + r, u))
                    yield

    yield from publish(0, 0)
    n_pub, last = 0, 0
    for t in range(1, len(mask)):
        if not mask[t]:
            continue
        cols = range(h0, h0 + nhop) if nhop else ([0] if rule == "column" else [])
        yield from _poll_columns(b, t, cols, h, w_words, slots[n_pub & 1], last, taken)
        yield from publish((n_pub + 1) & 1, t)
        n_pub, last = n_pub + 1, t


def _poll_columns(b, t, cols, h, w_words, buf, last, taken):
    """Block ``b`` at frame ``t`` polls the exit columns ``cols`` of
    publication buffer ``buf``, one word a step, until each word's tag is
    ``last``; an exit's value is ``(frame, h, u)``."""
    for u in cols:
        for hs in range(h):
            for q in range(w_words):
                while True:
                    tag, val = buf[u][hs][q]
                    yield
                    if tag == last:
                        if val != (last, hs, u):
                            raise ProtocolError(f"block {b} took {val} for {(last, hs, u)}")
                        taken.append((b, t, u, hs))
                        break
                    if tag != STALE and tag > last:
                        raise ProtocolError(f"block {b} waits for frame {last}'s exit "
                                            f"({hs}, {u}), overwritten by frame {tag}")


def _run_exchange(h, v, n_sm, mask, seed, w_words=1, rule="column", max_steps=2_000_000):
    """All blocks stepped in a seeded random interleaving; returns the
    ``(block, frame, word, history)`` reads in the order they happened."""
    rpb = tri.rows_per_block(h, n_sm)
    slots = [[[[(STALE, None)] * w_words for _ in range(h)] for _ in range(v)] for _ in range(2)]
    taken = []
    live = [_exchange_block(b, rpb, h, v, w_words, mask, slots, taken, rule)
            for b in range(-(-h // rpb))]
    rng = np.random.default_rng(seed)
    for _ in range(max_steps):
        if not live:
            return taken
        k = int(rng.integers(len(live))) if rng.random() < 0.9 else 0  # block 0 lags
        try:
            next(live[k])
        except StopIteration:
            live.pop(k)
    raise ProtocolError("the exchange did not finish: a block waits for a frame never published")


@pytest.mark.parametrize("w_words", [1, 2])  # float32, float64
@pytest.mark.parametrize("v,n_sm", [(4, 132), (5, 3), (6, 2)])
def test_exchange_model(v, n_sm, w_words):
    """Every block reads each exit it needs at the last valid frame, from
    every row, whatever the interleaving, with masks; one row a block (the
    <s> row's block then has no hop row: it reads word 0's column) and
    several."""
    h = v + 1
    for seed, mask in enumerate((np.ones(9, bool), np.r_[True, True, False, True, False, False,
                                                         True, True])):
        taken = _run_exchange(h, v, n_sm, mask, seed, w_words)
        rpb = tri.rows_per_block(h, n_sm)
        want = sum(max(1, min(rpb, h - b * rpb, v - b * rpb)) * h * w_words
                   for b in range(-(-h // rpb))) * (int(mask[1:].sum()))
        assert len(taken) == want


def test_exchange_model_needs_the_column_rule():
    """Without the <s> row's block reading a column, it runs ahead and
    overwrites a publication another block still waits for: the failure
    the rule prevents (one row a block, the block of row V has no hop)."""
    with pytest.raises(ProtocolError, match="overwritten|did not finish"):
        for seed in range(20):
            _run_exchange(5, 4, 132, np.ones(12, bool), seed, rule="hop rows only")


# -- the resident route's exchange --------------------------------------------


def _resident_exchange_block(b, lo, hi, h, v, exit_idx, mask, slots, taken):
    """One block of the resident route's frame loop as a generator: it owns
    copies ``[lo, hi)`` of the H*V (``h*V + w``) and publishes their exits
    at frame 0 and every valid frame (copy (hh, w)'s into column w, row
    hh). Each valid step it polls the columns of its hop copies' rows
    (column 0 when it has none) until every tag is the last publication's,
    then publishes the exits the hop cannot change, runs its hop pass, and
    publishes the rest: the exits at state 0 (``exit_idx``) of its hop
    copies."""
    n_hop = max(0, min(hi, v * v) - lo)
    cols = range(lo // v, (lo + n_hop - 1) // v + 1) if n_hop else [0]

    def publish(buf, t, late):
        for c in range(lo, hi):
            hh, w = divmod(c, v)
            if late is None or late == (c < v * v and exit_idx[w] == 0):
                slots[buf][w][hh][0] = (t, (t, hh, w))
                yield

    yield from publish(0, 0, None)
    n_pub, last = 0, 0
    for t in range(1, len(mask)):
        if not mask[t]:
            continue
        yield from _poll_columns(b, t, cols, h, 1, slots[n_pub & 1], last, taken)
        yield from publish((n_pub + 1) & 1, t, False)
        yield  # the hop pass
        yield from publish((n_pub + 1) & 1, t, True)
        n_pub, last = n_pub + 1, t


def _run_resident_exchange(h, v, blocks, exit_idx, mask, seed, max_steps=2_000_000):
    """``blocks`` blocks (``ops.trigram.copy_lo``'s ranges) stepped in a
    seeded random interleaving, block 0 lagging; returns the ``(block,
    frame, column, history)`` reads in order."""
    slots = [[[[(STALE, None)] for _ in range(h)] for _ in range(v)] for _ in range(2)]
    taken = []
    live = [_resident_exchange_block(b, tri.copy_lo(b, blocks, h, v),
                                     tri.copy_lo(b + 1, blocks, h, v), h, v, exit_idx, mask,
                                     slots, taken)
            for b in range(blocks)]
    rng = np.random.default_rng(seed)
    for _ in range(max_steps):
        if not live:
            return taken
        k = int(rng.integers(len(live))) if rng.random() < 0.9 else 0
        try:
            next(live[k])
        except StopIteration:
            live.pop(k)
    raise ProtocolError("the exchange did not finish: a block waits for a frame never published")


@pytest.mark.parametrize("v,n_sm", [(4, 132), (5, 3), (6, 2), (12, 132), (13, 5)])
def test_resident_exchange_model(v, n_sm):
    """The resident route's partition (min(SMs, H) blocks, every range at
    least V copies long) and its publication in two parts (before the hop
    pass the exits it cannot change, after it those at state 0 of a hop
    copy): whatever the interleaving, with masks, every block reads each
    exit it needs at the last valid frame from every row,
    one column for each hop row it owns (column 0 for the <s> row's block
    when it owns no hop copy); at the V = 200 segment no block reads more
    than 3 columns."""
    h = v + 1
    lay = tri.resident_layout(h, v, n_sm)
    exit_idx = np.arange(v) % 3  # every third word exits from state 0: published after its hop
    for seed, mask in enumerate((np.ones(9, bool), np.r_[True, True, False, True, False, False,
                                                         True, True])):
        taken = _run_resident_exchange(h, v, lay.blocks, exit_idx, mask, seed)
        cols = {(b, t): {u for bb, tt, u, _ in taken if (bb, tt) == (b, t)} for b, t, _, _ in taken}
        assert max(len(c) for c in cols.values()) == lay.ncol
        for b in range(lay.blocks):
            lo, hi = tri.copy_lo(b, lay.blocks, h, v), tri.copy_lo(b + 1, lay.blocks, h, v)
            n_hop = max(0, min(hi, v * v) - lo)
            want = ({u for u in range(lo // v, (lo + n_hop - 1) // v + 1)} if n_hop else {0})
            assert all(c == want for (bb, _), c in cols.items() if bb == b)
        assert len(taken) == sum(len(c) for c in cols.values()) * h
    assert tri.resident_layout(202, 201, 132).ncol == 3


def test_resident_exchange_needs_long_ranges():
    """With more blocks than history rows (ranges shorter than V), a column
    lacks a word of some block: a block that never reads the lagging
    block's words runs two publications ahead of it and overwrites words
    it still waits for. ``resident_layout`` keeps blocks <= H."""
    h, v = 5, 4
    assert tri.resident_layout(h, v, 132).blocks == h
    with pytest.raises(ProtocolError, match="overwritten|did not finish"):
        for seed in range(20):
            _run_resident_exchange(h, v, 2 * h, np.arange(v) % 3, np.ones(12, bool), seed)
