"""Kernel H's batch axis on the CPU: the trigram graph's batched decode.

- ``ops.trigram.trigram_forward_plain`` and ``trigram_backtrace_plain`` on
  a batch ``(B, T, V, S)`` with masks that differ by row (a full row, a
  bucket's padded tail, a row masked after its first frame, interior gaps)
  bitwise equal to their single calls row by row, and to the JAX
  package's vmapped decode (``TrigramDecodingGraph._decode_batch_fn``) on
  the same grid emissions; order-2 and order-3 LMs, float32 and float64,
  with and without silence.
- A NumPy model of the resident route's batched instantiation
  (``csrc/trigram_forward.cu``): utterances stepped in turn within each
  frame, each with its own states and publication count, the block's two
  exit-column buffers alternating with the steps it takes; a lagging half
  of a block's threads finishes a step's hop pass after the leading half
  has begun the next step's column read. Bitwise the plain version at
  several SM counts; a buffer picked by the utterance's own publication
  count is caught.
- A generator model of the batched exchange: every utterance its own
  two-buffer slab and publication count, ragged masks, random
  interleavings; every read is the utterance's last valid frame's; a slab
  shared by the utterances and a buffer picked by the frame's parity are
  caught.
- ``trigram_cut``'s budget and capacity rules, ``decode_batch_arrays``
  on a CUDA stand-in (one forward and one backtrace a piece, never a row),
  the wrappers on batch shapes, and ``decode_batch`` on features against
  the JAX package's.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lnasr_tpu.models.decoder import DecoderConfig as JDecoderConfig
from lnasr_tpu.models.decoder import TrigramDecodingGraph as JTrigram
from lnasr_tpu.models.lexicon import Lexicon as JLexicon
from lnasr_tpu.models.ngram import NGramCounter as JNGramCounter
from lnasr_tpu.models.ngram import NGramModel as JNGramModel
from lnasr_tpu.models.ngram import Tokenizer as JTokenizer
from lnasr_tpu_torch import entry
from lnasr_tpu_torch.convert import units_from_numpy
from lnasr_tpu_torch.models import decoder as tdec
from lnasr_tpu_torch.models.decoder import DecoderConfig, TrigramDecodingGraph
from lnasr_tpu_torch.models.lexicon import Lexicon
from lnasr_tpu_torch.models.ngram import NGramCounter, NGramModel
from lnasr_tpu_torch.ops import trigram as tri
from tests.test_torch_trigram_kernel import (CORPUS, STALE, WORDS, ProtocolError, _CudaStandIn,
                                             _graphs, _jax_unit, _scores, _take4,
                                             identity_emissions)

CASES = [(order, silence, dtype) for order in (2, 3) for silence in (False, True)
         for dtype in (torch.float64, torch.float32)]
T_LEN = 24


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain versions are frame loops of small ops: one intra-op thread
    runs them faster than a pool shared with the suite's other workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _row_masks(b=4, t_len=T_LEN):
    """Masks that differ by row: a full row, a bucket's padded tail, a row
    masked after its first frame, interior gaps (single frames and a run)."""
    m = np.ones((b, t_len), bool)
    m[1, 15:] = False
    m[2, 1:] = False
    m[3, 3:12:3] = False
    m[3, 16:19] = False
    return m


def _batch_inputs(tg, rng, quantum=None):
    n_real = tg.state_map.max().item() + 1
    masks = _row_masks()
    obs = np.stack([_scores(rng, T_LEN, n_real, quantum) for _ in range(len(masks))])
    log_b = tg._grid_log_b(torch.as_tensor(obs, dtype=tg.dtype))
    tabs = (tg.inner_a, tg.hop3, tg.log_pi_w, tg.final3, tg.exit_idx)
    return obs, masks, log_b, tabs


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.tobytes()


@pytest.mark.parametrize("order,silence,dtype", CASES)
def test_batched_plain_is_its_rows(identity_emissions, order, silence, dtype):
    """The batched plain forward and backtrace, on random and quantized
    scores (ties), bitwise equal row by row to their single calls: the
    backpointers, score, final state and path; with no mask, every row
    valid."""
    _, tg = _graphs(order, silence, dtype)
    rng = np.random.default_rng(40 + 2 * order + silence)
    for quantum in (None, 1.0):
        _, masks, log_b, tabs = _batch_inputs(tg, rng, quantum)
        for m in (torch.as_tensor(masks), None):
            bts, score, last = tri.trigram_forward_plain(log_b, m, *tabs)
            paths = tri.trigram_backtrace_plain(bts, last)
            assert bts.shape == (4, T_LEN - 1) + tuple(tg.grid_shape)
            assert paths.shape == (4, T_LEN) and paths.dtype == torch.int32
            for r in range(4):
                rb, rs, rl = tri.trigram_forward_plain(log_b[r], None if m is None else m[r],
                                                       *tabs)
                assert torch.equal(bts[r], rb) and _bits(score[r]) == _bits(rs)
                assert int(last[r]) == int(rl)
                assert torch.equal(paths[r], tri.trigram_backtrace_plain(rb, rl))
    # T = 1 and the empty batch
    path, score = tri.trigram_viterbi_plain(log_b[:, :1], torch.as_tensor(masks)[:, :1], *tabs)
    assert path.shape == (4, 1) and score.shape == (4,)
    for r in range(4):
        assert _bits(score[r]) == _bits(tri.trigram_viterbi_plain(log_b[r, :1], None, *tabs)[1])
    path, score = tri.trigram_viterbi_plain(log_b[:0], torch.as_tensor(masks)[:0], *tabs)
    assert path.shape == (0, T_LEN) and score.shape == (0,)


@pytest.mark.parametrize("order,silence,dtype", CASES)
def test_batched_plain_matches_jax_vmapped_decode(identity_emissions, order, silence, dtype):
    """The batched plain decode against the JAX package's vmapped decode
    (``_decode_batch_fn``: one jitted program for the batch) on the same
    per-state scores and ragged masks: paths and scores bitwise."""
    jg, tg = _graphs(order, silence, dtype)
    obs, masks, log_b, tabs = _batch_inputs(tg, np.random.default_rng(60 + 2 * order + silence))
    paths, scores = tri.trigram_viterbi_plain(log_b, torch.as_tensor(masks), *tabs)
    jpaths, jscores = jg._decode_batch_fn(
        jnp.asarray(obs, jg.dtype), jnp.asarray(masks), jg.inner_a, jg.hop3, jg.log_pi_w,
        jg.final3, jg.exit_idx, jg.state_map, jg.pad_mask, jg.log_w, jg.mu, jg.cov)
    np.testing.assert_array_equal(paths.numpy(), np.asarray(jpaths))
    assert _bits(scores) == np.asarray(jscores, scores.numpy().dtype).tobytes()


# -- a model of the resident route's batched instantiation -----------------------


def _resident_batch_model(log_b, mask, inner_a, hop3, log_pi_w, final3, exit_idx, n_sm,
                          kr=4, buffer="steps"):
    """What ``csrc/trigram_forward.cu``'s resident route computes for a
    batch ``(B, T, V, S)``, in the working dtype: ``(bts (B, T-1, H, V, S),
    score (B,), last (B,))``. The frames run in order and, in each, the
    utterances in turn; an utterance masked at a frame writes self
    pointers and takes no step. A step reads its utterance's exits of its
    last valid frame into one of the block's two exit-column buffers
    (``buffer``: ``"steps"``, the kernel's rule, the parity of the steps
    the block has taken; ``"own count"``, the parity of the utterance's
    own publications), runs the within-word pass, then the hop pass of the
    first half of each block's copies; the next step's column read then
    overwrites (here: with NaN) the buffer it will use while the second
    half still runs this step's hop pass from its buffer. Copies, splits
    and walks as ``tests/test_torch_trigram_kernel.py:
    _resident_model_forward``."""
    b_n, t_len, v, s = log_b.shape
    h = v + 1
    lay = tri.resident_layout(h, v, n_sm)
    rest = -(-(h - kr) // 4) * 4
    hsp = 0 if h <= kr else rest + (4 if rest % 8 == 0 else 0)
    ninf = log_b.dtype.type(-np.inf)
    grids = np.empty((b_n, h * v, s), log_b.dtype)  # each utterance's states, copy c = hh*v + w
    for r in range(b_n):
        for c in range(h * v):
            w = c % v
            for j in range(s):
                grids[r, c, j] = ((log_pi_w[w] if c >= v * v and j == 0 else ninf)
                                  + log_b[r, 0, w, j])
    bts = np.empty((b_n, max(t_len - 1, 0), h * v, s), np.int32)
    valid = np.ones((b_n, t_len), bool) if mask is None else mask
    seq = [(t, r) for t in range(1, t_len) for r in range(b_n) if valid[r, t]]
    for t in range(1, t_len):
        for r in range(b_n):
            if not valid[r, t]:
                bts[r, t - 1] = np.arange(h * v * s).reshape(h * v, s)
    n_pub = [0] * b_n

    def which(k):  # the exit-column buffer of valid step k
        return (k if buffer == "steps" else n_pub[seq[k][1]]) & 1

    ex = np.full((2, h, v), np.nan, log_b.dtype)  # a block's two buffers (every block alike)
    ranges = [(tri.copy_lo(b, lay.blocks, h, v), tri.copy_lo(b + 1, lay.blocks, h, v))
              for b in range(lay.blocks)]
    for k, (t, r) in enumerate(seq):
        grid = grids[r]
        buf = which(k)
        ex[buf] = grid[np.arange(h * v), exit_idx[np.arange(h * v) % v]].reshape(h, v)
        new = np.empty_like(grid)
        for c in range(h * v):  # the within-word pass: every state's pointer
            w = c % v
            for j in range(s):
                m, src = grid[c, 0] + inner_a[w, 0, j], 0
                for q in range(1, s):
                    cand = grid[c, q] + inner_a[w, q, j]
                    if cand > m:
                        m, src = cand, q
                bts[r, t - 1, c, j] = c * s + src
                new[c, j] = m if j == 0 and c < v * v else m + log_b[r, t, w, j]

        def hop(c):  # copy c's hop pass, its exits from the buffer of this step
            u, w = divmod(c, v)
            col = np.full(kr + hsp, ninf, log_b.dtype)
            col[:h] = hop3[:, u, w]
            e = np.full(kr + hsp, ninf, log_b.dtype)
            e[:h] = ex[buf][:, u]
            best, arg = ninf, 0
            for part in (range(0, kr, 4), range(kr, kr + hsp, 4)):  # registers, then smem
                for hh in part:
                    best, arg = _take4(best, arg, e[hh:hh + 4] + col[hh:hh + 4], hh)
            m = new[c, 0]
            if best > m:
                m = best
                bts[r, t - 1, c, 0] = (arg * v + u) * s + exit_idx[u]
            new[c, 0] = m + log_b[r, t, w, 0]

        hops = [list(range(lo, min(hi, v * v))) for lo, hi in ranges]
        for cs in hops:  # the leading half of each block's threads
            for c in cs[:len(cs) // 2]:
                hop(c)
        n_pub[r] += 1
        if k + 1 < len(seq):
            ex[which(k + 1)] = np.nan  # the next step's column read, in flight
        for cs in hops:  # the lagging half
            for c in cs[len(cs) // 2:]:
                hop(c)
        grids[r] = new
    scores, lasts = [], []
    for r in range(b_n):
        parts = []
        for lo, hi in ranges:  # each block's first maximum, then block order
            bv, bi = ninf, np.iinfo(np.int32).max
            for c in range(lo, hi):
                for j in range(s):
                    val = grids[r, c, j] + (final3.reshape(-1)[c] if j == exit_idx[c % v]
                                            else ninf)
                    if val > bv or (val == bv and c * s + j < bi):
                        bv, bi = val, c * s + j
            parts.append((bv, bi))
        score, last = parts[0]
        for pv, pi in parts[1:]:
            if pv > score or (pv == score and pi < last):
                score, last = pv, pi
        scores.append(score)
        lasts.append(last)
    return bts.reshape(b_n, -1, h, v, s), np.array(scores, log_b.dtype), np.array(lasts)


def _model_batch(n_sm):
    _, tg = _graphs(3, True, torch.float32)
    obs, masks, log_b, tabs = _batch_inputs(tg, np.random.default_rng(n_sm))
    np_args = [log_b.numpy(), masks] + [x.numpy() for x in tabs]
    return np_args, tri.trigram_forward_plain(log_b, torch.as_tensor(masks), *tabs)


@pytest.mark.parametrize("n_sm", [1, 2, 3, 7, 132])
def test_resident_batch_model_matches_plain(identity_emissions, n_sm):
    """The model of the resident route's batch (float32, 7 x 6 copies in 1
    to 7 blocks): utterances in turn with masks that differ by row, the
    exit-column buffers by the block's steps, a lagging half of each
    block's threads: bitwise the batched plain version in backpointers,
    scores and final states."""
    np_args, (bts, score, last) = _model_batch(n_sm)
    mb, ms, ml = _resident_batch_model(*np_args, n_sm)
    np.testing.assert_array_equal(mb, bts.numpy())
    assert ms.tobytes() == score.numpy().tobytes()
    np.testing.assert_array_equal(ml, last.numpy())


def test_resident_batch_model_needs_the_step_buffers(identity_emissions):
    """With the exit-column buffer picked by the utterance's own
    publication count, two utterances' steps in a row use one buffer, and
    the next step's column read overwrites exits the lagging threads still
    read: the backpointers differ from the plain version's."""
    np_args, (bts, _, _) = _model_batch(3)
    mb, _, _ = _resident_batch_model(*np_args, 3, buffer="own count")
    assert not np.array_equal(mb, bts.numpy())


# -- a model of the batched exchange ---------------------------------------------


def _poll_row(blk, t, r, cols, h, buf, last, taken):
    """Block ``blk`` at utterance ``r``'s step at frame ``t`` polls the
    exit columns ``cols`` of ``buf`` one word a step until each tag is
    ``last``; an exit's value is ``(frame, h, u, utterance)``."""
    for u in cols:
        for hs in range(h):
            while True:
                tag, val = buf[u][hs]
                yield
                if tag == last:
                    if val != (last, hs, u, r):
                        raise ProtocolError(f"block {blk} took {val} for {(last, hs, u, r)}")
                    taken.append((blk, t, r, u, hs))
                    break
                if tag != STALE and tag > last:
                    raise ProtocolError(f"block {blk} waits for frame {last}'s exit ({hs}, {u}) "
                                        f"of utterance {r}, overwritten by frame {tag}")


def _batch_exchange_block(blk, lo, hi, h, v, exit_idx, masks, slabs, taken, rule):
    """One block of the resident route's batched frame loop as a generator:
    frame 0 of every utterance published, then in each frame the
    utterances in turn, each valid one polling its own last publication
    and publishing in two parts (``_resident_exchange_block``'s steps).
    ``rule``: ``"own"`` (the kernel's: a slab an utterance, its k-th
    publication into buffer k & 1), ``"shared slab"`` (one slab for all),
    ``"frame parity"`` (a publication at frame t into buffer t & 1)."""
    n_hop = max(0, min(hi, v * v) - lo)
    cols = range(lo // v, (lo + n_hop - 1) // v + 1) if n_hop else [0]
    b_n, t_len = masks.shape
    slab = (lambda r: slabs[0]) if rule == "shared slab" else (lambda r: slabs[r])

    def publish(r, buf, t, late):
        for c in range(lo, hi):
            hh, w = divmod(c, v)
            if late is None or late == (c < v * v and exit_idx[w] == 0):
                slab(r)[buf][w][hh] = (t, (t, hh, w, r))
                yield

    for r in range(b_n):
        yield from publish(r, 0, 0, None)
    n_pub, last = [0] * b_n, [0] * b_n
    for t in range(1, t_len):
        for r in range(b_n):
            if not masks[r, t]:
                continue
            read = (last[r] if rule == "frame parity" else n_pub[r]) & 1
            write = (t if rule == "frame parity" else n_pub[r] + 1) & 1
            yield from _poll_row(blk, t, r, cols, h, slab(r)[read], last[r], taken)
            yield from publish(r, write, t, False)
            yield  # the hop pass
            yield from publish(r, write, t, True)
            n_pub[r], last[r] = n_pub[r] + 1, t


def _run_batch_exchange(h, v, blocks, exit_idx, masks, seed, rule="own",
                        max_steps=3_000_000):
    """``blocks`` blocks stepped in a seeded random interleaving, block 0
    lagging; returns the ``(block, frame, utterance, column, history)``
    reads in order."""
    slabs = [[[[(STALE, None)] * h for _ in range(v)] for _ in range(2)]
             for _ in range(masks.shape[0])]
    taken = []
    live = [_batch_exchange_block(b, tri.copy_lo(b, blocks, h, v), tri.copy_lo(b + 1, blocks, h, v),
                                  h, v, exit_idx, masks, slabs, taken, rule)
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


def _ragged(t_len=9):
    m = np.ones((3, t_len), bool)
    m[0, [2, 4, 5]] = False  # interior gaps: two publications of one parity in a row
    m[1, 1:] = False  # masked after its first frame: frame 0's publication only
    m[2, 6:] = False  # a padded tail
    return m


@pytest.mark.parametrize("v,n_sm", [(4, 132), (5, 3), (6, 2)])
def test_batch_exchange_model(v, n_sm):
    """Every block reads, for each valid step of each utterance, the
    columns it needs of that utterance's last valid frame, whatever the
    interleaving, with publication counts that differ by utterance."""
    h = v + 1
    lay = tri.resident_layout(h, v, n_sm)
    exit_idx = np.arange(v) % 3  # every third word exits from state 0: published after its hop
    masks = _ragged()
    for seed in range(3):
        taken = _run_batch_exchange(h, v, lay.blocks, exit_idx, masks, seed)
        for b in range(lay.blocks):
            lo, hi = tri.copy_lo(b, lay.blocks, h, v), tri.copy_lo(b + 1, lay.blocks, h, v)
            n_hop = max(0, min(hi, v * v) - lo)
            n_cols = (lo + n_hop - 1) // v - lo // v + 1 if n_hop else 1
            for r in range(masks.shape[0]):
                steps = int(masks[r, 1:].sum())
                assert sum(1 for x in taken if x[0] == b and x[2] == r) == steps * n_cols * h


@pytest.mark.parametrize("rule", ["shared slab", "frame parity"])
def test_batch_exchange_model_needs_a_count_an_utterance(rule):
    """One slab for all utterances, or a buffer picked by the frame's
    parity where masks skip frames: a block takes another utterance's
    exit, or a frame's exit overwritten before every block has read it."""
    v, h = 4, 5
    with pytest.raises(ProtocolError):
        for seed in range(20):
            _run_batch_exchange(h, v, h, np.arange(v) % 3, _ragged(12), seed, rule=rule)


# -- the cut, the wrappers and the graph's batch ----------------------------------


def test_trigram_cut():
    """``trigram_cut`` at the V = 200 serving geometry (T = 511, 132 SMs):
    8 rows one launch at float32 (5.30 GB of backpointers), 24 rows two of
    12 (the 8 GiB budget), float64 on its ``smem`` route two of 4 (each
    utterance's rows of two frames in a block's shared memory); every
    piece within the rules, at most ``MAX_BATCH``; one utterance a piece
    past every route, and never a refusal; an empty batch no piece."""
    n_states = 202 * 201 * 8
    assert tri.trigram_cut(8, 511, 202, 201, 8, 4, 132) == [(0, 8)]
    assert 8 * 510 * n_states * 4 == 5_300_997_120
    assert tri.trigram_cut(24, 511, 202, 201, 8, 4, 132) == [(0, 12), (12, 24)]
    assert 12 * 510 * n_states * 4 <= tri.BTS_BUDGET < 13 * 510 * n_states * 4
    assert tri.trigram_cut(8, 511, 202, 201, 8, 8, 132) == [(0, 4), (4, 8)]
    assert tri.batch_fits(4, 511, 202, 201, 8, 8, 132, "smem")
    assert not tri.batch_fits(5, 511, 202, 201, 8, 8, 132, "smem")
    assert tri.batch_fits(5, 511, 202, 201, 8, 8, 132, "global")  # its rows in device memory
    assert tri.trigram_cut(0, 511, 202, 201, 8, 4, 132) == []
    assert tri.trigram_cut(100, 20, 7, 6, 4, 4, 132) == [(0, 25), (25, 50), (50, 75), (75, 100)]
    assert tri.trigram_cut(33, 20, 7, 6, 4, 4, 132) == [(0, 17), (17, 33)]
    # one utterance fits, whatever its size: past the budget (10.4 GB of
    # backpointers at T = 8000) and past every route (H = 1867)
    for args in ((5, 8000, 202, 201, 8, 4, 132), (3, 600, 1867, 1866, 8, 4, 132)):
        assert [j - i for i, j in tri.trigram_cut(*args)] == [1] * args[0]
    for batch in range(1, 70):
        for t_len, isz in ((511, 4), (511, 8), (3000, 4)):
            pieces = tri.trigram_cut(batch, t_len, 202, 201, 8, isz, 132)
            assert pieces[0][0] == 0 and pieces[-1][1] == batch
            assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
            route = tri.trigram_route(202, 201, 8, isz, 132)
            assert all(tri.batch_fits(j - i, t_len, 202, 201, 8, isz, 132, route)
                       for i, j in pieces)
            assert max(j - i for i, j in pieces) - min(j - i for i, j in pieces) <= 1
            big = max(j - i for i, j in pieces)
            assert big == 1 or len(pieces) == 1 or not tri.batch_fits(
                -(-batch // (len(pieces) - 1)), t_len, 202, 201, 8, isz, 132, route)


def test_batch_wrappers_dispatch(monkeypatch):
    """A batch on CUDA tensors reaches the kernels or raises before any
    launch: masks of another shape, a batch past one launch (``cut it``),
    a batched backtrace with the wrong ``last``; no frame loop runs, no
    launch is counted. The batch's checks take its shapes, not its rows."""
    def no_loop(*a, **k):
        raise AssertionError("the frame loop ran for a CUDA tensor")
    monkeypatch.setattr(tri, "trigram_forward_plain", no_loop)
    monkeypatch.setattr(tri, "trigram_backtrace_plain", no_loop)
    monkeypatch.setattr(tri, "sm_count", lambda dev: 132)
    tri.trigram_forward.launches = tri.trigram_backtrace.launches = 0
    b, t, v, s = 3, 6, 5, 3
    cuda = dict(inner_a=_CudaStandIn((v, s, s)), hop3=_CudaStandIn((v + 1, v, v)),
                log_pi_w=_CudaStandIn((v,)), final3=_CudaStandIn((v + 1, v)),
                exit_idx=_CudaStandIn((v,), torch.int64))
    with pytest.raises(ValueError, match="takes mask"):
        tri.trigram_forward(_CudaStandIn((b, t, v, s)), _CudaStandIn((t,), torch.bool), **cuda)
    with pytest.raises(ValueError, match="cut it"):
        tri.trigram_forward(_CudaStandIn((tri.MAX_BATCH + 1, t, v, s)), None, **cuda)
    with pytest.raises((RuntimeError, AssertionError)):  # the launch needs a card
        tri.trigram_forward(_CudaStandIn((b, t, v, s)), _CudaStandIn((b, t), torch.bool), **cuda)
    with pytest.raises(ValueError, match="takes int32 bts"):
        tri.trigram_backtrace(_CudaStandIn((b, t - 1, v + 1, v, s), torch.int32),
                              _CudaStandIn((), torch.int32))
    with pytest.raises((RuntimeError, AssertionError)):
        tri.trigram_backtrace(_CudaStandIn((b, t - 1, v + 1, v, s), torch.int32),
                              _CudaStandIn((b,), torch.int32))
    assert tri.trigram_forward.launches == tri.trigram_backtrace.launches == 0


class _CudaRows(_CudaStandIn):
    """A CUDA stand-in whose rows can be sliced (``log_b[i:j]``)."""

    def __getitem__(self, rows):
        return _CudaRows((len(range(*rows.indices(self.shape[0]))),) + tuple(self.shape[1:]),
                         self.dtype)


@pytest.mark.parametrize("rows,budget,pieces", [(3, None, 1), (40, None, 2), (8, 2, 4)])
def test_decode_batch_arrays_launches_once_a_piece(monkeypatch, rows, budget, pieces):
    """On CUDA, ``decode_batch_arrays`` makes one emission product, then
    kernel H's forward and backtrace once for each piece of
    ``trigram_cut`` (one piece; past ``MAX_BATCH``; past a budget of two
    utterances' backpointers), each on its rows, and concatenates the
    pieces in order: never a call a row."""
    _, tg = _graphs(3, True, torch.float32)
    h, v, s = tg.grid_shape
    t_len = 7
    if budget is not None:
        monkeypatch.setattr(tri, "BTS_BUDGET", budget * 4 * (t_len - 1) * h * v * s)
    monkeypatch.setattr(tdec, "sm_count", lambda dev: 132)
    monkeypatch.setattr(TrigramDecodingGraph, "_grid_log_b",
                        lambda self, obs: _CudaRows((obs.shape[0], t_len, v, s)))
    calls = {"forward": [], "backtrace": []}

    def forward(log_b, mask, *tabs):
        assert isinstance(log_b, _CudaRows) and tuple(mask.shape) == (log_b.shape[0], t_len)
        n = log_b.shape[0]
        start = sum(calls["forward"])
        calls["forward"].append(n)
        return (torch.zeros((n, t_len - 1, h, v, s), dtype=torch.int32),
                torch.arange(start, start + n, dtype=torch.float32),
                torch.arange(start, start + n, dtype=torch.int32))

    def backtrace(bts, last):
        calls["backtrace"].append(bts.shape[0])
        return last[:, None].expand(-1, t_len).contiguous()

    monkeypatch.setattr(tri, "trigram_forward", forward)
    monkeypatch.setattr(tri, "trigram_backtrace", backtrace)
    feats = torch.zeros((rows, t_len, 2))
    masks = torch.ones((rows, t_len), dtype=torch.bool)
    paths, scores = tg.decode_batch_arrays(feats, masks)
    want = tri.trigram_cut(rows, t_len, h, v, s, 4, 132)
    assert len(want) == pieces
    assert calls["forward"] == calls["backtrace"] == [j - i for i, j in want]
    assert torch.equal(scores, torch.arange(rows, dtype=torch.float32))
    assert torch.equal(paths, torch.arange(rows, dtype=torch.int32)[:, None].expand(-1, t_len))


@functools.lru_cache(maxsize=None)
def _feature_graphs():
    """A JAX and a port trigram graph with their own emissions (not the
    identity the other tests trace with): five words and silence, an
    order-3 LM, float64."""
    units = {u: _jax_unit(k, 1 + k % 3) for k, u in enumerate("ABCDE")}
    units["<sil>"] = _jax_unit(9, 4)
    lex = {w: ("ABCDE"[k],) for k, w in enumerate(WORDS)}
    toks = [JTokenizer.get_tokens(x) for x in CORPUS]
    cfg = dict(lm_scale=1.3, word_insertion_penalty=-0.4)
    jg = JTrigram.build(JLexicon(lex), units, JNGramModel(JNGramCounter(3, toks)),
                        JDecoderConfig(**cfg), silence_model=units["<sil>"], dtype=jnp.float64)
    t_units = units_from_numpy(units, device="cpu", dtype=torch.float64)
    tg = TrigramDecodingGraph.build(Lexicon(lex), t_units, NGramModel(NGramCounter(3, toks)),
                                    DecoderConfig(**cfg), silence_model=t_units["<sil>"],
                                    dtype=torch.float64, device="cpu")
    return jg, tg


def test_graph_decode_batch_matches_jax_on_features():
    """``decode_batch`` on padded 2-D features (each package's own
    emissions) with ragged masks: the JAX package's words, scores within
    1e-5 relative, and each row what ``decode`` gives alone."""
    jg, tg = _feature_graphs()
    rng = np.random.default_rng(5)
    means = np.asarray(tg.mu[:, 0])
    feats = np.stack([means[rng.integers(0, len(means), size=T_LEN)]
                      + rng.normal(scale=0.3, size=(T_LEN, means.shape[1]))
                      for _ in range(4)])
    masks = _row_masks()
    got, ref = tg.decode_batch(feats, masks), jg.decode_batch(feats, masks)
    for r in range(4):
        assert got[r][0] == ref[r][0]
        assert got[r][2] == pytest.approx(ref[r][2], rel=1e-5)
        words, path, score = tg.decode(feats[r], masks[r])
        assert words == got[r][0] and score == got[r][2]
        np.testing.assert_array_equal(path, got[r][1])


def test_parallel_serving_trigram_batch():
    """``entry.parallel_serving(..., graph="trigram", lm_order=3)`` serves
    the trigram graph's batch (here V = 12 on the CPU): ragged bucketed
    segments whose batched decode equals looping ``decode``."""
    serve = entry.parallel_serving(12, 2, device="cpu", graph="trigram", lm_order=3)
    g = serve.recognizer.graph
    assert isinstance(g, TrigramDecodingGraph) and serve.recognizer.lm.ngram.order == 3
    assert serve.masks.shape == serve.features.shape[:2] and not bool(serve.masks.all())
    paths, scores = g.decode_batch_arrays(serve.features, serve.masks)
    for r in range(2):
        path, score = g.decode_arrays(serve.features[r], serve.masks[r])
        assert torch.equal(paths[r], path) and _bits(scores[r]) == _bits(score)


def test_dry_run_of_the_trigram_batch_group(monkeypatch, tmp_path):
    """``kernel_timing.py --kernels Hbatch`` at a cut vocabulary and batch
    on the CPU (the plain versions): the forward and the backtrace, the
    batch against its single calls in turns, then ``decode_batch`` against
    the loop."""
    import json
    import sys

    import kernel_timing

    monkeypatch.setattr(kernel_timing, "H_VOCAB", 6)
    real = kernel_timing.time_h_batch
    monkeypatch.setattr(kernel_timing, "time_h_batch",
                        lambda *a, **k: real(*a, **k, rows=2))
    out = tmp_path / "rows.jsonl"
    monkeypatch.setattr(sys, "argv", ["kernel_timing.py", "--device", "cpu", "--kernels",
                                      "Hbatch", "--reps", "1", "--out", str(out)])
    assert kernel_timing.main() == 0
    rows = [json.loads(line) for line in out.read_text().splitlines() if '"kernel"' in line]
    order = [("batch", "loop"), ("loop", "batch")]
    want = [(k, t, v) for k in ("forward", "backtrace", "decode")
            for t, vs in zip((1, 2), order) for v in vs]
    got = [(r["what"].split()[1] if r["kernel"] == "H" else "decode", r["turn"], r["version"])
           for r in rows]
    assert got == want
    assert [r["launches"] for r in rows if r["kernel"] == "H"] == [1, 2, 2, 1] * 2
    assert all(r.get("ms", r.get("host_ms")) > 0 for r in rows)
    assert "V=6 trigram B=2 T=511" in rows[0]["what"]


def test_sass_counts():
    """``kernel_timing.sass_counts`` counts each function's instruction
    lines of a ``cuobjdump -sass`` listing and nothing else."""
    import kernel_timing

    listing = """
        code for sm_90a
                Function : _ZN4kernelILb0EEEv
        .headerflags    @"EF_CUDA_TEXMODE_UNIFIED EF_CUDA_64BIT_ADDRESS EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                   /* 0x00000a00ff017b82 */
                                                                            /* 0x000fe20000000800 */
        /*0010*/                   S2R R0, SR_TID.X ;                       /* 0x0000000000007919 */
        /*0020*/                   EXIT ;                                   /* 0x000000000000794d */
                ..........
                Function : _ZN4kernelILb1EEEv
        /*0000*/                   BRA 0x10;                                /* 0xfffffffc00fc7947 */
    """
    assert kernel_timing.sass_counts(listing) == {"_ZN4kernelILb0EEEv": 3, "_ZN4kernelILb1EEEv": 1}
