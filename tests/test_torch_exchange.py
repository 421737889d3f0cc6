"""A model of the exit exchange that kernels D (``csrc/factored_forward.cu``)
and F (``csrc/factored_lattice.cu``) share, stepped in seeded random
interleavings of the blocks, against the plain versions and the JAX package.

The kernels cannot run here, so the protocol runs in Python. Each block owns
some words and, per frame, does what the kernels' blocks do: publish its
words' exits at frame 0 and at every valid frame (the k-th publication into
buffer ``k & 1``, tagged with its frame), poll all V slots of the other
buffer until every tag is the last published frame's, then step its words
with the exits it took (the plain recursion: ``factored_lattice_scan``'s
within-word argmax and ``hop_entry``; for a backoff hop the blocks compute
the entry from the polled column as the kernels do: the rank-1 argmax over
the column, and the block's own range of CSR arcs folded into per-word
(value, source) keys by a max in a seeded random order, the model of the
kernels' shared-memory atomics). A masked frame publishes nothing and
repeats its records. Every load and store of one slot is one atomic step,
and a seeded scheduler picks which block moves next. The checks: every exit
a reader takes is the plain forward's exit at the frame it asked for, and
that frame is the last valid one; no slot is overwritten while a block still
has to read it; and the rows and records the blocks assemble are bitwise
those of ``factored_forward_plain``, ``factored_lattice_plain`` and the JAX
package's ``factored_lattice_scan``. Two broken variants show the model
catches what the protocol guards against: a buffer picked by frame parity
instead of publication count, and an exchange not refilled with a tag no
frame uses between two launches.
"""

import random
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
from lnasr_tpu_torch.models import decoder as tdec
from lnasr_tpu_torch.models.lexicon import Lexicon
from lnasr_tpu_torch.models.ngram import NGramCounter, NGramModel
from lnasr_tpu_torch.ops import factored as F

DIM = 5
STALE = 0xFFFFFFFF  # the tag the launchers fill the exchange with: no frame's


class ProtocolError(AssertionError):
    pass


def _unit(mean, n_states, rng):
    with np.errstate(divide="ignore"):
        log_a = np.log(np.where(np.eye(n_states) + np.eye(n_states, k=1) > 0, 0.5, 0.0))
    return types.SimpleNamespace(
        n=n_states, config=JGMMHMMConfig(n_states=n_states, n_mix=1, dim=DIM),
        log_a=log_a.astype(np.float32), log_w=np.zeros((n_states, 1), np.float32),
        mu=(mean[None, None, :] + rng.normal(scale=0.3, size=(n_states, 1, DIM))).astype(np.float32),
        cov=np.full((n_states, 1, DIM), 0.1, np.float32))


def _world(v, hop_mode, seed, t_len=24):
    """One factored graph in both packages and one utterance's grid inputs:
    ``(jax graph, port graph, log_b, pi_grid)``; words of 2-4 states."""
    rng = np.random.default_rng(seed)
    means = rng.normal(scale=8.0, size=(v + 1, DIM))
    units = {f"w{i:02d}": _unit(means[i], 2 + i % 3, rng) for i in range(v)}
    names = sorted(units)
    corpus = [tuple(["<s>"] + list(rng.choice(names, size=3)) + ["</s>"]) for _ in range(30)]
    kw = dict(silence_model=_unit(means[v], 2, rng), hop_mode=hop_mode)
    jg = jdec.FactoredDecodingGraph.build(
        JLexicon.whole_word(names), units, JNGramModel(JNGramCounter(2, corpus)),
        jdec.DecoderConfig(lm_scale=0.7), dtype=jnp.float32, **kw)
    tg = tdec.FactoredDecodingGraph.build(
        Lexicon.whole_word(names), units, NGramModel(NGramCounter(2, corpus)),
        tdec.DecoderConfig(lm_scale=0.7), device="cpu", **kw)
    obs = rng.normal(scale=8.0, size=(t_len, DIM)).astype(np.float32)
    log_b, pi_grid, _ = (np.array(x) for x in jdec._factored_grid_inputs(
        jnp.asarray(obs), jg.log_pi_w, jg.log_final_w, jg.exit_idx, jg.state_map, jg.pad_mask,
        jg.log_w, jg.mu, jg.cov, jg.cov_type))
    return jg, tg, log_b, pi_grid


class _Exchange:
    """The ``(2, V)`` slots, each ``(tag, value, publication)``, and what
    every block still has to read."""

    def __init__(self, v, n_blocks):
        self.slots = [[(STALE, np.float32(0.0), None)] * v for _ in range(2)]
        self.read = [dict() for _ in range(n_blocks)]  # block -> publication -> slots read

    def store(self, buf, v, tag, value, pub):
        old_pub = self.slots[buf][v][2]
        if old_pub is not None:
            # every block reads every publication but the last, so one
            # about to be overwritten must be read by all already
            waiting = [b for b, r in enumerate(self.read) if v not in r.get(old_pub, ())]
            if waiting:
                raise ProtocolError(f"publication {old_pub} of word {v} overwritten while blocks "
                                    f"{waiting} still need it")
        self.slots[buf][v] = (tag, value, pub)


def _backoff_entry(ex, hop, words, rng):
    """Kernels D's and F's backoff entry of the block's ``words`` from the
    polled column ``ex``: the rank-1 family's first argmax, the silence
    word's, and the block's arcs (one CSR range) folded in a random order
    into each word's key ``(value, -source)`` by a max, as the kernels'
    atomicMax folds their 64-bit keys; then the larger family, the smaller
    achieving source."""
    big = 0x7FFFFFFF
    m1, a1 = torch.max(ex + hop.from_w, dim=0)
    m2, a2 = torch.max(ex + hop.sil_from, dim=0)
    keys = {w: (float("-inf"), -big) for w in words}
    ptr = hop.arc_ptr.tolist()
    arcs = list(range(ptr[words[0]], ptr[words[-1] + 1]))
    for k in rng.sample(arcs, len(arcs)):
        w, src = int(hop.arc_dst[k]), int(hop.arc_src[k])
        keys[w] = max(keys[w], (float(ex[src] + hop.arc_val[k]), -src))
    entry, esrc = torch.empty(len(words)), torch.empty(len(words), dtype=torch.int32)
    for q, w in enumerate(words):
        if w == hop.sil_idx:
            entry[q], esrc[q] = m2, int(a2)
            continue
        r1 = m1 + hop.uni[w]
        sp, sp_src = torch.tensor(keys[w][0], dtype=r1.dtype), -keys[w][1]
        e = torch.maximum(r1, sp)
        entry[q] = e
        esrc[q] = min(int(a1) if r1 >= e else big, sp_src if sp >= e else big)
    return entry, esrc


def _block(b, words, ex_slots, world, mask, taken, out, rule):
    """One block of kernel D or F, as a generator: each ``yield`` ends one
    atomic load or store of a slot. ``out`` collects its rows and records."""
    pi_grid, inner_a, exit_idx, hop, log_b = world
    t_len, v_words, _ = log_b.shape
    rng = random.Random(b)
    g = pi_grid[words] + log_b[0][words]
    st = torch.zeros_like(g, dtype=torch.int32)
    pr = torch.full_like(st, -1)
    el = exit_idx.long()[words][:, None]

    def record(t):
        out["grids"][t][words] = g
        for arr, x in (("score", g), ("start", st), ("pred", pr)):
            out[arr][t][words] = torch.gather(x, 1, el)[:, 0]

    record(0)
    order = list(range(len(words)))
    for q in rng.sample(order, len(order)):  # frame 0's publication, buffer 0
        ex_slots.store(0, words[q], 0, out["score"][0][words[q]].item(), 0)
        yield
    n_pub, last_pub = 0, 0
    for t in range(1, t_len):
        if not mask[t]:  # identity step: records repeat, nothing is published
            record(t)
            continue
        buf = (n_pub & 1) if rule == "publication" else (last_pub & 1)
        seen = ex_slots.read[b].setdefault(n_pub, set())
        ex = torch.empty(v_words)
        pending = list(range(v_words))
        while pending:  # poll: every slot not yet tagged is reloaded each round
            for v in rng.sample(pending, len(pending)):
                tag, value, _ = ex_slots.slots[buf][v]
                yield
                if tag == last_pub:
                    ex[v] = value
                    seen.add(v)
                    pending.remove(v)
        taken.append((b, t, last_pub, ex.clone()))
        within, wsrc = torch.max(g[:, :, None] + inner_a[words], dim=1)
        nst, npr = torch.gather(st, 1, wsrc), torch.gather(pr, 1, wsrc)
        if F.hop_kind(hop) == "backoff":
            entry, esrc = _backoff_entry(ex, hop, words, rng)
        else:
            entry, esrc = F.hop_entry(ex, hop)
            entry, esrc = entry[words], esrc[words]
        wins = entry > within[:, 0]
        within[:, 0] = torch.maximum(within[:, 0], entry)
        nst[:, 0] = torch.where(wins, torch.full_like(nst[:, 0], t), nst[:, 0])
        npr[:, 0] = torch.where(wins, esrc, npr[:, 0])
        g, st, pr = within + log_b[t][words], nst, npr
        record(t)
        wbuf = ((n_pub + 1) & 1) if rule == "publication" else (t & 1)
        for q in rng.sample(order, len(order)):
            ex_slots.store(wbuf, words[q], t, out["score"][t][words[q]].item(), n_pub + 1)
            yield
        n_pub, last_pub = n_pub + 1, t


def _run(world, mask, wpb, seed, rule="publication", exchange=None, max_steps=400_000):
    """Run the blocks to the end in one seeded interleaving. Returns the
    assembled rows, records and every exit the readers took."""
    t_len, v_words, s_max = world[4].shape
    blocks = [list(range(w0, min(w0 + wpb, v_words))) for w0 in range(0, v_words, wpb)]
    exchange = exchange or _Exchange(v_words, len(blocks))
    out = {"grids": torch.empty((t_len, v_words, s_max)),
           "score": torch.empty((t_len, v_words)),
           "start": torch.empty((t_len, v_words), dtype=torch.int32),
           "pred": torch.empty((t_len, v_words), dtype=torch.int32)}
    taken = []
    live = [_block(b, ws, exchange, world, mask, taken, out, rule) for b, ws in enumerate(blocks)]
    rng = random.Random(seed)
    for _ in range(max_steps):
        if not live:
            return out, taken, exchange
        g = rng.choice(live)
        try:
            next(g)
        except StopIteration:
            live.remove(g)
    raise ProtocolError("no progress: a reader waits for a tag that never comes")


def _inputs(hop_mode, seed):
    jg, tg, log_b, pi_grid = _world(9, hop_mode, seed)
    return jg, (torch.as_tensor(pi_grid), tg.inner_a, tg.exit_idx, tg._kernel_hop,
                torch.as_tensor(log_b))


MASKS = {
    "all valid": lambda t: np.ones(t, bool),
    "bucket tail": lambda t: np.arange(t) < t - 6,
    "gaps": lambda t: ~np.isin(np.arange(t), [1, 5, 6, 7, 12, 17]),
}


@pytest.mark.parametrize("hop_mode", ["dense", "rank1", "backoff"])
@pytest.mark.parametrize("mask_name", sorted(MASKS))
@pytest.mark.parametrize("wpb", [1, 4])
def test_exchange_model_bitwise(hop_mode, mask_name, wpb):
    """Over seeded interleavings, every exit a block takes is the plain
    forward's at the last valid frame, no slot needed is overwritten, and
    the blocks' rows and records are bitwise ``factored_forward_plain``'s,
    ``factored_lattice_plain``'s and the JAX package's."""
    jg, world = _inputs(hop_mode, seed=len(hop_mode) + wpb)
    pi_grid, inner_a, exit_idx, hop, log_b = world
    t_len = log_b.shape[0]
    mask = MASKS[mask_name](t_len)
    m = torch.as_tensor(mask)
    grids_ref = F.factored_forward_plain(pi_grid, inner_a, exit_idx, hop, log_b, m)
    recs_ref = F.factored_lattice_plain(pi_grid, inner_a, exit_idx, hop, log_b, m)
    j_recs = jdec.factored_lattice_scan(jnp.asarray(log_b.numpy()), jg.inner_a, jg.hop,
                                        jnp.asarray(pi_grid.numpy()), jg.exit_idx,
                                        jnp.asarray(mask))
    for seed in range(4):
        out, taken, _ = _run(world, mask, wpb, seed)
        for _, t, asked, ex in taken:
            assert asked == max(u for u in range(t) if u == 0 or mask[u])
            assert torch.equal(ex.view(torch.int32), recs_ref[0][asked].view(torch.int32))
        assert len(taken) == -(-log_b.shape[1] // wpb) * int(mask[1:].sum())
        assert torch.equal(out["grids"].view(torch.int32), grids_ref.view(torch.int32))
        for k, name in enumerate(("score", "start", "pred")):
            got = out[name].view(torch.int32) if name == "score" else out[name]
            ref = recs_ref[k].view(torch.int32) if name == "score" else recs_ref[k]
            assert torch.equal(got, ref), name
            jref = np.asarray(j_recs[k])
            np.testing.assert_array_equal(got.numpy(), jref.view(np.int32) if name == "score"
                                          else jref)


def test_frame_parity_buffers_break_the_exchange():
    """Picking the buffer by frame parity, not by publication count, is
    caught under masks (a masked frame shifts the parity): a slot still
    needed is overwritten, or a reader waits for a tag that never comes."""
    _, world = _inputs("dense", seed=3)
    mask = MASKS["gaps"](world[4].shape[0])
    caught = 0
    for seed in range(6):
        try:
            _run(world, mask, 2, seed, rule="frame", max_steps=100_000)
        except ProtocolError:
            caught += 1
    assert caught > 0
    _run(world, MASKS["all valid"](world[4].shape[0]), 2, 0, rule="frame")  # no mask, no fault


def test_second_launch_needs_the_stale_tag_refill():
    """A second launch on the same exchange without the refill can take the
    first launch's exits: after a first launch whose only valid frame past 0
    is frame 1, the buffers still hold tags 0 and 1, which the second
    launch's readers ask for at frames 1 and 2 (and a block that runs ahead
    on them overwrites a slot others still need). With the refill every
    taken exit is this launch's."""
    _, first = _inputs("dense", seed=5)
    _, second = _inputs("dense", seed=6)
    t_len, v_words = first[4].shape[:2]
    mask = MASKS["all valid"](t_len)
    ref = F.factored_lattice_plain(*second)[0].view(torch.int32)
    n_blocks = -(-v_words // 3)
    stale_taken = 0
    for seed in range(6):
        ex = _run(first, np.arange(t_len) < 2, 3, seed)[2]
        reused = _Exchange(v_words, n_blocks)
        reused.slots = [[(tag, val, None) for tag, val, _ in row] for row in ex.slots]
        try:  # stale exits taken, or a block raced ahead on them and overwrote a slot
            _, taken, _ = _run(second, mask, 3, seed + 100, exchange=reused)
            stale_taken += sum(not torch.equal(x.view(torch.int32), ref[a])
                               for _, _, a, x in taken)
        except ProtocolError:
            stale_taken += 1
        _, taken, _ = _run(second, mask, 3, seed + 100)  # refilled: tag STALE everywhere
        assert all(torch.equal(x.view(torch.int32), ref[a]) for _, _, a, x in taken)
    assert stale_taken > 0
