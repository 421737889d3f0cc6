"""A model of the exit exchange that kernels D (``csrc/factored_forward.cu``)
and F (``csrc/factored_lattice.cu``) share, stepped in seeded random
interleavings of the blocks, against the plain versions and the JAX package.

The kernels cannot run here, so the protocol runs in Python. Each block owns
some words and, per frame, does what the kernels' blocks do. With a dense
hop: publish its words' exits at frame 0 and at every valid frame (the k-th
publication into buffer ``k & 1``, tagged with its frame), poll all V slots
of the other buffer until every tag is the last published frame's, then
step its words with the exits it took (the plain recursion:
``factored_lattice_scan``'s within-word argmax and ``hop_entry``). With the
rank-1 and backoff hops (the kernels' factored kinds): fold its words' exits
into the rank-1 family's two (value, source) keys and publish each key as
two tagged words in a ``(2, n_blocks, 4)`` region (after its exits, for the
backoff hop); poll the other buffer's partial words of every block and,
for the backoff hop, the exits of its own arcs' distinct sources only
(``ops.factored.block_layout``, over the arc-balanced word map), taking a
key once both of its words carry the frame asked for; combine the blocks'
keys by max; fold its own arcs into per-word keys in a seeded random order
(the model of the kernels' shared-memory atomics); then form each word's
entry and source as the kernels' state-0 threads do. A masked frame
publishes nothing and repeats its records. Every load and store of one
slot is one atomic step, and a seeded scheduler picks which block moves
next. The checks: every exit and partial a reader takes is the plain
forward's at the frame it asked for, and that frame is the last valid one;
no slot is overwritten while a block that reads it still has to; and the
rows and records the blocks assemble are bitwise those of
``factored_forward_plain``, ``factored_lattice_plain`` and the JAX
package's ``factored_lattice_scan``. Two broken variants show the model
catches what the protocol guards against: a buffer picked by frame parity
instead of publication count, and an exchange not refilled with a tag no
frame uses between two launches.

The batched exchange (a launch of B utterances) is modelled the same way:
every utterance's slots apart, the utterances stepped in lockstep, a frame
live when any utterance takes it and then published for every utterance
(a masked one's values unchanged), every reader asking every utterance for
the last live frame's tag; with masks that differ by utterance its rows
and records are the batched plain versions', row by row, and a variant
whose masked utterances publish nothing is caught.
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
    """The slots, each ``(tag, value, publication)``: ``(2, V)`` exits and,
    for the factored kinds, ``(2, n_blocks, 4)`` partial words after them
    (slot ``V + 4 b + q``); and what every block still has to read.
    ``readers[slot]``: the blocks that read the slot at every publication
    (all of them, unless given)."""

    def __init__(self, v, n_blocks, readers=None):
        n = v + 4 * n_blocks
        self.slots = [[(STALE, np.float32(0.0), None)] * n for _ in range(2)]
        self.read = [dict() for _ in range(n_blocks)]  # block -> publication -> slots read
        self.readers = readers

    def store(self, buf, v, tag, value, pub):
        old_pub = self.slots[buf][v][2]
        if old_pub is not None:
            # every block that reads the slot reads every publication but
            # the last, so one about to be overwritten must be read already
            readers = range(len(self.read)) if self.readers is None else self.readers[v]
            waiting = [b for b in readers if v not in self.read[b].get(old_pub, ())]
            if waiting:
                raise ProtocolError(f"publication {old_pub} of slot {v} overwritten while blocks "
                                    f"{waiting} still need it")
        self.slots[buf][v] = (tag, value, pub)


BIG = 0x7FFFFFFF  # the kernels' "no source"


def _key(x, src):
    """The kernels' 64-bit (value, source) key of a float32 ``x``: the
    larger value, then the smaller source (-0 and +0 tied, the winner's
    sign kept), as a Python int."""
    bits = int(np.float32(x + np.float32(0.0)).view(np.uint32))
    hi = (~bits & 0xFFFFFFFF) if bits & 0x80000000 else bits | 0x80000000
    neg0 = int(np.float32(x).view(np.uint32) == 0x80000000)
    return (hi << 32) | (((~src & 0xFFFFFFFF) << 1) & 0xFFFFFFFF) | neg0


def _value(key):
    if key & 1:
        return np.float32(-0.0)
    hi = key >> 32
    return np.uint32(hi & 0x7FFFFFFF if hi & 0x80000000 else ~hi & 0xFFFFFFFF).view(np.float32)


def _source(key):
    return ~(((key & 0xFFFFFFFF) >> 1) | 0x80000000) & 0xFFFFFFFF


def _partials(ex, hop, words):
    """A block's two partial keys: its words' ``exit + from_w`` and
    ``exit + sil_from``, each with the word as its source."""
    return [max(_key(np.float32(ex[w] + f[w]), w) for w in words)
            for f in (hop.from_w.numpy(), hop.sil_from.numpy())]


def _factored_entry(k1, k2, src_ex, hop, words, lay, b, rng):
    """Kernels D's and F's entry and source of the block's ``words`` from
    the combined rank-1 keys and, for a backoff hop, the exits of the
    block's own sources (``src_ex``, in its list's order): the arcs of its
    one CSR range folded into per-word keys in a random order (the
    atomics), then the larger family, the smaller achieving source."""
    keys = {w: _key(np.float32(-np.inf), BIG) for w in words}
    if lay is not None:
        ptr = hop.arc_ptr.tolist()
        arcs = list(range(ptr[words[0]], ptr[words[-1] + 1]))
        for k in rng.sample(arcs, len(arcs)):
            cand = np.float32(src_ex[int(lay.arc_lsrc[k])] + hop.arc_val[k].item())
            w = int(hop.arc_dst[k])
            keys[w] = max(keys[w], _key(cand, int(hop.arc_src[k])))
    entry, esrc = torch.empty(len(words)), torch.empty(len(words), dtype=torch.int32)
    for q, w in enumerate(words):
        if w == hop.sil_idx:
            entry[q], esrc[q] = float(_value(k2)), _source(k2)
            continue
        r1 = np.float32(_value(k1) + hop.uni[w].item())
        sp = _value(keys[w])
        en = sp if sp > r1 else r1
        entry[q] = float(en)
        esrc[q] = min(_source(k1) if r1 >= en else BIG, _source(keys[w]) if sp >= en else BIG)
    return entry, esrc


def _block(b, words, ex_slots, world, mask, taken, out, rule, lay):
    """One block of kernel D or F, as a generator: each ``yield`` ends one
    atomic load or store of a slot. ``out`` collects its rows and records
    and, for the factored kinds, the partial keys it combined; ``lay`` is
    the backoff hop's block layout."""
    pi_grid, inner_a, exit_idx, hop, log_b = world
    t_len, v_words, _ = log_b.shape
    kind = F.hop_kind(hop)
    factored = kind in ("rank1", "backoff")
    n_blocks = len(ex_slots.read)
    rng = random.Random(b)
    g = pi_grid[words] + log_b[0][words]
    st = torch.zeros_like(g, dtype=torch.int32)
    pr = torch.full_like(st, -1)
    el = exit_idx.long()[words][:, None]
    srcs = [] if lay is None else [int(x) for x in lay.src[lay.src_ptr[b]:lay.src_ptr[b + 1]]]
    # the slots this block polls: every exit (dense), or every block's
    # partial words and its own sources' exits (the factored kinds)
    wanted = ([v_words + q for q in range(4 * n_blocks)] + srcs) if factored else \
        list(range(v_words))

    def record(t):
        out["grids"][t][words] = g
        for arr, x in (("score", g), ("start", st), ("pred", pr)):
            out[arr][t][words] = torch.gather(x, 1, el)[:, 0]

    def publish(buf, t, pub):
        """The exits (dense, backoff) in a random order, then, for the
        factored kinds, the partial keys' four words in a random order."""
        order = list(range(len(words)))
        if kind != "rank1":
            for q in rng.sample(order, len(order)):
                ex_slots.store(buf, words[q], t, out["score"][t][words[q]].item(), pub)
                yield
        if factored:
            k1, k2 = _partials(out["score"][t], hop, words)
            halves = [k1 >> 32, k1 & 0xFFFFFFFF, k2 >> 32, k2 & 0xFFFFFFFF]
            for q in rng.sample(range(4), 4):
                ex_slots.store(buf, v_words + 4 * b + q, t, halves[q], pub)
                yield

    record(0)
    yield from publish(0, 0, 0)  # frame 0's publication, buffer 0
    n_pub, last_pub = 0, 0
    for t in range(1, t_len):
        if not mask[t]:  # identity step: records repeat, nothing is published
            record(t)
            continue
        buf = (n_pub & 1) if rule == "publication" else (last_pub & 1)
        seen = ex_slots.read[b].setdefault(n_pub, set())
        got = {}
        pending = list(wanted)
        while pending:  # poll: every slot not yet tagged is reloaded each round
            for slot in rng.sample(pending, len(pending)):
                tag, value, _ = ex_slots.slots[buf][slot]
                yield
                if tag == last_pub:
                    got[slot] = value
                    seen.add(slot)
                    pending.remove(slot)
        ex = torch.full((v_words,), float("nan"))
        for slot, value in got.items():
            if slot < v_words:
                ex[slot] = value
        taken.append((b, t, last_pub, ex))
        within, wsrc = torch.max(g[:, :, None] + inner_a[words], dim=1)
        nst, npr = torch.gather(st, 1, wsrc), torch.gather(pr, 1, wsrc)
        if factored:
            base = [v_words + 4 * c for c in range(n_blocks)]
            k1 = max(got[q] << 32 | got[q + 1] for q in base)
            k2 = max(got[q + 2] << 32 | got[q + 3] for q in base)
            out["parts"].append((b, t, last_pub, k1, k2))
            entry, esrc = _factored_entry(k1, k2, [np.float32(got[v]) for v in srcs], hop,
                                          words, lay, b, rng)
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
        yield from publish(wbuf, t, n_pub + 1)
        n_pub, last_pub = n_pub + 1, t


def _run(world, mask, wpb, seed, rule="publication", exchange=None, max_steps=400_000):
    """Run the blocks to the end in one seeded interleaving. Returns the
    assembled rows, records, partial keys and every exit the readers took
    (NaN where a block polls no slot), and the exchange. The blocks own
    ``wpb`` words each, or for a backoff hop the ranges of
    ``ops.factored.block_layout`` over ``ceil(V / wpb)`` SMs."""
    t_len, v_words, s_max = world[4].shape
    hop = world[3]
    lay = None
    if F.hop_kind(hop) == "backoff":
        lay = F.block_layout(hop, s_max, -(-v_words // wpb))
        blk = [int(x) for x in lay.blk_ptr]
        blocks = [list(range(w0, w1)) for w0, w1 in zip(blk[:-1], blk[1:])]
    else:
        blocks = [list(range(w0, min(w0 + wpb, v_words))) for w0 in range(0, v_words, wpb)]
    n_blocks = len(blocks)
    readers = None
    if F.hop_kind(hop) in ("rank1", "backoff"):  # a partial: every block; an exit: its arcs' blocks
        readers = {v_words + q: range(n_blocks) for q in range(4 * n_blocks)}
        for v in range(v_words):
            readers[v] = [] if lay is None else [
                b for b in range(n_blocks) if v in set(lay.src[lay.src_ptr[b]:lay.src_ptr[b + 1]])]
    exchange = exchange or _Exchange(v_words, n_blocks, readers)
    out = {"grids": torch.empty((t_len, v_words, s_max)),
           "score": torch.empty((t_len, v_words)),
           "start": torch.empty((t_len, v_words), dtype=torch.int32),
           "pred": torch.empty((t_len, v_words), dtype=torch.int32),
           "parts": []}
    taken = []
    live = [_block(b, ws, exchange, world, mask, taken, out, rule, lay)
            for b, ws in enumerate(blocks)]
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
    """Over seeded interleavings, every exit and partial key a block takes
    is the plain forward's at the last valid frame (the factored kinds'
    blocks take their own sources' exits only), no slot needed is
    overwritten, and the blocks' rows and records are bitwise
    ``factored_forward_plain``'s, ``factored_lattice_plain``'s and the JAX
    package's."""
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
    factored = hop_mode != "dense"
    keys = [_partials(recs_ref[0][t], hop, range(log_b.shape[1])) for t in range(t_len)] \
        if factored else []
    for seed in range(4):
        out, taken, exchange = _run(world, mask, wpb, seed)
        for _, t, asked, ex in taken:
            assert asked == max(u for u in range(t) if u == 0 or mask[u])
            polled = ~torch.isnan(ex)
            assert bool(polled.all()) != factored  # the factored kinds poll only their sources
            assert torch.equal(ex[polled].view(torch.int32),
                               recs_ref[0][asked][polled].view(torch.int32))
        for _, t, asked, k1, k2 in out["parts"]:  # the blocks' keys combined: the plain's
            assert asked == max(u for u in range(t) if u == 0 or mask[u])
            assert [k1, k2] == keys[asked]
        assert len(taken) == len(exchange.read) * int(mask[1:].sum())
        assert len(out["parts"]) == (len(taken) if factored else 0)
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


# -- the batched exchange (a launch of B utterances) ---------------------------


def _batch_block(b, words, ex_slots, world, masks, taken, out, lay, rule="republish"):
    """One block of kernel D or F at a batch, as a generator (the batch
    rules of ``csrc/factored_exchange.cuh``): the utterances step in
    lockstep, slot ``s`` of utterance ``u`` is ``u * per + s`` (``per``:
    one utterance's exits and partial words); a frame is live when any
    utterance is valid at it, and a live frame publishes every utterance's
    exits and partials with its tag, an utterance masked there its
    unchanged ones, so every reader asks every utterance for one tag. With
    ``rule="skip masked"`` a masked utterance publishes nothing (the
    readers still ask for the common tag)."""
    pi_grid, inner_a, exit_idx, hop, log_b = world
    n_utt, t_len, v_words, _ = log_b.shape
    kind = F.hop_kind(hop)
    factored = kind in ("rank1", "backoff")
    n_blocks = len(ex_slots.read)
    per = v_words + 4 * n_blocks
    rng = random.Random(b)
    g = [pi_grid[words] + log_b[u, 0][words] for u in range(n_utt)]
    st = [torch.zeros_like(g[0], dtype=torch.int32) for _ in range(n_utt)]
    pr = [torch.full_like(st[0], -1) for _ in range(n_utt)]
    el = exit_idx.long()[words][:, None]
    srcs = [] if lay is None else [int(x) for x in lay.src[lay.src_ptr[b]:lay.src_ptr[b + 1]]]
    base = ([v_words + q for q in range(4 * n_blocks)] + srcs) if factored else \
        list(range(v_words))
    wanted = [u * per + s for u in range(n_utt) for s in base]

    def record(u, t):
        out["grids"][u, t][words] = g[u]
        for arr, x in (("score", g[u]), ("start", st[u]), ("pred", pr[u])):
            out[arr][u, t][words] = torch.gather(x, 1, el)[:, 0]

    def publish(buf, t, pub, valid):
        """Every utterance's exits and partial words (those of ``valid``
        alone under the broken rule), one store a step in a random order."""
        items = []
        for u in range(n_utt):
            if not valid[u]:
                continue
            if kind != "rank1":
                items += [(u * per + w, out["score"][u, t][w].item()) for w in words]
            if factored:
                k1, k2 = _partials(out["score"][u, t], hop, words)
                halves = [k1 >> 32, k1 & 0xFFFFFFFF, k2 >> 32, k2 & 0xFFFFFFFF]
                items += [(u * per + v_words + 4 * b + q, h) for q, h in enumerate(halves)]
        for slot, value in rng.sample(items, len(items)):
            ex_slots.store(buf, slot, t, value, pub)
            yield

    for u in range(n_utt):
        record(u, 0)
    yield from publish(0, 0, 0, [True] * n_utt)
    n_pub, last_pub = 0, 0
    for t in range(1, t_len):
        if not masks[:, t].any():  # no utterance takes the frame: nothing is published
            for u in range(n_utt):
                record(u, t)
            continue
        seen = ex_slots.read[b].setdefault(n_pub, set())
        got, pending = {}, list(wanted)
        while pending:  # poll: every utterance's slots, all asked for one tag
            for slot in rng.sample(pending, len(pending)):
                tag, value, _ = ex_slots.slots[n_pub & 1][slot]
                yield
                if tag == last_pub:
                    got[slot] = value
                    seen.add(slot)
                    pending.remove(slot)
        for u in range(n_utt):
            if masks[u, t]:
                ex = torch.full((v_words,), float("nan"))
                for v in range(v_words):
                    if u * per + v in got:
                        ex[v] = got[u * per + v]
                taken.append((b, u, t, last_pub, ex))
                within, wsrc = torch.max(g[u][:, :, None] + inner_a[words], dim=1)
                nst, npr = torch.gather(st[u], 1, wsrc), torch.gather(pr[u], 1, wsrc)
                if factored:
                    parts = [u * per + v_words + 4 * c for c in range(n_blocks)]
                    k1 = max(got[q] << 32 | got[q + 1] for q in parts)
                    k2 = max(got[q + 2] << 32 | got[q + 3] for q in parts)
                    out["parts"].append((b, u, t, last_pub, k1, k2))
                    entry, esrc = _factored_entry(
                        k1, k2, [np.float32(got[u * per + v]) for v in srcs], hop, words, lay, b,
                        rng)
                else:
                    entry, esrc = F.hop_entry(ex, hop)
                    entry, esrc = entry[words], esrc[words]
                wins = entry > within[:, 0]
                within[:, 0] = torch.maximum(within[:, 0], entry)
                nst[:, 0] = torch.where(wins, torch.full_like(nst[:, 0], t), nst[:, 0])
                npr[:, 0] = torch.where(wins, esrc, npr[:, 0])
                g[u], st[u], pr[u] = within + log_b[u, t][words], nst, npr
            record(u, t)
        valid = [True] * n_utt if rule == "republish" else list(masks[:, t])
        yield from publish((n_pub + 1) & 1, t, n_pub + 1, valid)
        n_pub, last_pub = n_pub + 1, t


def _run_batch(world, masks, wpb, seed, rule="republish", max_steps=1_500_000):
    """:func:`_run` for a batch ``log_b (B, T, V, S)``, ``masks (B, T)``."""
    n_utt, t_len, v_words, s_max = world[4].shape
    hop = world[3]
    lay = None
    if F.hop_kind(hop) == "backoff":
        lay = F.block_layout(hop, s_max, -(-v_words // wpb))
        blk = [int(x) for x in lay.blk_ptr]
        blocks = [list(range(w0, w1)) for w0, w1 in zip(blk[:-1], blk[1:])]
    else:
        blocks = [list(range(w0, min(w0 + wpb, v_words))) for w0 in range(0, v_words, wpb)]
    n_blocks = len(blocks)
    per = v_words + 4 * n_blocks
    readers = None
    if F.hop_kind(hop) in ("rank1", "backoff"):  # as in _run, for every utterance's slots
        one = {v_words + q: range(n_blocks) for q in range(4 * n_blocks)}
        for v in range(v_words):
            one[v] = [] if lay is None else [
                b for b in range(n_blocks) if v in set(lay.src[lay.src_ptr[b]:lay.src_ptr[b + 1]])]
        readers = {u * per + s: r for u in range(n_utt) for s, r in one.items()}
    exchange = _Exchange(n_utt * per - 4 * n_blocks, n_blocks, readers)  # n_utt * per slots
    out = {"grids": torch.empty((n_utt, t_len, v_words, s_max)),
           "score": torch.empty((n_utt, t_len, v_words)),
           "start": torch.empty((n_utt, t_len, v_words), dtype=torch.int32),
           "pred": torch.empty((n_utt, t_len, v_words), dtype=torch.int32),
           "parts": []}
    taken = []
    live = [_batch_block(b, ws, exchange, world, masks, taken, out, lay, rule)
            for b, ws in enumerate(blocks)]
    rng = random.Random(seed)
    for _ in range(max_steps):
        if not live:
            return out, taken, exchange
        gen = rng.choice(live)
        try:
            next(gen)
        except StopIteration:
            live.remove(gen)
    raise ProtocolError("no progress: a reader waits for a tag that never comes")


def _batch_inputs(hop_mode, seed, n_utt=3):
    """One graph and ``n_utt`` utterances' grid inputs over it (the JAX
    package's emissions): ``(jax graph, world with log_b (B, T, V, S))``."""
    jg, tg, log_b, pi_grid = _world(9, hop_mode, seed)
    rng = np.random.default_rng(seed + 50)
    rows = [log_b]
    for _ in range(n_utt - 1):
        obs = rng.normal(scale=8.0, size=(log_b.shape[0], DIM)).astype(np.float32)
        rows.append(np.array(jdec._factored_grid_inputs(
            jnp.asarray(obs), jg.log_pi_w, jg.log_final_w, jg.exit_idx, jg.state_map,
            jg.pad_mask, jg.log_w, jg.mu, jg.cov, jg.cov_type)[0]))
    return jg, (torch.as_tensor(pi_grid), tg.inner_a, tg.exit_idx, tg._kernel_hop,
                torch.as_tensor(np.stack(rows)))


def _batch_masks(t_len):
    """Masks that differ by utterance: a bucket tail with gaps, one valid
    at frame 0 alone, one all valid; frames 9 and 10 masked in every row (a
    frame no utterance takes)."""
    masks = np.ones((3, t_len), bool)
    masks[0, t_len - 6:] = False
    masks[0, [3, 4, 14]] = False
    masks[1, 1:] = False
    masks[:, [9, 10]] = False
    return masks


@pytest.mark.parametrize("hop_mode", ["dense", "rank1", "backoff"])
@pytest.mark.parametrize("wpb", [2, 5])
def test_batched_exchange_model_bitwise(hop_mode, wpb):
    """The batched exchange over seeded interleavings, with masks that
    differ by utterance: every exit and partial key a block takes for an
    utterance is the plain forward's at the last live frame, no slot needed
    is overwritten, and the blocks' rows and records are bitwise those of
    the batched ``factored_forward_plain`` and ``factored_lattice_plain``
    and of the JAX package's ``factored_lattice_scan``, row by row."""
    jg, world = _batch_inputs(hop_mode, seed=7 + wpb)
    pi_grid, inner_a, exit_idx, hop, log_b = world
    n_utt, t_len = log_b.shape[:2]
    masks = _batch_masks(t_len)
    m = torch.as_tensor(masks)
    grids_ref = F.factored_forward_plain(pi_grid, inner_a, exit_idx, hop, log_b, m)
    recs_ref = F.factored_lattice_plain(pi_grid, inner_a, exit_idx, hop, log_b, m)
    live = masks.any(0)
    last_live = lambda t: max(u for u in range(t) if u == 0 or live[u])  # noqa: E731
    factored = hop_mode != "dense"
    for seed in range(2):
        out, taken, exchange = _run_batch(world, masks, wpb, seed)
        for _, u, t, asked, ex in taken:
            assert asked == last_live(t) and masks[u, t]
            polled = ~torch.isnan(ex)
            assert bool(polled.all()) != factored
            assert torch.equal(ex[polled].view(torch.int32),
                               recs_ref[0][u, asked][polled].view(torch.int32))
        for _, u, t, asked, k1, k2 in out["parts"]:
            assert asked == last_live(t)
            assert [k1, k2] == _partials(recs_ref[0][u, asked], hop, range(log_b.shape[2]))
        assert len(taken) == len(exchange.read) * int(masks[:, 1:].sum())
        assert torch.equal(out["grids"].view(torch.int32), grids_ref.view(torch.int32))
        for k, name in enumerate(("score", "start", "pred")):
            got = out[name].view(torch.int32) if name == "score" else out[name]
            ref = recs_ref[k].view(torch.int32) if name == "score" else recs_ref[k]
            assert torch.equal(got, ref), name
    for u in range(n_utt):  # the batched plain rows: the JAX package's scans
        j_recs = jdec.factored_lattice_scan(jnp.asarray(log_b[u].numpy()), jg.inner_a, jg.hop,
                                            jnp.asarray(pi_grid.numpy()), jg.exit_idx,
                                            jnp.asarray(masks[u]))
        assert np.array_equal(recs_ref[0][u].numpy().view(np.int32),
                              np.asarray(j_recs[0]).view(np.int32))


def test_batched_exchange_needs_masked_utterances_republished():
    """If an utterance masked at a live frame published nothing, the
    readers, which ask every utterance for the live frame's tag, would wait
    for a tag that never comes (or take a stale one): the model is caught
    without the republication, and runs with it."""
    _, world = _batch_inputs("dense", seed=3)
    masks = _batch_masks(world[4].shape[1])
    with pytest.raises(ProtocolError):
        _run_batch(world, masks, 3, 0, rule="skip masked", max_steps=300_000)
    _run_batch(world, masks, 3, 0)
