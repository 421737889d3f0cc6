"""The word-to-block layout of kernels D and F for the rank-1 and backoff
hops (``ops/factored.py``: ``block_map``, ``block_sources``,
``block_layout``), and a NumPy model of the hop entry in the kernels'
order, against the plain ``hop_entry``. No JAX: ``hop_entry`` is held to
the JAX package's ``_hop_entry`` in ``test_torch_factored_backoff.py``.

The kernels cannot run here. The model does what their blocks do each
frame: every block folds its own words' ``exit + from_w`` and ``exit +
sil_from`` into two 64-bit (value, source) keys (the kernels' ``key_of``:
the larger value, then the smaller source, -0 and +0 tied with the
winner's sign kept); the blocks' keys are combined by max; a block reads
the exits of its own arcs' distinct sources only, through the source list
and each arc's index into it, and folds its arcs into per-word keys of the
same form in a seeded random order (the shared-memory atomics); the entry
is then formed as the word's state-0 thread forms it. The cases plant the
ties the rules are for: rank-1 maxima reached by words of several blocks,
arcs that tie the rank-1 entry from another block, signed zeros, ``-inf``
holes and all-``-inf`` exits.
"""

import numpy as np
import pytest
import torch

from lnasr_tpu_torch.ops import factored as F

BIG = 0x7FFFFFFF  # the kernels' "no source"


def _csr(rng, v, heavy_low=4, row256=None, zeros=0.3, lam=3.0):
    """A skewed CSR by destination: the lowest ids the heaviest rows (as a
    corpus bigram's popular words), a row of 256 at ``row256``, a share of
    rows with no arc. Returns ``(arc_ptr, arc_src)``, sources ascending."""
    rows = rng.poisson(lam, size=v)
    rows[rng.random(v) < zeros] = 0
    rows[:heavy_low] = rng.integers(60, 160, size=heavy_low)
    if row256 is not None:
        rows[row256] = 256
    rows = np.minimum(rows, v)
    ptr = np.concatenate([[0], np.cumsum(rows)]).astype(np.int64)
    src = np.concatenate([np.sort(rng.choice(v, size=n, replace=False)) for n in rows]
                         + [np.zeros(0, np.int64)])
    return ptr, src.astype(np.int32)


MAP_CASES = [  # (V, S, n_sm, heavy low rows, the row of 256, seed)
    (300, 3, 4, 4, 150, 0),
    (300, 2, 8, 6, None, 1),
    (280, 3, 6, 0, 0, 2),
    (400, 2, 5, 8, 399, 3),
    (120, 8, 8, 3, 60, 4),
]


@pytest.mark.parametrize("case", MAP_CASES, ids=lambda c: "V{}S{}sm{}".format(*c[:3]))
def test_block_map_covers_and_balances(case):
    """``block_map`` cuts the words into contiguous, non-empty ranges that
    cover them all, at most ``n_sm`` blocks of at most ``1024 // S`` words,
    the largest block holding at most the largest row plus an even share
    (``ceil(nnz / n_blocks)``) of the arcs; a row of 256 past that share
    sits in a block whose other rows fit beside it; the same CSR gives the
    same map."""
    v, s, n_sm, heavy, row256, seed = case
    ptr, _ = _csr(np.random.default_rng(seed), v, heavy, row256)
    blk = F.block_map(ptr, s, n_sm)
    assert blk.dtype == np.int32 and blk[0] == 0 and blk[-1] == v
    words, arcs = np.diff(blk), np.diff(ptr[blk])
    n_blocks = len(words)
    assert 1 <= n_blocks <= n_sm and (words >= 1).all() and words.max() <= 1024 // s
    nnz, row = int(ptr[-1]), int(np.diff(ptr).max())
    assert arcs.max() <= row + -(-nnz // n_blocks)
    assert arcs.max() <= row + -(-nnz // n_sm)
    if row256 is not None:
        b = int(np.searchsorted(blk, row256, side="right")) - 1
        assert blk[b] <= row256 < blk[b + 1] and arcs[b] <= row + -(-nnz // n_sm)
    np.testing.assert_array_equal(F.block_map(ptr, s, n_sm), blk)
    # the threads of the launch: the largest block's cells in warps, >= 256
    threads = max(256, -(-int(words.max()) * s // 32) * 32)
    assert threads <= F.MAX_THREADS


def test_block_map_word_cap_and_few_arcs():
    """Where the words fill the blocks, the map still covers them within
    the word cap, and past ``n_sm * (1024 // S)`` words there is none; a
    graph with few arcs keeps the even map's threads (``ceil(V / n_sm)``
    words a block at most), as the V = 5000 serving graph does."""
    rng = np.random.default_rng(5)
    s, n_sm = 8, 6
    v = n_sm * (1024 // s) - 3
    ptr, _ = _csr(rng, v, heavy_low=2, lam=1.0)
    blk = F.block_map(ptr, s, n_sm)
    words = np.diff(blk)
    assert blk[-1] == v and len(words) == n_sm and words.max() == 1024 // s
    assert F.block_map(np.zeros(n_sm * (1024 // s) + 2, np.int64), s, n_sm) is None
    # 500 words, an arc every 97th, 16 SMs, S = 8: the even map's 32 words
    # a block are 256 threads, and the map takes no more
    v = 500
    few = np.concatenate([[0], np.cumsum((np.arange(v) % 97 == 0).astype(np.int64))])
    assert np.diff(F.block_map(few, 8, 16)).max() * 8 <= 256
    empty = F.block_map(np.zeros(v + 1, np.int64), 3, 16)
    assert empty[-1] == v and len(empty) - 1 <= 16 and np.diff(empty).max() * 3 <= 256


@pytest.mark.parametrize("case", MAP_CASES[:3], ids=lambda c: "V{}S{}sm{}".format(*c[:3]))
def test_block_sources_index_every_arc(case):
    """Each block's source list is its arcs' distinct sources, ascending;
    every arc's index into its block's list gives back its source."""
    v, s, n_sm, heavy, row256, seed = case
    ptr, src = _csr(np.random.default_rng(seed), v, heavy, row256)
    blk = F.block_map(ptr, s, n_sm)
    src_ptr, bsrc, lsrc = F.block_sources(ptr, src, blk)
    assert src_ptr.dtype == bsrc.dtype == lsrc.dtype == np.int32
    assert src_ptr[0] == 0 and src_ptr[-1] == len(bsrc) and len(lsrc) == len(src)
    for b in range(len(blk) - 1):
        a0, a1 = ptr[blk[b]], ptr[blk[b + 1]]
        mine = bsrc[src_ptr[b]:src_ptr[b + 1]]
        np.testing.assert_array_equal(mine, np.unique(src[a0:a1]))
        np.testing.assert_array_equal(mine[lsrc[a0:a1]], src[a0:a1])


# -- the hop entry in the kernels' order ----------------------------------------


def _key(x, src):
    """The kernels' ``key_of`` on float32 values and int sources, as
    uint64: the order-preserving pattern of ``x + 0`` (so -0 and +0 tie)
    above the complemented source shifted over a bit that marks -0."""
    x = np.asarray(x, np.float32)
    b = (x + np.float32(0.0)).view(np.uint32)
    hi = np.where(b & 0x80000000, ~b, b | 0x80000000).astype(np.uint64)
    neg0 = (x.view(np.uint32) == 0x80000000).astype(np.uint64)
    lo = ((~np.asarray(src, np.int64).astype(np.uint32)).astype(np.uint64) << 1) & 0xFFFFFFFF
    return (hi << np.uint64(32)) | lo | neg0


def _value(key):
    key = np.asarray(key, np.uint64)
    hi = (key >> np.uint64(32)).astype(np.uint32)
    val = np.where(hi & 0x80000000, hi & 0x7FFFFFFF, ~hi).astype(np.uint32).view(np.float32)
    return np.where(key & np.uint64(1), np.float32(-0.0), val).astype(np.float32)


def _source(key):
    lo = (np.asarray(key, np.uint64) & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    return (~((lo >> 1) | np.uint32(0x80000000))).astype(np.int64)


def _model_entry(exit_v, hop, layout, rng):
    """The entry and its source as kernels D and F form them over
    ``layout``'s blocks (rank-1 partials combined across blocks; each
    block's arcs through its source list, folded in a random order)."""
    exit_v = np.asarray(exit_v, np.float32)
    from_w, uni, sil_from = (x.numpy() for x in (hop.from_w, hop.uni, hop.sil_from))
    v = len(from_w)
    blk = np.asarray(layout.blk_ptr) if layout is not None else \
        np.minimum(np.arange(0, v + -(-v // 7), -(-v // 7)), v)
    k1 = k2 = np.uint64(0)
    for w0, w1 in zip(blk[:-1], blk[1:]):  # each block's partials, then their max
        words = np.arange(w0, w1)
        k1 = max(k1, _key(exit_v[words] + from_w[words], words).max())
        k2 = max(k2, _key(exit_v[words] + sil_from[words], words).max())
    m1, a1, m2, a2 = _value(k1), _source(k1), _value(k2), _source(k2)
    entry = np.zeros(v, np.float32)
    esrc = np.zeros(v, np.int64)
    sp_key = np.full(v, _key(np.float32(-np.inf), BIG), np.uint64)
    if isinstance(hop, F.BackoffHop):
        ptr, src, dst, val = (x.numpy() for x in (hop.arc_ptr, hop.arc_src, hop.arc_dst,
                                                  hop.arc_val))
        for b in range(len(blk) - 1):
            bsrc = np.asarray(layout.src)[layout.src_ptr[b]:layout.src_ptr[b + 1]]
            polled = exit_v[bsrc]  # the only exit slots the block reads
            arcs = np.arange(ptr[blk[b]], ptr[blk[b + 1]])
            for k in rng.permutation(arcs):
                cand = polled[layout.arc_lsrc[k]] + val[k]
                sp_key[dst[k]] = max(sp_key[dst[k]], _key(cand, src[k]))
    for w in range(v):
        if w == hop.sil_idx:
            entry[w], esrc[w] = m2, a2
            continue
        r1 = np.float32(m1 + uni[w])
        sp = _value(sp_key[w])
        en = sp if sp > r1 else r1  # torch.maximum(r1, sp): r1 on a tie
        entry[w] = en
        esrc[w] = min(a1 if r1 >= en else BIG, _source(sp_key[w]) if sp >= en else BIG)
    return entry, esrc


def _tie_hop(rng, v, sil, kind):
    """Factors with integer scores in a narrow range (ties across blocks,
    signed zeros) and arcs at their own backoff estimate (ties between the
    families), as a ``BackoffHop`` or a ``Rank1Hop``."""
    def draw(*shape):
        return np.round(rng.normal(scale=0.6, size=shape)).astype(np.float32)

    from_w, uni = draw(v), draw(v)
    sil_idx = v - 1 if sil else -1
    sil_from = draw(v) if sil else np.full(v, -np.inf, np.float32)
    if sil:
        sil_from[sil_idx] = uni[sil_idx] = -np.inf
    k = 6
    pred = np.zeros((v, k), np.int32)
    val = np.full((v, k), -np.inf, np.float32)
    for w in range(v):
        n = int(rng.integers(0, k + 1)) if w > 2 else k
        srcs = np.sort(rng.choice(v, size=n, replace=False))
        x = from_w[srcs] + uni[w] + np.abs(draw(n))
        at = rng.random(n) < 0.5
        x[at] = from_w[srcs[at]] + uni[w]
        pred[w, :n], val[w, :n] = srcs, x
    t = torch.as_tensor
    if kind == "rank1":
        return F.Rank1Hop(t(from_w), t(uni), t(sil_from), sil_idx)
    import types
    return F.backoff_hop(types.SimpleNamespace(from_w=t(from_w), uni=t(uni), sil_from=t(sil_from),
                                               sil_idx=sil_idx, pred=t(pred), val=t(val)))


def _bits(x):
    return np.asarray(x, np.float32).view(np.int32)


@pytest.mark.parametrize("kind", ["backoff", "rank1"])
@pytest.mark.parametrize("sil", [True, False])
def test_entry_in_kernel_order_bitwise(kind, sil):
    """The entry formed the kernels' way (per-block partial keys combined
    across blocks; a block's arcs through its own source list) equals
    ``hop_entry`` bit for bit in value (for the rank-1 hop with the sign of
    a zero too; see the next test for the backoff hop's) and in source
    wherever the entry is finite, on exits with ties across blocks, zeros
    of both signs, ``-inf`` holes and all ``-inf``; the planted ties do
    cross blocks."""
    rng = np.random.default_rng(11 + sil)
    v, s, n_sm = 90, 3, 6
    hop = _tie_hop(rng, v, sil, kind)
    layout = F.block_layout(hop, s, n_sm)
    assert (layout is None) == (kind == "rank1")
    if layout is not None:
        assert layout.n_blocks > 1 and layout.max_words * s <= F.MAX_THREADS
    blk = np.asarray(layout.blk_ptr) if layout is not None else \
        np.minimum(np.arange(0, v + -(-v // 7), -(-v // 7)), v)
    block_of = np.searchsorted(blk, np.arange(v), side="right") - 1
    cross_r1 = cross_fam = neg0 = 0
    exits = [np.round(rng.normal(scale=0.6, size=v)) for _ in range(6)]
    holes = np.round(rng.normal(scale=0.6, size=v))
    holes[rng.random(v) < 0.4] = -np.inf
    # the rank-1 maximum a -0, reached in several blocks: -0 + -0 where
    # from_w is -0, -1 elsewhere
    fw = hop.from_w.numpy()
    zeros = np.where(fw.view(np.int32) == np.int32(-2**31), np.float32(-0.0), -fw - 1)
    exits += [np.zeros(v), -np.zeros(v), zeros, holes, np.full(v, -np.inf)]
    for exit_v in exits:
        exit_v = exit_v.astype(np.float32)
        want_e, want_s = (x.numpy() for x in F.hop_entry(torch.as_tensor(exit_v), hop))
        got_e, got_s = _model_entry(exit_v, hop, layout, rng)
        if kind == "rank1":
            np.testing.assert_array_equal(_bits(got_e), _bits(want_e))
        else:  # torch.maximum(r1, sp) gives either zero on a tie of -0 and +0
            np.testing.assert_array_equal(_bits(got_e + np.float32(0.0)),
                                          _bits(want_e + np.float32(0.0)))
        finite = np.isfinite(want_e)
        np.testing.assert_array_equal(got_s[finite], want_s[finite])
        c = exit_v + hop.from_w.numpy()
        if np.isfinite(c.max()):
            cross_r1 += len(set(block_of[c == c.max()])) > 1
        neg0 += int((_bits(want_e) == np.int32(-2**31)).sum())
        if kind == "backoff":
            cand = exit_v[hop.arc_src.numpy()] + hop.arc_val.numpy()
            r1 = c.max() + hop.uni.numpy()[hop.arc_dst.numpy()]
            a1 = int(np.argmax(c))
            cross_fam += int(((cand == r1) & np.isfinite(cand)
                              & (block_of[hop.arc_src.numpy()] != block_of[a1])).sum())
    assert cross_r1 > 0 and neg0 > 0
    assert kind == "rank1" or cross_fam > 0


def test_signed_zero_ties_of_torch_maximum():
    """Why the backoff entries are compared with -0 and +0 taken as one:
    the plain ``torch.maximum(r1, sp)`` itself gives the first operand's
    zero on short CPU tensors and the second's on long ones, while
    ``torch.max`` keeps its first maximum's sign at every length (which
    the kernels' keys reproduce)."""
    signs = set()
    for n in (4, 64):
        neg, pos = torch.full((n,), -0.0), torch.zeros(n)
        signs.add(bool(torch.signbit(torch.maximum(neg, pos))[0]))
        row = torch.full((n,), -1.0)
        row[1], row[-1] = -0.0, 0.0
        value, index = torch.max(row, dim=0)
        assert bool(torch.signbit(value)) and int(index) == 1
    assert len(signs) == 2


def test_signed_zero_arc_ties_keep_lowest_source():
    """The sign the kernels keep when a word's arc candidates tie at -0 and
    +0: the two zeros tie (neither ranks above the other), the lowest
    source wins and its zero's sign is kept, as ``torch.max`` keeps its
    first maximum over the padded rows' ascending sources. Word 5's arcs
    give -0 from source 1 and +0 from source 3, word 6's +0 from source 2
    and -0 from source 4; the fold runs in several random orders and
    maps."""
    import types

    v, s = 8, 2
    neg0 = np.float32(-0.0)
    from_w, uni = np.full(v, -10.0, np.float32), np.zeros(v, np.float32)
    pred = np.zeros((v, 3), np.int32)
    val = np.full((v, 3), -np.inf, np.float32)
    pred[5], val[5] = [1, 3, 6], [neg0, 0.0, -1.0]
    pred[6], val[6] = [2, 4, 7], [0.0, neg0, -2.0]
    exit_v = np.full(v, -3.0, np.float32)
    exit_v[[1, 4]] = neg0  # -0 + -0 = -0
    exit_v[[2, 3]] = 0.0  # +0 + +0 = +0
    t = torch.as_tensor
    padded = types.SimpleNamespace(from_w=t(from_w), uni=t(uni),
                                   sil_from=t(np.full(v, -np.inf, np.float32)), sil_idx=-1,
                                   pred=t(pred), val=t(val))
    hop = F.backoff_hop(padded)
    want_e, want_s = (x.numpy() for x in F.hop_entry(t(exit_v), padded))
    assert _bits(want_e[5]) == _bits(neg0) and want_s[5] == 1
    assert _bits(want_e[6]) == 0 and want_s[6] == 2
    rng = np.random.default_rng(5)
    for n_sm in (1, 2, 4):
        layout = F.block_layout(hop, s, n_sm)
        for _ in range(4):
            got_e, got_s = _model_entry(exit_v, hop, layout, rng)
            np.testing.assert_array_equal(_bits(got_e[5:7]), _bits(want_e[5:7]))
            np.testing.assert_array_equal(got_s[5:7], [1, 2])
    # the key itself: the zeros tie on the value half, the source decides
    lo_neg, hi_pos = _key(neg0, 1), _key(np.float32(0.0), 3)
    assert lo_neg >> np.uint64(32) == hi_pos >> np.uint64(32) and lo_neg > hi_pos
    assert _key(np.float32(0.0), 2) > _key(neg0, 4)


def test_layout_operands_and_capacity():
    """``block_layout`` builds once per (S, SMs) and device and keeps it in
    the hop's cache; the capacity rules size the map's largest block and
    its source list as the launchers do (64-bit sparse keys, four partial
    words a block), and the exchange holds the exits and the partials."""
    rng = np.random.default_rng(7)
    hop = _tie_hop(rng, 200, True, "backoff")
    lay = F.block_layout(hop, 3, 8)
    assert F.block_layout(hop, 3, 8) is lay and (3, 8) in hop.cache
    on = F.block_layout(hop, 3, 8, device="cpu")
    assert torch.equal(on.blk_ptr, torch.as_tensor(lay.blk_ptr)) and on.blk_ptr.dtype == torch.int32
    assert F.block_layout(hop, 3, 8, device="cpu") is on
    assert lay.max_arcs == int(np.diff(hop.arc_ptr.numpy()[lay.blk_ptr]).max())
    wpb, nb, ns = lay.max_words, lay.n_blocks, lay.max_src
    ns2 = ns + ns % 2  # the polled slots padded to an even count (8-byte keys follow)
    # rows, within-word maxima and emissions (3 wpb S), inner blocks, exit
    # indices, slots; 64-bit keys: a word's sparse one and its two exit
    # keys, and the two polled ones of a group of 32 blocks
    assert F.forward_smem_bytes(200, 3, wpb, "backoff", nb, ns) == (
        4 * (3 * wpb * 3 + wpb * 9 + wpb + 4 * nb + ns2 + ns) + 8 * (3 * wpb + 2))
    assert F.lattice_smem_bytes(200, 3, wpb, "backoff", nb, ns) == (
        4 * (3 * wpb * 3 + wpb * 9 + wpb + 4 * wpb * 3 + 4 * nb + ns2 + ns) + 8 * (3 * wpb + 2))
    assert F.forward_smem_bytes(200, 3, 25, "rank1") == (
        4 * (3 * 25 * 3 + 25 * 9 + 25 + 4 * 8) + 8 * (2 * 25 + 2))
    assert F.exchange_slots(200, "backoff", nb) == 2 * 200 + 2 * nb * F.PART_WORDS
    assert F.exchange_slots(200, "rank1", 8) == 2 * 8 * F.PART_WORDS
    assert F.exchange_slots(200, "dense", 8) == F.exchange_slots(200, "none", 8) == 400
    assert F.factored_kernel_ok(50, 200, 3, hop, 8) and F.lattice_kernel_ok(200, 3, hop, 8)
    # 200 words on one SM: past 1024 // S words a block, no map and no kernel
    assert F.block_layout(hop, 8, 1) is None
    assert not F.factored_kernel_ok(50, 200, 8, hop, 1) and not F.lattice_kernel_ok(200, 8, hop, 1)
