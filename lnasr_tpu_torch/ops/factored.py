"""Factored word-graph Viterbi: the forward (every frame's ``(V, S)`` grid),
the exact-replay backtrace over the stored grids, and the lattice-recording
forward (per frame and word, the exit record ``(score, start, pred)``).

Counterpart of the JAX package's ``ops/factored_pallas.py``
(``factored_forward_pallas``, ``factored_decode_pallas``, the XLA
``factored_backtrace`` and ``factored_lattice_pallas``). For CUDA tensors
:func:`factored_forward` launches the kernel of
``csrc/factored_forward.cu`` (a cooperative launch over the card; the
blocks exchange each frame's exit scores through tagged 64-bit slots,
with no grid barrier), :func:`factored_backtrace` the kernels of
``csrc/factored_backtrace.cu`` (a pre-pass over the card gathering every
frame's exit scores, then one block per utterance walking the replay in
windows of :data:`BACKTRACE_WINDOW` frames) and :func:`factored_lattice`
the kernel of ``csrc/factored_lattice.cu`` (the forward's layout and
exchange, carrying each state's token start and predecessor word);
for CPU tensors they run :func:`factored_forward_plain`,
:func:`factored_backtrace_plain` and :func:`factored_lattice_plain`, which
the kernels are held to bitwise.

The word hop is ``None`` (loop-free graph), a dense ``(V, V)`` matrix
``hop[from, to]``, or backoff factors (``from_w``, ``uni``, ``sil_from``,
``sil_idx``, ``pred``, ``val``: :class:`lnasr_tpu_torch.models.decoder.
HopFactors`, duck-typed here). The kernels take four hop kinds: none, the
dense matrix, the edge-free ("rank-1") factors (:class:`Rank1Hop`) and
the factors with sparse seen-bigram edges as a CSR of their finite arcs
by destination (:class:`BackoffHop`, built by :func:`backoff_hop`; the
forward and lattice kernels spread its words over the blocks by
:func:`block_map` and poll only each block's own arcs' sources,
:func:`block_sources`). The
padded ``(V, K)`` factors stay the operand of the scans, the counterparts
of the JAX package's jitted scans: :func:`factored_lattice_scan` here
(it is also the lattice kernel's plain version) and
``factored_trellis_scan`` in :mod:`lnasr_tpu_torch.models.decoder`.

Every function takes one utterance, ``(T, V, S)`` emissions and a ``(T,)``
mask, or a batch of them, ``(B, T, V, S)`` and ``(B, T)``, over one graph
(the JAX package's ``jax.vmap`` of its scans): a kernel launch then
decodes the B utterances together, and a plain version steps them as one
tensor, each row bitwise the single-utterance call. One launch takes as
many utterances as :func:`factored_kernel_ok` and :func:`lattice_kernel_ok`
allow; :func:`cut_batch` cuts a larger batch into launches by those rules.
"""

from __future__ import annotations

import bisect
import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from lnasr_tpu_torch import _build

SMEM_LIMIT = 232448  # bytes of shared memory one block can use on sm_90
GRID_BUDGET = 2 * 1024**3  # bytes of stored grids one launch may take (B T V S floats)
MAX_THREADS = 1024  # a forward block's threads: csrc/factored_forward.cu's launch bounds
BACKTRACE_WINDOW = 32  # frames a backtrace window stages: csrc/factored_backtrace.cu's K
MAX_BLOCKS = 1024  # the factored kinds' blocks (csrc/factored_exchange.cuh): 32 combines of 32
MAX_BATCH = 64  # utterances a launch of D or F takes: a frame's valid flags are one 64-bit word

_P = ctypes.c_void_p
_I = ctypes.c_int
# every launch's hop operands: hop_kind, hop_t, from_w, uni, sil_from,
# sil_idx, arc_ptr, arc_dst, arc_src, arc_val
_HOP_ARGTYPES = [_I, _P, _P, _P, _P, _I, _P, _P, _P, _P]
# the forward's and lattice kernel's word-to-block layout (BlockLayout):
# blk_ptr, src_ptr, src, arc_lsrc, n_blocks, max_words, max_src
_MAP_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I]
# pi_grid, inner_a, exit_idx, (hop), log_b, mask, B, T, V, S, n_sm, (layout),
# grids, exchange, stream
_FWD_ARGTYPES = [_P, _P, _P, *_HOP_ARGTYPES, _P, _P, _I, _I, _I, _I, _I, *_MAP_ARGTYPES,
                 _P, _P, _P]
# grids, inner_a, exit_idx, (hop), final, mask, B, T, V, S, exits, path,
# score, stream
_BWD_ARGTYPES = [_P, _P, _P, *_HOP_ARGTYPES, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P]
# pi_grid, inner_a, exit_idx, (hop), log_b, mask, B, T, V, S, n_sm, (layout),
# exit_score, exit_start, exit_pred, exchange, stream
_LAT_ARGTYPES = [_P, _P, _P, *_HOP_ARGTYPES, _P, _P, _I, _I, _I, _I, _I, *_MAP_ARGTYPES,
                 _P, _P, _P, _P, _P]
_HOP_IDS = {"none": 0, "dense": 1, "rank1": 2, "backoff": 3}  # the kernels' HOP_* constants
# exchange words a block publishes a frame for the rank-1 family's partials
# (csrc/factored_exchange.cuh's PART): m1's and m2's 64-bit (value, source) keys, each as
# two tagged words
PART_WORDS = 4


class Rank1Hop(NamedTuple):
    """Edge-free backoff factors, the kernels' rank-1 hop operand:
    ``entry[w] = max_v(exit[v] + from_w[v]) + uni[w]``, and for the silence
    word ``max_v(exit[v] + sil_from[v])``. Telling the kind by type keeps
    the dispatch free of a device read of ``val``."""

    from_w: torch.Tensor  # (V,)
    uni: torch.Tensor  # (V,)
    sil_from: torch.Tensor  # (V,)
    sil_idx: int  # silence word id, -1 when absent


class BackoffHop(NamedTuple):
    """Backoff factors with sparse seen-bigram edges, the kernels' backoff
    hop operand: the rank-1 family of :class:`Rank1Hop` and, per
    destination ``w``, ``sp[w] = max over w's arcs of exit[src] + val``;
    ``entry[w] = max(r1[w], sp[w])``, the silence word riding ``sil_from``.
    The arcs are the factors' finite ``(V, K)`` slots in CSR by
    destination (:func:`backoff_hop`): a padded slot is ``-inf`` and can
    neither raise a maximum nor tie a finite one."""

    from_w: torch.Tensor  # (V,)
    uni: torch.Tensor  # (V,)
    sil_from: torch.Tensor  # (V,)
    sil_idx: int  # silence word id, -1 when absent
    arc_ptr: torch.Tensor  # (V + 1,) int32: destination w's arcs are [arc_ptr[w], arc_ptr[w+1])
    arc_src: torch.Tensor  # (nnz,) int32 source words, ascending within a row
    arc_val: torch.Tensor  # (nnz,) arc scores, all finite
    arc_dst: torch.Tensor  # (nnz,) int32 each arc's destination (its CSR row)
    # host copies of arc_ptr and arc_src ("ptr", "src") and the kernels'
    # layouts built from them (block_layout), so that no launch reads the
    # CSR back from the card
    cache: dict


def backoff_hop(factors) -> BackoffHop:
    """The CSR operand of ``factors`` (``from_w``, ``uni``, ``sil_from``,
    ``sil_idx``, padded ``pred``/``val`` rows): every finite ``val`` slot
    as an arc, rows by destination, sources ascending within a row, on the
    device and in the dtype of ``factors.from_w``."""
    pred = torch.as_tensor(factors.pred).cpu().numpy()
    val = torch.as_tensor(factors.val).cpu().numpy()
    dst, k = np.nonzero(np.isfinite(val))
    src = pred[dst, k]
    order = np.lexsort((src, dst))
    dst, src, arc_val = dst[order], src[order], val[dst[order], k[order]]
    v = pred.shape[0]
    ptr = np.zeros(v + 1, np.int64)
    np.cumsum(np.bincount(dst, minlength=v), out=ptr[1:])
    if ptr[-1] >= 2**31:
        raise ValueError(f"{ptr[-1]} arcs overflow the CSR's int32 offsets")
    dev, dtype = factors.from_w.device, factors.from_w.dtype
    i32 = lambda x: torch.as_tensor(x.astype(np.int32), device=dev)  # noqa: E731
    return BackoffHop(factors.from_w, factors.uni, factors.sil_from, int(factors.sil_idx),
                      i32(ptr), i32(src), torch.as_tensor(arc_val, dtype=dtype, device=dev),
                      i32(dst), {"ptr": ptr.astype(np.int32), "src": src.astype(np.int32)})


class BlockLayout(NamedTuple):
    """How kernels D and F spread a backoff hop's words over their blocks:
    the word-to-block map (:func:`block_map`) and each block's distinct arc
    sources (:func:`block_sources`), as the launch operands and the sizes
    the capacity rule and the launcher read."""

    blk_ptr: object  # (n_blocks + 1,) int32: block b owns words [blk_ptr[b], blk_ptr[b+1])
    src_ptr: object  # (n_blocks + 1,) int32: block b's sources are src[src_ptr[b]:src_ptr[b+1]]
    src: object  # int32 each block's distinct arc sources, ascending
    arc_lsrc: object  # (nnz,) int32 each arc's source as an index into its block's list
    n_blocks: int
    max_words: int  # words of the largest block (the launch's threads: its cells)
    max_src: int  # sources of the block with the most (the slots it polls beside the partials)
    max_arcs: int  # arcs of the block with the most


def _greedy_cut(prefix, cap_arcs: int, cap_words: int, n_max: int) -> Optional[list]:
    """Contiguous blocks, each as long as ``cap_arcs`` arcs and
    ``cap_words`` words allow (``prefix``: the arc counts' running sums), as
    their first words and the end; None if that takes more than ``n_max``
    blocks. Taking the most each time gives the fewest blocks of any cut
    under both caps."""
    v, cut, i = len(prefix) - 1, [0], 0
    while i < v:
        j = min(bisect.bisect_right(prefix, prefix[i] + cap_arcs) - 1, i + cap_words, v)
        if j <= i or len(cut) > n_max:
            return None
        cut.append(j)
        i = j
    return cut


def block_map(arc_ptr, s: int, n_sm: int) -> Optional[np.ndarray]:
    """Kernels D's and F's word-to-block map for a backoff hop: contiguous
    ranges of words as ``blk_ptr`` (``n_blocks + 1`` int32), at most
    ``n_sm`` blocks (all resident under the cooperative launch) of at most
    ``MAX_THREADS // s`` words (a thread a cell). A block's frame waits for
    its arcs' rounds (``arcs / threads``) and every block waits for the
    slowest, so the ranges are cut by arcs: for each thread count from the
    even map's (``ceil(V / n_sm)`` words a block, at least 256 threads) up,
    in warps, the cut with the fewest arcs in its largest block under that
    count's word cap (a bisection over the arc cap, each tried by
    :func:`_greedy_cut`), and the first count whose largest block takes one
    round of its threads and holds at most the largest row plus an even
    share, ``ceil(nnz / n_sm)``; if none does, the cut at the most threads.
    So a graph with few arcs keeps the even map's threads. None if the words
    do not fit ``n_sm`` blocks."""
    arc_ptr = np.asarray(arc_ptr, np.int64)
    v = len(arc_ptr) - 1
    cap_all = MAX_THREADS // s if s >= 1 else 0
    n_sm = min(n_sm, MAX_BLOCKS)
    if v < 1 or n_sm < 1 or cap_all < 1 or v > n_sm * cap_all:
        return None
    prefix = arc_ptr.tolist()
    rows = np.diff(arc_ptr)
    share = int(rows.max()) + -(-int(arc_ptr[-1]) // n_sm)
    first = max(256, -(-(-(-v // n_sm) * s) // 32) * 32)
    best = None
    for threads in range(first, MAX_THREADS + 1, 32):
        cap_words = min(threads // s, cap_all)
        if cap_words * n_sm < v:
            continue
        lo, hi = int(rows.max()), int(arc_ptr[-1])
        while lo < hi:  # the least arc cap that cuts into at most n_sm blocks
            mid = (lo + hi) // 2
            if _greedy_cut(prefix, mid, cap_words, n_sm) is None:
                lo = mid + 1
            else:
                hi = mid
        best = _greedy_cut(prefix, lo, cap_words, n_sm)
        words = int(np.diff(best).max())
        if lo <= min(max(256, -(-words * s // 32) * 32), share):
            break
    return np.asarray(best, np.int32)


def block_sources(arc_ptr, arc_src, blk_ptr) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Each block's distinct arc sources for the map ``blk_ptr``:
    ``(src_ptr, src, arc_lsrc)``, block ``b``'s sources ascending in
    ``src[src_ptr[b]:src_ptr[b+1]]`` (the only exit slots it polls) and each
    arc's source as an index into its block's list, all int32."""
    arc_ptr, arc_src = np.asarray(arc_ptr, np.int64), np.asarray(arc_src)
    lsrc = np.zeros(len(arc_src), np.int32)
    lists, ptr = [], [0]
    for w0, w1 in zip(blk_ptr[:-1], blk_ptr[1:]):
        a0, a1 = arc_ptr[w0], arc_ptr[w1]
        uniq, inv = np.unique(arc_src[a0:a1], return_inverse=True)
        lsrc[a0:a1] = inv
        lists.append(uniq)
        ptr.append(ptr[-1] + len(uniq))
    src = np.concatenate(lists) if lists else np.zeros(0)
    return np.asarray(ptr, np.int32), src.astype(np.int32), lsrc


def block_layout(hop, s: int, n_sm: int, device=None) -> Optional[BlockLayout]:
    """The :class:`BlockLayout` of a :class:`BackoffHop` at ``s`` states
    and ``n_sm`` SMs, its arrays as NumPy or, with ``device``, as int32
    tensors there; built once per hop from its host copies and kept in its
    ``cache``. None for another hop, or where the words do not fit."""
    if not isinstance(hop, BackoffHop):
        return None
    cache, key = hop.cache, (s, n_sm)
    if key not in cache:
        ptr, src = cache["ptr"], cache["src"]
        blk = block_map(ptr, s, n_sm)
        if blk is None:
            cache[key] = None
        else:
            src_ptr, bsrc, lsrc = block_sources(ptr, src, blk)
            words, arcs = np.diff(blk), np.diff(np.asarray(ptr, np.int64)[blk])
            cache[key] = BlockLayout(blk, src_ptr, bsrc, lsrc, len(blk) - 1, int(words.max()),
                                     int(np.diff(src_ptr).max()), int(arcs.max()))
    layout = cache[key]
    if layout is None or device is None:
        return layout
    dkey = (s, n_sm, str(device))
    if dkey not in cache:
        cache[dkey] = layout._replace(**{n: torch.as_tensor(getattr(layout, n), device=device)
                                         for n in ("blk_ptr", "src_ptr", "src", "arc_lsrc")})
    return cache[dkey]


def _is_factors(hop) -> bool:
    return hop is not None and hasattr(hop, "from_w")


def hop_kind(hop) -> str:
    """``"none"``, ``"dense"``, ``"rank1"`` (:class:`Rank1Hop`, or factors
    without a finite sparse edge) or ``"backoff"`` (:class:`BackoffHop`,
    or padded factors with sparse seen-bigram edges)."""
    if hop is None:
        return "none"
    if isinstance(hop, BackoffHop):
        return "backoff"
    if not _is_factors(hop):
        return "dense"
    if not hasattr(hop, "val"):
        return "rank1"
    return "backoff" if bool(torch.isfinite(torch.as_tensor(hop.val)).any()) else "rank1"


def hop_entry(exit_v: torch.Tensor, hop) -> Tuple[torch.Tensor, torch.Tensor]:
    """Word entry ``entry[w] = max_v exit_v[v] + hop[v, w]`` and its first
    argmax source, for a dense matrix or backoff factors (the JAX package's
    ``models/decoder.py:_hop_entry``); ``exit_v`` ``(V,)`` or a batch's
    ``(B, V)``, each row on its own. The factored argmax reproduces the
    dense first-index rule: the rank-1 family's achiever is the lowest
    index, the sparse family's the lowest achieving predecessor (rows are
    sorted by source id), and the source is the smaller of the achieving
    families' sources; the silence word rides ``sil_from``.

    A :class:`BackoffHop` gives the padded factors' entries everywhere and
    their sources wherever the entry is finite (the only places a source
    is read: a hop is taken only when strictly better than the within-word
    candidate). Where a row's best arc is ``-inf`` its source is the row's
    lowest (as in the kernels), and a row without arcs has none
    (``V + 1``)."""
    if _is_factors(hop):
        big = hop.from_w.shape[0] + 1
        m1, a1 = torch.max(exit_v + hop.from_w, dim=-1)
        r1 = m1[..., None] + hop.uni
        a1 = a1[..., None].expand(r1.shape)
        if isinstance(hop, BackoffHop):
            src, dst = hop.arc_src.long(), hop.arc_dst.long()
            cand = exit_v[..., src] + hop.arc_val  # (..., nnz)
            dst_b = dst.expand(cand.shape)
            sp = torch.full_like(r1, -math.inf).scatter_reduce(-1, dst_b, cand, "amax")
            fill = torch.full(r1.shape, big, dtype=torch.long, device=r1.device)
            sp_src = fill.scatter_reduce(-1, dst_b, torch.where(cand == sp[..., dst], src, big),
                                         "amin")
            entry = torch.maximum(r1, sp)
            esrc = torch.minimum(torch.where(r1 >= entry, a1, fill),
                                 torch.where(sp >= entry, sp_src, fill)).to(torch.int32)
        elif not hasattr(hop, "pred"):  # Rank1Hop: max(r1, -inf) is r1
            entry, esrc = r1, a1.to(torch.int32).clone()
        else:
            cand = exit_v[..., hop.pred.long()] + hop.val  # (..., V, K)
            sp, ksel = torch.max(cand, dim=-1)
            pred = hop.pred.expand(cand.shape)
            sp_src = torch.gather(pred, -1, ksel[..., None])[..., 0]
            entry = torch.maximum(r1, sp)
            fill = torch.full_like(sp_src, big)
            esrc = torch.minimum(torch.where(r1 >= entry, a1.to(sp_src.dtype), fill),
                                 torch.where(sp >= entry, sp_src, fill)).to(torch.int32)
        sil = int(hop.sil_idx)
        if sil >= 0:
            m2, a2 = torch.max(exit_v + hop.sil_from, dim=-1)
            entry = entry.clone()
            entry[..., sil] = m2
            esrc[..., sil] = a2.to(torch.int32)
        return entry, esrc
    best, arg = torch.max(exit_v[..., :, None] + hop, dim=-2)
    return best, arg.to(torch.int32)


def _as_batch(x: torch.Tensor, mask: Optional[torch.Tensor]):
    """``(x (B, T, ...), mask (B, T) bool or None, single)``: one
    utterance's ``(T, V, S)`` input as a batch of one."""
    single = x.dim() == 3
    if single:
        x = x[None]
        mask = None if mask is None else mask[None]
    return x, None if mask is None else mask.to(torch.bool), single


def _frame_rules(valid: Optional[torch.Tensor], t_len: int) -> list:
    """Each frame's rule for the plain loops, read from the host once: True
    where every utterance is valid (or there is no mask), False where none
    is (an identity step for all), None where some are (the step keeps the
    masked utterances' values)."""
    if valid is None:
        return [True] * t_len
    return [all(c) or (None if any(c) else False) for c in zip(*valid.tolist())]


def factored_forward_plain(pi_grid: torch.Tensor, inner_a: torch.Tensor, exit_idx: torch.Tensor,
                           hop, log_b_grid: torch.Tensor,
                           mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every frame's grid ``(T, V, S)``, or ``(B, T, V, S)`` for a batch:
    the forward half of
    :func:`~lnasr_tpu_torch.models.decoder.factored_trellis_scan` (the same
    adds in the same order; max is exact), the batch's utterances stepped as
    one tensor. Masked frames keep an utterance's grid."""
    log_b, valid, single = _as_batch(log_b_grid, mask)
    b, t_len, v_words, _ = log_b.shape
    live = _frame_rules(valid, t_len)
    exit_l = exit_idx.long()[None, :, None].expand(b, v_words, 1)
    v = pi_grid + log_b[:, 0]
    grids = [v]
    for t in range(1, t_len):
        if live[t] is False:
            grids.append(v)
            continue
        within = torch.amax(v[..., None] + inner_a, dim=-2)
        if hop is not None:
            entry, _ = hop_entry(torch.gather(v, 2, exit_l)[..., 0], hop)
            within[..., 0] = torch.maximum(within[..., 0], entry)
        new = within + log_b[:, t]
        v = new if live[t] else torch.where(valid[:, t, None, None], new, v)
        grids.append(v)
    out = torch.stack(grids, dim=1)
    return out[0] if single else out


def factored_backtrace_plain(grids: torch.Tensor, inner_a: torch.Tensor, exit_idx: torch.Tensor,
                             hop, final_grid: torch.Tensor,
                             mask: Optional[torch.Tensor] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact-replay backtrace over ``grids (T, V, S)`` -> ``(path (T,) int32
    in v*S+s ids, score)``, or over a batch's ``(B, T, V, S)`` -> ``(paths
    (B, T), scores (B,))``: the JAX package's ``factored_backtrace``
    extended with the rank-1 rules of its ``_bwd_kernel`` and the backoff
    rules of ``models/decoder.py:_hop_entry`` (:func:`hop_entry`). Per step:
    the first s maximizing ``grid[t-1][w, s] + inner_a[w, s, j]``; at j = 0
    the first hop source, taken only when strictly better; masked frames
    point to themselves; termination is the first maximum over flat ids.
    The states walk on the host: each step reads the valid utterances'
    rows through views and takes their maxima in one call, and the hop is formed only for the utterances at a word
    entry (a backoff hop's entries in one call)."""
    g, valid, single = _as_batch(grids, mask)
    kind = hop_kind(hop)
    b, t_len, v_words, s_max = g.shape
    valid = [[True] * t_len] * b if valid is None else valid.tolist()
    exit_l = exit_idx.long()
    exit_host = exit_l.tolist()
    words = torch.arange(v_words, device=g.device)
    inner_t = inner_a.transpose(1, 2)  # [w, j]: the column inner_a[w, :, j]
    score, last = torch.max((g[:, -1] + final_grid).reshape(b, -1), dim=1)
    state = last.tolist()
    path = [state]
    sil = int(hop.sil_idx) if kind == "rank1" else -1
    for t in range(t_len - 1, 0, -1):
        live = [i for i in range(b) if valid[i][t]]
        if not live:
            path.append(state)
            continue
        vprev = g[:, t - 1]
        wj = [divmod(state[i], s_max) for i in live]
        m, s_arg = torch.max(torch.stack([vprev[i, w] + inner_t[w, j]
                                          for i, (w, j) in zip(live, wj)]), dim=1)
        state = list(state)
        for i, (w, _), s in zip(live, wj, s_arg.tolist()):
            state[i] = w * s_max + s
        at = [k for k, (_, j) in enumerate(wj) if j == 0]
        if kind == "none" or not at:
            path.append(state)
            continue
        exits = vprev[:, words, exit_l]  # (B, V)
        if kind == "backoff":
            entry, esrc = hop_entry(exits[[live[k] for k in at]], hop)
            best = [(entry[r, wj[k][0]], esrc[r, wj[k][0]]) for r, k in enumerate(at)]
        else:
            best = []
            for k in at:
                w, x = wj[k][0], exits[live[k]]
                if kind == "dense":
                    best.append(torch.max(x + hop[:, w], dim=0))
                elif w == sil:
                    best.append(torch.max(x + hop.sil_from, dim=0))
                else:
                    h, src = torch.max(x + hop.from_w, dim=0)
                    best.append((h + hop.uni[w], src))
        m_host = m.tolist()
        hmax, src = (torch.stack(x).tolist() for x in zip(*best))
        for k, h, v in zip(at, hmax, src):
            if h > m_host[k]:
                state[live[k]] = v * s_max + exit_host[v]
        path.append(state)
    path = torch.tensor(path[::-1], dtype=torch.int32, device=g.device).t().contiguous()
    return (path[0], score[0]) if single else (path, score)


def factored_lattice_scan(log_b_grid: torch.Tensor, inner_a: torch.Tensor, hop,
                          pi_grid: torch.Tensor, exit_idx: torch.Tensor,
                          mask: Optional[torch.Tensor] = None
                          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The lattice-recording forward, ``(exit_score (T, V), exit_start (T, V)
    int32, exit_pred (T, V) int32, v_last (V, S))``, or for a batch's
    ``(B, T, V, S)`` emissions each with a leading B, its utterances stepped
    as one tensor: the JAX package's ``models/decoder.py:factored_lattice_scan``
    with its argument order and the same adds in the same order, for every
    hop kind (:func:`hop_entry`). Each state carries the frame its word
    token was entered (``start``) and the word it was entered from
    (``pred``, -1 at sentence begin), both following the first within-word
    argmax; state 0 takes ``(t, hop source)`` only where the hop is strictly
    better. Masked frames are identity steps and repeat the previous
    frame's records."""
    log_b, valid, single = _as_batch(log_b_grid, mask)
    b, t_len, v_words, s_max = log_b.shape
    live = _frame_rules(valid, t_len)
    dev = log_b.device
    exit_g = exit_idx.long()[None, :, None].expand(b, v_words, 1)

    def records(v, start, pred):
        return tuple(torch.gather(x, 2, exit_g)[..., 0] for x in (v, start, pred))

    v = pi_grid + log_b[:, 0]
    start = torch.zeros((b, v_words, s_max), dtype=torch.int32, device=dev)
    pred = torch.full((b, v_words, s_max), -1, dtype=torch.int32, device=dev)
    recs = [records(v, start, pred)]
    for t in range(1, t_len):
        if live[t] is False:
            recs.append(recs[-1])
            continue
        within, wsrc = torch.max(v[..., None] + inner_a, dim=-2)
        new_start = torch.gather(start, 2, wsrc)
        new_pred = torch.gather(pred, 2, wsrc)
        if hop is not None:
            entry, esrc = hop_entry(torch.gather(v, 2, exit_g)[..., 0], hop)
            wins = entry > within[..., 0]
            within[..., 0] = torch.maximum(within[..., 0], entry)
            new_start[..., 0] = torch.where(wins, torch.full_like(new_start[..., 0], t),
                                            new_start[..., 0])
            new_pred[..., 0] = torch.where(wins, esrc, new_pred[..., 0])
        new = within + log_b[:, t]
        if not live[t]:
            keep = valid[:, t, None, None]
            new, new_start, new_pred = (torch.where(keep, x, y) for x, y in
                                        ((new, v), (new_start, start), (new_pred, pred)))
        v, start, pred = new, new_start, new_pred
        recs.append(records(v, start, pred))
    out = tuple(torch.stack(x, dim=1) for x in zip(*recs)) + (v,)
    return tuple(x[0] for x in out) if single else out


def factored_lattice_plain(pi_grid: torch.Tensor, inner_a: torch.Tensor, exit_idx: torch.Tensor,
                           hop, log_b_grid: torch.Tensor, mask: Optional[torch.Tensor] = None
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Kernel F's plain version: ``(exit_score, exit_start, exit_pred)``, the
    first three outputs of :func:`factored_lattice_scan`."""
    return factored_lattice_scan(log_b_grid, inner_a, hop, pi_grid, exit_idx, mask)[:3]


# -- capacity rule -------------------------------------------------------------


def _factors_smem_bytes(row_words: int, v: int, wpb: int, kind: str, n_blocks: Optional[int],
                        n_src: int, batch: int = 1) -> int:
    """Shared memory of a forward or lattice block for the rank-1 and
    backoff hops (``csrc/factored_exchange.cuh:factors_smem_bytes``) at
    ``batch`` utterances: the kernel's ``row_words`` 4-byte words, the
    ``4 n_blocks`` polled partial slots of each utterance (``n_blocks``: the
    even map's ``ceil(V / wpb)`` unless given), for a backoff hop its
    ``n_src`` source indices and each utterance's polled exits (padded to an
    even count), then 64-bit keys: each (utterance, word)'s two exit keys
    and, for a backoff hop, its sparse key, and each utterance's two polled
    keys combined 32 blocks a group."""
    n_blocks = -(-v // wpb) if n_blocks is None else n_blocks
    words = row_words + batch * PART_WORDS * n_blocks + -(-batch * n_src // 2) * 2 + n_src
    keys = batch * wpb * (3 if kind == "backoff" else 2) + 2 * batch * -(-n_blocks // 32)
    return 4 * words + 8 * keys


def forward_smem_bytes(v: int, s: int, wpb: int, kind: str, n_blocks: Optional[int] = None,
                       n_src: int = 0, batch: int = 1) -> int:
    """Shared memory of one forward block at ``batch`` utterances
    (``csrc/factored_forward.cu:smem_bytes``): each utterance's grid rows,
    within-word maxima and emissions (``rows``), the inner blocks and exit
    indices; for no hop and a dense hop also each utterance's entries and,
    for a dense hop, its V exit scores of the previous frame and the block's
    ``wpb`` hop columns; for the rank-1 and backoff hops the exchange's
    slots and keys (:func:`_factors_smem_bytes`)."""
    rows = batch * wpb * s
    if kind in ("rank1", "backoff"):
        return _factors_smem_bytes(3 * rows + wpb * s * s + wpb, v, wpb, kind, n_blocks, n_src,
                                   batch)
    floats = 3 * rows + wpb * s * s + batch * wpb + (batch * v if kind == "dense" else 0)
    extra = 4 * wpb * v if kind == "dense" else 0
    return 4 * (floats + wpb) + extra


def backtrace_smem_bytes(v: int, s: int, kind: str) -> int:
    """Shared memory of a backtrace block, one an utterance
    (``csrc/factored_backtrace.cu:smem_bytes``): a window's
    :data:`BACKTRACE_WINDOW` staged S-rows and its table of each step's
    predecessor of each local state, the word's inner block and, with a hop,
    its hop column (V rounded up to 4 floats)."""
    vp = -(-v // 4) * 4 if kind != "none" else 0
    return 4 * (vp + s * s + 2 * BACKTRACE_WINDOW * s)


def _geometry(v: int, s: int, hop, n_sm: int):
    """``(wpb, n_blocks, n_src)`` of the forward and lattice launches: the
    largest block's words, the blocks and the most sources a block polls;
    a backoff hop's from its :func:`block_layout`, the other kinds'
    ``ceil(V / n_sm)`` words a block. None where the words do not fit, or
    where the rank-1 and backoff kinds would have more than
    :data:`MAX_BLOCKS` blocks."""
    if hop_kind(hop) == "backoff":
        layout = block_layout(hop, s, n_sm)
        return None if layout is None else (layout.max_words, layout.n_blocks, layout.max_src)
    wpb = -(-v // n_sm)
    n_blocks = -(-v // wpb)
    # the factored kinds combine the blocks' keys 32 at a time, in 32 slots
    return None if hop_kind(hop) == "rank1" and n_blocks > MAX_BLOCKS else (wpb, n_blocks, 0)


def factored_kernel_ok(t_len: int, v: int, s: int, hop, n_sm: int, batch: int = 1) -> bool:
    """The kernels' H100 capacity rule for one launch of ``batch``
    utterances (it replaces the TPU's VMEM budgets ``factored_pallas_ok`` /
    ``factored_rank1_ok``): the forward spreads the V words over ``n_sm``
    blocks, ``wpb = ceil(V / n_sm)`` words each or, for a backoff hop, the
    ranges of :func:`block_map` (``wpb`` its largest), one thread per (word,
    state) cell (``wpb * S <= 1024``, the most threads a block may have; the
    kernel is compiled for 1024 threads per block, so its registers stay
    within the SM's 64 K; a batch's threads step its cells in turn); a
    block's 227 KB of shared memory must hold every utterance's rows and,
    for a dense hop, its ``wpb`` hop columns (4 * wpb * V bytes: V up to
    ~2,500 words on 132 SMs) and every utterance's V exits; the stored grids
    (4 B T V S bytes) stay within 2 GiB of HBM; a launch takes at most
    :data:`MAX_BATCH` utterances. The backtrace's block, one an utterance,
    must hold a window (:func:`backtrace_smem_bytes`: with a hop, V up to
    ~57,000 words at S = 8, past the ~16,900 the forward takes on 132 SMs).
    A backoff hop is taken as a :class:`BackoffHop` (padded factors are the
    scans' operand); its arcs are read through the read-only data path, not
    staged, so their number adds no limit past the CSR's int32 offsets, and
    its shared memory is the rank-1 hop's plus a 64-bit key an (utterance,
    word) and its largest source list."""
    if not _kernel_operand(hop) or min(t_len, v, s, n_sm, batch) < 1 or batch > MAX_BATCH:
        return False
    kind = hop_kind(hop)
    geo = _geometry(v, s, hop, n_sm)
    if geo is None:
        return False
    wpb, n_blocks, n_src = geo
    return (wpb * s <= MAX_THREADS
            and forward_smem_bytes(v, s, wpb, kind, n_blocks, n_src, batch) + 1024 <= SMEM_LIMIT
            and backtrace_smem_bytes(v, s, kind) + 1024 <= SMEM_LIMIT
            and 4 * batch * t_len * v * s <= GRID_BUDGET)


def _kernel_operand(hop) -> bool:
    """Whether ``hop`` is a kernel operand: none, a dense matrix, a
    :class:`Rank1Hop` or a :class:`BackoffHop` (not padded factors)."""
    return not _is_factors(hop) or isinstance(hop, (Rank1Hop, BackoffHop))


def backtrace_windows(path, mask, s_max: int, window: int = BACKTRACE_WINDOW) -> list:
    """The windows kernel E walks for the decoded ``path`` (``(T,)`` in
    v*S+s ids; ``mask`` ``(T,)`` or ``None``), as the frame each starts
    from: from the last frame, a window takes up to ``window`` steps in one
    word and ends early at the first valid step whose predecessor lies in
    another word (only a hop changes the word; a masked step keeps the
    state)."""
    path = [int(x) for x in path]
    valid = [True] * len(path) if mask is None else [bool(x) for x in mask]
    windows, tau = [], len(path) - 1
    while tau >= 1:
        windows.append(tau)
        w, steps = path[tau] // s_max, min(window, tau)
        for t in range(tau, tau - steps, -1):
            if valid[t] and path[t - 1] // s_max != w:
                tau = t - 1
                break
        else:
            tau -= steps
    return windows


def lattice_smem_bytes(v: int, s: int, wpb: int, kind: str, n_blocks: Optional[int] = None,
                       n_src: int = 0, batch: int = 1) -> int:
    """Shared memory of one lattice block at ``batch`` utterances
    (``csrc/factored_lattice.cu:smem_bytes``): for no hop and a dense hop
    the forward's (:func:`forward_smem_bytes`) plus each (utterance, word)'s
    hop source and each item's start and pred rows and their within-word
    step's; for the rank-1 and backoff hops the rows, within-word maxima,
    emissions, inner blocks, exit indices, the four start and pred rows and
    the exchange's slots and keys (:func:`_factors_smem_bytes`)."""
    rows = batch * wpb * s
    if kind in ("rank1", "backoff"):
        return _factors_smem_bytes(7 * rows + wpb * s * s + wpb, v, wpb, kind, n_blocks, n_src,
                                   batch)
    return forward_smem_bytes(v, s, wpb, kind, batch=batch) + 4 * (batch * wpb + 4 * rows)


def lattice_kernel_ok(v: int, s: int, hop, n_sm: int, batch: int = 1) -> bool:
    """Kernel F's H100 capacity rule for one launch of ``batch``
    utterances: the forward's threads and shared-memory test
    (:func:`factored_kernel_ok`, the same blocks) with F's own shared
    memory, at most :data:`MAX_BATCH` utterances; no grid budget, since F
    stores no grids, only its ``(B, T, V)`` records. A backoff hop is taken
    as a :class:`BackoffHop`, as in the forward."""
    if not _kernel_operand(hop) or min(v, s, n_sm, batch) < 1 or batch > MAX_BATCH:
        return False
    geo = _geometry(v, s, hop, n_sm)
    if geo is None:
        return False
    wpb, n_blocks, n_src = geo
    return (wpb * s <= MAX_THREADS
            and lattice_smem_bytes(v, s, wpb, hop_kind(hop), n_blocks, n_src, batch) + 1024
            <= SMEM_LIMIT)


def exchange_slots(v: int, kind: str, n_blocks: int, batch: int = 1) -> int:
    """64-bit slots of a forward or lattice launch's exchange (what its
    launcher fills with the stale tag): ``(2, B, V)`` exits for the dense
    and backoff hops (and, unused, for no hop), then ``(2, B, n_blocks,
    PART_WORDS)`` partials for the rank-1 and backoff hops."""
    exits = 0 if kind == "rank1" else 2 * v
    return batch * (exits + (2 * n_blocks * PART_WORDS if kind in ("rank1", "backoff") else 0))


def cut_batch(batch: int, t_len: int, v: int, s: int, hop, n_sm: int,
              lattice: bool = False) -> List[Tuple[int, int]]:
    """The launches of a batch of ``batch`` utterances, as ``(start,
    stop)`` row ranges in order: as few as the capacity rule of one launch
    allows (:func:`factored_kernel_ok`, or :func:`lattice_kernel_ok` with
    ``lattice``: shared memory, the grid budget, :data:`MAX_BATCH`), the
    rows spread over them as evenly as they go, the first pieces the
    larger. Nothing for an empty batch; a ValueError where even one
    utterance is past the rule."""
    if batch < 1:
        return []

    def fits(b):
        return (lattice_kernel_ok(v, s, hop, n_sm, b) if lattice
                else factored_kernel_ok(t_len, v, s, hop, n_sm, b))

    if not fits(1):
        what = "lattice kernel's" if lattice else "factored kernels'"
        raise ValueError(f"T={t_len}, V={v}, S={s} with a {hop_kind(hop)} hop is past the "
                         f"{what} capacity")
    return even_pieces(batch, MAX_BATCH, fits)


def even_pieces(batch: int, most: int, fits) -> List[Tuple[int, int]]:
    """``batch`` rows as ``(start, stop)`` ranges in order: as few pieces
    as the largest piece that ``fits`` (a rule monotone in the piece's
    size, true at 1, bisected up to ``most``) allows, the rows spread over
    them as evenly as they go, the first pieces the larger."""
    lo, hi = 1, min(batch, most)
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid) else (lo, mid - 1)
    n = -(-batch // lo)
    size, extra = divmod(batch, n)
    bounds = [0]
    for k in range(n):
        bounds.append(bounds[-1] + size + (k < extra))
    return list(zip(bounds[:-1], bounds[1:]))


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """Streaming multiprocessors of a CUDA device."""
    return torch.cuda.get_device_properties(device).multi_processor_count


# -- kernels -------------------------------------------------------------------


def _check(name, x, shape, dtype, dev):
    if x.device != dev or x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name} must be {dtype} {tuple(shape)} on {dev}, got "
                         f"{x.dtype} {tuple(x.shape)} on {x.device}")
    return x.contiguous()


def _hop_args(hop, hop_t, v, dev):
    """A launch's hop operands (``_HOP_ARGTYPES``, pointers as the checked
    tensors, which :func:`_c_args` turns into pointers at the call): the
    kind id, ``hop_t``, ``from_w``, ``uni``, ``sil_from``, ``sil_idx``,
    ``arc_ptr``, ``arc_dst``, ``arc_src``, ``arc_val``; absent operands are
    ``None`` (null pointers)."""
    kind = hop_kind(hop)
    f32, i32 = torch.float32, torch.int32
    ops = [None] * 8
    if kind == "dense":
        _check("hop", hop, (v, v), f32, dev)
        ops[0] = hop.t().contiguous() if hop_t is None else _check("hop_t", hop_t, (v, v), f32, dev)
    elif kind != "none":
        if not isinstance(hop, (Rank1Hop, BackoffHop)):
            raise ValueError("the factored kernels take factors with sparse edges as a "
                             "BackoffHop (ops.factored.backoff_hop), not padded rows")
        ops[1:4] = [_check(n, getattr(hop, n), (v,), f32, dev)
                    for n in ("from_w", "uni", "sil_from")]
        if kind == "backoff":
            nnz = hop.arc_src.shape[0]
            ops[4] = _check("arc_ptr", hop.arc_ptr, (v + 1,), i32, dev)
            ops[5:8] = [_check(n, getattr(hop, n), (nnz,), dt, dev) for n, dt in
                        (("arc_dst", i32), ("arc_src", i32), ("arc_val", f32))]
    sil_idx = int(hop.sil_idx) if kind in ("rank1", "backoff") else -1
    return [_HOP_IDS[kind], *ops[:4], sil_idx, *ops[4:]]


def _layout_args(hop, v, s, n_sm, dev):
    """A launch's layout operands (``_MAP_ARGTYPES``) and its number of
    blocks: a backoff hop's :func:`block_layout` on ``dev``; null and 0 for
    the other kinds, whose launchers take ``ceil(V / n_sm)`` words a
    block."""
    layout = block_layout(hop, s, n_sm, dev)
    if layout is None:
        wpb = -(-v // n_sm)
        return [None] * 4 + [0, 0, 0], -(-v // wpb)
    return [layout.blk_ptr, layout.src_ptr, layout.src, layout.arc_lsrc, layout.n_blocks,
            layout.max_words, layout.max_src], layout.n_blocks


def _c_args(args):
    return [_ptr(x) if x is None or torch.is_tensor(x) else x for x in args]


def _ptr(x):
    return None if x is None else x.data_ptr()


def _mask_arg(mask, shape, dev):
    if mask is None:
        return None
    if tuple(mask.shape) != tuple(shape) or mask.device != dev:
        raise ValueError(f"mask must be {tuple(shape)} on {dev}, got {tuple(mask.shape)}")
    return mask.to(torch.bool).contiguous()


def _batch_shape(name, x):
    """``(B, (T, V, S), single)`` of one utterance's ``(T, V, S)`` input or
    a batch's ``(B, T, V, S)``, read from its shape alone."""
    shape = tuple(x.shape)
    if len(shape) not in (3, 4):
        raise ValueError(f"{name} must be (T, V, S) or (B, T, V, S), got {shape}")
    return (1, shape, True) if len(shape) == 3 else (shape[0], shape[1:], False)


def factored_forward(pi_grid: torch.Tensor, inner_a: torch.Tensor, exit_idx: torch.Tensor,
                     hop, log_b_grid: torch.Tensor, mask: Optional[torch.Tensor] = None,
                     hop_t: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every frame's grid ``(T, V, S)``, or ``(B, T, V, S)`` for a batch's
    emissions with ``(B, T)`` masks: the CUDA kernel for CUDA tensors, one
    launch (float32, within :func:`factored_kernel_ok` at the batch; it
    raises otherwise), the plain forward for CPU tensors; bitwise equal on
    the same inputs. ``hop_t`` is the dense hop transposed, if the caller
    keeps one."""
    dev = log_b_grid.device
    if dev.type == "cpu":
        return factored_forward_plain(pi_grid, inner_a, exit_idx, hop, log_b_grid, mask)
    if dev.type != "cuda":
        raise ValueError(f"factored_forward runs on cpu or cuda tensors, got {dev}")
    b, (t, v, s), single = _batch_shape("log_b_grid", log_b_grid)
    n_sm = sm_count(dev)
    if b > 0 and not factored_kernel_ok(t, v, s, hop, n_sm, b):
        raise ValueError(f"B={b}, T={t}, V={v}, S={s} with a {hop_kind(hop)} hop is past the "
                         "factored kernels' capacity")
    f32 = torch.float32
    log_b_grid = _check("log_b_grid", log_b_grid, log_b_grid.shape, f32, dev)
    pi_grid = _check("pi_grid", pi_grid, (v, s), f32, dev)
    inner_a = _check("inner_a", inner_a, (v, s, s), f32, dev)
    exit_idx = _check("exit_idx", exit_idx, (v,), torch.int32, dev)
    mask = _mask_arg(mask, log_b_grid.shape[:-2], dev)
    grids = torch.empty((b, t, v, s), dtype=f32, device=dev)
    if b > 0:
        hop_args = _hop_args(hop, hop_t, v, dev)
        layout_args, n_blocks = _layout_args(hop, v, s, n_sm, dev)
        # the exchange, (frame tag, 32 bits) in 8 bytes a slot: exits and the
        # blocks' partials; the launcher fills it with a tag no frame uses
        # before the kernel runs
        exchange = torch.empty((exchange_slots(v, hop_kind(hop), n_blocks, b),),
                               dtype=torch.int64, device=dev)
        lib = _build.load("factored_forward", _FWD_ARGTYPES)
        with torch.cuda.device(dev):
            rc = lib.factored_forward_launch(
                pi_grid.data_ptr(), inner_a.data_ptr(), exit_idx.data_ptr(), *_c_args(hop_args),
                log_b_grid.data_ptr(), _ptr(mask), b, t, v, s, n_sm, *_c_args(layout_args),
                grids.data_ptr(), exchange.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
            )
        _build.check(lib, "factored_forward", rc)
        factored_forward.launches += 1
    return grids[0] if single else grids


factored_forward.launches = 0  # kernel launches; plain CPU calls do not count


def factored_backtrace(grids: torch.Tensor, inner_a: torch.Tensor, exit_idx: torch.Tensor,
                       hop, final_grid: torch.Tensor, mask: Optional[torch.Tensor] = None,
                       hop_t: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Replay backtrace: ``grids (T, V, S)`` -> ``(path (T,) int32, score
    ())``, or a batch's ``(B, T, V, S)`` with ``(B, T)`` masks -> ``(paths
    (B, T), scores (B,))``. The CUDA kernels for CUDA tensors (float32,
    within :func:`backtrace_smem_bytes`; it raises otherwise: the exit
    pre-pass and the windowed walk, a block an utterance, two launches
    counted as one), the plain replay for CPU tensors; bitwise equal."""
    dev = grids.device
    if dev.type == "cpu":
        return factored_backtrace_plain(grids, inner_a, exit_idx, hop, final_grid, mask)
    if dev.type != "cuda":
        raise ValueError(f"factored_backtrace runs on cpu or cuda tensors, got {dev}")
    b, (t, v, s), single = _batch_shape("grids", grids)
    f32 = torch.float32
    grids = _check("grids", grids, grids.shape, f32, dev)
    inner_a = _check("inner_a", inner_a, (v, s, s), f32, dev)
    exit_idx = _check("exit_idx", exit_idx, (v,), torch.int32, dev)
    final_grid = _check("final_grid", final_grid, (v, s), f32, dev)
    mask = _mask_arg(mask, grids.shape[:-2], dev)
    path = torch.empty((b, t), dtype=torch.int32, device=dev)
    score = torch.empty((b,), dtype=f32, device=dev)
    if b > 0:
        hop_args = _hop_args(hop, hop_t, v, dev)
        # every frame's exit scores, gathered by the pre-pass into rows of V
        # rounded up to 4 (no hop: unused)
        exits = (torch.empty((b, t, -(-v // 4) * 4), dtype=f32, device=dev) if hop_args[0]
                 else None)
        lib = _build.load("factored_backtrace", _BWD_ARGTYPES)
        with torch.cuda.device(dev):
            rc = lib.factored_backtrace_launch(
                grids.data_ptr(), inner_a.data_ptr(), exit_idx.data_ptr(), *_c_args(hop_args),
                final_grid.data_ptr(), _ptr(mask), b, t, v, s, _ptr(exits), path.data_ptr(),
                score.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream,
            )
        _build.check(lib, "factored_backtrace", rc)
        factored_backtrace.launches += 1
    return (path[0], score[0]) if single else (path, score)


factored_backtrace.launches = 0  # kernel launches; plain CPU calls do not count


def factored_lattice(pi_grid: torch.Tensor, inner_a: torch.Tensor, exit_idx: torch.Tensor,
                     hop, log_b_grid: torch.Tensor, mask: Optional[torch.Tensor] = None,
                     hop_t: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Lattice records ``(exit_score (T, V), exit_start (T, V) int32,
    exit_pred (T, V) int32)``, each with a leading B for a batch's
    ``(B, T, V, S)`` emissions and ``(B, T)`` masks: the CUDA kernel for
    CUDA tensors, one launch (float32, within :func:`lattice_kernel_ok` at
    the batch; it raises otherwise), the plain version for CPU tensors;
    bitwise equal on the same inputs. ``hop_t`` is the dense hop
    transposed, if the caller keeps one."""
    dev = log_b_grid.device
    if dev.type == "cpu":
        return factored_lattice_plain(pi_grid, inner_a, exit_idx, hop, log_b_grid, mask)
    if dev.type != "cuda":
        raise ValueError(f"factored_lattice runs on cpu or cuda tensors, got {dev}")
    b, (t, v, s), single = _batch_shape("log_b_grid", log_b_grid)
    n_sm = sm_count(dev)
    if t < 1 or (b > 0 and not lattice_kernel_ok(v, s, hop, n_sm, b)):
        raise ValueError(f"B={b}, T={t}, V={v}, S={s} with a {hop_kind(hop)} hop is past the "
                         "lattice kernel's capacity")
    f32, i32 = torch.float32, torch.int32
    log_b_grid = _check("log_b_grid", log_b_grid, log_b_grid.shape, f32, dev)
    pi_grid = _check("pi_grid", pi_grid, (v, s), f32, dev)
    inner_a = _check("inner_a", inner_a, (v, s, s), f32, dev)
    exit_idx = _check("exit_idx", exit_idx, (v,), i32, dev)
    mask = _mask_arg(mask, log_b_grid.shape[:-2], dev)
    score = torch.empty((b, t, v), dtype=f32, device=dev)
    start = torch.empty((b, t, v), dtype=i32, device=dev)
    pred = torch.empty((b, t, v), dtype=i32, device=dev)
    if b > 0:
        hop_args = _hop_args(hop, hop_t, v, dev)
        layout_args, n_blocks = _layout_args(hop, v, s, n_sm, dev)
        # the exchange, as in factored_forward: the launcher fills it with a
        # tag no frame uses before the kernel runs
        exchange = torch.empty((exchange_slots(v, hop_kind(hop), n_blocks, b),),
                               dtype=torch.int64, device=dev)
        lib = _build.load("factored_lattice", _LAT_ARGTYPES)
        with torch.cuda.device(dev):
            rc = lib.factored_lattice_launch(
                pi_grid.data_ptr(), inner_a.data_ptr(), exit_idx.data_ptr(), *_c_args(hop_args),
                log_b_grid.data_ptr(), _ptr(mask), b, t, v, s, n_sm, *_c_args(layout_args),
                score.data_ptr(), start.data_ptr(), pred.data_ptr(),
                exchange.data_ptr(), torch.cuda.current_stream(dev).cuda_stream,
            )
        _build.check(lib, "factored_lattice", rc)
        factored_lattice.launches += 1
    out = (score, start, pred)
    return tuple(x[0] for x in out) if single else out


factored_lattice.launches = 0  # kernel launches; plain CPU calls do not count
