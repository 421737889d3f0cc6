"""Sequence parallelism: trellis recursions across time chunks.

The HMM forward/backward/Viterbi recursions compose (N, N) operators
``M_t[i, j] = A[i, j] + b[t, j]`` under (+, logsumexp) or (+, max) matmul
(see :func:`lnasr_tpu_torch.ops.trellis.forward_assoc`). Operators are
associative, so a long utterance splits along a ``seq`` mesh axis: every
rank reduces its chunk's operators locally (an inclusive Hillis-Steele
scan, ceil(log2 Tc) passes of batched (N, N) products), the per-chunk
products -- one (N, N) matrix each -- cross ranks in a single all-gather,
and each chunk applies the product of its neighbours. Communication is
O(S N^2) for the trellis, regardless of sequence length, plus the gather
of each chunk's rows that hands every rank the whole result.

Masked (padded) frames and the global first frame carry the identity
operator, so results equal the unpadded recursions; the public functions
pad T to a multiple of the axis size, so any length decomposes onto any
mesh. Every rank passes the whole ``log_b`` and gets the whole result;
its own work covers its chunk. The scans combine in another tree than
the JAX package's ``lax.associative_scan``, so the two agree to rounding
(Viterbi paths exactly, up to ties that rounding splits).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch

from lnasr_tpu_torch.ops.numerics import log_matmul, logsumexp, maxplus_matmul
from lnasr_tpu_torch.parallel.distributed import Axis, all_gather
from lnasr_tpu_torch.parallel.mesh import mesh_axis


def _identity_op(n: int, dtype, device) -> torch.Tensor:
    eye = torch.eye(n, dtype=torch.bool, device=device)
    return torch.where(eye, 0.0, -torch.inf).to(dtype)


def _chunk_ops(log_a, log_b_chunk, mask_chunk, is_global_first: bool) -> torch.Tensor:
    """Per-frame operators: ``A + b[t]`` at valid frames, identity at
    masked frames and at the global first frame (whose emission folds into
    the initial vector instead)."""
    tc, n = log_b_chunk.shape
    mats = log_a[None, :, :] + log_b_chunk[:, None, :]
    use_id = ~mask_chunk
    if is_global_first:
        use_id = use_id.clone()
        use_id[0] = True
    ident = _identity_op(n, log_b_chunk.dtype, log_b_chunk.device)
    return torch.where(use_id[:, None, None], ident, mats)


def _prefix_scan(combine, mats: torch.Tensor) -> torch.Tensor:
    """Inclusive ascending prefix products ``P_t = M_0 * ... * M_t``: pass
    k composes every prefix with the one 2^k steps before it."""
    d = 1
    while d < mats.shape[0]:
        mats = torch.cat([mats[:d], combine(mats[:-d], mats[d:])])
        d *= 2
    return mats


def _suffix_scan(combine, mats: torch.Tensor) -> torch.Tensor:
    """Inclusive ascending suffix products ``S_t = M_t * ... * M_last``
    (the operands stay in time order: the later one on the right)."""
    d = 1
    while d < mats.shape[0]:
        mats = torch.cat([combine(mats[:-d], mats[d:]), mats[-d:]])
        d *= 2
    return mats


def _before_product(totals: torch.Tensor, axis: Axis, combine) -> torch.Tensor:
    """Product of the chunk totals ``(S, N, N)`` strictly before this
    rank's chunk, in ascending order."""
    before = _identity_op(totals.shape[-1], totals.dtype, totals.device)
    for c in range(axis.index):
        before = combine(before, totals[c])
    return before


def _after_product(totals: torch.Tensor, axis: Axis, combine) -> torch.Tensor:
    """Product of the chunk totals strictly after this rank's chunk."""
    after = _identity_op(totals.shape[-1], totals.dtype, totals.device)
    for c in range(axis.index + 1, axis.size):
        after = combine(after, totals[c])
    return after


def _pad_time(arrays: List[torch.Tensor], t: int, seq_size: int):
    """Pad leading time axes to a multiple of the seq axis; returns the
    padded arrays and the padded length."""
    t_pad = -(-t // seq_size) * seq_size
    if t_pad == t:
        return arrays, t
    out = []
    for a in arrays:
        pad = torch.zeros((t_pad - t, *a.shape[1:]), dtype=a.dtype, device=a.device)
        out.append(torch.cat([a, pad]))
    return out, t_pad


def _local_chunk(x, mask, axis: Axis):
    """This rank's chunk of the time-major ``x`` (emissions, features or
    symbols) and its mask, padded to a multiple of the axis with masked
    frames: ``(x_c, mask_c, tc, t_pad)``."""
    t = x.shape[0]
    if mask is None:
        mask = torch.ones((t,), dtype=torch.bool, device=x.device)
    mask = torch.as_tensor(mask, device=x.device).bool()
    (x_p, mask_p), t_pad = _pad_time([x, mask], t, axis.size)
    mask_p = mask_p & (torch.arange(t_pad, device=x.device) < t)
    tc = t_pad // axis.size
    lo = axis.index * tc
    return x_p[lo:lo + tc], mask_p[lo:lo + tc], tc, t_pad


def forward_seq_parallel(log_pi: torch.Tensor, log_a: torch.Tensor, log_b: torch.Tensor,
                         mesh, mask: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward pass with the time axis sharded over the mesh's ``seq`` axis.

    ``log_b (T, N)`` for any T (auto-padded); optional ``mask (T,)``.
    Returns ``(alpha (T, N), loglik)`` equal (up to float reassociation) to
    :func:`lnasr_tpu_torch.ops.trellis.forward_scan`, on every rank."""
    axis = mesh_axis(mesh, "seq")
    t, n = log_b.shape
    log_b_c, mask_c, _, t_pad = _local_chunk(log_b, mask, axis)
    mats = _chunk_ops(log_a, log_b_c, mask_c, axis.index == 0)
    prefix = _prefix_scan(log_matmul, mats)
    before = _before_product(all_gather(prefix[-1], axis), axis, log_matmul)
    alpha0 = log_pi + log_b[0]
    alpha_c = logsumexp(alpha0[None, :, None] + log_matmul(before[None], prefix), dim=1)
    alpha = all_gather(alpha_c, axis).reshape(t_pad, n)[:t]
    return alpha, logsumexp(alpha[-1], dim=0)


def backward_seq_parallel(log_a: torch.Tensor, log_b: torch.Tensor, mesh,
                          mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Backward pass over the ``seq`` axis: ``beta (T, N)`` equal (up to
    float reassociation) to :func:`lnasr_tpu_torch.ops.trellis.backward_scan`.

    ``beta_t = lse_j [M_{t+1} ... M_{T-1}]_{:, j}``: each chunk reduces its
    ascending suffix products locally and composes with the product of
    the chunks after it (one all-gather, the forward's traffic)."""
    axis = mesh_axis(mesh, "seq")
    t, n = log_b.shape
    log_b_c, mask_c, _, t_pad = _local_chunk(log_b, mask, axis)
    mats = _chunk_ops(log_a, log_b_c, mask_c, axis.index == 0)
    suffix = _suffix_scan(log_matmul, mats)
    after = _after_product(all_gather(suffix[0], axis), axis, log_matmul)
    # beta_t needs the suffix starting at t+1
    suffix_next = torch.cat([suffix[1:], _identity_op(n, mats.dtype, mats.device)[None]])
    beta_c = logsumexp(log_matmul(suffix_next, after[None]), dim=2)
    return all_gather(beta_c, axis).reshape(t_pad, n)[:t]


def _compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """State maps composed: ``(a o b)[h] = a[b[h]]`` row by row."""
    return torch.gather(a, -1, b)


def viterbi_seq_parallel(log_pi: torch.Tensor, log_a: torch.Tensor, log_b: torch.Tensor,
                         mesh, mask: Optional[torch.Tensor] = None
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Viterbi decode with the time axis sharded over ``seq``.

    The chunked operators of :func:`forward_seq_parallel` in the (+, max)
    semiring, plus a *parallel backtrace*: every chunk computes, for each
    of the N possible states at its last frame, the state at each of its
    frames and the implied state at the previous chunk's boundary, by
    composing its backpointer maps in a Hillis-Steele suffix scan (exact
    integer gathers). The N-entry boundary tables are all-gathered
    (O(S N)) and composed right to left; each chunk selects its path
    column, and the columns are gathered.

    Ties keep the JAX package's rules: the first maximum; backpointers
    taken against the operator matrices, so masked frames point to
    themselves; frame 0 of chunk 0 points to itself; padded chunks reuse
    the last exit state. Any T (auto-padded) and optional masks. Returns
    ``(path (T,) int32, best score)`` on every rank."""
    axis = mesh_axis(mesh, "seq")
    t, n = log_b.shape
    dev = log_b.device
    log_b_c, mask_c, tc, t_pad = _local_chunk(log_b, mask, axis)
    first_chunk = axis.index == 0
    mats = _chunk_ops(log_a, log_b_c, mask_c, first_chunk)
    prefix = _prefix_scan(maxplus_matmul, mats)
    before = _before_product(all_gather(prefix[-1], axis), axis, maxplus_matmul)
    v0 = log_pi + log_b[0]
    v_chunk = torch.amax(v0[None, :, None] + maxplus_matmul(before[None], prefix), dim=1)
    v_prev_last = torch.amax(v0[:, None] + before, dim=0)

    # local backpointers against the *operator* matrices, so masked frames
    # point to themselves (identity), as in viterbi_scan; frame 0 of the
    # chunk points into the previous chunk
    v_prev = torch.cat([v_prev_last[None], v_chunk[:-1]])
    bt = torch.argmax(v_prev[:, :, None] + mats, dim=1)  # (Tc, N), first max
    states = torch.arange(n, device=dev)
    if first_chunk:
        bt[0] = states

    # maps[t][h] = state at local frame t given state h at the chunk's last
    # frame: the suffix composition of bt[t+1], ..., bt[Tc-1]
    maps = torch.cat([bt[1:], states[None]])
    maps = _suffix_scan(_compose, maps)
    boundary = states if first_chunk else bt[0][maps[0]]
    boundaries = all_gather(boundary, axis).tolist()  # (S, N): one host read

    # compose chunk exits right to left; the best final state comes from
    # the last *valid* frame's row, held by chunk (t - 1) // tc
    last_chunk = (t - 1) // tc
    row = v_chunk[min(max(t - 1 - axis.index * tc, 0), tc - 1)]
    v_last = all_gather(row, axis)[last_chunk]
    exits = [int(torch.argmax(v_last))]
    for c in range(axis.size - 1, 0, -1):
        exits.append(exits[-1] if c > last_chunk else boundaries[c][exits[-1]])
    exits = exits[::-1]  # the exit state of each chunk
    path_c = maps[:, exits[axis.index]].to(torch.int32)
    path = all_gather(path_c, axis).reshape(t_pad)[:t]
    return path, torch.amax(v_last)
