"""Log-space numerics (natural log, -inf for empty mass).

The counterparts of the JAX package's ``ops/numerics.py``, plus
:func:`segment_sum`, the order-fixed replacement for
``jax.ops.segment_sum`` that the discrete HMM's M-step needs.
"""

from __future__ import annotations

import math

import torch

NEG_INF = -math.inf


def logsumexp(x: torch.Tensor, dim, keepdim: bool = False) -> torch.Tensor:
    """Max-shifted log-sum-exp; an all--inf slice gives -inf (not NaN)."""
    return torch.logsumexp(x, dim=dim, keepdim=keepdim)


def logsumexp2(x: torch.Tensor, dim=None, keepdim: bool = False) -> torch.Tensor:
    """Base-2 log-sum-exp, log2(sum(2**x)); ``dim=None`` reduces every axis."""
    if dim is None:
        dim = tuple(range(x.dim()))
    ln2 = math.log(2.0)
    return torch.logsumexp(x * ln2, dim=dim, keepdim=keepdim) / ln2


def log_matvec(log_m: torch.Tensor, log_v: torch.Tensor) -> torch.Tensor:
    """(log M) @ (log v) in the (+, logsumexp) semiring:
    ``out[..., i] = lse_j(log_m[..., i, j] + log_v[..., j])``."""
    return logsumexp(log_m + log_v[..., None, :], dim=-1)


def log_matmul(log_a: torch.Tensor, log_b: torch.Tensor) -> torch.Tensor:
    """Matrix product in the (+, logsumexp) semiring over the last two
    axes, batched over the leading ones:
    ``out[..., i, j] = lse_k(log_a[..., i, k] + log_b[..., k, j])``."""
    return logsumexp(log_a[..., :, :, None] + log_b[..., None, :, :], dim=-2)


def maxplus_matmul(log_a: torch.Tensor, log_b: torch.Tensor) -> torch.Tensor:
    """Matrix product in the (+, max) (tropical) semiring."""
    return torch.amax(log_a[..., :, :, None] + log_b[..., None, :, :], dim=-2)


def normalize_log(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Normalize log-probabilities so their logsumexp over ``dim`` is 0."""
    return x - logsumexp(x, dim=dim, keepdim=True)


def safe_log(x: torch.Tensor) -> torch.Tensor:
    """log with log(0) -> -inf (and -inf for negative or NaN inputs)."""
    pos = x > 0
    return torch.where(pos, torch.log(torch.where(pos, x, torch.ones_like(x))),
                       torch.full_like(x, NEG_INF))


def segment_sum(values: torch.Tensor, ids: torch.Tensor, num_segments: int) -> torch.Tensor:
    """``out[s] = sum of values[i] over ids[i] == s``: ``values (L, ...)``,
    ``ids (L,)`` integers in ``[0, num_segments)`` -> ``(num_segments, ...)``,
    zeros where no id falls.

    The order of the additions is fixed by the data alone, so the result
    is the same bits on every run (``index_add_`` and ``scatter_add_`` on
    CUDA add in the order their atomics land): the ids are sorted
    (stably), each run of equal ids is summed by a segmented Hillis-Steele
    scan (ceil(log2 L) passes of whole-array ops), and each segment reads
    its run's last element. No step waits on the host."""
    ids = ids.reshape(-1)
    keys, order = torch.sort(ids, stable=True)
    vals = values[order]
    trail = (1,) * (vals.dim() - 1)
    d = 1
    while d < keys.shape[0]:
        same = (keys[d:] == keys[:-d]).reshape(-1, *trail)
        vals = torch.cat([vals[:d], vals[d:] + torch.where(same, vals[:-d], 0)])
        d *= 2
    seg = torch.arange(num_segments, dtype=keys.dtype, device=keys.device)
    end = torch.searchsorted(keys, seg, right=True)
    present = (end > torch.searchsorted(keys, seg)).reshape(-1, *trail)
    return torch.where(present, vals[(end - 1).clamp(min=0)], 0)
