"""HMM Viterbi trellis in plain PyTorch.

Counterpart of the JAX package's ``ops/trellis.py:viterbi_scan``: a T-step
loop whose step is one batched (+, max) matrix-vector product with
first-index argmax backpointers. It is the plain version of the batched
Viterbi kernel (``ops/viterbi.py``) and serves masked decodes.

Conventions: natural-log inputs; time-major emissions ``log_b[..., t, j]``;
an optional boolean ``mask[..., t]`` marks real frames, and masked steps
apply the identity operator (``v`` unchanged, backpointer ``j -> j``).
Leading batch dimensions are written out instead of ``vmap``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class ViterbiResult(NamedTuple):
    scores: torch.Tensor  # (..., T, N) Viterbi trellis
    backptr: torch.Tensor  # (..., T, N) int32 argmax predecessors (row 0 zeros)
    path: torch.Tensor  # (..., T) int32 best state sequence
    score: torch.Tensor  # (...) best final log-score


def viterbi_scan(
    log_pi: torch.Tensor,
    log_a: torch.Tensor,
    log_b: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    log_final: Optional[torch.Tensor] = None,
) -> ViterbiResult:
    """Max-plus trellis and backtrace over ``log_b (..., T, N)``.

    ``log_final (N,)`` adds per-state termination weights before the final
    argmax; the reported ``score`` includes it. Ties pick the first index,
    as ``jnp.argmax`` does, so paths and scores are bitwise those of the
    JAX scan on the same fp32 inputs."""
    t, n = log_b.shape[-2:]
    states = torch.arange(n, dtype=torch.int32, device=log_b.device)
    v = log_pi + log_b[..., 0, :]
    scores = [v]
    backptr = [torch.zeros_like(v, dtype=torch.int32)]
    for s in range(1, t):
        cand = v[..., :, None] + log_a  # cand[..., i, j]
        best, arg = torch.max(cand, dim=-2)
        new_v = best + log_b[..., s, :]
        arg = arg.to(torch.int32)
        if mask is not None:
            valid = mask[..., s, None]
            new_v = torch.where(valid, new_v, v)
            arg = torch.where(valid, arg, states)
        v = new_v
        scores.append(v)
        backptr.append(arg)
    scores = torch.stack(scores, dim=-2)
    backptr = torch.stack(backptr, dim=-2)

    v_final = v if log_final is None else v + log_final
    score, last = torch.max(v_final, dim=-1)
    path = [last.to(torch.int32)]
    for s in range(t - 1, 0, -1):
        prev = torch.gather(backptr[..., s, :], -1, path[-1][..., None].long())[..., 0]
        path.append(prev)
    path = torch.stack(path[::-1], dim=-1)
    return ViterbiResult(scores=scores, backptr=backptr, path=path, score=score)
