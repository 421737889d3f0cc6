"""HMM trellis recursions in plain PyTorch.

Counterparts of the JAX package's ``ops/trellis.py``:

- :func:`viterbi_scan`: a T-step loop whose step is one batched (+, max)
  matrix-vector product with first-index argmax backpointers. It is the
  plain version of the batched Viterbi kernel (``ops/viterbi.py``) and
  serves masked decodes.
- :func:`forward_scan`, :func:`backward_scan`: the Baum-Welch recursions,
  one (+, logsumexp) matrix-vector product a step;
  :func:`forward_assoc`, the forward pass as a log-depth Hillis-Steele
  scan over (N, N) operators; :func:`posteriors`, the E-step's ``xi`` and
  ``gamma``.

Conventions: natural-log inputs; time-major emissions ``log_b[..., t, j]``;
an optional boolean ``mask[..., t]`` marks real frames, and masked steps
apply the identity operator (for Viterbi, ``v`` unchanged and backpointer
``j -> j``). Leading batch dimensions are written out instead of ``vmap``:
every op of a frame loop covers the whole batch, and no step reads a
value back to the host.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from lnasr_tpu_torch.ops.numerics import log_matmul, logsumexp


class ForwardResult(NamedTuple):
    alpha: torch.Tensor  # (..., T, N) forward log-probabilities
    loglik: torch.Tensor  # (...) log P(O | model), from the last valid frame


def forward_scan(
    log_pi: torch.Tensor,
    log_a: torch.Tensor,
    log_b: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> ForwardResult:
    """Forward algorithm over ``log_b (..., T, N)``:
    ``alpha[t, j] = lse_i(alpha[t-1, i] + A[i, j]) + b[t, j]``; a masked
    frame keeps ``alpha`` unchanged, so ``alpha[..., -1, :]`` is the last
    valid frame's."""
    alpha = log_pi + log_b[..., 0, :]
    alphas = [alpha]
    for s in range(1, log_b.shape[-2]):
        new = logsumexp(alpha[..., :, None] + log_a, dim=-2) + log_b[..., s, :]
        if mask is not None:
            new = torch.where(mask[..., s, None], new, alpha)
        alpha = new
        alphas.append(alpha)
    return ForwardResult(alpha=torch.stack(alphas, dim=-2), loglik=logsumexp(alpha, dim=-1))


def backward_scan(
    log_a: torch.Tensor,
    log_b: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Backward algorithm: ``beta[t, i] = lse_j(A[i, j] + b[t+1, j] +
    beta[t+1, j])``, ``beta[T-1] = 0``. A masked frame t+1 propagates
    ``beta`` unchanged, so for a sequence of true length L, ``beta[:L]``
    equals the unpadded result and ``beta[L-1:]`` is zero."""
    t_len = log_b.shape[-2]
    beta = torch.zeros_like(log_b[..., 0, :])
    betas = [beta]
    for s in range(t_len - 2, -1, -1):
        new = logsumexp(log_a + (log_b[..., s + 1, :] + beta)[..., None, :], dim=-1)
        if mask is not None:
            new = torch.where(mask[..., s + 1, None], new, beta)
        beta = new
        betas.append(beta)
    return torch.stack(betas[::-1], dim=-2)


def forward_assoc(
    log_pi: torch.Tensor,
    log_a: torch.Tensor,
    log_b: torch.Tensor,
) -> ForwardResult:
    """Forward algorithm as a scan over the step operators ``M_t[i, j] =
    A[i, j] + b[t, j]``, composed by (+, logsumexp) matmul: an inclusive
    Hillis-Steele scan, ceil(log2 T) passes (pass k composes every prefix
    with the one 2^k steps before it). O(T N^3 log T) work; the JAX
    package's ``lax.associative_scan`` combines in another tree, so the two
    agree to rounding."""
    alpha0 = log_pi + log_b[..., 0, :]
    prefix = log_a[..., None, :, :] + log_b[..., 1:, None, :]  # (..., T-1, N, N)
    steps = prefix.shape[-3]
    d = 1
    while d < steps:
        prefix = torch.cat([prefix[..., :d, :, :],
                            log_matmul(prefix[..., :-d, :, :], prefix[..., d:, :, :])], dim=-3)
        d *= 2
    alphas = logsumexp(alpha0[..., None, :, None] + prefix, dim=-2)
    alpha = torch.cat([alpha0[..., None, :], alphas], dim=-2)
    return ForwardResult(alpha=alpha, loglik=logsumexp(alpha[..., -1, :], dim=-1))


def posteriors(
    alpha: torch.Tensor,
    beta: torch.Tensor,
    log_a: torch.Tensor,
    log_b: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Baum-Welch E-step quantities ``xi (..., T, N, N)`` and ``gamma (...,
    T, N)``, with the JAX package's estimator: each ``xi[t]`` is normalized
    by its own log-sum over (i, j); ``xi[T-1]`` is all -inf; ``gamma =
    lse_j(xi)``, so the final frame carries no occupancy mass. With a
    ``mask``, transitions into masked frames are -inf."""
    numer = (alpha[..., :-1, :, None] + log_a + log_b[..., 1:, None, :]
             + beta[..., 1:, None, :])
    denom = logsumexp(numer.flatten(-2), dim=-1)
    xi_body = numer - denom[..., None, None]
    if mask is not None:
        xi_body = torch.where(mask[..., 1:, None, None], xi_body, -torch.inf)
    last = torch.full_like(xi_body[..., :1, :, :], -torch.inf)
    xi = torch.cat([xi_body, last], dim=-3)
    return xi, logsumexp(xi, dim=-1)


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
