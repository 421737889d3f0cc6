"""Log-space numerics (natural log, -inf for empty mass)."""

from __future__ import annotations

import torch


def logsumexp(x: torch.Tensor, dim, keepdim: bool = False) -> torch.Tensor:
    """Max-shifted log-sum-exp; an all--inf slice gives -inf (not NaN)."""
    return torch.logsumexp(x, dim=dim, keepdim=keepdim)
