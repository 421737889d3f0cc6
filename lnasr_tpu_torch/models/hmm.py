"""Discrete-emission hidden Markov model: the inference half.

Log-space parameters as in the JAX package's ``models/hmm.py``; the
Viterbi trellis is :func:`lnasr_tpu_torch.ops.trellis.viterbi_scan`.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from lnasr_tpu_torch._device import resolve_device
from lnasr_tpu_torch.ops.trellis import ViterbiResult, viterbi_scan


class HMMParams(NamedTuple):
    """Log-space parameters: transitions (N, N), emissions (N, M), initial (N,)."""

    log_a: torch.Tensor
    log_b: torch.Tensor
    log_pi: torch.Tensor


def _emission_lookup(log_b_table: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """B (N, M) indexed by the observation sequence -> time-major (..., T, N)."""
    return log_b_table.T[obs.long()]


class HMM:
    """Discrete HMM on one device (CUDA by default)."""

    def __init__(
        self,
        n: int = 1,
        m: int = 1,
        log_a=None,
        log_b=None,
        log_pi=None,
        dtype=torch.float32,
        device="cuda",
    ):
        self.n = n
        self.m = m
        self.dtype = dtype
        self.device = resolve_device(device)
        self.log_a = self._param(log_a)
        self.log_b = self._param(log_b)
        self.log_pi = self._param(log_pi)

    def _param(self, x) -> Optional[torch.Tensor]:
        return None if x is None else torch.as_tensor(x, dtype=self.dtype, device=self.device)

    @property
    def params(self) -> HMMParams:
        return HMMParams(self.log_a, self.log_b, self.log_pi)

    def emissions(self, obs) -> torch.Tensor:
        return _emission_lookup(self.log_b, torch.as_tensor(obs, device=self.device))

    def viterbi(self, obs, mask=None) -> ViterbiResult:
        if mask is not None:
            mask = torch.as_tensor(mask, device=self.device)
        return viterbi_scan(self.log_pi, self.log_a, self.emissions(obs), mask)

    def decode(self, obs) -> torch.Tensor:
        """Most-likely state path."""
        return self.viterbi(obs).path

    def decode_batch(self, obs, mask) -> torch.Tensor:
        """Batched Viterbi over padded ``(B, T)`` sequences."""
        return self.viterbi(obs, mask).path
