"""Discrete-emission hidden Markov model.

Log-space parameters as in the JAX package's ``models/hmm.py``. The
trellis recursions are those of :mod:`lnasr_tpu_torch.ops.trellis`: on the
card the E-step's forward and backward are one launch of kernel G, on the
CPU frame loops whose every op covers the whole batch. The
Baum-Welch M-step takes statistics of a padded batch of sequences in one
shot; its emission numerator is an order-fixed segment sum over the
observed symbols (:func:`lnasr_tpu_torch.ops.numerics.segment_sum`), so an
EM sweep gives the same bits on every run, on CUDA too. Training runs
under :func:`lnasr_tpu_torch.utils.checkpoints.em_loop`: stop when
|delta loglik| < eps, with optional checkpoints and deterministic resume.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from lnasr_tpu_torch._device import resolve_device
from lnasr_tpu_torch.ops.numerics import logsumexp, safe_log, segment_sum
from lnasr_tpu_torch.ops.trellis import (
    ForwardResult,
    ViterbiResult,
    backward_scan,
    forward_backward,
    forward_scan,
    posteriors,
    viterbi_scan,
)


class HMMParams(NamedTuple):
    """Log-space parameters: transitions (N, N), emissions (N, M), initial (N,)."""

    log_a: torch.Tensor
    log_b: torch.Tensor
    log_pi: torch.Tensor

    @property
    def n_states(self) -> int:
        return self.log_a.shape[0]

    @property
    def n_symbols(self) -> int:
        return self.log_b.shape[1]


class EMStats(NamedTuple):
    """Log-space sufficient statistics of one EM sweep (per sequence over
    leading batch axes, or batch-combined)."""

    log_xi_sum: torch.Tensor  # (..., N, N)   lse_t xi[t]
    log_gamma_sum: torch.Tensor  # (..., N)   lse_t gamma[t]
    log_b_num: torch.Tensor  # (..., N, M)    lse_{t: o_t = k} gamma[t]
    log_pi_num: torch.Tensor  # (..., N)      gamma[0]
    loglik: torch.Tensor  # (...)             log-likelihood


def _emission_lookup(log_b_table: torch.Tensor, obs: torch.Tensor) -> torch.Tensor:
    """B (N, M) indexed by the observation sequence -> time-major (..., T, N)."""
    return log_b_table.T[obs.long()]


def _sequence_stats(params: HMMParams, obs: torch.Tensor, mask: torch.Tensor) -> EMStats:
    """E-step statistics of each padded sequence of ``obs (B, T)`` /
    ``mask (B, T)``; every field keeps the leading batch axis."""
    n, m = params.log_b.shape
    log_b = _emission_lookup(params.log_b, obs)
    (alpha, loglik), beta = forward_backward(params.log_pi, params.log_a, log_b, mask)
    xi, gamma = posteriors(alpha, beta, params.log_a, log_b, mask)
    gamma_masked = torch.where(mask[..., None], gamma, -torch.inf)
    # the emission numerator as a probability-space sum over each
    # sequence's observed symbols: exp(gamma) <= 1, and no (T, N, M) one-hot
    # (the segmenter has 65,536 symbols)
    occ = torch.where(mask[..., None], torch.exp(gamma_masked), 0.0)  # (B, T, N)
    b = obs.shape[0]
    ids = obs.long() + m * torch.arange(b, device=obs.device)[:, None]
    b_num = segment_sum(occ.reshape(-1, n), ids, b * m).reshape(b, m, n)
    return EMStats(
        log_xi_sum=logsumexp(xi, dim=-3),
        log_gamma_sum=logsumexp(gamma_masked, dim=-2),
        log_b_num=safe_log(b_num.transpose(-1, -2)),
        log_pi_num=gamma[..., 0, :],
        loglik=loglik,
    )


def _combine_stats(stats: EMStats) -> EMStats:
    """Combine per-sequence stats (leading batch axis) by log-space sum."""
    return EMStats(
        log_xi_sum=logsumexp(stats.log_xi_sum, dim=0),
        log_gamma_sum=logsumexp(stats.log_gamma_sum, dim=0),
        log_b_num=logsumexp(stats.log_b_num, dim=0),
        log_pi_num=logsumexp(stats.log_pi_num, dim=0) - float(np.log(stats.log_pi_num.shape[0])),
        loglik=torch.sum(stats.loglik),
    )


def _maximize(stats: EMStats) -> HMMParams:
    """M-step: row-normalized log-space re-estimates."""
    log_a = stats.log_xi_sum - stats.log_gamma_sum[:, None]
    log_b = stats.log_b_num - stats.log_gamma_sum[:, None]
    return HMMParams(log_a=log_a, log_b=log_b, log_pi=stats.log_pi_num)


def em_step(params: HMMParams, obs: torch.Tensor, mask: torch.Tensor
            ) -> Tuple[HMMParams, torch.Tensor]:
    """One Baum-Welch iteration over a batch ``obs (B, T)`` / ``mask (B, T)``.

    Returns updated parameters and the log-likelihood of the batch under the
    pre-update parameters (a 0-d tensor on the device)."""
    combined = _combine_stats(_sequence_stats(params, obs, mask))
    return _maximize(combined), combined.loglik


class HMM:
    """Discrete HMM on one device (CUDA by default): ``calc_prob``,
    ``decode``, ``train``, ``reset``, ``save``/``load``, and batched
    variants."""

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

    # -- parameters ---------------------------------------------------------

    @property
    def params(self) -> HMMParams:
        return HMMParams(self.log_a, self.log_b, self.log_pi)

    def set_params(self, params: HMMParams) -> "HMM":
        """Adopt ``params`` (moved to this model's device and dtype)."""
        self.log_a, self.log_b, self.log_pi = (self._param(x) for x in params)
        self.n, self.m = self.log_b.shape
        return self

    def reset(self, init_type: str = "uniform", generator: Optional[torch.Generator] = None):
        """Uniform or random (row-normalized, drawn from (0, 1]) log-probs;
        randomness from ``generator`` (seed 0 when ``None``)."""
        n, m = self.n, self.m
        if init_type == "uniform":
            self.log_a = self._param(np.full((n, n), -np.log(n)))
            self.log_b = self._param(np.full((n, m), -np.log(m)))
            self.log_pi = self._param(np.full((n,), -np.log(n)))
        elif init_type == "random":
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            draw = lambda *shape: 1.0 - torch.rand(shape, generator=generator, dtype=self.dtype)  # noqa: E731
            a, b, pi = draw(n, n), draw(n, m), draw(n)
            self.log_a = self._param(torch.log(a / a.sum(dim=1, keepdim=True)))
            self.log_b = self._param(torch.log(b / b.sum(dim=1, keepdim=True)))
            self.log_pi = self._param(torch.log(pi / pi.sum()))
        else:
            raise ValueError(f"unknown init type: {init_type!r}")
        return self

    @classmethod
    def from_counts(
        cls,
        trans_counts: np.ndarray,
        emit_counts: np.ndarray,
        init_counts: np.ndarray,
        emit_add_one: bool = True,
        dtype=torch.float64,
        device="cuda",
    ) -> "HMM":
        """Supervised estimation from raw counts, with add-one smoothing of
        the emissions by default. A state with no outgoing counts is
        unreachable: its 0/0 row becomes log(0) = -inf, not NaN."""
        trans = np.asarray(trans_counts, np.float64)
        emit = np.asarray(emit_counts, np.float64)
        init = np.asarray(init_counts, np.float64)
        if emit_add_one:
            emit = emit + 1.0
        with np.errstate(divide="ignore", invalid="ignore"):
            log_a = np.log(trans / trans.sum(axis=1, keepdims=True))
            log_b = np.log(emit / emit.sum(axis=1, keepdims=True))
            log_pi = np.log(init / init.sum())
        for x in (log_a, log_b, log_pi):
            x[np.isnan(x)] = -np.inf
        return cls(trans.shape[0], emit.shape[1], log_a, log_b, log_pi, dtype=dtype,
                   device=device)

    # -- inference ----------------------------------------------------------

    def emissions(self, obs) -> torch.Tensor:
        return _emission_lookup(self.log_b, torch.as_tensor(obs, device=self.device))

    def _mask(self, mask) -> Optional[torch.Tensor]:
        return None if mask is None else torch.as_tensor(mask, device=self.device)

    def forward(self, obs, mask=None) -> ForwardResult:
        return forward_scan(self.log_pi, self.log_a, self.emissions(obs), self._mask(mask))

    def backward(self, obs, mask=None) -> torch.Tensor:
        return backward_scan(self.log_a, self.emissions(obs), self._mask(mask))

    def viterbi(self, obs, mask=None) -> ViterbiResult:
        return viterbi_scan(self.log_pi, self.log_a, self.emissions(obs), self._mask(mask))

    def calc_prob(self, obs) -> torch.Tensor:
        """log P(O | model)."""
        return self.forward(obs).loglik

    def decode(self, obs) -> torch.Tensor:
        """Most-likely state path."""
        return self.viterbi(obs).path

    def decode_batch(self, obs, mask) -> torch.Tensor:
        """Batched Viterbi over padded ``(B, T)`` sequences."""
        return self.viterbi(obs, mask).path

    # -- training -----------------------------------------------------------

    def _ensure_batch(self, obs, mask):
        """Promote a single sequence to a batch of one; default masks."""
        obs = torch.as_tensor(obs, device=self.device)
        if obs.dim() == 1:
            obs = obs[None]
        if mask is None:
            mask = torch.ones(obs.shape[:2], dtype=torch.bool, device=self.device)
        else:
            mask = torch.as_tensor(mask, dtype=torch.bool, device=self.device)
            if mask.dim() == 1:
                mask = mask[None]
        return obs, mask

    def _em(self, params, obs, mask):
        """One EM sweep; subclasses plug in their own emission model."""
        return em_step(params, obs, mask)

    def train(self, obs, iters: int = 1, eps: float = 1e-4, verbose: bool = False,
              mask=None, config=None):
        """Baum-Welch EM until |delta loglik| < eps or ``iters`` sweeps.

        ``obs`` is one sequence or a padded batch with a matching boolean
        ``mask``. A :class:`~lnasr_tpu_torch.config.TrainConfig` supplies
        the budget (``max_iters``/``eps``) and enables periodic checkpoints
        with deterministic resume (``checkpoint_every``/``checkpoint_dir``).
        Returns the loglik history."""
        from lnasr_tpu_torch.utils.checkpoints import checkpointer_from_config, em_loop

        if config is not None:
            iters, eps = config.max_iters, config.eps
        obs, mask = self._ensure_batch(obs, mask)
        params, history = em_loop(lambda p: self._em(p, obs, mask), self.params, iters, eps,
                                  verbose=verbose, checkpointer=checkpointer_from_config(config))
        self.set_params(params)
        return history

    # -- persistence --------------------------------------------------------

    def save(self, filename: str) -> None:
        """HDF5 with datasets ``A``, ``B``, ``pi`` (log-probs, float64), the
        JAX package's format."""
        import h5py

        with h5py.File(filename, "w") as f:
            for key, x in (("A", self.log_a), ("B", self.log_b), ("pi", self.log_pi)):
                f.create_dataset(key, data=x.detach().cpu().numpy().astype(np.float64))

    def load(self, filename: str) -> "HMM":
        """Load a checkpoint written by either package."""
        import h5py

        with h5py.File(filename, "r") as f:
            return self.set_params(HMMParams(f["A"][...], f["B"][...], f["pi"][...]))
