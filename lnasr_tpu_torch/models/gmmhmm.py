"""Continuous GMM-HMM acoustic model.

Parameters, initialization, emission scoring, batched decoding, Baum-Welch
training and the HDF5 format of the JAX package's ``models/gmmhmm.py``.
Randomness comes from a ``torch.Generator``, so draws differ from
``jax.random`` ones for the same seed; carry parameters across with
:mod:`lnasr_tpu_torch.convert` where both packages must compute with the
same weights.

The M-step accumulates streamed sufficient statistics (occupancy, first
and second moments), whose size does not grow with T. Two covariance
regimes: ``"diag"`` re-estimates variances about the new means under a
variance floor; ``"full"`` keeps the JAX package's estimator, centred on
the old means, plus a ``min_std * I`` ridge. A component whose occupancy
falls under ``occ_floor`` keeps its previous parameters (the starvation
guard).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch.profiler import record_function

from lnasr_tpu_torch.config import GMMHMMConfig
from lnasr_tpu_torch.models.hmm import HMM
from lnasr_tpu_torch.ops.gaussian import gmm_emissions_diag, gmm_emissions_full
from lnasr_tpu_torch.ops.numerics import logsumexp
from lnasr_tpu_torch.ops.trellis import forward_backward, posteriors, viterbi_scan


class GMMHMMParams(NamedTuple):
    """Log-space transitions/initial/weights; linear-space means and
    covariances (``cov`` is ``(N, M, D)`` variances for diagonal models,
    ``(N, M, D, D)`` matrices for full ones)."""

    log_a: torch.Tensor
    log_pi: torch.Tensor
    log_w: torch.Tensor
    mu: torch.Tensor
    cov: torch.Tensor


class GMMEMStats(NamedTuple):
    """Sufficient statistics of one EM sweep (per sequence over a leading
    batch axis, or batch-combined)."""

    log_xi_sum: torch.Tensor  # (..., N, N)
    log_gamma_sum: torch.Tensor  # (..., N)
    log_pi_num: torch.Tensor  # (..., N)
    log_w_num: torch.Tensor  # (..., N, M)   lse_t xi_mix
    occ: torch.Tensor  # (..., N, M)         sum_t p[t]
    first: torch.Tensor  # (..., N, M, D)    sum_t p[t] o_t
    second: torch.Tensor  # diag (..., N, M, D) sum p o^2; full (..., N, M, D, D) centred
    loglik: torch.Tensor  # (...)


def _emissions(params: GMMHMMParams, obs: torch.Tensor, cov_type: str):
    if cov_type == "diag":
        return gmm_emissions_diag(obs, params.log_w, params.mu, params.cov)
    return gmm_emissions_full(obs, params.log_w, params.mu, params.cov)


def _sequence_stats(params: GMMHMMParams, obs: torch.Tensor, mask: torch.Tensor,
                    cov_type: str, emissions_fn=None) -> GMMEMStats:
    """E-step statistics of each padded sequence of ``obs (B, T, D)`` /
    ``mask (B, T)``; every field keeps the leading batch axis.

    ``emissions_fn`` overrides the emission scorer (``(params, obs,
    cov_type) -> (log_b, log_bm)``): a mixture-sharded step supplies one
    whose ``log_b`` is a logsumexp over every shard while ``log_bm`` stays
    the shard's own, so each mixture statistic covers only its components.
    The stages run under ``torch.profiler`` ranges (``gmmhmm.emissions``,
    ``gmmhmm.forward_backward``, ``gmmhmm.posteriors_stats``), which a
    profile splits the sweep by and which cost nothing without one."""
    with record_function("gmmhmm.emissions"):
        log_b, log_bm = (emissions_fn or _emissions)(params, obs, cov_type)
    with record_function("gmmhmm.forward_backward"):
        (alpha, loglik), beta = forward_backward(params.log_pi, params.log_a, log_b, mask)
    with record_function("gmmhmm.posteriors_stats"):
        return _posterior_stats(params, obs, mask, cov_type, log_b, log_bm, alpha, beta, loglik)


def _posterior_stats(params, obs, mask, cov_type, log_b, log_bm, alpha, beta, loglik):
    xi, gamma = posteriors(alpha, beta, params.log_a, log_b, mask)
    gamma_masked = torch.where(mask[..., None], gamma, -torch.inf)

    # component posteriors: the state occupancy from alpha + beta,
    # normalized per frame (the final frame included, unlike the
    # transitions' gamma), times the in-state component responsibility
    ab = alpha + beta  # (B, T, N)
    log_state_post = ab - logsumexp(ab, dim=-1, keepdim=True)
    log_resp = (params.log_w + log_bm) - log_b[..., None]
    xi_mix = log_state_post[..., None] + log_resp  # (B, T, N, M)
    xi_mix = torch.where(mask[..., None, None], xi_mix, -torch.inf)

    p = torch.exp(xi_mix)  # posteriors <= 1: safe in linear space
    occ = torch.sum(p, dim=-3)  # (B, N, M)
    # each moment is one batched GEMM over (b, t): no (B, T, N, M, D, D)
    first = torch.einsum("btnm,btd->bnmd", p, obs)
    if cov_type == "diag":
        second = torch.einsum("btnm,btd->bnmd", p, obs * obs)
    else:
        # centred on the old means, as the JAX package's estimator
        xc = obs[..., :, None, None, :] - params.mu  # (B, T, N, M, D)
        second = torch.einsum("btnmd,btnme->bnmde", p[..., None] * xc, xc)
    return GMMEMStats(
        log_xi_sum=logsumexp(xi, dim=-3),
        log_gamma_sum=logsumexp(gamma_masked, dim=-2),
        log_pi_num=gamma[..., 0, :],
        log_w_num=logsumexp(xi_mix, dim=-3),
        occ=occ,
        first=first,
        second=second,
        loglik=loglik,
    )


def _combine_stats(stats: GMMEMStats) -> GMMEMStats:
    """Combine per-sequence stats (leading batch axis): log-space sums of
    the log fields, plain sums of the moments."""
    return GMMEMStats(
        log_xi_sum=logsumexp(stats.log_xi_sum, dim=0),
        log_gamma_sum=logsumexp(stats.log_gamma_sum, dim=0),
        log_pi_num=logsumexp(stats.log_pi_num, dim=0) - float(np.log(stats.log_pi_num.shape[0])),
        log_w_num=logsumexp(stats.log_w_num, dim=0),
        occ=torch.sum(stats.occ, dim=0),
        first=torch.sum(stats.first, dim=0),
        second=torch.sum(stats.second, dim=0),
        loglik=torch.sum(stats.loglik),
    )


def _maximize(stats: GMMEMStats, old: GMMHMMParams, cov_type: str, min_std: float,
              var_floor, occ_floor: float = 1e-3, lse_m=None) -> GMMHMMParams:
    """M-step. ``lse_m`` computes the per-state logsumexp over the whole
    mixture axis of an ``(N, M)`` table (keeping the axis); a
    mixture-sharded step supplies one that reduces across its shards.

    The starvation guard: a component whose occupancy is under
    ``occ_floor`` would get 0/0 means and a -inf weight, so it keeps its
    previous mean and covariance, and its weight becomes the dtype's
    smallest normal number before the weights are renormalized."""
    if lse_m is None:
        lse_m = lambda x: logsumexp(x, dim=1, keepdim=True)  # noqa: E731
    log_a = stats.log_xi_sum - stats.log_gamma_sum[:, None]
    log_w = stats.log_w_num - lse_m(stats.log_w_num)
    tiny = torch.finfo(stats.occ.dtype).tiny
    starved = stats.occ < occ_floor  # (N, M)
    denom = torch.clamp(stats.occ, min=tiny)[..., None]
    mu = torch.where(starved[..., None], old.mu, stats.first / denom)
    if cov_type == "diag":
        var = stats.second / denom - mu * mu
        # scalar or (D,); an asynchronous copy, so the sweep never waits on the device
        floor = torch.as_tensor(var_floor, dtype=mu.dtype).to(mu.device, non_blocking=True)
        cov = torch.where(starved[..., None], old.cov, torch.maximum(var, floor))
    else:
        d = mu.shape[-1]
        cov = stats.second / denom[..., None] + min_std * torch.eye(d, dtype=mu.dtype,
                                                                    device=mu.device)
        cov = torch.where(starved[..., None, None], old.cov, cov)
    log_w = torch.where(starved, float(np.log(tiny)), log_w)
    log_w = log_w - lse_m(log_w)
    return GMMHMMParams(log_a=log_a, log_pi=stats.log_pi_num, log_w=log_w, mu=mu, cov=cov)


def gmmhmm_em_step(params: GMMHMMParams, obs: torch.Tensor, mask: torch.Tensor,
                   cov_type: str = "diag", min_std: float = 0.01, var_floor=1e-3
                   ) -> Tuple[GMMHMMParams, torch.Tensor]:
    """One Baum-Welch sweep over ``obs (B, T, D)`` / ``mask (B, T)``:
    updated parameters and the batch's log-likelihood under the old ones
    (a 0-d tensor on the device). ``var_floor`` is a float or a
    per-dimension tuple."""
    stats = _sequence_stats(params, obs, mask, cov_type)
    with record_function("gmmhmm.m_step"):
        combined = _combine_stats(stats)
        return _maximize(combined, params, cov_type, min_std, var_floor), combined.loglik


def resolve_var_floor(cfg: GMMHMMConfig, frames) -> GMMHMMConfig:
    """``cfg`` with its diagonal variance floor resolved against ``frames
    (T, D)``: ``max(var_floor, var_floor_scale * per-dim variance)``, in
    float64, as a per-dimension tuple. A tuple floor (already resolved), a
    full covariance or ``var_floor_scale <= 0`` leaves ``cfg`` as it is."""
    if cfg.cov_type != "diag" or cfg.var_floor_scale <= 0 or not np.isscalar(cfg.var_floor):
        return cfg
    x = frames.detach().cpu().numpy() if torch.is_tensor(frames) else np.asarray(frames)
    floor = np.maximum(cfg.var_floor_scale * np.var(x.astype(np.float64), axis=0), cfg.var_floor)
    return dataclasses.replace(cfg, var_floor=tuple(float(v) for v in floor))


class GMMHMM(HMM):
    """GMM-emission HMM on one device (CUDA by default)."""

    def __init__(self, config: GMMHMMConfig = GMMHMMConfig(), dtype=torch.float32,
                 device="cuda"):
        super().__init__(config.n_states, config.n_mix, dtype=dtype, device=device)
        self.config = config
        self.d = config.dim
        self.log_w: Optional[torch.Tensor] = None
        self.mu: Optional[torch.Tensor] = None
        self.cov: Optional[torch.Tensor] = None

    @property
    def params(self) -> GMMHMMParams:
        return GMMHMMParams(self.log_a, self.log_pi, self.log_w, self.mu, self.cov)

    def set_params(self, params: GMMHMMParams) -> "GMMHMM":
        """Adopt ``params`` (moved to this model's device and dtype)."""
        self.log_a, self.log_pi, self.log_w, self.mu, self.cov = (
            torch.as_tensor(x, dtype=self.dtype, device=self.device) for x in params)
        self.n, self.m = self.log_w.shape
        self.d = self.mu.shape[-1]
        return self

    def _full(self, shape, value) -> torch.Tensor:
        return torch.full(shape, value, dtype=self.dtype, device=self.device)

    def _unit_cov(self, n, m, d) -> torch.Tensor:
        if self.config.cov_type == "diag":
            return torch.ones((n, m, d), dtype=self.dtype, device=self.device)
        eye = torch.eye(d, dtype=self.dtype, device=self.device)
        return eye.expand(n, m, d, d).clone()

    def reset(self, init_type: str = "uniform", generator: Optional[torch.Generator] = None):
        """Uniform or random log-probs, random means in [-0.3, 0.3)
        (zeros for uniform), identity covariance (ones for diagonal)."""
        n, m, d = self.n, self.m, self.d
        if init_type == "uniform":
            self.log_a = self._full((n, n), -float(np.log(n)))
            self.log_pi = self._full((n,), -float(np.log(n)))
            self.log_w = self._full((n, m), -float(np.log(m)))
            self.mu = torch.zeros((n, m, d), dtype=self.dtype, device=self.device)
        elif init_type == "random":
            if generator is None:
                generator = torch.Generator().manual_seed(0)
            rand = lambda *shape: torch.rand(shape, generator=generator, dtype=self.dtype).to(self.device)  # noqa: E731
            a, pi, w = rand(n, n), rand(n), rand(n, m)
            self.log_a = torch.log(a / a.sum(dim=1, keepdim=True))
            self.log_pi = torch.log(pi / pi.sum())
            self.log_w = torch.log(w / w.sum(dim=1, keepdim=True))
            self.mu = 0.6 * rand(n, m, d) - 0.3
        else:
            raise ValueError(f"unknown init type: {init_type!r}")
        self.cov = self._unit_cov(n, m, d)
        return self

    def _var_cov(self, obs: torch.Tensor) -> torch.Tensor:
        """The global (population) feature variance under the floor
        resolved against ``obs``, as the covariance of every component."""
        n, m, d = self.n, self.m, self.d
        self.config = resolve_var_floor(self.config, obs)
        floor = torch.as_tensor(self.config.var_floor, dtype=self.dtype, device=self.device)
        var = torch.maximum(torch.var(obs, dim=0, correction=0), floor)
        if self.config.cov_type == "diag":
            return var.expand(n, m, d).clone()
        return torch.diag(var).expand(n, m, d, d).clone()

    def init_left_to_right(self, obs, generator: Optional[torch.Generator] = None,
                           self_loop: float = 0.5):
        """Left-to-right (Bakis) initialization for word and phone units:
        upper-bidiagonal transitions (stay ``self_loop`` / advance), the last
        state's self-loop 0 (the decoding graph handles the exit), entry
        pinned to state 0, uniform weights, and each state's means drawn
        from its slice of a uniform time segmentation of the frames
        (``np.array_split``; with replacement only when the slice has
        fewer frames than mixtures)."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        obs = torch.as_tensor(obs, dtype=self.dtype, device=self.device)
        if obs.dim() == 3:
            obs = obs.reshape(-1, obs.shape[-1])
        n, m = self.n, self.m
        a = np.full((n, n), -np.inf)
        for i in range(n - 1):
            a[i, i] = np.log(self_loop)
            a[i, i + 1] = np.log(1.0 - self_loop)
        a[n - 1, n - 1] = 0.0
        pi = np.full(n, -np.inf)
        pi[0] = 0.0
        self.log_a = self._param(a)
        self.log_pi = self._param(pi)
        self.log_w = self._full((n, m), -float(np.log(m)))
        t_total = obs.shape[0]
        mus = []
        for idx in np.array_split(np.arange(t_total), n):
            if len(idx) == 0:
                idx = np.arange(t_total)
            if len(idx) < m:
                pick = torch.randint(len(idx), (m,), generator=generator)
            else:
                pick = torch.randperm(len(idx), generator=generator)[:m]
            mus.append(obs[torch.as_tensor(idx[pick.numpy()], device=self.device)])
        self.mu = torch.stack(mus)
        self.cov = self._var_cov(obs)
        return self

    def init_from_data(self, obs, generator: Optional[torch.Generator] = None):
        """Data-driven initialization: means sampled from real frames
        (without replacement when there are enough), covariance from the
        global feature variance under the resolved floor, uniform A/pi/w."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        obs = torch.as_tensor(obs, dtype=self.dtype, device=self.device)
        if obs.dim() == 3:
            obs = obs.reshape(-1, obs.shape[-1])
        n, m, d = self.n, self.m, self.d
        self.log_a = self._full((n, n), -float(np.log(n)))
        self.log_pi = self._full((n,), -float(np.log(n)))
        self.log_w = self._full((n, m), -float(np.log(m)))
        t = obs.shape[0]
        if t < n * m:
            idx = torch.randint(t, (n * m,), generator=generator)
        else:
            idx = torch.randperm(t, generator=generator)[: n * m]
        self.mu = obs[idx.to(self.device)].reshape(n, m, d)
        self.cov = self._var_cov(obs)
        return self

    # -- inference ----------------------------------------------------------

    def emissions(self, obs) -> torch.Tensor:
        obs = torch.as_tensor(obs, dtype=self.dtype, device=self.device)
        return _emissions(self.params, obs, self.config.cov_type)[0]

    def decode_batch(self, obs, mask) -> torch.Tensor:
        """Masked Viterbi paths of padded ``obs (B, T, D)``."""
        log_b = self.emissions(obs)
        mask = torch.as_tensor(mask, device=self.device)
        return viterbi_scan(self.log_pi, self.log_a, log_b, mask).path

    # -- training -----------------------------------------------------------

    def _ensure_batch(self, obs, mask):
        obs = torch.as_tensor(obs, dtype=self.dtype, device=self.device)
        if obs.dim() == 2:
            obs = obs[None]
        return super()._ensure_batch(obs, mask)

    def _em(self, params, obs, mask):
        cfg = self.config
        return gmmhmm_em_step(params, obs, mask, cov_type=cfg.cov_type, min_std=cfg.min_std,
                              var_floor=cfg.var_floor)

    # -- persistence --------------------------------------------------------

    def save(self, filename: str) -> None:
        """HDF5 with datasets ``A``, ``pi``, ``w``, ``mu``, ``si`` (float64);
        diagonal models also store the compact ``var`` and expand ``si``
        to full matrices, as the JAX package does."""
        import h5py

        as64 = lambda x: x.detach().cpu().numpy().astype(np.float64)  # noqa: E731
        with h5py.File(filename, "w") as f:
            f.create_dataset("A", data=as64(self.log_a))
            f.create_dataset("pi", data=as64(self.log_pi))
            f.create_dataset("w", data=as64(self.log_w))
            f.create_dataset("mu", data=as64(self.mu))
            if self.config.cov_type == "diag":
                var = as64(self.cov)
                f.create_dataset("var", data=var)
                si = np.zeros((self.n, self.m, self.d, self.d))
                idx = np.arange(self.d)
                si[:, :, idx, idx] = var
                f.create_dataset("si", data=si)
            else:
                f.create_dataset("si", data=as64(self.cov))

    def load(self, filename: str) -> "GMMHMM":
        """Load a checkpoint written by either package; diagonal models read
        ``var`` if present, else the diagonal of ``si``."""
        import h5py

        with h5py.File(filename, "r") as f:
            a, pi, w, mu = (f[k][...] for k in ("A", "pi", "w", "mu"))
            if self.config.cov_type == "diag":
                if "var" in f:
                    cov = f["var"][...]
                else:
                    si = f["si"][...]
                    idx = np.arange(si.shape[-1])
                    cov = si[:, :, idx, idx]
            else:
                cov = f["si"][...]
        return self.set_params(GMMHMMParams(a, pi, w, mu, cov))
