"""Continuous GMM-HMM acoustic model: the inference half.

Parameters, initialization, emission scoring, batched decoding and the
HDF5 format of the JAX package's ``models/gmmhmm.py``. Randomness comes
from a ``torch.Generator``, so draws differ from ``jax.random`` ones for
the same seed; carry parameters across with :mod:`lnasr_tpu_torch.convert`
where both packages must compute with the same weights.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from lnasr_tpu_torch.config import GMMHMMConfig
from lnasr_tpu_torch.models.hmm import HMM
from lnasr_tpu_torch.ops.gaussian import gmm_emissions_diag, gmm_emissions_full
from lnasr_tpu_torch.ops.trellis import viterbi_scan


class GMMHMMParams(NamedTuple):
    """Log-space transitions/initial/weights; linear-space means and
    covariances (``cov`` is ``(N, M, D)`` variances for diagonal models,
    ``(N, M, D, D)`` matrices for full ones)."""

    log_a: torch.Tensor
    log_pi: torch.Tensor
    log_w: torch.Tensor
    mu: torch.Tensor
    cov: torch.Tensor


def _emissions(params: GMMHMMParams, obs: torch.Tensor, cov_type: str):
    if cov_type == "diag":
        return gmm_emissions_diag(obs, params.log_w, params.mu, params.cov)
    return gmm_emissions_full(obs, params.log_w, params.mu, params.cov)


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

    def _resolve_var_floor(self, obs: torch.Tensor) -> None:
        """Resolve the diagonal variance floor against the data:
        ``max(var_floor, var_floor_scale * per-dim variance)``, computed in
        float64. A tuple floor (already resolved) is left alone."""
        cfg = self.config
        if (cfg.cov_type != "diag" or cfg.var_floor_scale <= 0
                or not np.isscalar(cfg.var_floor)):
            return
        gvar = np.var(obs.detach().cpu().numpy().astype(np.float64), axis=0)
        floor = tuple(float(v) for v in np.maximum(cfg.var_floor_scale * gvar, cfg.var_floor))
        self.config = dataclasses.replace(cfg, var_floor=floor)

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
        self._resolve_var_floor(obs)
        floor = torch.as_tensor(self.config.var_floor, dtype=self.dtype, device=self.device)
        var = torch.maximum(torch.var(obs, dim=0, correction=0), floor)
        if self.config.cov_type == "diag":
            self.cov = var.expand(n, m, d).clone()
        else:
            self.cov = torch.diag(var).expand(n, m, d, d).clone()
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
