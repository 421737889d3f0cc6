"""Standalone Gaussian mixture model with EM fitting.

The port of the JAX package's ``models/gmm.py``: diagonal (or full)
covariance EM over ``x (T, D)``, seeded from random data points, with the
GMM-HMM's starvation guard, and HDF5 persistence in the JAX package's
format.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from lnasr_tpu_torch._device import resolve_device
from lnasr_tpu_torch.ops.gaussian import diag_components_logpdf, gmm_emissions_full
from lnasr_tpu_torch.ops.numerics import logsumexp


class GMMParams(NamedTuple):
    log_w: torch.Tensor  # (M,)
    mu: torch.Tensor  # (M, D)
    cov: torch.Tensor  # (M, D) diagonal variances or (M, D, D)


def _component_logpdf(params: GMMParams, x: torch.Tensor, cov_type: str) -> torch.Tensor:
    """(T, M) per-component log-densities."""
    if cov_type == "diag":
        return diag_components_logpdf(x, params.mu, params.cov)
    _, log_bm = gmm_emissions_full(x, params.log_w[None, :], params.mu[None], params.cov[None])
    return log_bm[:, 0, :]


def gmm_em_step(params: GMMParams, x: torch.Tensor, cov_type: str = "diag",
                var_floor: float = 1e-4) -> Tuple[GMMParams, torch.Tensor]:
    """One EM sweep over ``x (T, D)``: updated parameters and the
    log-likelihood under the old ones (a 0-d tensor on the device)."""
    comp = _component_logpdf(params, x, cov_type)  # (T, M)
    joint = params.log_w[None, :] + comp
    norm = logsumexp(joint, dim=1, keepdim=True)
    loglik = torch.sum(norm)
    resp = torch.exp(joint - norm)  # (T, M), rows sum to 1

    occ = torch.sum(resp, dim=0)  # (M,)
    tiny = torch.finfo(occ.dtype).tiny
    starved = occ < 1e-3
    denom = torch.clamp(occ, min=tiny)[:, None]
    mu = resp.T @ x / denom
    if cov_type == "diag":
        second = resp.T @ (x * x) / denom
        cov = torch.clamp(second - mu * mu, min=var_floor)
        cov = torch.where(starved[:, None], params.cov, cov)
    else:
        xc = x[:, None, :] - mu[None]  # (T, M, D)
        cov = torch.einsum("tmd,tme->mde", resp[..., None] * xc, xc) / denom[..., None]
        d = mu.shape[-1]
        cov = cov + var_floor * torch.eye(d, dtype=mu.dtype, device=mu.device)
        cov = torch.where(starved[:, None, None], params.cov, cov)
    mu = torch.where(starved[:, None], params.mu, mu)
    log_w = torch.log(torch.clamp(occ / occ.sum(), min=tiny))
    return GMMParams(log_w=log_w, mu=mu, cov=cov), loglik


class GMM:
    """Mixture model on one device (CUDA by default): ``fit`` (EM),
    ``logpdf``, ``predict`` (hard assignment), ``score`` (mean
    log-likelihood), HDF5 persistence."""

    def __init__(self, n_mix: int, dim: int, cov_type: str = "diag",
                 var_floor: float = 1e-4, dtype=torch.float32, device="cuda"):
        self.m = n_mix
        self.d = dim
        self.cov_type = cov_type
        self.var_floor = var_floor
        self.dtype = dtype
        self.device = resolve_device(device)
        self.log_w: Optional[torch.Tensor] = None
        self.mu: Optional[torch.Tensor] = None
        self.cov: Optional[torch.Tensor] = None

    @property
    def params(self) -> GMMParams:
        return GMMParams(self.log_w, self.mu, self.cov)

    def set_params(self, params: GMMParams) -> "GMM":
        """Adopt ``params`` (moved to this model's device and dtype)."""
        self.log_w, self.mu, self.cov = (
            torch.as_tensor(x, dtype=self.dtype, device=self.device) for x in params)
        self.m, self.d = self.mu.shape
        return self

    def _x(self, x) -> torch.Tensor:
        return torch.as_tensor(x, dtype=self.dtype, device=self.device)

    def init_from_data(self, x, generator: Optional[torch.Generator] = None) -> "GMM":
        """Means from random data points (without replacement when there
        are enough), variances from the global (population) variance under
        ``var_floor``, uniform weights."""
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        x = self._x(x)
        t = x.shape[0]
        if t < self.m:
            idx = torch.randint(t, (self.m,), generator=generator)
        else:
            idx = torch.randperm(t, generator=generator)[: self.m]
        self.mu = x[idx.to(self.device)]
        var = torch.clamp(torch.var(x, dim=0, correction=0), min=self.var_floor)
        if self.cov_type == "diag":
            self.cov = var.expand(self.m, self.d).clone()
        else:
            self.cov = torch.diag(var).expand(self.m, self.d, self.d).clone()
        self.log_w = torch.full((self.m,), -float(np.log(self.m)), dtype=self.dtype,
                                device=self.device)
        return self

    def fit(self, x, iters: int = 50, eps: float = 1e-4,
            generator: Optional[torch.Generator] = None, verbose: bool = False):
        """EM until |delta loglik| < eps or ``iters`` sweeps; initializes
        from ``x`` first when the model has no parameters. Returns the
        loglik history."""
        x = self._x(x)
        if self.mu is None:
            self.init_from_data(x, generator)
        params = self.params
        history = []
        prev = None
        for it in range(iters):
            params, loglik = gmm_em_step(params, x, self.cov_type, self.var_floor)
            loglik = float(loglik)
            history.append(loglik)
            if verbose:
                print(f"iter {it:3}: loglik {loglik:.6e}")
            if prev is not None and abs(loglik - prev) < eps:
                break
            prev = loglik
        self.log_w, self.mu, self.cov = params
        return history

    def logpdf(self, x) -> torch.Tensor:
        """(T,) mixture log-density."""
        comp = _component_logpdf(self.params, self._x(x), self.cov_type)
        return logsumexp(self.log_w[None, :] + comp, dim=1)

    def score(self, x) -> float:
        return float(torch.mean(self.logpdf(x)))

    def predict(self, x) -> torch.Tensor:
        """(T,) most-responsible component per sample (first on ties)."""
        comp = _component_logpdf(self.params, self._x(x), self.cov_type)
        return torch.argmax(self.log_w[None, :] + comp, dim=1)

    def save(self, filename: str) -> None:
        """HDF5 with datasets ``w`` (log weights), ``mu``, ``cov`` (float64)
        and a ``cov_type`` attribute, the JAX package's format."""
        import h5py

        with h5py.File(filename, "w") as f:
            for key, x in (("w", self.log_w), ("mu", self.mu), ("cov", self.cov)):
                f.create_dataset(key, data=x.detach().cpu().numpy().astype(np.float64))
            f.attrs["cov_type"] = self.cov_type

    def load(self, filename: str) -> "GMM":
        """Load a file written by either package."""
        import h5py

        with h5py.File(filename, "r") as f:
            params = GMMParams(f["w"][...], f["mu"][...], f["cov"][...])
            self.cov_type = str(f.attrs.get("cov_type", self.cov_type))
        return self.set_params(params)
