"""Gaussian and Gaussian-mixture log-densities.

The six scalar pdfs of the JAX package's ``ops/gaussian.py``
(``gaussian_logpdf`` ... ``gmm_pdf_full``), and the emission scorers of
the GMM-HMM. The diagonal-covariance scorer is one fp32 GEMM:

    log N(o; mu_k, var_k) = [o^2, o, 1] @ [-ivar/2, mu*ivar, c_k]^T

with ``c_k = -(D log 2pi + sum log var_k)/2 - sum mu_k^2 ivar_k / 2``, as
in the JAX package's ``ops/gaussian.py``, where it runs outside any Pallas
kernel; here it is ``torch.matmul`` (cuBLAS on the card, TF32 off: the
quadratic terms cancel against each other, so reduced-precision passes
would corrupt the tails).
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from lnasr_tpu_torch.ops.numerics import logsumexp

_LOG_2PI = float(np.log(2.0 * np.pi))


# -- scalar and generic pdfs ------------------------------------------------

def gaussian_logpdf(x, mu, sigma2) -> torch.Tensor:
    """Univariate normal log-density."""
    x = torch.as_tensor(x)
    sigma2 = torch.as_tensor(sigma2, dtype=x.dtype, device=x.device)
    return -0.5 * (_LOG_2PI + torch.log(sigma2) + (x - mu) * (x - mu) / sigma2)


def gaussian_pdf(x, mu, sigma2) -> torch.Tensor:
    """Univariate normal density."""
    return torch.exp(gaussian_logpdf(x, mu, sigma2))


def mvn_logpdf_full(x: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor) -> torch.Tensor:
    """Full-covariance normal log-density: ``x (L, D)``, ``mu (..., D)``,
    ``sigma (..., D, D)`` -> ``(..., L)`` (log-determinant, explicit
    inverse, Mahalanobis form)."""
    d = x.shape[-1]
    _, logdet = torch.linalg.slogdet(sigma)
    inv = torch.linalg.inv(sigma)
    xc = x - mu[..., None, :]
    maha = torch.einsum("...ld,...de,...le->...l", xc, inv, xc)
    return -0.5 * (d * _LOG_2PI + logdet[..., None] + maha)


def mvn_pdf_full(x, mu, sigma) -> torch.Tensor:
    return torch.exp(mvn_logpdf_full(x, mu, sigma))


def gmm_logpdf_full(log_w: torch.Tensor, x: torch.Tensor, mu: torch.Tensor,
                    sigma: torch.Tensor) -> torch.Tensor:
    """Log-density of a full-covariance mixture: ``log_w (M,)``, ``mu (M,
    D)``, ``sigma (M, D, D)`` -> ``(L,)``."""
    return logsumexp(log_w[:, None] + mvn_logpdf_full(x, mu, sigma), dim=0)


def gmm_pdf_full(w: torch.Tensor, x: torch.Tensor, mu: torch.Tensor,
                 sigma: torch.Tensor) -> torch.Tensor:
    """Linear-space mixture density (weights linear)."""
    return w @ mvn_pdf_full(x, mu, sigma)


# -- emission scorers -------------------------------------------------------


def diag_components_logpdf(obs: torch.Tensor, mu: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """Per-component diagonal-Gaussian log-densities: ``obs (..., T, D)``,
    ``mu (..., K1, K2, D)`` and ``var`` alike -> ``(..., T, K1, K2)``, the
    component axes flattened for the product and restored after."""
    comp_shape = mu.shape[:-1]
    d = obs.shape[-1]
    mu2 = mu.reshape(-1, d)
    var2 = var.reshape(-1, d)
    ivar = 1.0 / var2
    const = -0.5 * (d * _LOG_2PI + torch.sum(torch.log(var2), dim=-1))
    lhs = torch.cat([obs * obs, obs, torch.ones_like(obs[..., :1])], dim=-1)
    rhs = torch.cat(
        [-0.5 * ivar, mu2 * ivar, (const - 0.5 * torch.sum(mu2 * mu2 * ivar, dim=-1))[:, None]],
        dim=1,
    ).T  # (2D+1, K)
    out = lhs @ rhs
    return out.reshape(*obs.shape[:-1], *comp_shape)


def gmm_emissions_diag(
    obs: torch.Tensor, log_w: torch.Tensor, mu: torch.Tensor, var: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """``obs (..., T, D)``, ``log_w (N, M)``, ``mu``/``var (N, M, D)`` ->
    ``(log_b (..., T, N), log_bm (..., T, N, M))``."""
    log_bm = diag_components_logpdf(obs, mu, var)
    return logsumexp(log_w + log_bm, dim=-1), log_bm


def gmm_emissions_full(
    obs: torch.Tensor, log_w: torch.Tensor, mu: torch.Tensor, sigma: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-covariance emissions: ``sigma (N, M, D, D)``; inverses and
    log-determinants are computed once per call."""
    n, m, d = mu.shape
    mu_f = mu.reshape(n * m, d)
    sig_f = sigma.reshape(n * m, d, d)
    _, logdet = torch.linalg.slogdet(sig_f)
    inv = torch.linalg.inv(sig_f)
    xc = obs[..., :, None, :] - mu_f  # (..., T, NM, D)
    maha = torch.einsum("...tkd,kde,...tke->...tk", xc, inv, xc)
    log_bm = (-0.5 * (d * _LOG_2PI + logdet + maha)).reshape(*obs.shape[:-1], n, m)
    return logsumexp(log_w + log_bm, dim=-1), log_bm
