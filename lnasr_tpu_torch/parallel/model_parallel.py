"""Model parallelism: GMM mixture components sharded over the ``model``
mesh axis.

When N*M*D outgrows one device, the mixture axis shards: every rank
scores its own component slice (the GEMM of
:func:`lnasr_tpu_torch.ops.gaussian.diag_components_logpdf` on an
M/S-wide slab) and the per-state logsumexp over components completes with
one ``pmax`` + ``psum`` pair (a numerically stable distributed
logsumexp). The collective payload is O(T N), independent of M.

:func:`make_mp_gmmhmm_em_step` extends this to training: a Baum-Welch
step over a ``('data', 'model')`` mesh where each mixture shard computes
the E-step statistics of its OWN components from the shared state
posteriors (replicated over ``model`` by construction), the statistics
are summed over ``data``, and the M-step runs shard-local. Means,
covariances and weights are never gathered during training; the only
cross-``model`` traffic is the O(T N) emission logsumexp and an O(N)
weight normalizer (the ``emissions_fn=``/``lse_m=`` hooks of
:mod:`lnasr_tpu_torch.models.gmmhmm`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from lnasr_tpu_torch.config import GMMHMMConfig
from lnasr_tpu_torch.models import gmmhmm as _g
from lnasr_tpu_torch.ops.gaussian import (
    diag_components_logpdf,
    gmm_emissions_diag,
    gmm_emissions_full,
)
from lnasr_tpu_torch.ops.numerics import logsumexp
from lnasr_tpu_torch.parallel.distributed import Axis, all_gather, pmax, psum
from lnasr_tpu_torch.parallel.mesh import local_rows, mesh_axis
from lnasr_tpu_torch.parallel.training import _FMT, _gmm_linear_stats, _gmm_stats


def distributed_logsumexp(local: torch.Tensor, axis: Axis) -> torch.Tensor:
    """logsumexp across an axis of the mesh: elements of ``local`` hold each
    shard's partial logsumexp; the result is equal on every rank."""
    m = pmax(local, axis)
    safe = torch.where(torch.isfinite(m), m, 0.0)
    total = psum(torch.exp(local - safe), axis)
    return torch.where(torch.isfinite(m), safe + torch.log(total), m)


def _mixture_slice(n_mix: int, axis: Axis) -> slice:
    if n_mix % axis.size:
        raise ValueError(f"the model axis size ({axis.size}) must divide n_mix={n_mix}")
    per = n_mix // axis.size
    return slice(axis.index * per, (axis.index + 1) * per)


def make_mp_emission_fn(mesh) -> Callable:
    """``fn(obs (..., T, D), log_w (N, M), mu (N, M, D), var (N, M, D)) ->
    log_b (..., T, N)`` with the mixture axis M sharded over ``model``:
    every rank passes the whole parameters, scores its own slice of the
    components and gets the whole ``log_b``."""
    model = mesh_axis(mesh, "model")

    def fn(obs, log_w, mu, var):
        sl = _mixture_slice(log_w.shape[1], model)
        log_bm = diag_components_logpdf(obs, mu[:, sl], var[:, sl])  # (..., T, N, M/S)
        return distributed_logsumexp(logsumexp(log_w[:, sl] + log_bm, dim=-1), model)

    return fn


class MPParamSpecs(NamedTuple):
    """The mixture-sharded layout of
    :class:`~lnasr_tpu_torch.models.gmmhmm.GMMHMMParams`: transitions and
    initial replicated, weights/means/covariances split on axis 1 (M)."""

    local: Callable  # (params, mesh) -> this rank's mixture slice
    gather: Callable  # (params, mesh) -> the whole parameters, on every rank


def mp_param_specs() -> MPParamSpecs:
    """The pair of functions that cut a rank's mixture slice out of whole
    :class:`~lnasr_tpu_torch.models.gmmhmm.GMMHMMParams` and gather the
    slices back (an exact all-gather), by the rank's ``model`` coordinate.
    The mixture axis is axis 1 for diagonal ``(N, M, D)`` and full
    ``(N, M, D, D)`` covariances alike."""

    def local(params: _g.GMMHMMParams, mesh) -> _g.GMMHMMParams:
        model = mesh_axis(mesh, "model")
        sl = _mixture_slice(params.log_w.shape[1], model)
        return params._replace(**{k: getattr(params, k)[:, sl].contiguous()
                                  for k in ("log_w", "mu", "cov")})

    def gather(params: _g.GMMHMMParams, mesh) -> _g.GMMHMMParams:
        model = mesh_axis(mesh, "model")
        return params._replace(**{k: torch.cat(list(all_gather(getattr(params, k), model)),
                                               dim=1)
                                  for k in ("log_w", "mu", "cov")})

    return MPParamSpecs(local, gather)


def make_mp_gmmhmm_em_step(mesh, config: GMMHMMConfig) -> Callable:
    """A model(+data)-parallel Baum-Welch step ``(params, obs (b, T, D),
    mask (b, T)) -> (params, loglik)``: ``params`` is this rank's mixture
    slice (:func:`mp_param_specs`), ``obs``/``mask`` its rows of the batch
    sharded over ``data``.

    Per rank: local component log-densities -> distributed logsumexp gives
    the exact global ``log_b`` (equal over ``model``) -> the trellis runs
    redundantly per shard (O(T N^2), cheap) -> mixture statistics
    (occupancy, first/second moments, weight numerators) for the shard's
    own components only. The statistics are summed over ``data``; the
    M-step is shard-local except the O(N) weight normalizer, a distributed
    logsumexp. Equals the single-device
    :func:`~lnasr_tpu_torch.models.gmmhmm.gmmhmm_em_step` up to the float
    reassociation of the distributed reductions."""
    cov_type, min_std, var_floor = config.cov_type, config.min_std, config.var_floor
    data, model = mesh_axis(mesh, "data"), mesh_axis(mesh, "model")
    if model.size > 1 and config.n_mix % model.size:
        raise ValueError(f"the model axis size ({model.size}) must divide "
                         f"n_mix={config.n_mix}")
    scorer = gmm_emissions_diag if cov_type == "diag" else gmm_emissions_full

    def emissions_fn(p, obs, ct):
        local, log_bm = scorer(obs, p.log_w, p.mu, p.cov)
        return distributed_logsumexp(local, model), log_bm

    def lse_m(x):  # logsumexp over the WHOLE (sharded) mixture axis
        return distributed_logsumexp(logsumexp(x, dim=1), model)[:, None]

    def step(params, obs, mask):
        total = psum(_gmm_linear_stats(params, obs, mask, cov_type, emissions_fn), data)
        stats = _gmm_stats(total)
        new = _g._maximize(stats, params, cov_type, min_std, var_floor, lse_m=lse_m)
        return new, stats.loglik

    return step


def train_model_parallel(model, obs, mask, mesh, iters: int = 10, eps: float = 1e-4,
                         verbose: bool = False, config=None):
    """The EM loop over the model(+data)-parallel step. ``model`` is a
    :class:`~lnasr_tpu_torch.models.gmmhmm.GMMHMM`; every rank passes it
    with the whole parameters and the global batch, trains its mixture
    slice on its rows, and ends with the whole parameters gathered (equal
    on every rank) in ``model``. Returns the loglik history. An optional
    :class:`~lnasr_tpu_torch.config.TrainConfig` supplies the budget and
    periodic checkpoints with resume: the mixture axis is gathered before
    each save (world rank 0 writes the single-device layout) and re-sliced
    on resume."""
    from lnasr_tpu_torch.utils.checkpoints import em_loop, rank_checkpointer_from_config

    if config is not None:
        iters, eps = config.max_iters, config.eps
    step = make_mp_gmmhmm_em_step(mesh, model.config)
    specs = mp_param_specs()
    data = mesh_axis(mesh, "data")
    dev = model.device
    obs = local_rows(torch.as_tensor(obs, dtype=model.dtype, device=dev), data)
    mask = local_rows(torch.as_tensor(mask, device=dev).bool(), data)
    ckpt = rank_checkpointer_from_config(config, gather=lambda p: specs.gather(p, mesh),
                                         local=lambda p: specs.local(p, mesh))
    params, history = em_loop(lambda p: step(p, obs, mask), specs.local(model.params, mesh),
                              iters, eps, verbose=verbose, checkpointer=ckpt, fmt=_FMT)
    model.set_params(specs.gather(params, mesh))
    return history
