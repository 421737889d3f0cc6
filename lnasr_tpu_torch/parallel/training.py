"""Data- and sequence-parallel Baum-Welch over a rank mesh.

Data parallel: utterance batches shard across the ``data`` axis; each
rank computes its E-step sufficient statistics locally (the
single-device per-sequence code), the statistics are summed with one
``psum``, and the M-step runs replicated on every rank, so parameters
never move and the only communication is one small sum a sweep
(O(N^2 + N M D) values, independent of batch size and sequence length).

Sequence parallel: ONE long utterance's time axis shards across the
``seq`` axis (:mod:`lnasr_tpu_torch.parallel.seqscan`'s operators), with
one boundary row shifted between neighbouring chunks for the cross-chunk
transitions.

Statistics cross the collective in linear space, as in the JAX package
(posterior masses are bounded by the frame count, so ``exp`` of the
log-space accumulators is safe): ``log_pi_num = log(sum pi / count)``.
The single-device sweep combines in log space, so the two agree to about
one ulp, not bitwise.

The step functions take this rank's shard (its batch rows or its time
chunk); the ``train_*`` functions take the global inputs on every rank
and cut out the shard by the rank's mesh coordinate.
"""

from __future__ import annotations

from typing import Callable

import torch

from lnasr_tpu_torch.config import GMMHMMConfig
from lnasr_tpu_torch.models import gmmhmm as _g
from lnasr_tpu_torch.models import hmm as _h
from lnasr_tpu_torch.ops.numerics import log_matmul, logsumexp, safe_log, segment_sum
from lnasr_tpu_torch.parallel.distributed import Axis, all_gather, ppermute, psum
from lnasr_tpu_torch.parallel.mesh import local_rows, mesh_axis
from lnasr_tpu_torch.parallel.seqscan import (
    _after_product,
    _before_product,
    _chunk_ops,
    _identity_op,
    _local_chunk,
    _prefix_scan,
    _suffix_scan,
)

_FMT = "Iter {it:3}: loglik {loglik:.6e}"


def _gmm_linear_stats(params, obs, mask, cov_type, emissions_fn=None):
    """Per-shard E-step: the batch's sequence stats combined into
    linear-space, psum-ready accumulators."""
    stats = _g._sequence_stats(params, obs, mask, cov_type, emissions_fn=emissions_fn)
    return dict(
        xi=torch.sum(torch.exp(stats.log_xi_sum), dim=0),
        gamma=torch.sum(torch.exp(stats.log_gamma_sum), dim=0),
        pi=torch.sum(torch.exp(stats.log_pi_num), dim=0),
        w=torch.sum(torch.exp(stats.log_w_num), dim=0),
        occ=torch.sum(stats.occ, dim=0),
        first=torch.sum(stats.first, dim=0),
        second=torch.sum(stats.second, dim=0),
        loglik=torch.sum(stats.loglik),
        count=torch.tensor(float(obs.shape[0]), dtype=stats.occ.dtype, device=obs.device),
    )


def _gmm_stats(total, per_count: bool = True) -> _g.GMMEMStats:
    """Summed linear statistics back in the M-step's log-space form."""
    pi = total["pi"] / total["count"] if per_count else total["pi"]
    return _g.GMMEMStats(
        log_xi_sum=safe_log(total["xi"]),
        log_gamma_sum=safe_log(total["gamma"]),
        log_pi_num=safe_log(pi),
        log_w_num=safe_log(total["w"]),
        occ=total["occ"],
        first=total["first"],
        second=total["second"],
        loglik=total["loglik"],
    )


def make_dp_gmmhmm_em_step(mesh, config: GMMHMMConfig) -> Callable:
    """A data-parallel EM step ``(params, obs (b, T, D), mask (b, T)) ->
    (params, loglik)``: ``obs``/``mask`` are this rank's rows of the batch
    sharded over the mesh's ``data`` axis; parameters are replicated and
    the returned ones are equal on every rank, as is the batch loglik."""
    cov_type, min_std, var_floor = config.cov_type, config.min_std, config.var_floor
    data = mesh_axis(mesh, "data")

    def step(params, obs, mask):
        total = psum(_gmm_linear_stats(params, obs, mask, cov_type), data)
        stats = _gmm_stats(total)
        return _g._maximize(stats, params, cov_type, min_std, var_floor), stats.loglik

    return step


def make_dp_hmm_em_step(mesh) -> Callable:
    """Same as :func:`make_dp_gmmhmm_em_step` for the discrete HMM."""
    data = mesh_axis(mesh, "data")

    def step(params, obs, mask):
        stats = _h._sequence_stats(params, obs, mask)
        local = dict(
            xi=torch.sum(torch.exp(stats.log_xi_sum), dim=0),
            gamma=torch.sum(torch.exp(stats.log_gamma_sum), dim=0),
            b=torch.sum(torch.exp(stats.log_b_num), dim=0),
            pi=torch.sum(torch.exp(stats.log_pi_num), dim=0),
            loglik=torch.sum(stats.loglik),
            count=torch.tensor(float(obs.shape[0]), dtype=stats.log_pi_num.dtype,
                               device=obs.device),
        )
        total = psum(local, data)
        combined = _h.EMStats(
            log_xi_sum=safe_log(total["xi"]),
            log_gamma_sum=safe_log(total["gamma"]),
            log_b_num=safe_log(total["b"]),
            log_pi_num=safe_log(total["pi"] / total["count"]),
            loglik=total["loglik"],
        )
        return _h._maximize(combined), combined.loglik

    return step


def _seq_trellis_stats(log_pi, log_a, log_b_c, mask_c, axis: Axis):
    """Chunk-local alpha/beta rows and normalized xi/gamma for one long
    utterance sharded over the ``seq`` axis (shared by the continuous and
    discrete seq-parallel EM steps). Returns
    ``(alpha_c, beta_c, xi, gamma, gamma_m)``."""
    n = log_a.shape[0]
    tc = log_b_c.shape[0]
    mats = _chunk_ops(log_a, log_b_c, mask_c, axis.index == 0)
    prefix = _prefix_scan(log_matmul, mats)
    suffix = _suffix_scan(log_matmul, mats)
    # one gather carries both chunk totals and the global frame 0's row
    first_row = torch.cat([log_b_c[0], log_b_c.new_zeros(n * n - n)]).reshape(n, n)
    gathered = all_gather(torch.stack([prefix[-1], suffix[0], first_row]), axis)
    before = _before_product(gathered[:, 0], axis, log_matmul)
    after = _after_product(gathered[:, 1], axis, log_matmul)
    alpha0 = log_pi + gathered[0, 2].reshape(-1)[:n]
    alpha_c = logsumexp(alpha0[None, :, None] + log_matmul(before[None], prefix), dim=1)
    suffix_next = torch.cat([suffix[1:], _identity_op(n, mats.dtype, mats.device)[None]])
    beta_c = logsumexp(log_matmul(suffix_next, after[None]), dim=2)

    # boundary rows from the next chunk (the last chunk receives zeros and
    # masks them out: the global last frame has no outgoing transition)
    shift_up = [(i, i - 1) for i in range(1, axis.size)]  # chunk c+1 -> c
    head = torch.stack([log_b_c[0], beta_c[0], mask_c[0].to(log_b_c.dtype).expand(n)])
    nxt = ppermute(head, axis, shift_up)
    b_next = torch.cat([log_b_c[1:], nxt[0][None]])
    beta_next = torch.cat([beta_c[1:], nxt[1][None]])
    # frame t+1 valid <=> the transition t -> t+1 exists
    mask_next = torch.cat([mask_c[1:], (nxt[2, :1] > 0)])

    # xi / gamma (the per-frame normalization is chunk-local)
    numer = alpha_c[:, :, None] + log_a[None] + (b_next + beta_next)[:, None, :]
    denom = logsumexp(numer.reshape(tc, n * n), dim=1)
    xi = torch.where(mask_next[:, None, None], numer - denom[:, None, None], -torch.inf)
    gamma = logsumexp(xi, dim=2)
    gamma_m = torch.where(mask_c[:, None], gamma, -torch.inf)
    return alpha_c, beta_c, xi, gamma, gamma_m


def _edge_terms(axis: Axis, alpha_c, gamma):
    """The initial-state numerator (chunk 0 only) and the loglik (the last
    chunk only), zeros elsewhere."""
    pi = torch.exp(gamma[0]) if axis.index == 0 else torch.zeros_like(gamma[0])
    loglik = (logsumexp(alpha_c[-1], dim=0) if axis.index == axis.size - 1
              else alpha_c.new_zeros(()))
    return pi, loglik


def make_seq_gmmhmm_em_step(mesh, config: GMMHMMConfig) -> Callable:
    """Baum-Welch for ONE long utterance with the *time* axis sharded over
    the mesh's ``seq`` axis: ``(params, obs_c (Tc, D), mask_c (Tc,)) ->
    (params, loglik)``, where ``obs_c``/``mask_c`` are this rank's chunk of
    the padded utterance.

    Each chunk computes its emissions and the forward prefix and backward
    suffix operator products locally, exchanges one (N, N) product per
    chunk, shifts one boundary row down one chunk for the cross-chunk xi
    transitions, and sums the linear-space sufficient statistics. The
    M-step runs replicated. Statistics match the single-device sweep up
    to float reassociation."""
    cov_type, min_std, var_floor = config.cov_type, config.min_std, config.var_floor
    seq = mesh_axis(mesh, "seq")

    def step(params, obs_c, mask_c):
        log_b_c, log_bm_c = _g._emissions(params, obs_c, cov_type)
        alpha_c, beta_c, xi, gamma, gamma_m = _seq_trellis_stats(
            params.log_pi, params.log_a, log_b_c, mask_c, seq)

        # mixture posteriors (the single-device sweep's, chunk-local)
        ab = alpha_c + beta_c
        log_state_post = ab - logsumexp(ab, dim=1, keepdim=True)
        log_resp = (params.log_w[None] + log_bm_c) - log_b_c[..., None]
        xi_mix = torch.where(mask_c[:, None, None], log_state_post[..., None] + log_resp,
                             -torch.inf)
        p = torch.exp(xi_mix)  # (Tc, N, M)
        if cov_type == "diag":
            second = torch.einsum("tnm,td->nmd", p, obs_c * obs_c)
        else:
            xc = obs_c[:, None, None, :] - params.mu[None]
            second = torch.einsum("tnmd,tnme->nmde", p[..., None] * xc, xc)
        pi, loglik = _edge_terms(seq, alpha_c, gamma)
        local = dict(
            xi=torch.sum(torch.exp(xi), dim=0),
            gamma=torch.sum(torch.exp(gamma_m), dim=0),
            pi=pi,
            w=torch.sum(p, dim=0),
            occ=torch.sum(p, dim=0),
            first=torch.einsum("tnm,td->nmd", p, obs_c),
            second=second,
            loglik=loglik,
        )
        stats = _gmm_stats(psum(local, seq), per_count=False)
        return _g._maximize(stats, params, cov_type, min_std, var_floor), stats.loglik

    return step


def make_seq_hmm_em_step(mesh) -> Callable:
    """Discrete-HMM Baum-Welch for ONE long observation sequence with the
    time axis sharded over ``seq``: ``(params, obs_c (Tc,) int, mask_c
    (Tc,)) -> (params, loglik)``. Same machinery as
    :func:`make_seq_gmmhmm_em_step`, with a table-gather emission model
    and the order-fixed segment sum (``ops.numerics.segment_sum``) for the
    emission numerator, so a sweep gives the same bits on every run."""
    seq = mesh_axis(mesh, "seq")

    def step(params, obs_c, mask_c):
        m_sym = params.log_b.shape[1]
        log_b_c = _h._emission_lookup(params.log_b, obs_c)
        alpha_c, _, xi, gamma, gamma_m = _seq_trellis_stats(
            params.log_pi, params.log_a, log_b_c, mask_c, seq)
        occ = torch.where(mask_c[:, None], torch.exp(gamma_m), 0.0)  # (Tc, N)
        pi, loglik = _edge_terms(seq, alpha_c, gamma)
        local = dict(
            xi=torch.sum(torch.exp(xi), dim=0),
            gamma=torch.sum(torch.exp(gamma_m), dim=0),
            pi=pi,
            b=segment_sum(occ, obs_c, m_sym).T,
            loglik=loglik,
        )
        total = psum(local, seq)
        combined = _h.EMStats(
            log_xi_sum=safe_log(total["xi"]),
            log_gamma_sum=safe_log(total["gamma"]),
            log_b_num=safe_log(total["b"]),
            log_pi_num=safe_log(total["pi"]),
            loglik=total["loglik"],
        )
        return _h._maximize(combined), combined.loglik

    return step


def _is_discrete(model) -> bool:
    # GMMHMM subclasses HMM, so identify the discrete model by its params
    return hasattr(model.params, "log_b")


def train_seq_parallel(model, obs, mesh, iters: int = 10, mask=None, eps: float = 1e-4,
                       verbose: bool = False, config=None):
    """EM over ONE long utterance, time-sharded across the ``seq`` axis.

    ``model`` may be a :class:`~lnasr_tpu_torch.models.gmmhmm.GMMHMM`
    (``obs (T, D)`` float features) or a discrete
    :class:`~lnasr_tpu_torch.models.hmm.HMM` (``obs (T,)`` symbol ids).
    T need not divide the axis size (auto-padded with masked frames).
    Every rank passes the whole utterance and ends with the same
    parameters. Updates ``model`` in place, returns the loglik history. An
    optional :class:`~lnasr_tpu_torch.config.TrainConfig` supplies the
    budget and periodic checkpoints with resume (world rank 0 writes)."""
    from lnasr_tpu_torch.utils.checkpoints import em_loop, rank_checkpointer_from_config

    if config is not None:
        iters, eps = config.max_iters, config.eps
    discrete = _is_discrete(model)
    dev = model.device
    obs = (torch.as_tensor(obs, device=dev) if discrete
           else torch.as_tensor(obs, dtype=model.dtype, device=dev))
    obs_c, mask_c, _, _ = _local_chunk(obs, mask, mesh_axis(mesh, "seq"))
    step = make_seq_hmm_em_step(mesh) if discrete else make_seq_gmmhmm_em_step(mesh,
                                                                               model.config)
    params, history = em_loop(lambda p: step(p, obs_c, mask_c), model.params, iters, eps,
                              verbose=verbose, checkpointer=rank_checkpointer_from_config(config),
                              fmt=_FMT)
    model.set_params(params)
    return history


def train_data_parallel(model, obs, mask, mesh, iters: int = 10, eps: float = 1e-4,
                        verbose: bool = False, config=None):
    """The EM loop over a data-parallel step. ``model`` is a
    :class:`~lnasr_tpu_torch.models.gmmhmm.GMMHMM` or a discrete
    :class:`~lnasr_tpu_torch.models.hmm.HMM`; every rank passes the global
    batch ``obs (B, T[, D])`` / ``mask (B, T)`` and steps on its rows of
    the ``data`` axis (B must divide by its size). Parameters are updated
    in place, equal on every rank, and the loglik history is returned. An
    optional :class:`~lnasr_tpu_torch.config.TrainConfig` supplies the
    budget and periodic checkpoints with resume (world rank 0 writes)."""
    from lnasr_tpu_torch.utils.checkpoints import em_loop, rank_checkpointer_from_config

    if config is not None:
        iters, eps = config.max_iters, config.eps
    dev = model.device
    if _is_discrete(model):
        step = make_dp_hmm_em_step(mesh)
        obs = torch.as_tensor(obs, device=dev)  # symbol ids stay integral
    else:
        step = make_dp_gmmhmm_em_step(mesh, model.config)
        obs = torch.as_tensor(obs, dtype=model.dtype, device=dev)
    data = mesh_axis(mesh, "data")
    obs = local_rows(obs, data)
    mask = local_rows(torch.as_tensor(mask, device=dev).bool(), data)
    params, history = em_loop(lambda p: step(p, obs, mask), model.params, iters, eps,
                              verbose=verbose, checkpointer=rank_checkpointer_from_config(config),
                              fmt=_FMT)
    model.set_params(params)
    return history
