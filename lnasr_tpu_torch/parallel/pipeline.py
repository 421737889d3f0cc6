"""Pipeline parallelism: streaming stage overlap across ranks.

The decode flow (audio -> MFCC -> AM scoring -> trellis) staged across a
``stage`` mesh of any size S >= 2:

  stages 0..S-2 (frontend): each holds 1/(S-1) of the GMM mixture
                 components and adds its partial emission log-probs
                 (``logaddexp`` accumulation) as a feature chunk's buffer
                 flows down the ring, so chunk k is in stage 1 while chunk
                 k+1 is in stage 0;
  stage S-1 (decoder): the forward (or max-plus) recursion over the
                 completed emissions, optionally recording backpointers
                 for a true Viterbi decode: one launch of kernel P
                 (:func:`~lnasr_tpu_torch.ops.trellis.trellis_chunk`) a
                 chunk, and one of the walk
                 (:func:`~lnasr_tpu_torch.ops.trellis.pointer_walk`) a
                 decode.

Buffers cross ranks once per tick per stage (:func:`~lnasr_tpu_torch.
parallel.distributed.ppermute`, one (chunk, N) block each), for
``n_chunks + S - 1`` ticks. The decoder stage then publishes alpha
(``pmax``) and the backpointers (``psum``) to every rank of the world, so
ranks outside a smaller stage mesh return the same result. This is the
streaming counterpart of :mod:`lnasr_tpu_torch.parallel.seqscan`, which
needs the whole sequence up front; the pipeline needs one chunk of
lookahead.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from lnasr_tpu_torch.ops.gaussian import gmm_emissions_diag
from lnasr_tpu_torch.ops.numerics import logsumexp
from lnasr_tpu_torch.ops.trellis import pointer_walk, trellis_chunk
from lnasr_tpu_torch.parallel.distributed import Axis, local_device, pmax, ppermute, psum

N_STAGES = 2  # default mesh size (one frontend + one decoder stage)


def make_stage_mesh(n_stages: int = N_STAGES) -> DeviceMesh:
    """A ``('stage',)`` mesh over world ranks ``0 .. n_stages - 1``:
    ``n_stages - 1`` emission stages feeding one decoder stage. Every rank
    of the world calls it, members or not (``new_group`` is collective)."""
    if n_stages < 2:
        raise ValueError("pipeline needs at least 2 stages")
    if not dist.is_initialized():
        raise RuntimeError("make_stage_mesh needs a world: call "
                           "parallel.distributed.initialize first")
    if dist.get_world_size() < n_stages:
        raise ValueError(f"pipeline needs {n_stages} devices, have {dist.get_world_size()}")
    return DeviceMesh(local_device().type, list(range(n_stages)), mesh_dim_names=("stage",))


def _pad_mixtures(log_w, mu, var, n_shards: int):
    """Pad the mixture axis so it splits evenly across emission stages;
    padded components carry -inf weight (no probability mass)."""
    n, m = log_w.shape
    m_pad = -(-m // n_shards) * n_shards
    if m_pad == m:
        return log_w, mu, var, m
    pw = torch.full((n, m_pad - m), -torch.inf, dtype=log_w.dtype, device=log_w.device)
    ones = torch.ones((n, m_pad - m, mu.shape[-1]), dtype=mu.dtype, device=mu.device)
    return (torch.cat([log_w, pw], dim=1), torch.cat([mu, ones], dim=1),
            torch.cat([var, ones], dim=1), m)


def _world() -> Axis:
    return Axis("world", None, dist.get_world_size(), dist.get_rank())


def _pipeline(log_pi, log_a, log_w, mu, var, feats, mesh, chunk, semiring, want_path):
    """Shared S-stage machinery. Returns ``(alpha (N,), bt (T, N) int32)``
    on every rank; ``bt`` is all zeros when ``want_path`` is false."""
    t = feats.shape[0]
    n = log_a.shape[0]
    dtype, dev = feats.dtype, feats.device
    if chunk is None:
        chunk = t // 4 if t % 4 == 0 else t
    if t % chunk:
        raise ValueError(f"chunk {chunk} must divide T={t}")
    if semiring not in ("log", "max"):
        raise ValueError(f"unknown semiring: {semiring!r}")
    n_chunks = t // chunk
    feats3 = feats.reshape(n_chunks, chunk, -1)
    n_stages = mesh.size(0)
    n_shards = n_stages - 1
    n_ticks = n_chunks + n_stages - 1
    alpha = torch.full((n,), -torch.inf, dtype=dtype, device=dev)
    bts = torch.zeros((n_ticks, chunk, n), dtype=torch.int32, device=dev)
    coord = mesh.get_coordinate()
    if coord is not None:  # a member of the stage mesh
        idx = coord[0]
        stage = Axis("stage", mesh.get_group("stage"), n_stages, idx)
        is_first, is_last = idx == 0, idx == n_stages - 1
        log_w_p, mu_p, var_p, _ = _pad_mixtures(log_w, mu, var, n_shards)
        m_per = log_w_p.shape[1] // n_shards
        # this rank's mixture slice (the decoder stage's is unused)
        sl = slice(min(idx, n_shards - 1) * m_per, (min(idx, n_shards - 1) + 1) * m_per)
        w_s, mu_s, var_s = log_w_p[:, sl], mu_p[:, sl], var_p[:, sl]
        ring = [(i, i + 1) for i in range(n_stages - 1)]
        empty = torch.full((chunk, n), -torch.inf, dtype=dtype, device=dev)
        buf, pos = empty, 0
        for k in range(n_ticks):
            active = 0 <= k - idx < n_chunks
            if is_last:
                out = buf
                if active:  # the arrived complete emissions: one kernel P launch
                    alpha, _ = trellis_chunk(alpha, pos, log_pi, log_a, buf, semiring,
                                             want_path, bts[k])
                    pos += chunk
            else:  # inject (stage 0) or accumulate a partial
                part = (gmm_emissions_diag(feats3[k - idx], w_s, mu_s, var_s)[0].to(dtype)
                        if active else empty)
                out = torch.logaddexp(empty if is_first else buf, part)
            buf = ppermute(out, stage, ring)
        if not is_last:
            alpha = torch.full_like(alpha, -torch.inf)
    # publish the decoder stage's results to every rank of the world
    alpha = pmax(alpha, _world())
    bts = psum(bts, _world())  # zeros everywhere but the decoder
    # the decoder processes chunk k at tick k + S - 1
    return alpha, bts[n_stages - 1:].reshape(t, n)


def streaming_pipeline_scores(log_pi: torch.Tensor, log_a: torch.Tensor, log_w: torch.Tensor,
                              mu: torch.Tensor, var: torch.Tensor, feats: torch.Tensor,
                              mesh, chunk: Optional[int] = None,
                              semiring: str = "log") -> torch.Tensor:
    """Pipelined scoring of one utterance's features ``(T, D)``.

    ``semiring="log"`` returns the forward log-likelihood (=
    :func:`lnasr_tpu_torch.ops.trellis.forward_scan`'s loglik); ``"max"``
    the best-path (Viterbi) score without a backtrace, the streaming
    keyword-scoring primitive. ``chunk`` must divide T (default: T/4 when
    divisible, else T)."""
    alpha, _ = _pipeline(log_pi, log_a, log_w, mu, var, feats, mesh, chunk, semiring, False)
    return logsumexp(alpha, dim=0) if semiring == "log" else torch.amax(alpha)


def streaming_pipeline_decode(log_pi: torch.Tensor, log_a: torch.Tensor, log_w: torch.Tensor,
                              mu: torch.Tensor, var: torch.Tensor, feats: torch.Tensor,
                              mesh, chunk: Optional[int] = None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pipelined Viterbi decode: ``(path (T,) int32, best score)``, equal
    to :func:`lnasr_tpu_torch.ops.trellis.viterbi_scan` on the same
    emissions. Backpointers are recorded on the decoder stage as chunks
    stream through; the backtrace is the O(T) pointer chase, one launch
    of the walk on every rank (no copy to the host)."""
    alpha, bt = _pipeline(log_pi, log_a, log_w, mu, var, feats, mesh, chunk, "max", True)
    return pointer_walk(alpha, bt), torch.amax(alpha)
