"""HMM trellis recursions: the Baum-Welch kernel and plain PyTorch loops.

Counterparts of the JAX package's ``ops/trellis.py``:

- :func:`forward_backward`, :func:`forward_scan`, :func:`backward_scan`:
  the Baum-Welch recursions, one (+, logsumexp) matrix-vector product a
  step. For CUDA tensors they launch the hand-written kernel of
  ``csrc/forward_backward.cu`` (kernel G: both directions of a batch in
  one launch; for N <= 8 a block of warps an utterance and direction,
  time cut into chunks whose (N, N) operator products are chained and
  then replayed, else one warp or block an utterance and direction,
  lane = state: :func:`fb_route`), which does on the card what XLA does
  for the JAX package's jitted ``lax.scan``: the whole recursion in one
  launch. For CPU tensors they run the frame loops
  :func:`forward_scan_plain` and :func:`backward_scan_plain`, which the
  kernel is held to; :func:`forward_backward_chunked_plain` mirrors the
  chunked route;
  :func:`forward_assoc`, the forward pass as a log-depth Hillis-Steele
  scan over (N, N) operators; :func:`posteriors`, the E-step's ``xi`` and
  ``gamma``.
- :func:`viterbi_scan`: the max-plus trellis with first-index argmax
  backpointers and its backtrace, behind every HMM decode. For CUDA
  tensors it launches the hand-written kernel of
  ``csrc/viterbi_trellis.cu`` (kernel K: trellis and backtrace in one
  launch; a warp a sequence for N <= 32, a block for N <= 1024:
  :func:`viterbi_trellis_route`), the counterpart of the JAX package's
  jitted ``lax.scan`` pair; for CPU tensors it runs
  :func:`viterbi_scan_plain`, a T-step loop whose step is one batched
  (+, max) matrix-vector product, which the kernel is held to bitwise and
  which the Viterbi kernels B and C are held to as well
  (``ops/viterbi.py``, ``ops/viterbi_dense.py``).
- :func:`trellis_chunk` and :func:`pointer_walk`: the streaming
  pipeline's decoder stage (``parallel/pipeline.py``), the max-plus or
  log-semiring step carried over one arrived chunk of emissions from the
  previous chunk's ``alpha``, and the walk of the utterance's
  backpointers. For CUDA tensors each launches its entry of
  ``csrc/trellis_chunk.cu`` once (kernel P; the log semiring at N <= 8 as
  a product scan over pieces of the chunk, else a warp for N <= 32 and a
  block for N <= 1024: :func:`trellis_chunk_route`; the walk as a
  chunk-map backtrace for N <= 1024: :func:`walk_route`); for CPU tensors
  they run :func:`trellis_chunk_plain` and :func:`pointer_walk_plain`;
  :func:`trellis_chunk_chunked_plain` mirrors the chunked route.

Conventions: natural-log inputs; time-major emissions ``log_b[..., t, j]``;
an optional boolean ``mask[..., t]`` marks real frames, and masked steps
apply the identity operator (for Viterbi, ``v`` unchanged and backpointer
``j -> j``). Leading batch dimensions are written out instead of ``vmap``:
every op of a frame loop covers the whole batch, and no step reads a
value back to the host.
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from lnasr_tpu_torch import _build
from lnasr_tpu_torch.ops.numerics import log_matmul, logsumexp

_P = ctypes.c_void_p
_I = ctypes.c_int
# log_pi, log_a, log_b, mask, B, T, N, dirs, route, chunk, is_double, alpha,
# loglik, beta, stream
_ARGTYPES = [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P]
_FORWARD, _BACKWARD = 1, 2  # the kernel's ``dirs`` bits
SMEM_LIMIT = 232448  # bytes of shared memory one block can use on sm_90
# the kernel's ``route`` codes, in order
FB_ROUTES = ("warp", "smem", "l2", "global", "chunked")
CHUNK_MAX_N = 8  # the chunked route's states: N <= 8 (every EM model and unit)
CHUNK_WARPS = 32  # the chunked route's chunks (warps of a block), at most


def fb_chunks(t: int) -> Tuple[int, int]:
    """``(C, L)``: the chunked route cuts the ``t - 1`` steps of a
    direction into ``C`` chunks of ``L`` (the last may be shorter), one
    warp each. Its chain is ``L + C + L`` steps deep (the chunk products,
    the boundary chain, the replay), least near ``C = sqrt(2 (t - 1))``;
    at most :data:`CHUNK_WARPS` chunks, so ``L`` grows past that."""
    steps = t - 1
    if steps < 1:
        return 1, 1
    c = min(CHUNK_WARPS, max(1, round(math.sqrt(2 * steps))))
    chunk = -(-steps // c)
    return -(-steps // chunk), chunk


def fb_route(n: int, itemsize: int) -> str:
    """Kernel G's route for ``n`` states of ``itemsize`` bytes:
    ``"chunked"`` (N <= 8, every EM model and unit: a block of warps an
    utterance and direction, time cut into chunks), ``"warp"`` (N <= 32:
    one warp, lane = state), else a block of ceil(N/32) warps with the
    step's vector double-buffered and ``log_a`` in shared memory
    (``"smem"``), the vector there and ``log_a`` through L2 (``"l2"``), or
    both in device memory (``"global"``, past 2 N values of shared memory).
    Every N and T has a route."""
    if n <= CHUNK_MAX_N:
        return "chunked"
    if n <= 32:
        return "warp"
    vec, mat = 2 * n * itemsize, n * n * itemsize
    if vec + mat <= SMEM_LIMIT:
        return "smem"
    return "l2" if vec <= SMEM_LIMIT else "global"


class ForwardResult(NamedTuple):
    alpha: torch.Tensor  # (..., T, N) forward log-probabilities
    loglik: torch.Tensor  # (...) log P(O | model), from the last valid frame


def forward_scan_plain(
    log_pi: torch.Tensor,
    log_a: torch.Tensor,
    log_b: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> ForwardResult:
    """Kernel G's plain forward, a frame loop over ``log_b (..., T, N)``:
    ``alpha[t, j] = lse_i(alpha[t-1, i] + A[i, j]) + b[t, j]``; a masked
    frame keeps ``alpha`` unchanged, so ``alpha[..., -1, :]`` is the last
    valid frame's."""
    alpha = log_pi + log_b[..., 0, :]
    alphas = [alpha]
    for s in range(1, log_b.shape[-2]):
        new = logsumexp(alpha[..., :, None] + log_a, dim=-2) + log_b[..., s, :]
        if mask is not None:
            new = torch.where(mask[..., s, None], new, alpha)
        alpha = new
        alphas.append(alpha)
    return ForwardResult(alpha=torch.stack(alphas, dim=-2), loglik=logsumexp(alpha, dim=-1))


def backward_scan_plain(
    log_a: torch.Tensor,
    log_b: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Kernel G's plain backward, a frame loop: ``beta[t, i] =
    lse_j(A[i, j] + b[t+1, j] + beta[t+1, j])``, ``beta[T-1] = 0``. A masked frame t+1 propagates
    ``beta`` unchanged, so for a sequence of true length L, ``beta[:L]``
    equals the unpadded result and ``beta[L-1:]`` is zero."""
    t_len = log_b.shape[-2]
    beta = torch.zeros_like(log_b[..., 0, :])
    betas = [beta]
    for s in range(t_len - 2, -1, -1):
        new = logsumexp(log_a + (log_b[..., s + 1, :] + beta)[..., None, :], dim=-1)
        if mask is not None:
            new = torch.where(mask[..., s + 1, None], new, beta)
        beta = new
        betas.append(beta)
    return torch.stack(betas[::-1], dim=-2)


def _chunked_direction(v0, log_a, log_b, valid, fwd):
    """One direction of the chunked route over ``log_b (..., T, N)`` and
    ``valid (..., T)``: the rows it writes, in step order (step k reads
    frame k forward, T - k backward)."""
    t, n = log_b.shape[-2:]
    lead = log_b.shape[:-2]
    steps = t - 1
    c, chunk = fb_chunks(t)
    frames = (torch.arange(1, t, device=log_b.device) if fwd
              else torch.arange(t - 1, 0, -1, device=log_b.device))
    pad = c * chunk - steps
    b_st = torch.cat([log_b[..., frames, :], log_b.new_zeros(lead + (pad, n))], dim=-2)
    v_st = torch.cat([valid[..., frames], valid.new_zeros(lead + (pad,))], dim=-1)
    b_st, v_st = b_st.reshape(lead + (c, chunk, n)), v_st.reshape(lead + (c, chunk))
    # phase 1: each chunk's product from the identity; row r of R is the
    # forward's P[r, :] and the backward's Q[:, r]
    eye = torch.eye(n, dtype=torch.bool, device=log_b.device)
    r = torch.where(eye, 0.0, -torch.inf).to(log_b.dtype).expand(lead + (c, n, n))
    for q in range(chunk):
        bq = b_st[..., q, None, :]  # (..., c, 1, n): column col's emission
        if fwd:
            new = logsumexp(r[..., :, :, None] + log_a, dim=-2) + bq
        else:
            new = logsumexp((r + bq)[..., :, None, :] + log_a, dim=-1)
        r = torch.where(v_st[..., q, None, None], new, r)
    # phase 2: the boundary chain, v_{c+1}[l] = lse_k(v_c[k] + R_c[k, l])
    v, bounds = v0, []
    for ci in range(c):
        bounds.append(v)
        v = logsumexp(v[..., :, None] + r[..., ci, :, :], dim=-2)
    state = torch.stack(bounds, dim=-2)  # (..., c, n): entering each chunk
    # phase 3: each chunk replayed from its boundary, the plain loops' step
    rows = []
    for q in range(chunk):
        bq = b_st[..., q, :]
        if fwd:
            new = logsumexp(state[..., :, None] + log_a, dim=-2) + bq
        else:
            new = logsumexp(log_a + (bq + state)[..., None, :], dim=-1)
        state = torch.where(v_st[..., q, None], new, state)
        rows.append(state)
    return torch.stack(rows, dim=-2).reshape(lead + (c * chunk, n))[..., :steps, :]


def forward_backward_chunked_plain(
    log_pi: torch.Tensor,
    log_a: torch.Tensor,
    log_b: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[ForwardResult, torch.Tensor]:
    """Kernel G's chunked route in plain PyTorch (tests and
    ``chip_smoke.py`` hold the kernel and the loops to it; no caller on the
    main path): each direction's ``T - 1`` steps cut into the chunks of
    :func:`fb_chunks`, each chunk's (N, N) operator product in the
    (logsumexp, +) semiring from the identity (a masked step is the
    identity, skipped), the boundary vector carried through the products
    chunk by chunk, then each chunk replayed from its boundary with the
    plain loops' step. The same function as :func:`forward_scan_plain` and
    :func:`backward_scan_plain`, rounded in other places."""
    t = log_b.shape[-2]
    lead = log_b.shape[:-2]
    valid = (torch.ones(lead + (t,), dtype=torch.bool, device=log_b.device) if mask is None
             else torch.broadcast_to(mask, lead + (t,)))
    alpha0 = log_pi + log_b[..., 0, :]
    alpha = torch.cat([alpha0[..., None, :],
                       _chunked_direction(alpha0, log_a, log_b, valid, True)], dim=-2)
    zero = torch.zeros_like(alpha0)
    beta = torch.cat([_chunked_direction(zero, log_a, log_b, valid, False).flip(-2),
                      zero[..., None, :]], dim=-2)
    return ForwardResult(alpha=alpha, loglik=logsumexp(alpha[..., -1, :], dim=-1)), beta


def _dense(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype`` and contiguous, copied only where it is not."""
    return x if x.dtype == dtype and x.is_contiguous() else x.to(dtype).contiguous()


def _launch(log_pi, log_a, log_b, mask, dirs, route=None):
    """Kernel G on the card: ``(alpha, loglik, beta)``, each ``None`` for a
    direction not in ``dirs``. Leading batch dimensions of ``log_b`` (and
    ``mask``) are flattened; ``log_pi``/``log_a`` are shared by the batch.
    ``route`` overrides :func:`fb_route` (any block route runs any N, the
    chunked route N <= 8 at any T; the warp route needs N <= 32). Every
    check reads shapes, dtypes and devices only: nothing waits on the card,
    and an input already in its dtype and contiguous is passed as it is."""
    dev = log_b.device
    if log_b.dim() < 2:
        raise ValueError(f"log_b must be (..., T, N), got shape {tuple(log_b.shape)}")
    lead, (t, n) = tuple(log_b.shape[:-2]), tuple(log_b.shape[-2:])
    if log_a.shape != (n, n) or (log_pi is not None and log_pi.shape != (n,)):
        raise ValueError(f"the forward-backward kernel takes log_a (N, N) and log_pi (N,) shared "
                         f"by the batch; got N={n}, log_a {tuple(log_a.shape)}"
                         + ("" if log_pi is None else f", log_pi {tuple(log_pi.shape)}"))
    if t < 1:
        raise ValueError("the forward-backward kernel needs at least one frame")
    dtype = log_b.dtype if log_pi is None else torch.promote_types(log_pi.dtype, log_b.dtype)
    dtype = torch.promote_types(dtype, log_a.dtype)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the forward-backward kernel takes float32 or float64, got {dtype}")
    for name, x in (("log_pi", log_pi), ("log_a", log_a), ("mask", mask)):
        if x is not None and x.device != dev:
            raise ValueError(f"{name} is on {x.device}, log_b on {dev}")
    route = fb_route(n, dtype.itemsize) if route is None else route
    if (route not in FB_ROUTES or (route == "warp" and n > 32)
            or (route == "chunked" and n > CHUNK_MAX_N)):
        raise ValueError(f"no route {route!r} of the forward-backward kernel at N={n}")
    b = math.prod(lead)
    shape = lead + (t, n)
    fwd, bwd = bool(dirs & _FORWARD), bool(dirs & _BACKWARD)
    alpha = torch.empty(shape, dtype=dtype, device=dev) if fwd else None
    loglik = torch.empty(lead, dtype=dtype, device=dev) if fwd else None
    beta = torch.empty(shape, dtype=dtype, device=dev) if bwd else None
    if b > 0:
        m = None if mask is None else _dense(torch.broadcast_to(mask, lead + (t,)), torch.bool)
        lb, a = _dense(log_b, dtype), _dense(log_a, dtype)
        pi = _dense(log_pi, dtype) if fwd else None
        ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
        chunk = fb_chunks(t)[1] if route == "chunked" else 0
        lib = _build.load("forward_backward", _ARGTYPES)
        with torch.cuda.device(dev):  # launch on the tensors' card
            rc = lib.forward_backward_launch(
                ptr(pi), a.data_ptr(), lb.data_ptr(), ptr(m), b, t, n, dirs,
                FB_ROUTES.index(route), chunk, int(dtype == torch.float64), ptr(alpha),
                ptr(loglik), ptr(beta), torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, "forward_backward", rc)
        forward_backward.launches += 1
    return alpha, loglik, beta


def _on_cuda(log_b: torch.Tensor) -> bool:
    if log_b.device.type == "cpu":
        return False
    if log_b.device.type != "cuda":
        raise ValueError(f"the trellis recursions run on cpu or cuda tensors, got {log_b.device}")
    return True


def forward_backward(
    log_pi: torch.Tensor,
    log_a: torch.Tensor,
    log_b: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[ForwardResult, torch.Tensor]:
    """``(ForwardResult(alpha, loglik), beta)`` of ``log_b (..., T, N)``:
    the E-step's two recursions. CUDA tensors launch kernel G once for both
    (float32 or float64; ``log_pi (N,)``/``log_a (N, N)`` shared by the
    batch, anything else raises); CPU tensors run the plain loops."""
    if not _on_cuda(log_b):
        return (forward_scan_plain(log_pi, log_a, log_b, mask),
                backward_scan_plain(log_a, log_b, mask))
    alpha, loglik, beta = _launch(log_pi, log_a, log_b, mask, _FORWARD | _BACKWARD)
    return ForwardResult(alpha=alpha, loglik=loglik), beta


forward_backward.launches = 0  # kernel G launches; plain CPU calls do not count


def forward_scan(
    log_pi: torch.Tensor,
    log_a: torch.Tensor,
    log_b: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> ForwardResult:
    """Forward algorithm over ``log_b (..., T, N)``:
    ``alpha[t, j] = lse_i(alpha[t-1, i] + A[i, j]) + b[t, j]``; a masked
    frame keeps ``alpha`` unchanged, so ``alpha[..., -1, :]`` is the last
    valid frame's. Kernel G's forward alone on CUDA tensors, the plain loop
    on CPU ones."""
    if not _on_cuda(log_b):
        return forward_scan_plain(log_pi, log_a, log_b, mask)
    alpha, loglik, _ = _launch(log_pi, log_a, log_b, mask, _FORWARD)
    return ForwardResult(alpha=alpha, loglik=loglik)


def backward_scan(
    log_a: torch.Tensor,
    log_b: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Backward algorithm: ``beta[t, i] = lse_j(A[i, j] + b[t+1, j] +
    beta[t+1, j])``, ``beta[T-1] = 0``. A masked frame t+1 propagates
    ``beta`` unchanged, so for a sequence of true length L, ``beta[:L]``
    equals the unpadded result and ``beta[L-1:]`` is zero. Kernel G's
    backward alone on CUDA tensors, the plain loop on CPU ones."""
    if not _on_cuda(log_b):
        return backward_scan_plain(log_a, log_b, mask)
    return _launch(None, log_a, log_b, mask, _BACKWARD)[2]


def forward_assoc(
    log_pi: torch.Tensor,
    log_a: torch.Tensor,
    log_b: torch.Tensor,
) -> ForwardResult:
    """Forward algorithm as a scan over the step operators ``M_t[i, j] =
    A[i, j] + b[t, j]``, composed by (+, logsumexp) matmul: an inclusive
    Hillis-Steele scan, ceil(log2 T) passes (pass k composes every prefix
    with the one 2^k steps before it). O(T N^3 log T) work; the JAX
    package's ``lax.associative_scan`` combines in another tree, so the two
    agree to rounding."""
    alpha0 = log_pi + log_b[..., 0, :]
    prefix = log_a[..., None, :, :] + log_b[..., 1:, None, :]  # (..., T-1, N, N)
    steps = prefix.shape[-3]
    d = 1
    while d < steps:
        prefix = torch.cat([prefix[..., :d, :, :],
                            log_matmul(prefix[..., :-d, :, :], prefix[..., d:, :, :])], dim=-3)
        d *= 2
    alphas = logsumexp(alpha0[..., None, :, None] + prefix, dim=-2)
    alpha = torch.cat([alpha0[..., None, :], alphas], dim=-2)
    return ForwardResult(alpha=alpha, loglik=logsumexp(alpha[..., -1, :], dim=-1))


def posteriors(
    alpha: torch.Tensor,
    beta: torch.Tensor,
    log_a: torch.Tensor,
    log_b: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Baum-Welch E-step quantities ``xi (..., T, N, N)`` and ``gamma (...,
    T, N)``, with the JAX package's estimator: each ``xi[t]`` is normalized
    by its own log-sum over (i, j); ``xi[T-1]`` is all -inf; ``gamma =
    lse_j(xi)``, so the final frame carries no occupancy mass. With a
    ``mask``, transitions into masked frames are -inf."""
    numer = (alpha[..., :-1, :, None] + log_a + log_b[..., 1:, None, :]
             + beta[..., 1:, None, :])
    denom = logsumexp(numer.flatten(-2), dim=-1)
    xi_body = numer - denom[..., None, None]
    if mask is not None:
        xi_body = torch.where(mask[..., 1:, None, None], xi_body, -torch.inf)
    last = torch.full_like(xi_body[..., :1, :, :], -torch.inf)
    xi = torch.cat([xi_body, last], dim=-3)
    return xi, logsumexp(xi, dim=-1)


class ViterbiResult(NamedTuple):
    scores: torch.Tensor  # (..., T, N) Viterbi trellis
    backptr: torch.Tensor  # (..., T, N) int32 argmax predecessors (row 0 zeros)
    path: torch.Tensor  # (..., T) int32 best state sequence
    score: torch.Tensor  # (...) best final log-score


def viterbi_scan_plain(
    log_pi: torch.Tensor,
    log_a: torch.Tensor,
    log_b: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    log_final: Optional[torch.Tensor] = None,
) -> ViterbiResult:
    """Kernel K's plain version: the max-plus trellis over ``log_b (..., T,
    N)`` as a T-step loop, then the backtrace as T - 1 gathers.

    A step is ``v'[j] = max_i(v[i] + A[i, j]) + b[t, j]``, the max taken
    first, with the first ``i`` that reaches it as the backpointer (ties
    pick the first index, as ``jnp.argmax`` does); a masked frame keeps
    ``v`` and points every state to itself. ``log_final (N,)`` adds
    per-state termination weights before the final argmax; the reported
    ``score`` includes it. Paths and scores are bitwise those of the JAX
    scan on the same inputs."""
    t, n = log_b.shape[-2:]
    states = torch.arange(n, dtype=torch.int32, device=log_b.device)
    v = log_pi + log_b[..., 0, :]
    scores = [v]
    backptr = [torch.zeros_like(v, dtype=torch.int32)]
    for s in range(1, t):
        cand = v[..., :, None] + log_a  # cand[..., i, j]
        best, arg = torch.max(cand, dim=-2)
        new_v = best + log_b[..., s, :]
        arg = arg.to(torch.int32)
        if mask is not None:
            valid = mask[..., s, None]
            new_v = torch.where(valid, new_v, v)
            arg = torch.where(valid, arg, states)
        v = new_v
        scores.append(v)
        backptr.append(arg)
    scores = torch.stack(scores, dim=-2)
    backptr = torch.stack(backptr, dim=-2)

    v_final = v if log_final is None else v + log_final
    score, last = torch.max(v_final, dim=-1)
    path = [last.to(torch.int32)]
    for s in range(t - 1, 0, -1):
        prev = torch.gather(backptr[..., s, :], -1, path[-1][..., None].long())[..., 0]
        path.append(prev)
    path = torch.stack(path[::-1], dim=-1)
    return ViterbiResult(scores=scores, backptr=backptr, path=path, score=score)


# kernel K (csrc/viterbi_trellis.cu): its routes, in the order of its codes
VITERBI_ROUTES = ("warp", "block")
VITERBI_MAX_N = 1024  # the block route's threads: one a target state
VITERBI_CHUNK = 32  # the backtrace's chunk of steps, while the maps fit
VITERBI_BP_SMEM = 48 * 1024  # warp route: T * N int8 backpointers kept on chip, at most
# bytes of int16 chunk maps and chunk ends a sequence keeps in shared memory
VITERBI_MAP_BYTES = {"warp": 16 * 1024, "block": 96 * 1024}
# log_pi, log_a, log_b, mask, log_final, B, T, N, route, on_chip, n_chunks,
# chunk, is_double, scores, backptr, path, score, stream
_VITERBI_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P, _P, _P, _P]


def viterbi_trellis_route(n: int) -> str:
    """Kernel K's route for ``n`` states: ``"warp"`` for N <= 32 (a warp a
    sequence, lane = state), ``"block"`` for 33 <= N <= 1024 (a block a
    sequence, a thread a target state, ``v`` double-buffered in shared
    memory); past that the kernel has no route and this raises."""
    if n < 1:
        raise ValueError(f"the Viterbi trellis kernel needs at least one state, got N={n}")
    if n <= 32:
        return "warp"
    if n <= VITERBI_MAX_N:
        return "block"
    raise ValueError(f"the Viterbi trellis kernel takes N <= {VITERBI_MAX_N} states (a thread a "
                     f"target state), got N={n}")


def viterbi_chunks(t: int, n: int, route: str) -> Tuple[int, int]:
    """``(C, K)``: kernel K's backtrace cuts the ``t - 1`` steps into ``C``
    chunks of ``K`` (the last may be shorter). ``C`` is ``ceil((t - 1) /
    32)`` while the chunks' int16 maps ``(C, N)`` and ends ``(C,)`` fit in
    :data:`VITERBI_MAP_BYTES` of the route, so ``K`` is at most
    :data:`VITERBI_CHUNK`; past that ``C`` stays at what fits and ``K``
    grows.
    No step: ``(0, 1)``."""
    steps = t - 1
    if steps < 1:
        return 0, 1
    cap = max(1, VITERBI_MAP_BYTES[route] // (2 * (n + 1)))
    c = min(-(-steps // VITERBI_CHUNK), cap)
    k = -(-steps // c)
    return -(-steps // k), k


def viterbi_on_chip(t: int, n: int, route: str) -> bool:
    """Whether kernel K's backtrace reads int8 backpointers it kept in
    shared memory (the warp route, where ``T * N`` bytes fit) rather than
    the int32 ``backptr`` output in device memory."""
    return route == "warp" and t * n <= VITERBI_BP_SMEM


def _viterbi_launch(log_pi, log_a, log_b, mask=None, log_final=None, route=None, on_chip=None):
    """Kernel K on the card: :class:`ViterbiResult` of ``log_b (..., T,
    N)``, leading dimensions flattened; ``log_pi (N,)``, ``log_a (N, N)``
    and ``log_final (N,)`` shared by the batch, ``mask (..., T)``
    broadcast. The inputs promote as the plain loop's arithmetic does
    (float32 or float64; a ``log_final`` wider than that raises). ``route``
    overrides :func:`viterbi_trellis_route` (the block route runs any N up
    to 1024, the warp route N <= 32); ``on_chip`` overrides
    :func:`viterbi_on_chip` (``False``: the backtrace reads the int32
    output; ``True`` where the rule does not allow it raises). Every check
    reads shapes, dtypes and devices only: nothing waits on the card."""
    dev = log_b.device
    if log_b.dim() < 2:
        raise ValueError(f"log_b must be (..., T, N), got shape {tuple(log_b.shape)}")
    lead, (t, n) = tuple(log_b.shape[:-2]), tuple(log_b.shape[-2:])
    if (log_a.shape != (n, n) or log_pi.shape != (n,)
            or (log_final is not None and log_final.shape != (n,))):
        raise ValueError(f"the Viterbi trellis kernel takes log_pi (N,), log_a (N, N) and "
                         f"log_final (N,) shared by the batch; got N={n}, log_pi "
                         f"{tuple(log_pi.shape)}, log_a {tuple(log_a.shape)}"
                         + ("" if log_final is None else f", log_final {tuple(log_final.shape)}"))
    if t < 1:
        raise ValueError("the Viterbi trellis kernel needs at least one frame")
    dtype = torch.promote_types(torch.promote_types(log_pi.dtype, log_a.dtype), log_b.dtype)
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the Viterbi trellis kernel takes float32 or float64, got {dtype}")
    if log_final is not None and torch.promote_types(dtype, log_final.dtype) != dtype:
        raise ValueError(f"log_final is {log_final.dtype}, wider than the trellis' {dtype}")
    for name, x in (("log_pi", log_pi), ("log_a", log_a), ("mask", mask),
                    ("log_final", log_final)):
        if x is not None and x.device != dev:
            raise ValueError(f"{name} is on {x.device}, log_b on {dev}")
    route = viterbi_trellis_route(n) if route is None else route
    if route not in VITERBI_ROUTES or (route == "warp" and n > 32) or n > VITERBI_MAX_N:
        raise ValueError(f"no route {route!r} of the Viterbi trellis kernel at N={n}")
    fits = viterbi_on_chip(t, n, route)
    if on_chip and not fits:
        raise ValueError(f"kernel K's {route} route cannot keep T={t} x N={n} backpointers on chip")
    on_chip = fits if on_chip is None else on_chip
    b = math.prod(lead)
    scores = torch.empty(lead + (t, n), dtype=dtype, device=dev)
    backptr = torch.empty(lead + (t, n), dtype=torch.int32, device=dev)
    path = torch.empty(lead + (t,), dtype=torch.int32, device=dev)
    score = torch.empty(lead, dtype=dtype, device=dev)
    if b > 0:
        m = None if mask is None else _dense(torch.broadcast_to(mask, lead + (t,)), torch.bool)
        pi, a, lb = _dense(log_pi, dtype), _dense(log_a, dtype), _dense(log_b, dtype)
        lf = None if log_final is None else _dense(log_final, dtype)
        n_chunks, chunk = viterbi_chunks(t, n, route)
        lib = _build.load("viterbi_trellis", _VITERBI_ARGTYPES)
        with torch.cuda.device(dev):  # launch on the tensors' card
            rc = lib.viterbi_trellis_launch(
                pi.data_ptr(), a.data_ptr(), lb.data_ptr(), None if m is None else m.data_ptr(),
                None if lf is None else lf.data_ptr(), b, t, n, VITERBI_ROUTES.index(route),
                int(on_chip), n_chunks, chunk, int(dtype == torch.float64),
                scores.data_ptr(), backptr.data_ptr(), path.data_ptr(), score.data_ptr(),
                torch.cuda.current_stream(dev).cuda_stream)
        _build.check(lib, "viterbi_trellis", rc)
        viterbi_scan.launches += 1
        viterbi_scan.route_launches[route] += 1
    return ViterbiResult(scores=scores, backptr=backptr, path=path, score=score)


def viterbi_scan(
    log_pi: torch.Tensor,
    log_a: torch.Tensor,
    log_b: torch.Tensor,
    mask: Optional[torch.Tensor] = None,
    log_final: Optional[torch.Tensor] = None,
) -> ViterbiResult:
    """Max-plus trellis and backtrace over ``log_b (..., T, N)``: the
    trellis ``scores``, int32 ``backptr`` (row 0 zeros), int32 ``path`` and
    the best final ``score``, with the semantics of
    :func:`viterbi_scan_plain` (masked frames keep ``v`` and point to
    themselves; ``log_final (N,)`` is added before the final argmax; ties
    pick the first index). CUDA tensors launch kernel K once (float32 or
    float64, N <= 1024, ``log_pi``/``log_a``/``log_final`` shared by the
    batch; anything else raises), CPU tensors run the plain loop."""
    if not _on_cuda(log_b):
        return viterbi_scan_plain(log_pi, log_a, log_b, mask, log_final)
    return _viterbi_launch(log_pi, log_a, log_b, mask, log_final)


viterbi_scan.launches = 0  # kernel K launches; plain CPU calls do not count
viterbi_scan.route_launches = dict.fromkeys(VITERBI_ROUTES, 0)  # the same, by route


def trellis_chunk_plain(
    alpha: torch.Tensor,
    pos: int,
    log_pi: torch.Tensor,
    log_a: torch.Tensor,
    log_b: torch.Tensor,
    semiring: str = "max",
    want_path: bool = False,
    bt: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel P's plain version: the streaming pipeline's decoder stage
    over one arrived chunk ``log_b (chunk, N)`` whose row 0 is frame
    ``pos`` of the utterance, from the carried ``alpha (N,)``. Returns
    ``(alpha_out (N,), bt (chunk, N) int32)``.

    Frame 0 gives ``log_pi + log_b[0]`` and the pointers ``arange(N)``;
    every other frame ``amax`` (``semiring="max"``) or ``logsumexp``
    (``"log"``) over ``i`` of ``alpha[i] + log_a[i, j]``, plus the
    emission, with the first ``i`` reaching the maximum as the pointer.
    The pointer rows are written into ``bt`` where it is given (the
    caller's slice of the utterance's backpointers), else into a new
    zeroed tensor; with ``want_path=False`` they are left as they are."""
    if bt is None:
        bt = torch.zeros(log_b.shape, dtype=torch.int32, device=log_b.device)
    states = torch.arange(log_b.shape[-1], dtype=torch.int32, device=log_b.device)
    for r, log_bt in enumerate(log_b):
        if pos + r == 0:
            alpha = log_pi + log_bt
            if want_path:
                bt[r] = states
            continue
        scores = alpha[:, None] + log_a
        adv = logsumexp(scores, dim=0) if semiring == "log" else torch.amax(scores, dim=0)
        alpha = adv + log_bt
        if want_path:
            bt[r] = torch.argmax(scores, dim=0).to(torch.int32)
    return alpha, bt


def pointer_walk_plain(alpha: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """The walk's plain version: the ``(T,)`` int32 path from the first
    argmax of ``alpha (N,)`` down the pointers ``bt (T, N)``,
    ``path[t] = bt[t + 1][path[t + 1]]``, as a host loop after one copy;
    the path is returned on ``bt``'s device."""
    rows = bt.cpu().numpy()
    path = np.empty(rows.shape[0], np.int32)
    path[-1] = int(torch.argmax(alpha))
    for s in range(rows.shape[0] - 2, -1, -1):
        path[s] = rows[s + 1, path[s + 1]]
    return torch.as_tensor(path, device=bt.device)


def stage_pieces(steps: int) -> Tuple[int, int]:
    """``(C, L)``: kernel P's chunked route cuts a chunk's ``steps`` stepped
    rows into ``C`` pieces of ``L`` (the last may be shorter), one warp
    each. Its chain is ``L + C`` steps deep (the pieces' products, then
    ``alpha`` through them), least near ``C = sqrt(steps)``; at most
    :data:`STAGE_MAX_PIECES` pieces, so ``L`` grows past that. No step:
    ``(1, 1)``, a piece with no row."""
    if steps < 1:
        return 1, 1
    c = min(STAGE_MAX_PIECES, max(1, round(math.sqrt(steps))))
    piece = -(-steps // c)
    return -(-steps // piece), piece


def trellis_chunk_chunked_plain(
    alpha: torch.Tensor,
    pos: int,
    log_pi: torch.Tensor,
    log_a: torch.Tensor,
    log_b: torch.Tensor,
    want_path: bool = False,
    bt: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Kernel P's chunked route (the log semiring) in plain PyTorch (tests
    and ``chip_smoke.py`` hold the kernel and the frame loop to it; no
    caller on the main path): the chunk's stepped rows (rows 1... where
    row 0 is frame 0, whose ``alpha`` is ``log_pi + log_b[0]`` in the
    working type) cut into the pieces of :func:`stage_pieces`, each
    piece's (N, N) operator product ``M_r[i, j] = log_a[i, j] +
    log_b[r, j]`` in the (logsumexp, +) semiring from the identity, then
    ``alpha`` carried through the products piece by piece; every value in
    float64, ``alpha_out`` rounded to the working type once. With
    ``want_path`` each piece is replayed from the ``alpha`` entering it and
    the pointer is the first argmax of the candidates formed in the
    working type from that ``alpha`` rounded to it. The function of
    :func:`trellis_chunk_plain` with ``semiring="log"``, rounded in other
    places; returns ``(alpha_out (N,), bt (chunk, N) int32)`` as it does."""
    dtype = torch.promote_types(torch.promote_types(alpha.dtype, log_pi.dtype),
                                torch.promote_types(log_a.dtype, log_b.dtype))
    dev, f64 = log_b.device, torch.float64
    chunk, n = log_b.shape
    if bt is None:
        bt = torch.zeros((chunk, n), dtype=torch.int32, device=dev)
    first = 1 if pos == 0 else 0
    v = (log_pi.to(dtype) + log_b[0].to(dtype)) if first else alpha.to(dtype)
    v, a, a_w = v.to(f64), log_a.to(f64), log_a.to(dtype)
    c, piece = stage_pieces(chunk - first)
    pad = c * piece - (chunk - first)
    b = torch.cat([log_b[first:].to(f64), log_b.new_zeros((pad, n), dtype=f64)])
    real = torch.arange(c * piece, device=dev) < chunk - first
    b, real = b.reshape(c, piece, n), real.reshape(c, piece)
    # phase 1: each piece's product from the identity (a padding row skipped)
    eye = torch.eye(n, dtype=torch.bool, device=dev)
    prod = torch.where(eye, 0.0, -torch.inf).to(f64).expand(c, n, n)
    for q in range(piece):
        new = logsumexp(prod[..., :, :, None] + a, dim=-2) + b[:, q, None, :]
        prod = torch.where(real[:, q, None, None], new, prod)
    # phase 2: alpha through the products
    bounds = []
    for ci in range(c):
        bounds.append(v)
        v = logsumexp(v[:, None] + prod[ci], dim=0)
    if want_path:  # phase 3: each piece replayed from its boundary
        if first:
            bt[0] = torch.arange(n, dtype=torch.int32, device=dev)
        state, rows = torch.stack(bounds), []
        for q in range(piece):
            rows.append(torch.argmax(state.to(dtype)[:, :, None] + a_w, dim=-2).to(torch.int32))
            state = logsumexp(state[:, :, None] + a, dim=-2) + b[:, q, :]
        bt[first:] = torch.stack(rows, dim=1).reshape(c * piece, n)[:chunk - first]
    return v.to(dtype), bt


# kernel P (csrc/trellis_chunk.cu): its semirings, in the order of their codes
STAGE_SEMIRINGS = ("max", "log")
STAGE_ROUTES = ("warp", "block", "chunked")  # kernel P's routes, in the order of their codes
STAGE_MAX_N = 1024  # the block route's threads: one a target state
STAGE_MAX_PIECES = 32  # the chunked route's pieces (warps of its block), at most
WALK_ROUTES = ("maps", "chase")  # the walk's routes, in the order of their codes
WALK_MAX_N = 1024  # the map route's states (int16 maps)
WALK_MAP_BYTES = 48 * 1024  # the map route's int16 chunk maps and ends, at most
WALK_ROWS_BYTES = 160 * 1024  # the map route's int16 copy of the pointer rows, at most
# alpha, pos0, log_pi, log_a, log_b, chunk, N, semiring, route, piece,
# is_double, alpha_out, bt, stream
_CHUNK_ARGTYPES = [_P, _I, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P, _P]
# alpha, N, bt, T, route, n_chunks, piece, staged, is_double, path, stream
_WALK_ARGTYPES = [_P, _I, _P, _I, _I, _I, _I, _I, _I, _P, _P]


def trellis_chunk_route(n: int, semiring: str = "max") -> str:
    """Kernel P's route for ``n`` states in ``semiring``: ``"chunked"`` for
    the log semiring at N <= :data:`CHUNK_MAX_N` (the chunk's rows cut into
    pieces whose operator products are chained, :func:`stage_pieces`),
    else ``"warp"`` for N <= 32 (lane = target state, ``alpha`` exchanged
    by shuffles) and ``"block"`` for 33 <= N <= 1024 (a thread a target
    state); past that it raises."""
    if not 1 <= n <= STAGE_MAX_N:
        raise ValueError(f"the decoder-stage kernel takes 1 <= N <= {STAGE_MAX_N} states (a "
                         f"thread a target state), got N={n}")
    if semiring == "log" and n <= CHUNK_MAX_N:
        return "chunked"
    return "warp" if n <= 32 else "block"


def walk_route(n: int) -> str:
    """The walk's route for ``n`` states: ``"maps"`` for N <=
    :data:`WALK_MAX_N` (the chunk-map backtrace, :func:`walk_chunks`),
    else ``"chase"`` (one thread through memory). Every N has a route."""
    return "maps" if n <= WALK_MAX_N else "chase"


def walk_chunks(t: int, n: int) -> Tuple[int, int]:
    """``(C, L)``: the walk's map route cuts the ``t - 1`` pointer rows into
    ``C`` chunks of ``L`` (the last may be shorter). Its chain is ``2 L +
    C`` deep (the chunk walks, the maps' composition, the walks again),
    least near ``C = sqrt(2 (t - 1))``, while the int16 maps ``(C, N)`` and
    ends ``(C,)`` fit in :data:`WALK_MAP_BYTES`; past that ``L`` grows.
    No row: ``(0, 1)``."""
    steps = t - 1
    if steps < 1:
        return 0, 1
    cap = max(1, WALK_MAP_BYTES // (2 * (n + 1)))
    c = min(cap, max(1, round(math.sqrt(2 * steps))))
    piece = -(-steps // c)
    return -(-steps // piece), piece


def walk_staged(t: int, n: int) -> bool:
    """Whether the map route copies the ``(t, n)`` pointer rows into shared
    memory as int16 (where they fit in :data:`WALK_ROWS_BYTES`) rather than
    reading the int32 input through L1."""
    return 2 * t * n <= WALK_ROWS_BYTES


def _chunk_library():
    lib = _build.load("trellis_chunk", _CHUNK_ARGTYPES)
    lib.pointer_walk_launch.argtypes = _WALK_ARGTYPES
    lib.pointer_walk_launch.restype = ctypes.c_int
    return lib


def _chunk_launch(alpha, pos, log_pi, log_a, log_b, semiring, want_path, bt, route=None):
    """Kernel P on the card (see :func:`trellis_chunk`). ``route``
    overrides :func:`trellis_chunk_route` (the block route runs any N up to
    1024, the warp route N <= 32, the chunked route the log semiring at
    N <= 8). Every check reads shapes, dtypes and devices only: nothing
    waits on the card."""
    dev = log_b.device
    if log_b.dim() != 2 or log_b.shape[0] < 1:
        raise ValueError(f"the decoder-stage kernel takes log_b (chunk, N) with chunk >= 1, got "
                         f"shape {tuple(log_b.shape)}")
    chunk, n = tuple(log_b.shape)
    if semiring not in STAGE_SEMIRINGS:
        raise ValueError(f"unknown semiring: {semiring!r}")
    route = trellis_chunk_route(n, semiring) if route is None else route
    if (route not in STAGE_ROUTES or not 1 <= n <= STAGE_MAX_N or (route == "warp" and n > 32)
            or (route == "chunked" and (semiring != "log" or n > CHUNK_MAX_N))):
        raise ValueError(f"no route {route!r} of the decoder-stage kernel at N={n} in the "
                         f"{semiring} semiring")
    if alpha.shape != (n,) or log_pi.shape != (n,) or log_a.shape != (n, n):
        raise ValueError(f"the decoder-stage kernel takes alpha (N,), log_pi (N,) and log_a "
                         f"(N, N); got N={n}, alpha {tuple(alpha.shape)}, log_pi "
                         f"{tuple(log_pi.shape)}, log_a {tuple(log_a.shape)}")
    if not 0 <= pos < 2 ** 31:
        raise ValueError(f"the chunk's first frame must be in [0, 2**31), got {pos}")
    dtype = torch.promote_types(torch.promote_types(alpha.dtype, log_pi.dtype),
                                torch.promote_types(log_a.dtype, log_b.dtype))
    if dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the decoder-stage kernel takes float32 or float64, got {dtype}")
    for name, x in (("alpha", alpha), ("log_pi", log_pi), ("log_a", log_a), ("bt", bt)):
        if x is not None and x.device != dev:
            raise ValueError(f"{name} is on {x.device}, log_b on {dev}")
    if bt is None:
        bt = torch.zeros((chunk, n), dtype=torch.int32, device=dev)
    elif bt.shape != (chunk, n) or bt.dtype != torch.int32 or not bt.is_contiguous():
        raise ValueError(f"bt must be a contiguous int32 (chunk, N) = {(chunk, n)} tensor, got "
                         f"{bt.dtype} {tuple(bt.shape)}")
    out = torch.empty((n,), dtype=dtype, device=dev)
    piece = stage_pieces(chunk - (pos == 0))[1] if route == "chunked" else 0
    # the inputs in the working type, held until the launch is queued
    v, pi, a, lb = (_dense(x, dtype) for x in (alpha, log_pi, log_a, log_b))
    lib = _chunk_library()
    with torch.cuda.device(dev):  # launch on the tensors' card
        rc = lib.trellis_chunk_launch(
            v.data_ptr(), pos, pi.data_ptr(), a.data_ptr(), lb.data_ptr(), chunk, n,
            STAGE_SEMIRINGS.index(semiring), STAGE_ROUTES.index(route), piece,
            int(dtype == torch.float64), out.data_ptr(), bt.data_ptr() if want_path else None,
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "trellis_chunk", rc)
    trellis_chunk.launches += 1
    trellis_chunk.route_launches[route] += 1
    return out, bt


def trellis_chunk(
    alpha: torch.Tensor,
    pos: int,
    log_pi: torch.Tensor,
    log_a: torch.Tensor,
    log_b: torch.Tensor,
    semiring: str = "max",
    want_path: bool = False,
    bt: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The streaming pipeline's decoder stage over one arrived chunk, with
    the semantics of :func:`trellis_chunk_plain`: ``(alpha_out (N,), bt
    (chunk, N) int32)``, the pointer rows written into ``bt`` where it is
    given. CUDA tensors launch kernel P once (float32 or float64, N <=
    1024, a contiguous int32 ``bt``; anything else raises) on the route of
    :func:`trellis_chunk_route`, CPU tensors run the plain loop."""
    if not _on_cuda(log_b):
        return trellis_chunk_plain(alpha, pos, log_pi, log_a, log_b, semiring, want_path, bt)
    return _chunk_launch(alpha, pos, log_pi, log_a, log_b, semiring, want_path, bt)


trellis_chunk.launches = 0  # kernel P launches; plain CPU calls do not count
trellis_chunk.route_launches = dict.fromkeys(STAGE_ROUTES, 0)  # the same, by route


def _walk_launch(alpha, bt, route=None):
    """The walk on the card (see :func:`pointer_walk`). ``route`` overrides
    :func:`walk_route` (the chase runs any N, the map route N <= 1024).
    Every check reads shapes, dtypes and devices only."""
    dev = bt.device
    if bt.dim() != 2 or bt.shape[0] < 1 or bt.dtype != torch.int32:
        raise ValueError(f"the walk takes int32 bt (T, N) with T >= 1, got {bt.dtype} "
                         f"{tuple(bt.shape)}")
    t, n = tuple(bt.shape)
    if alpha.shape != (n,) or alpha.device != dev:
        raise ValueError(f"the walk takes alpha (N,) = ({n},) on {dev}, got "
                         f"{tuple(alpha.shape)} on {alpha.device}")
    if alpha.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"the walk takes float32 or float64 alpha, got {alpha.dtype}")
    route = walk_route(n) if route is None else route
    if route not in WALK_ROUTES or (route == "maps" and n > WALK_MAX_N):
        raise ValueError(f"no route {route!r} of the walk at N={n}")
    n_chunks, piece = walk_chunks(t, n) if route == "maps" else (0, 1)
    staged = route == "maps" and walk_staged(t, n)
    path = torch.empty((t,), dtype=torch.int32, device=dev)
    alpha, bt = alpha.contiguous(), bt.contiguous()  # held until the launch is queued
    lib = _chunk_library()
    with torch.cuda.device(dev):
        rc = lib.pointer_walk_launch(alpha.data_ptr(), n, bt.data_ptr(), t,
                                     WALK_ROUTES.index(route), n_chunks, piece, int(staged),
                                     int(alpha.dtype == torch.float64), path.data_ptr(),
                                     torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "trellis_chunk", rc)
    pointer_walk.launches += 1
    pointer_walk.route_launches[route] += 1
    return path


def pointer_walk(alpha: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """The ``(T,)`` int32 path of :func:`pointer_walk_plain`. CUDA tensors
    launch the walk of ``csrc/trellis_chunk.cu`` once on the route of
    :func:`walk_route` (float32 or float64 ``alpha (N,)``, int32 ``bt (T,
    N)``, T >= 1; anything else raises), with no copy to the host and no
    wait; CPU tensors run the plain loop."""
    if not _on_cuda(bt):
        return pointer_walk_plain(alpha, bt)
    return _walk_launch(alpha, bt)


pointer_walk.launches = 0  # walk launches; plain CPU calls do not count
pointer_walk.route_launches = dict.fromkeys(WALK_ROUTES, 0)  # the same, by route
