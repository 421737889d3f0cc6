"""Linear recurrences (IIR filters) as log-depth scans.

The port of the JAX package's ``ops/lfilter.py``. A linear recurrence is
an affine map on its state, and affine maps compose associatively, so an
IIR filter over T samples runs in ceil(log2 T) passes of whole-signal
tensor ops instead of T sequential steps. Torch has no
``associative_scan``; each function here is an inclusive Hillis-Steele
scan: pass k combines every element with the running result 2^k places
before it.

- :func:`first_order_recurrence`: h[t] = a[t] * h[t-1] + b[t]
- :func:`affine_recurrence`: h[t] = A[t] @ h[t-1] + u[t] for a small state
- :func:`allpass2`: the second-order allpass section (state stride 2) of
  the WebRTC-style VAD's QMF/halfband split filters
- :func:`biquad`: the direct-form-I biquad, as a 2x2 affine recurrence

The scans combine in another order than the JAX package's tree, so
results agree to rounding, not bitwise.
"""

from __future__ import annotations

from typing import Tuple

import torch


def first_order_recurrence(a, b: torch.Tensor, h0) -> torch.Tensor:
    """Solve h[t] = a[t] * h[t-1] + b[t] (h[-1] = h0) along dim 0.

    ``b`` is ``(T, ...)``; ``a`` and ``h0`` broadcast against ``b`` and
    ``b[0]`` (a scalar, a ``(T,)`` array, or per-column coefficients);
    returns ``(T, ...)``."""
    t_len = b.shape[0]
    a = torch.broadcast_to(torch.as_tensor(a, dtype=b.dtype, device=b.device), b.shape)
    h0 = torch.as_tensor(h0, dtype=b.dtype, device=b.device)
    # fold the initial state into the first step
    b = torch.cat([(b[0] + a[0] * h0)[None], b[1:]])
    d = 1
    while d < t_len:
        b = torch.cat([b[:d], a[d:] * b[:-d] + b[d:]])
        a = torch.cat([a[:d], a[:-d] * a[d:]])
        d *= 2
    return b


def _matmul_small(m2: torch.Tensor, m1: torch.Tensor) -> torch.Tensor:
    """``m2 @ m1`` over the last two axes as elementwise products and sums:
    full precision whatever the matmul precision settings."""
    return (m2[..., :, :, None] * m1[..., None, :, :]).sum(-2)


def _matvec_small(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (m * v[..., None, :]).sum(-1)


def affine_recurrence(mats: torch.Tensor, vecs: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """Solve h[t] = M[t] @ h[t-1] + u[t]: ``mats (T, D, D)``, ``vecs (T,
    D)``, ``h0 (D,)`` -> ``(T, D)``. O(T D^3 log T) work in log T passes;
    D should be small (a filter's order). The products are exact-precision
    elementwise sums (never TF32), as the JAX package pins ``HIGHEST``."""
    t_len = vecs.shape[0]
    vecs = torch.cat([(vecs[0] + _matvec_small(mats[0], h0))[None], vecs[1:]])
    d = 1
    while d < t_len:
        vecs = torch.cat([vecs[:d], _matvec_small(mats[d:], vecs[:-d]) + vecs[d:]])
        mats = torch.cat([mats[:d], _matmul_small(mats[d:], mats[:-d])])
        d *= 2
    return vecs


def allpass2(x: torch.Tensor, c: float, state: Tuple[torch.Tensor, torch.Tensor]
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """Second-order allpass y(n) = x(n-2) - c*y(n-2) + c*x(n).

    The two sample phases are independent first-order recurrences in the
    internal state s(n) = x(n) - c*y(n): s(n) = -c*s(n-2) + (1-c^2)*x(n),
    y(n) = s(n-2) + c*x(n). ``state`` is (s[-2], s[-1]); returns (y,
    new_state). ``x`` must have even length, so that the phases stay
    aligned across streamed chunks."""
    t_len = x.shape[0]
    assert t_len % 2 == 0, "allpass2 needs an even-length chunk"
    xp = x.reshape(t_len // 2, 2)  # columns: even phase, odd phase
    s_prev = torch.stack([torch.as_tensor(v, dtype=x.dtype, device=x.device) for v in state])
    s = first_order_recurrence(-c, (1.0 - c * c) * xp, s_prev)
    s_shifted = torch.cat([s_prev[None, :], s[:-1]])
    y = (s_shifted + c * xp).reshape(t_len)
    return y, (s[-1, 0], s[-1, 1])


def biquad(x: torch.Tensor, b_coefs, a_coefs, state: torch.Tensor
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Direct-form-I biquad with the 4-element state ``[x(n-1), x(n-2),
    y(n-1), y(n-2)]``: the feed-forward part in parallel, the feedback as
    a 2x2 affine recurrence over ``[y(n), y(n-1)]``."""
    as_x = lambda v: torch.as_tensor(v, dtype=x.dtype, device=x.device)  # noqa: E731
    b0, b1, b2 = (as_x(v) for v in b_coefs)
    _, a1, a2 = (as_x(v) for v in a_coefs)
    t_len = x.shape[0]
    state = as_x(state)
    xm1 = torch.cat([state[:1], x[:-1]])
    xm2 = torch.cat([state[1:2], state[:1], x[:-2]]) if t_len >= 2 else state[1:2]
    drive = b0 * x + b1 * xm1 + b2 * xm2
    mat = torch.stack([torch.stack([-a1, -a2]), torch.stack([as_x(1.0), as_x(0.0)])])
    mats = mat.expand(t_len, 2, 2)
    vecs = torch.stack([drive, torch.zeros_like(drive)], dim=1)
    h = affine_recurrence(mats, vecs, torch.stack([state[2], state[3]]))
    y = h[:, 0]
    return y, torch.stack([x[-1], xm1[-1], y[-1], h[-1, 1]])
