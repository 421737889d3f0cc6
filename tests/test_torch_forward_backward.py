"""Kernel G (``csrc/forward_backward.cu``) on the CPU: its plain versions
against the JAX package's scans, the wrapper's host side against a NumPy
model of the kernel, the E-step callers, and the source's C interface.

- ``forward_scan_plain``/``backward_scan_plain`` (and ``posteriors`` on
  their output) against the JAX ``forward_scan``/``backward_scan``/
  ``posteriors`` on padded batches: at float64 within 1e-12 relative (the
  same sums in another order: ~T ulps) with an identical ``-inf``
  pattern; at float32 no farther from the float64 JAX result than 2x the
  JAX float32 result is (both round every step; the port's
  ``torch.logsumexp`` and the JAX one shift by the max alike). The
  distance is the root mean square of the entries' relative errors
  (:func:`_rms_rel`): the largest single error is a few ulps in both, and
  over four utterances' logliks its ratio swings past 2 by chance.
- ``forward_backward_chunked_plain``, the chunked route's mirror (chunk
  products, boundary chain, replay), against the same JAX scans and
  ``forward_assoc`` at the same bars, at every N = 2-8 and lengths from
  one frame to several chunks.
- ``_launch`` (what a CUDA call runs) with its library replaced by a NumPy
  model of the kernel's arithmetic (per step ``x = v[src] + M[src, dst]``,
  ``m = max`` or 0 where infinite, ``log(sum_src exp(x - m)) + m`` with
  ascending sources; on the chunked route that step on every row of each
  chunk's product, then the boundary chain and the replay), fed the real
  pointers of CPU tensors: the flattening, dtype promotion, mask
  broadcast, inputs passed uncopied, the route and chunk length and the
  argument order of the C call, within 1e-12 of the plain versions at
  float64, the same ``-inf`` pattern, no NaN.
"""

import ctypes
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lnasr_tpu.ops import trellis as jtr
from lnasr_tpu_torch import _build
from lnasr_tpu_torch.models import gmmhmm as tgh
from lnasr_tpu_torch.models import hmm as thmm
from lnasr_tpu_torch.ops import trellis as ttr

RTOL = 1e-12
SOURCE = Path(__file__).resolve().parents[1] / "lnasr_tpu_torch" / "csrc" / "forward_backward.cu"

J_FORWARD = jax.jit(jax.vmap(jtr.forward_scan, in_axes=(None, None, 0, 0)))
J_BACKWARD = jax.jit(jax.vmap(jtr.backward_scan, in_axes=(None, 0, 0)))
J_POSTERIORS = jax.jit(jax.vmap(jtr.posteriors, in_axes=(0, 0, None, 0, 0)))


def _model(rng, n, t, b, kind):
    """``(log_pi, log_a, log_b, mask)``: random, left-to-right (-inf off the
    band), or random with an unreachable state (an all--inf column of
    log_a and -inf in log_pi) and a state with no way out (an all--inf
    row); ragged masks with a length-1 utterance."""
    if kind == "left_to_right":
        with np.errstate(divide="ignore"):
            a = np.log(np.eye(n) * 0.6 + np.eye(n, k=1) * 0.4)
        a[-1, -1] = 0.0
        pi = np.full(n, -np.inf)
        pi[0] = 0.0
    else:
        a = np.log(rng.dirichlet(np.ones(n), size=n))
        pi = np.log(rng.dirichlet(np.ones(n)))
        if kind == "inf":
            a[:, n // 2] = -np.inf
            pi[n // 2] = -np.inf
            a[n - 1, :] = -np.inf
    log_b = rng.normal(scale=2.0, size=(b, t, n)) - 3.0
    lengths = np.array([t, 1, max(2, t // 2), t - 3][:b])
    mask = np.arange(t)[None, :] < lengths[:, None]
    return pi, a, log_b, mask


def _same_inf(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    assert not np.isnan(got).any() or np.array_equal(np.isnan(got), np.isnan(ref))


def _close64(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    _same_inf(got, ref)
    fin = np.isfinite(ref)
    np.testing.assert_allclose(got[fin], ref[fin], rtol=RTOL, atol=RTOL)


def _rms_rel(got, ref):
    """Root mean square of ``(got - ref) / max(|ref|, 1)`` over the finite
    entries of ``ref``; the ``-inf`` patterns must be equal."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    np.testing.assert_array_equal(np.isneginf(got), np.isneginf(ref))
    fin = np.isfinite(ref)
    return float(np.sqrt(np.mean(((got[fin] - ref[fin]) / np.abs(ref[fin]).clip(1)) ** 2)))


def _jax(pi, a, log_b, mask, dtype):
    args = [jnp.asarray(x, dtype) for x in (pi, a, log_b)]
    fwd = J_FORWARD(*args, jnp.asarray(mask))
    beta = J_BACKWARD(args[1], args[2], jnp.asarray(mask))
    return fwd, beta, args


def _plain(pi, a, log_b, mask, dtype):
    t = [torch.as_tensor(x, dtype=dtype) for x in (pi, a, log_b)]
    fwd = ttr.forward_scan_plain(*t, torch.as_tensor(mask))
    return fwd, ttr.backward_scan_plain(t[1], t[2], torch.as_tensor(mask)), t


CASES = [(n, kind) for n in (2, 5, 8, 33, 40) for kind in ("random", "left_to_right", "inf")]


@pytest.mark.parametrize("n,kind", CASES)
def test_plain_matches_jax_float64(n, kind):
    rng = np.random.default_rng(100 * n + len(kind))
    pi, a, log_b, mask = _model(rng, n, 29, 4, kind)
    fwd, beta, jargs = _jax(pi, a, log_b, mask, jnp.float64)
    got, got_beta, targs = _plain(pi, a, log_b, mask, torch.float64)
    _close64(got.alpha, fwd.alpha)
    _close64(got.loglik, fwd.loglik)
    _close64(got_beta, beta)
    xi, gamma = ttr.posteriors(got.alpha, got_beta, targs[1], targs[2], torch.as_tensor(mask))
    xi_ref, gamma_ref = J_POSTERIORS(fwd.alpha, beta, jargs[1], jargs[2], jnp.asarray(mask))
    np.testing.assert_allclose(xi.numpy(), np.asarray(xi_ref), rtol=1e-11, atol=1e-11)
    np.testing.assert_allclose(gamma.numpy(), np.asarray(gamma_ref), rtol=1e-11, atol=1e-11)
    # the length-1 utterance: alpha[0] everywhere, beta all zeros
    np.testing.assert_array_equal(got.alpha[1].numpy(), np.broadcast_to(got.alpha[1, 0], (29, n)))
    assert not got_beta[1].any()


@pytest.mark.parametrize("n,kind", CASES)
def test_plain_float32_within_twice_jax(n, kind):
    rng = np.random.default_rng(200 * n + len(kind))
    pi, a, log_b, mask = _model(rng, n, 61, 4, kind)
    f64, b64, _ = _jax(pi, a, log_b, mask, jnp.float64)
    f32, b32, _ = _jax(pi, a, log_b, mask, jnp.float32)
    got, got_beta, _ = _plain(pi, a, log_b, mask, torch.float32)
    assert got.alpha.dtype == got_beta.dtype == torch.float32
    for port, jx, ref in ((got.alpha, f32.alpha, f64.alpha), (got.loglik, f32.loglik, f64.loglik),
                          (got_beta, b32, b64)):
        d_port, d_jax = _rms_rel(port.numpy(), ref), _rms_rel(jx, ref)
        assert d_port <= 2 * d_jax, (d_port, d_jax)


# -- the chunked route's plain mirror against the JAX scans -------------------

J_ASSOC = jax.jit(jax.vmap(jtr.forward_assoc, in_axes=(None, None, 0)))


def _chunked(pi, a, log_b, mask, dtype):
    t = [torch.as_tensor(x, dtype=dtype) for x in (pi, a, log_b)]
    fwd, beta = ttr.forward_backward_chunked_plain(*t, torch.as_tensor(mask))
    return fwd, beta


@pytest.mark.parametrize("n,kind", CASES)
def test_chunked_plain_matches_jax_float64(n, kind):
    """The chunked route's mirror (chunk products, boundary chain, replay)
    against the JAX scans on the inputs of the plain loops' float64 test:
    1e-12, ``-inf`` patterns identical."""
    rng = np.random.default_rng(100 * n + len(kind))
    pi, a, log_b, mask = _model(rng, n, 29, 4, kind)
    fwd, beta, _ = _jax(pi, a, log_b, mask, jnp.float64)
    got, got_beta = _chunked(pi, a, log_b, mask, torch.float64)
    _close64(got.alpha, fwd.alpha)
    _close64(got.loglik, fwd.loglik)
    _close64(got_beta, beta)


@pytest.mark.parametrize("n,kind", CASES)
def test_chunked_plain_float32_within_twice_jax(n, kind):
    rng = np.random.default_rng(200 * n + len(kind))
    pi, a, log_b, mask = _model(rng, n, 61, 4, kind)
    f64, b64, _ = _jax(pi, a, log_b, mask, jnp.float64)
    f32, b32, _ = _jax(pi, a, log_b, mask, jnp.float32)
    got, got_beta = _chunked(pi, a, log_b, mask, torch.float32)
    assert got.alpha.dtype == got_beta.dtype == torch.float32
    for port, jx, ref in ((got.alpha, f32.alpha, f64.alpha), (got.loglik, f32.loglik, f64.loglik),
                          (got_beta, b32, b64)):
        d_port, d_jax = _rms_rel(port.numpy(), ref), _rms_rel(jx, ref)
        assert d_port <= 2 * d_jax, (d_port, d_jax)


# every N of the chunked route, each at three lengths: one frame, one step,
# fewer frames than the flagship's 32-step chunks, a last chunk shorter than
# the rest (T = 100: 13 chunks of 8 steps, the last of 3), and past 2 tiles
LENGTHS = [(n, t) for n, ts in zip(range(2, 9), ((1, 33, 100), (2, 5, 130), (1, 31, 100),
                                                  (3, 64, 300), (2, 29, 100), (1, 5, 33),
                                                  (2, 100, 200)))
           for t in ts]


@pytest.mark.parametrize("n,t", LENGTHS)
def test_chunked_plain_lengths_against_jax(n, t):
    """At every N = 2-8 and lengths from one frame to several chunks, with
    an unreachable state, a state with no way out, a frame of -inf
    emissions and ragged masks (one utterance of a single frame): float64
    within 1e-12 of the JAX scans, ``-inf`` patterns identical; float32
    within 2x the JAX float32 RMS distance from the float64 result."""
    rng = np.random.default_rng(500 + 10 * n + t)
    pi, a, log_b, mask = _model(rng, n, t, 4, "inf")
    log_b[-1, t // 3] = -np.inf
    f64, b64, _ = _jax(pi, a, log_b, mask, jnp.float64)
    got, got_beta = _chunked(pi, a, log_b, mask, torch.float64)
    _close64(got.alpha, f64.alpha)
    _close64(got.loglik, f64.loglik)
    _close64(got_beta, b64)
    f32, b32, _ = _jax(pi, a, log_b, mask, jnp.float32)
    got, got_beta = _chunked(pi, a, log_b, mask, torch.float32)
    for port, jx, ref in ((got.alpha, f32.alpha, f64.alpha), (got_beta, b32, b64)):
        d_port, d_jax = _rms_rel(port.numpy(), ref), _rms_rel(jx, ref)
        assert d_port <= 2 * d_jax, (d_port, d_jax)


@pytest.mark.parametrize("n,kind", [(2, "random"), (5, "left_to_right"), (8, "inf")])
def test_chunked_plain_matches_forward_assoc(n, kind):
    """Unmasked, the mirror's alpha and loglik equal the JAX
    ``forward_assoc`` (a log-depth scan over the same (N, N) operators)
    within 1e-12."""
    rng = np.random.default_rng(600 + n)
    pi, a, log_b, _ = _model(rng, n, 47, 4, kind)
    ref = J_ASSOC(*(jnp.asarray(x, jnp.float64) for x in (pi, a, log_b)))
    got, _ = _chunked(pi, a, log_b, np.ones(log_b.shape[:2], bool), torch.float64)
    _close64(got.alpha, ref.alpha)
    _close64(got.loglik, ref.loglik)


# -- the wrapper's host side, with the kernel replaced by a NumPy model -----------


def _lse_steps(v, m):
    """``out[dst] = lse_src(v[src] + m[src, dst])`` as the kernel computes
    it: torch.logsumexp's shift and the sources summed in ascending order,
    in float64 past 32 sources (the block route)."""
    x = v[:, None] + m
    mx = x.max(axis=0)
    mx = np.where(np.isinf(mx), np.zeros_like(mx), mx)
    s = np.zeros(mx.shape, np.float64 if x.shape[0] > 32 else x.dtype)
    with np.errstate(over="ignore"):
        for i in range(x.shape[0]):
            s = s + np.exp(x[i] - mx)
    with np.errstate(divide="ignore"):
        return np.log(s).astype(x.dtype) + mx


def _steps(t_n, fwd):
    """Step k = 1 .. T-1 reads frame k (forward) or T - k (backward) and
    writes row k or T - 1 - k."""
    return [(k, k if fwd else t_n - k, k if fwd else t_n - 1 - k) for k in range(1, t_n)]


def _chunk_rows(v0, m, log_b, valid, fwd, chunk):
    """The chunked route's rows of one direction (step order) as the kernel
    forms them: each chunk's product from the identity, row by row (lane
    (row, col) a step of the lane-per-state recursion), masked steps
    skipped; the boundary chain through the products; each chunk replayed
    from its boundary."""
    t_n, n = log_b.shape
    steps = _steps(t_n, fwd)
    chunks = [steps[i:i + chunk] for i in range(0, len(steps), chunk)] or [[]]
    with np.errstate(divide="ignore"):
        eye = np.log(np.eye(n)).astype(log_b.dtype)
    prods = []
    for ch in chunks:
        r = eye.copy()
        for _, f, _ in ch:
            if valid[f]:
                r = np.stack([_lse_steps(row, m) + log_b[f] if fwd
                              else _lse_steps(row + log_b[f], m) for row in r])
        prods.append(r)
    v, out = v0, {}
    for ch, r in zip(chunks, prods):
        state = v
        for _, f, row in ch:
            if valid[f]:
                state = (_lse_steps(state, m) + log_b[f] if fwd
                         else _lse_steps(log_b[f] + state, m))
            out[row] = state
        v = _lse_steps(v, r)
    return out, state


def kernel_model(pi, a, log_b, mask, fwd, bwd, chunk=0):
    """What the kernel writes for ``log_b (B, T, N)``: each direction as
    one recursion over ``M[src, dst]`` (``a`` for the forward, ``a`` read
    transposed for the backward), step by step, or on the chunked route
    (``chunk`` > 0 steps a chunk) by :func:`_chunk_rows`."""
    b_n, t_n, n = log_b.shape
    alpha = np.empty_like(log_b)
    loglik = np.empty(b_n, log_b.dtype)
    beta = np.empty_like(log_b)
    valid = np.ones((b_n, t_n), bool) if mask is None else mask
    for b in range(b_n):
        for on, d_fwd, out in ((fwd, True, alpha), (bwd, False, beta)):
            if not on:
                continue
            m = a if d_fwd else a.T
            state = pi + log_b[b, 0] if d_fwd else np.zeros(n, log_b.dtype)
            out[b, 0 if d_fwd else t_n - 1] = state
            if chunk:
                rows, state = _chunk_rows(state, m, log_b[b], valid[b], d_fwd, chunk)
                for r, x in rows.items():
                    out[b, r] = x
            else:
                for _, f, r in _steps(t_n, d_fwd):
                    if valid[b, f]:
                        state = (_lse_steps(state, m) + log_b[b, f] if d_fwd
                                 else _lse_steps(log_b[b, f] + state, m))
                    out[b, r] = state
            if d_fwd:
                loglik[b] = _lse_steps(state, np.zeros((n, 1), log_b.dtype))[0]
    return alpha, loglik, beta


class _ModelLibrary:
    """Stands in for the built ``forward_backward`` library: reads the C
    call's pointers (CPU tensors' addresses) and writes the model's
    results where the kernel would."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _view(ptr, dtype, shape):
        count = int(np.prod(shape))
        buf = (ctypes.c_char * (count * np.dtype(dtype).itemsize)).from_address(ptr)
        return np.frombuffer(buf, dtype=dtype).reshape(shape)

    def forward_backward_launch(self, pi, a, lb, mask, b, t, n, dirs, route, chunk, is_double,
                                alpha, loglik, beta, stream):
        self.calls.append(dict(b=b, t=t, n=n, dirs=dirs, route=ttr.FB_ROUTES[route],
                               chunk=chunk, is_double=is_double, mask=mask, ptrs=(pi, a, lb)))
        dt = np.float64 if is_double else np.float32
        fwd, bwd = bool(dirs & 1), bool(dirs & 2)
        chunked = ttr.FB_ROUTES[route] == "chunked"
        out = kernel_model(
            self._view(pi, dt, (n,)).copy() if fwd else None, self._view(a, dt, (n, n)).copy(),
            self._view(lb, dt, (b, t, n)).copy(),
            None if mask is None else self._view(mask, np.bool_, (b, t)).copy(), fwd, bwd,
            chunk if chunked else 0)
        if fwd:
            self._view(alpha, dt, (b, t, n))[...] = out[0]
            self._view(loglik, dt, (b,))[...] = out[1]
        if bwd:
            self._view(beta, dt, (b, t, n))[...] = out[2]
        return 0


@pytest.fixture
def model_library(monkeypatch):
    """``_launch`` runs its host side on CPU tensors against the model."""
    lib = _ModelLibrary()
    monkeypatch.setattr(_build, "load", lambda name, argtypes: lib)

    class _NoDevice:
        def __init__(self, dev):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "device", _NoDevice)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: type("S", (), {"cuda_stream": 0})())
    return lib


@pytest.mark.parametrize("n,kind", [(5, "random"), (3, "left_to_right"), (4, "inf"),
                                    (8, "random"), (64, "inf"), (179, "left_to_right")])
def test_launch_host_side_against_model(model_library, n, kind):
    rng = np.random.default_rng(300 + n)
    pi, a, log_b, mask = _model(rng, n, 23, 4, kind)
    t = [torch.as_tensor(x) for x in (pi, a, log_b)]
    before = ttr.forward_backward.launches
    alpha, loglik, beta = ttr._launch(*t, torch.as_tensor(mask), 3)
    ref, ref_beta = ttr.forward_backward(*t, torch.as_tensor(mask))  # CPU: the plain loops
    _close64(alpha, ref.alpha)
    _close64(loglik, ref.loglik)
    _close64(beta, ref_beta)
    assert not (torch.isnan(alpha).any() or torch.isnan(beta).any())
    assert ttr.forward_backward.launches == before + 1
    call = model_library.calls[-1]
    assert (call["b"], call["t"], call["n"], call["dirs"], call["is_double"]) == (4, 23, n, 3, 1)
    assert call["route"] == ttr.fb_route(n, 8)


def test_launch_flattens_promotes_and_broadcasts(model_library):
    """Leading dimensions flatten into B; float32 and float64 inputs promote
    to float64; a (T,) mask broadcasts over the batch; one direction at a
    time writes only its outputs."""
    rng = np.random.default_rng(7)
    pi, a, log_b, _ = _model(rng, 5, 17, 4, "random")
    log_b = log_b.reshape(2, 2, 17, 5)
    mask = np.arange(17) < 12
    t_pi, t_a = torch.as_tensor(pi, dtype=torch.float32), torch.as_tensor(a)
    t_b, t_m = torch.as_tensor(log_b), torch.as_tensor(mask)
    alpha, loglik, beta = ttr._launch(t_pi, t_a, t_b, t_m, 1)
    assert beta is None and alpha.shape == (2, 2, 17, 5) and loglik.shape == (2, 2)
    assert alpha.dtype == torch.float64
    ref = ttr.forward_scan_plain(t_pi.double(), t_a, t_b, t_m)
    _close64(alpha, ref.alpha)
    _close64(loglik, ref.loglik)
    _, _, beta = ttr._launch(None, t_a, t_b, t_m, 2)
    _close64(beta, ttr.backward_scan_plain(t_a, t_b, t_m))
    assert [c["b"] for c in model_library.calls[-2:]] == [4, 4]
    assert model_library.calls[-1]["dirs"] == 2
    _, _, beta = ttr._launch(None, t_a, t_b, None, 2)  # no mask: a null pointer
    assert model_library.calls[-1]["mask"] is None
    _close64(beta, ttr.backward_scan_plain(t_a, t_b))


def test_launch_float32_model_within_twice_plain(model_library):
    """At float32 the model of the kernel is as near the float64 plain
    result as 2x the float32 plain loops are."""
    rng = np.random.default_rng(12)
    pi, a, log_b, mask = _model(rng, 5, 200, 4, "random")
    t64 = [torch.as_tensor(x) for x in (pi, a, log_b)]
    t32 = [x.float() for x in t64]
    m = torch.as_tensor(mask)
    ref, ref_beta = ttr.forward_backward(*t64, m)
    plain, plain_beta = ttr.forward_backward(*t32, m)
    alpha, loglik, beta = ttr._launch(*t32, m, 3)
    for got, p, r in ((alpha, plain.alpha, ref.alpha), (loglik, plain.loglik, ref.loglik),
                      (beta, plain_beta, ref_beta)):
        assert got.dtype == torch.float32
        assert _rms_rel(got, r) <= 2 * _rms_rel(p, r)


def test_routes_cover_every_n():
    """The chunked route up to 8 states (every EM model and unit), the
    warp route up to 32; past that the block routes by what fits in a
    block's shared memory: the step's vector and ``log_a``, the vector
    alone (``log_a`` through L2), or neither. No N is refused."""
    route = ttr.fb_route
    assert [route(n, itemsize) for n in (1, 2, 5, 8) for itemsize in (4, 8)] == ["chunked"] * 8
    assert [route(n, 4) for n in (9, 16, 32)] == ["warp"] * 3
    assert route(33, 8) == route(64, 8) == route(179, 4) == "smem"
    assert route(179, 8) == "l2"  # 179 x 179 float64 is 256 KB
    assert route(14_000, 4) == "l2" and route(14_600, 8) == "global"
    assert route(10 ** 6, 4) == "global"


@pytest.mark.parametrize("t", [1, 2, 3, 5, 31, 33, 64, 100, 300, 999, 1000, 2049, 10 ** 5])
def test_chunks_cover_the_steps(t):
    """``fb_chunks``: at most 32 chunks, every step in one, none empty
    (only T = 1, with no steps, has one chunk of none), ``C`` near
    ``sqrt(2 (T - 1))`` while that fits; the flagship's T = 999 is 32 x 32."""
    c, chunk = ttr.fb_chunks(t)
    steps = t - 1
    assert 1 <= c <= ttr.CHUNK_WARPS and chunk >= 1
    if steps:
        assert (c - 1) * chunk < steps <= c * chunk
        assert c == ttr.CHUNK_WARPS or abs(c - np.sqrt(2 * steps)) <= chunk
    assert ttr.fb_chunks(999) == (32, 32)


def test_launch_forced_routes(model_library):
    """A forced block route reaches the C call at any N, and the chunked
    route at N <= 8 with its chunk length; the warp route past 32 states
    and the chunked route past 8 are refused."""
    rng = np.random.default_rng(9)
    pi, a, log_b, mask = _model(rng, 5, 11, 2, "random")
    t = [torch.as_tensor(x) for x in (pi, a, log_b)]
    for route in ("smem", "l2", "global", "chunked"):
        ttr._launch(*t, torch.as_tensor(mask), 3, route=route)
        assert model_library.calls[-1]["route"] == route
    assert model_library.calls[-1]["chunk"] == ttr.fb_chunks(11)[1]
    t40 = [torch.zeros(40), torch.zeros(40, 40), torch.zeros(1, 3, 40)]
    with pytest.raises(ValueError, match="no route 'warp'"):
        ttr._launch(*t40, None, 3, route="warp")
    t9 = [torch.zeros(9), torch.zeros(9, 9), torch.zeros(1, 70, 9)]
    with pytest.raises(ValueError, match="no route 'chunked'"):
        ttr._launch(*t9, None, 3, route="chunked")


CHUNKED_LAUNCHES = [(n, t, route) for n, t in zip(range(2, 9), (64, 100, 130, 70, 200, 65, 99))
                    for route in (None, "warp")] + [(5, 1, "chunked"), (3, 5, "chunked"),
                                                   (8, 31, "chunked"), (6, 2, "chunked")]


@pytest.mark.parametrize("n,t,route", CHUNKED_LAUNCHES)
def test_launch_chunked_against_model(model_library, n, t, route):
    """The chunked route as the wrapper calls it (chosen, or forced; the
    warp route forced at the same shapes): the
    C call gets the route and ``fb_chunks``' chunk length, and the model of
    the kernel on that route (chunk products, boundary chain, replay) is
    within 1e-12 of the plain loops at float64, the ``-inf`` patterns
    identical, the -inf rows, columns and frames and ragged masks
    included."""
    rng = np.random.default_rng(400 + 10 * n + t)
    pi, a, log_b, mask = _model(rng, n, t, 4, "inf")
    log_b[-1, t // 3] = -np.inf
    ts = [torch.as_tensor(x) for x in (pi, a, log_b)]
    m = torch.as_tensor(mask)
    alpha, loglik, beta = ttr._launch(*ts, m, 3, route=route)
    call = model_library.calls[-1]
    assert call["route"] == (route or "chunked")
    assert call["chunk"] == (ttr.fb_chunks(t)[1] if call["route"] == "chunked" else 0)
    ref, ref_beta = ttr.forward_backward(*ts, m)
    _close64(alpha, ref.alpha)
    _close64(loglik, ref.loglik)
    _close64(beta, ref_beta)


def test_launch_passes_dense_inputs_as_they_are(model_library):
    """An input already in the call's dtype and contiguous reaches the C
    call as it is (no copy, no launch); one that is not is copied once; no
    transposed ``log_a`` is made (the kernel reads it by index)."""
    rng = np.random.default_rng(14)
    pi, a, log_b, mask = _model(rng, 5, 80, 3, "random")
    ts = [torch.as_tensor(x) for x in (pi, a, log_b)]
    m = torch.as_tensor(mask)
    ttr._launch(*ts, m, 3)
    call = model_library.calls[-1]
    assert call["ptrs"] == tuple(x.data_ptr() for x in ts)
    assert call["mask"] == m.data_ptr()
    a_t = ts[1].t().contiguous().t()  # the same values, not contiguous
    ttr._launch(ts[0], a_t, ts[2].float(), m[0], 3)  # float32 log_b promotes; a (T,) mask broadcasts
    call = model_library.calls[-1]
    assert call["ptrs"][0] == ts[0].data_ptr()
    assert call["ptrs"][1] != a_t.data_ptr() and call["ptrs"][2] != ts[2].data_ptr()
    assert call["b"] == 3 and call["mask"] != m.data_ptr()


# -- the CPU path, the refusals, the callers --------------------------------------


def test_cpu_calls_count_no_launch():
    rng = np.random.default_rng(3)
    pi, a, log_b, mask = _model(rng, 5, 19, 3, "random")
    t = [torch.as_tensor(x) for x in (pi, a, log_b)]
    m = torch.as_tensor(mask)
    before = ttr.forward_backward.launches
    fwd, beta = ttr.forward_backward(*t, m)
    fwd2 = ttr.forward_scan(*t, m)
    beta2 = ttr.backward_scan(t[1], t[2], m)
    assert torch.equal(fwd.alpha, fwd2.alpha) and torch.equal(fwd.loglik, fwd2.loglik)
    assert torch.equal(beta, beta2)
    assert ttr.forward_backward.launches == before


class _CudaStandIn:
    """A CUDA tensor's device, dtype and shape: all the wrapper reads before
    it refuses."""

    def __init__(self, shape, dtype=torch.float32):
        self.device, self.dtype, self.shape = torch.device("cuda"), dtype, tuple(shape)

    def dim(self):
        return len(self.shape)


def test_cuda_refuses_instead_of_the_loops(monkeypatch):
    """On CUDA tensors the wrappers launch kernel G or raise: per-utterance
    matrices, a dtype other than float32/float64 and no frames are refused
    before anything is built, and nothing falls back to the loops."""
    monkeypatch.setattr(_build, "load", lambda *a: pytest.fail("built for a refused call"))
    monkeypatch.setattr(ttr, "forward_scan_plain", lambda *a: pytest.fail("fell back"))
    monkeypatch.setattr(ttr, "backward_scan_plain", lambda *a: pytest.fail("fell back"))
    pi, a = _CudaStandIn((5,)), _CudaStandIn((5, 5))
    before = ttr.forward_backward.launches
    with pytest.raises(ValueError, match="shared by the batch"):
        ttr.forward_backward(pi, _CudaStandIn((3, 5, 5)), _CudaStandIn((3, 40, 5)))
    with pytest.raises(ValueError, match="shared by the batch"):
        ttr.forward_scan(_CudaStandIn((3, 5)), a, _CudaStandIn((3, 40, 5)))
    with pytest.raises(ValueError, match="float32 or float64"):
        ttr.forward_backward(_CudaStandIn((5,), torch.float16), _CudaStandIn((5, 5), torch.float16),
                             _CudaStandIn((3, 40, 5), torch.float16))
    with pytest.raises(ValueError, match="float32 or float64"):
        ttr.backward_scan(_CudaStandIn((5, 5), torch.bfloat16),
                          _CudaStandIn((3, 40, 5), torch.bfloat16))
    with pytest.raises(ValueError, match="at least one frame"):
        ttr.forward_backward(pi, a, _CudaStandIn((3, 0, 5)))
    assert ttr.forward_backward.launches == before


@pytest.fixture
def spied(monkeypatch):
    """Counts the E-step's calls of ``forward_backward`` in both models;
    the single-direction wrappers must not be reached from there."""
    calls = []

    def spy(*args, **kw):
        calls.append(args[2].shape)
        return ttr.forward_backward(*args, **kw)

    for mod in (tgh, thmm):
        monkeypatch.setattr(mod, "forward_backward", spy)
    monkeypatch.setattr(thmm, "forward_scan", lambda *a: pytest.fail("forward_scan"))
    monkeypatch.setattr(thmm, "backward_scan", lambda *a: pytest.fail("backward_scan"))
    return calls


def test_gmmhmm_sequence_stats_calls_forward_backward_once(spied):
    from lnasr_tpu_torch.config import GMMHMMConfig

    rng = np.random.default_rng(5)
    obs = torch.as_tensor(rng.normal(size=(3, 20, 4)))
    mask = torch.as_tensor(np.arange(20)[None, :] < np.array([[20], [13], [1]]))
    model = tgh.GMMHMM(GMMHMMConfig(n_states=3, n_mix=2, dim=4), dtype=torch.float64,
                       device="cpu").reset("random", torch.Generator().manual_seed(5))
    stats = tgh._sequence_stats(model.params, obs, mask, "diag")
    assert spied == [(3, 20, 3)]
    assert torch.isfinite(stats.loglik).all()
    tgh.gmmhmm_em_step(model.params, obs, mask)
    assert len(spied) == 2


def test_hmm_sequence_stats_calls_forward_backward_once(spied):
    rng = np.random.default_rng(6)
    obs = torch.as_tensor(rng.integers(0, 7, size=(4, 15)))
    mask = torch.as_tensor(np.arange(15)[None, :] < np.array([[15], [9], [1], [12]]))
    model = thmm.HMM(3, 7, dtype=torch.float64, device="cpu").reset(
        "random", torch.Generator().manual_seed(6))
    thmm._sequence_stats(model.params, obs, mask)
    assert spied == [(4, 15, 3)]
    thmm.em_step(model.params, obs, mask)
    assert len(spied) == 2


# -- the source -----------------------------------------------------------------


def test_source_exports_what_the_wrapper_binds():
    """``forward_backward_launch`` takes as many arguments as the wrapper's
    ``argtypes`` name (ctypes passes a pointer cut to 32 bits where an
    argument is missing), in their order of pointers and ints, with no
    transposed matrix (the backward reads ``log_a`` by index) and the
    chunked route's chunk length; returns int, and an error-string entry
    exists; the source uses the exact ``exp``/``log`` and no atomics."""
    src = SOURCE.read_text()
    sig = re.search(r'extern "C" int forward_backward_launch\(([^)]*)\)', src)
    assert sig is not None
    params = [p.strip() for p in sig.group(1).split(",")]
    assert len(params) == len(ttr._ARGTYPES) == 15
    pointer = ["*" in p for p in params]
    names = [p.split()[-1].lstrip("*") for p in params]
    assert names[:4] == ["log_pi", "log_a", "log_b", "mask"] and "log_at" not in names
    assert names[8:10] == ["route", "chunk"]
    assert pointer == [t is ctypes.c_void_p for t in ttr._ARGTYPES]
    assert 'extern "C" const char* forward_backward_error_string(int err)' in src
    code = re.sub(r"//[^\n]*", "", src)
    assert "__expf" not in code and "__logf" not in code and "atomic" not in code
    assert "use_fast_math" not in " ".join(_build.NVCC_FLAGS)
    assert "forward_backward" in {p.stem for p in SOURCE.parent.glob("*.cu")}
