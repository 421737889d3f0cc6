"""The port's Baum-Welch trellis (``forward_scan``, ``backward_scan``,
``forward_assoc``, ``posteriors``), log-space numerics and scalar pdfs
against the JAX package on the same float64 inputs.

Tolerances: the recursions are the same sums in another order (torch's
logsumexp and the JAX one shift by the max alike), so float64 results
agree to ~T ulps: rtol 1e-12 with atol 1e-12 for values near 0.
``forward_assoc`` composes the step operators in another tree than
``lax.associative_scan``: rtol 1e-11 against the JAX scan and the port's
own ``forward_scan``. -inf entries (left-to-right models, masks) must
match exactly; the numerics and pdfs agree to 1e-13 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lnasr_tpu.ops import gaussian as jgauss
from lnasr_tpu.ops import numerics as jnum
from lnasr_tpu.ops import trellis as jtr
from lnasr_tpu_torch.ops import gaussian as tgauss
from lnasr_tpu_torch.ops import numerics as tnum
from lnasr_tpu_torch.ops import trellis as ttr

# the hand-traceable 2-state / 3-symbol example of tests/test_trellis.py
A = np.log(np.array([[0.6, 0.4], [0.5, 0.5]]))
B = np.log(np.array([[0.2, 0.4, 0.4], [0.5, 0.4, 0.1]]))
PI = np.log(np.array([0.8, 0.2]))
OBS = np.array([2, 0, 2])

RTOL, ATOL = 1e-12, 1e-12
# the JAX package's functions, each compiled as one program (op-by-op
# dispatch of the associative scan alone takes ~9 s a shape on the CPU)
J_FORWARD = jax.jit(jtr.forward_scan)
J_BACKWARD = jax.jit(jtr.backward_scan)
J_POSTERIORS = jax.jit(jtr.posteriors)
J_ASSOC = jax.jit(jtr.forward_assoc)


def _random_model(rng, n, t):
    log_a = np.log(rng.dirichlet(np.ones(n), size=n))
    log_pi = np.log(rng.dirichlet(np.ones(n)))
    log_b = rng.normal(scale=2.0, size=(t, n)) - 3.0
    return log_pi, log_a, log_b


def _left_to_right(rng, n, t):
    with np.errstate(divide="ignore"):
        a = np.log(np.eye(n) * 0.6 + np.eye(n, k=1) * 0.4)
    a[-1, -1] = 0.0
    pi = np.full(n, -np.inf)
    pi[0] = 0.0
    return pi, a, rng.normal(scale=2.0, size=(t, n)) - 3.0


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _close(got, ref, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got) else got, np.asarray(ref),
                               rtol=rtol, atol=atol)


def _check_all(log_pi, log_a, log_b, mask=None):
    """Forward, backward, posteriors and the associative forward of the
    port against the JAX package's, one sequence."""
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.as_tensor(mask)
    ref = J_FORWARD(jnp.asarray(log_pi), jnp.asarray(log_a), jnp.asarray(log_b), jm)
    got = ttr.forward_scan(_t(log_pi), _t(log_a), _t(log_b), tm)
    _close(got.alpha, ref.alpha)
    _close(got.loglik, ref.loglik)
    beta_ref = J_BACKWARD(jnp.asarray(log_a), jnp.asarray(log_b), jm)
    beta = ttr.backward_scan(_t(log_a), _t(log_b), tm)
    _close(beta, beta_ref)
    xi_ref, gamma_ref = J_POSTERIORS(ref.alpha, beta_ref, jnp.asarray(log_a),
                                     jnp.asarray(log_b), jm)
    xi, gamma = ttr.posteriors(got.alpha, beta, _t(log_a), _t(log_b), tm)
    _close(xi, xi_ref)
    _close(gamma, gamma_ref)
    assert torch.all(xi[-1] == -torch.inf) and torch.all(gamma[-1] == -torch.inf)
    if mask is None:
        assoc = ttr.forward_assoc(_t(log_pi), _t(log_a), _t(log_b))
        assoc_ref = J_ASSOC(jnp.asarray(log_pi), jnp.asarray(log_a), jnp.asarray(log_b))
        _close(assoc.alpha, assoc_ref.alpha, rtol=1e-11)
        _close(assoc.alpha, got.alpha.numpy(), rtol=1e-11)
        _close(assoc.loglik, assoc_ref.loglik, rtol=1e-11)
    return got, beta, xi, gamma


def test_ice_cream():
    got, _, _, gamma = _check_all(PI, A, B[:, OBS].T)
    total = sum(np.exp(PI[s0] + B[s0, 2] + A[s0, s1] + B[s1, 0] + A[s1, s2] + B[s2, 2])
                for s0 in range(2) for s1 in range(2) for s2 in range(2))
    np.testing.assert_allclose(np.exp(float(got.loglik)), total, rtol=1e-12)
    # each non-final frame's state posteriors sum to one
    np.testing.assert_allclose(torch.logsumexp(gamma[:-1], dim=-1).numpy(), 0.0, atol=1e-12)


@pytest.mark.parametrize("kind,n,t", [("random", 2, 3), ("random", 5, 50), ("random", 8, 33),
                                      ("left_to_right", 4, 20), ("left_to_right", 6, 9)])
def test_recursions_match_jax(kind, n, t):
    rng = np.random.default_rng(n * 100 + t)
    make = _random_model if kind == "random" else _left_to_right
    _check_all(*make(rng, n, t))


@pytest.mark.parametrize("kind", ["random", "left_to_right"])
def test_masked_sequence_matches_jax(kind):
    rng = np.random.default_rng(11)
    make = _random_model if kind == "random" else _left_to_right
    log_pi, log_a, log_b = make(rng, 4, 30)
    mask = np.arange(30) < 21
    _check_all(log_pi, log_a, log_b, mask)


@pytest.mark.parametrize("kind", ["random", "left_to_right"])
def test_padded_batch_equals_unpadded(kind):
    """One frame loop over a padded batch with masks gives each sequence's
    unpadded alpha, beta, xi and gamma on its valid frames."""
    rng = np.random.default_rng(5)
    make = _random_model if kind == "random" else _left_to_right
    n, t_max, lengths = 5, 24, (24, 17, 9)
    log_pi, log_a, _ = make(rng, n, t_max)
    log_b = rng.normal(scale=2.0, size=(len(lengths), t_max, n)) - 3.0
    mask = np.arange(t_max)[None, :] < np.array(lengths)[:, None]
    res = ttr.forward_scan(_t(log_pi), _t(log_a), _t(log_b), torch.as_tensor(mask))
    beta = ttr.backward_scan(_t(log_a), _t(log_b), torch.as_tensor(mask))
    xi, gamma = ttr.posteriors(res.alpha, beta, _t(log_a), _t(log_b), torch.as_tensor(mask))
    for k, length in enumerate(lengths):
        one = ttr.forward_scan(_t(log_pi), _t(log_a), _t(log_b[k, :length]))
        beta1 = ttr.backward_scan(_t(log_a), _t(log_b[k, :length]))
        xi1, gamma1 = ttr.posteriors(one.alpha, beta1, _t(log_a), _t(log_b[k, :length]))
        _close(res.alpha[k, :length], one.alpha.numpy())
        _close(res.loglik[k], one.loglik.numpy())
        _close(beta[k, :length], beta1.numpy())
        _close(xi[k, :length], xi1.numpy())
        _close(gamma[k, :length], gamma1.numpy())
        assert torch.all(xi[k, length - 1:] == -torch.inf)
        # the JAX package's masked single-sequence run agrees on the whole row
        ref = J_FORWARD(jnp.asarray(log_pi), jnp.asarray(log_a), jnp.asarray(log_b[k]),
                        jnp.asarray(mask[k]))
        _close(res.alpha[k], ref.alpha)


def test_numerics_match_jax():
    rng = np.random.default_rng(3)
    x = rng.normal(scale=4.0, size=(3, 5, 6))
    x[0, 1] = -np.inf  # an all--inf slice
    x[1, 2, :3] = -np.inf
    y = rng.normal(scale=4.0, size=(3, 6, 4))
    y[2, 3] = -np.inf
    r = dict(rtol=1e-13, atol=1e-13)
    _close(tnum.logsumexp2(_t(x), dim=-1), jnum.logsumexp2(jnp.asarray(x), axis=-1), **r)
    _close(tnum.logsumexp2(_t(x)), jnum.logsumexp2(jnp.asarray(x)), **r)
    _close(tnum.log_matvec(_t(x[0]), _t(y[0, :, 0])),
           jnum.log_matvec(jnp.asarray(x[0]), jnp.asarray(y[0, :, 0])), **r)
    _close(tnum.log_matmul(_t(x), _t(y)), jnum.log_matmul(jnp.asarray(x), jnp.asarray(y)), **r)
    _close(tnum.maxplus_matmul(_t(x), _t(y)),
           jnum.maxplus_matmul(jnp.asarray(x), jnp.asarray(y)), **r)
    _close(tnum.normalize_log(_t(x[1:])), jnum.normalize_log(jnp.asarray(x[1:])), **r)
    p = np.array([0.0, 1e-300, 0.5, 2.0, -1.0, np.nan])
    _close(tnum.safe_log(_t(p)), jnum.safe_log(jnp.asarray(p)), **r)


def test_scalar_pdfs_match_jax():
    rng = np.random.default_rng(4)
    r = dict(rtol=1e-13, atol=1e-300)
    x = rng.normal(size=7)
    _close(tgauss.gaussian_logpdf(_t(x), 0.3, 2.5), jgauss.gaussian_logpdf(jnp.asarray(x), 0.3, 2.5),
           **r)
    _close(tgauss.gaussian_pdf(_t(x), -0.2, 0.7), jgauss.gaussian_pdf(jnp.asarray(x), -0.2, 0.7),
           **r)
    m, d, n = 3, 4, 9
    obs = rng.normal(size=(n, d))
    mu = rng.normal(size=(m, d))
    g = rng.normal(scale=0.5, size=(m, d, d))
    sigma = g @ np.swapaxes(g, -1, -2) + np.eye(d)
    w = rng.dirichlet(np.ones(m))
    _close(tgauss.mvn_logpdf_full(_t(obs), _t(mu[0]), _t(sigma[0])),
           jgauss.mvn_logpdf_full(jnp.asarray(obs), jnp.asarray(mu[0]), jnp.asarray(sigma[0])), **r)
    _close(tgauss.mvn_pdf_full(_t(obs), _t(mu[1]), _t(sigma[1])),
           jgauss.mvn_pdf_full(jnp.asarray(obs), jnp.asarray(mu[1]), jnp.asarray(sigma[1])), **r)
    _close(tgauss.gmm_logpdf_full(_t(np.log(w)), _t(obs), _t(mu), _t(sigma)),
           jgauss.gmm_logpdf_full(jnp.asarray(np.log(w)), jnp.asarray(obs), jnp.asarray(mu),
                                  jnp.asarray(sigma)), **r)
    _close(tgauss.gmm_pdf_full(_t(w), _t(obs), _t(mu), _t(sigma)),
           jgauss.gmm_pdf_full(jnp.asarray(w), jnp.asarray(obs), jnp.asarray(mu),
                               jnp.asarray(sigma)), **r)
