"""The port's GMM-HMM training (``gmmhmm_em_step``, the starvation guard,
``init_left_to_right``, ``train``) against the JAX package, with the JAX
model's parameters carried over (``convert.params_from_numpy``).

Tolerances: at float64 one sweep agrees to rtol 1e-10 (the emission
GEMMs and moment sums add in another order; the M-step divides by
occupancies, which amplifies that by their condition, ~1e2 here), and
three chained sweeps of ``train`` to rtol 1e-9. -inf entries must match
exactly. At float32 a sweep is held within 2e-3 relative of the float64
sweep from the same start (~2^-24 per op, amplified by the
cancellations of the second moments minus the squared means).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lnasr_tpu.config import GMMHMMConfig as JGMMHMMConfig
from lnasr_tpu.models import gmmhmm as jgh
from lnasr_tpu_torch.config import GMMHMMConfig
from lnasr_tpu_torch.convert import params_from_numpy
from lnasr_tpu_torch.models import gmmhmm as tgh

F64 = torch.float64
N, M, D = 3, 2, 4


def _features(rng, b=3, t=20, d=D):
    shift = np.linspace(-2.0, 2.0, t)[None, :, None]  # drifts through the states
    return rng.normal(size=(b, t, d)) + shift


def _jax_model(feats, cov_type="diag", seed=3, n=N, m=M):
    d = feats.shape[-1]
    model = jgh.GMMHMM(JGMMHMMConfig(n_states=n, n_mix=m, dim=d, cov_type=cov_type),
                       dtype=jnp.float64)
    model.init_left_to_right(feats.reshape(-1, d), jax.random.PRNGKey(seed))
    return model


def _port_params(jmodel, dtype=F64):
    return params_from_numpy(*jmodel.params, device="cpu", dtype=dtype)


def _close(got, ref, rtol):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got) else got, np.asarray(ref),
                               rtol=rtol, atol=1e-12)


def _step_both(jmodel, feats, mask, **kw):
    ref = jgh.gmmhmm_em_step(jmodel.params, jnp.asarray(feats), jnp.asarray(mask), **kw)
    got = tgh.gmmhmm_em_step(_port_params(jmodel), torch.as_tensor(feats),
                             torch.as_tensor(mask), **kw)
    return got, ref


@pytest.mark.parametrize("cov_type", ["diag", "full"])
def test_em_step_matches_jax(cov_type):
    rng = np.random.default_rng(1)
    feats = _features(rng)
    mask = np.ones(feats.shape[:2], bool)
    mask[2, 13:] = False
    jm = _jax_model(feats, cov_type)
    if cov_type == "full":  # non-diagonal covariances
        g = rng.normal(scale=0.3, size=(N, M, D, D))
        jm.cov = jm.cov + jnp.asarray(g @ np.swapaxes(g, -1, -2))
    kw = dict(cov_type=cov_type, min_std=jm.config.min_std,
              var_floor=jm.config.var_floor if cov_type == "diag" else 1e-3)
    (got_p, got_l), (ref_p, ref_l) = _step_both(jm, feats, mask, **kw)
    _close(got_l, ref_l, 1e-12)
    for g, r in zip(got_p, ref_p):
        _close(g, r, 1e-10)
    assert torch.all(got_p.log_a[1, 0] == -torch.inf)  # the left-to-right zeros stay


def test_starved_component_and_tuple_floor_match_jax():
    """A component far from every frame starves: it keeps its mean and
    covariance and gets the smallest weight; the per-dim floor binds."""
    rng = np.random.default_rng(2)
    feats = _features(rng, b=2, t=16)
    mask = np.ones(feats.shape[:2], bool)
    jm = _jax_model(feats)
    jm.mu = jm.mu.at[1, 1].set(1e3)  # state 1, mixture 1: never responsible
    floor = (0.05, 2.0, 0.05, 0.9)  # dims 1 and 3 floored
    (got_p, got_l), (ref_p, ref_l) = _step_both(jm, feats, mask, var_floor=floor)
    _close(got_l, ref_l, 1e-12)
    for g, r in zip(got_p, ref_p):
        _close(g, r, 1e-10)
    np.testing.assert_array_equal(got_p.mu[1, 1].numpy(), np.asarray(jm.mu[1, 1]))
    np.testing.assert_array_equal(got_p.cov[1, 1].numpy(), np.asarray(jm.cov[1, 1]))
    assert float(got_p.log_w[1, 1]) < -700.0  # log(tiny) before renormalizing
    assert torch.all(got_p.cov[..., 1] >= 2.0) and torch.all(got_p.cov[..., 3] >= 0.9)


def test_init_left_to_right_structure():
    rng = np.random.default_rng(3)
    n, m, d = 4, 3, 5
    frames = rng.normal(size=(37, d))
    model = tgh.GMMHMM(GMMHMMConfig(n_states=n, n_mix=m, dim=d), dtype=F64, device="cpu")
    model.init_left_to_right(frames, torch.Generator().manual_seed(0))
    a = model.log_a.numpy()
    for i in range(n):
        for j in range(n):
            if i == j == n - 1:
                assert a[i, j] == 0.0
            elif j == i or j == i + 1:
                assert a[i, j] == np.log(0.5)
            else:
                assert a[i, j] == -np.inf
    np.testing.assert_array_equal(model.log_pi.numpy(), [0.0] + [-np.inf] * (n - 1))
    np.testing.assert_allclose(model.log_w.numpy(), -np.log(m))
    # each state's means are distinct frames of its own time slice
    for i, idx in enumerate(np.array_split(np.arange(len(frames)), n)):
        rows = [int(np.flatnonzero((frames == mu).all(1))[0]) for mu in model.mu[i].numpy()]
        assert set(rows) <= set(idx.tolist()) and len(set(rows)) == m
    # the covariance is the population variance, floored as the JAX package does
    jm = jgh.GMMHMM(JGMMHMMConfig(n_states=n, n_mix=m, dim=d), dtype=jnp.float64)
    jm.init_left_to_right(frames, jax.random.PRNGKey(0))
    assert model.config.var_floor == jm.config.var_floor
    np.testing.assert_allclose(model.cov.numpy(), np.asarray(jm.cov), rtol=1e-14)
    for x, y in ((model.log_a, jm.log_a), (model.log_pi, jm.log_pi), (model.log_w, jm.log_w)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))
    # a slice shorter than the mixtures draws with replacement
    short = tgh.GMMHMM(GMMHMMConfig(n_states=3, n_mix=4, dim=d), dtype=F64, device="cpu")
    short.init_left_to_right(frames[:6], torch.Generator().manual_seed(1))
    for i, idx in enumerate(np.array_split(np.arange(6), 3)):
        assert all(any((frames[j] == mu).all() for j in idx) for mu in short.mu[i].numpy())


@pytest.mark.parametrize("cov_type", ["diag", "full"])
def test_train_matches_jax_and_is_monotone(cov_type):
    rng = np.random.default_rng(4)
    feats = _features(rng, b=3, t=24)
    mask = np.ones(feats.shape[:2], bool)
    mask[0, 19:] = False
    jm = _jax_model(feats, cov_type, seed=5)
    tm = tgh.GMMHMM(GMMHMMConfig(**dataclasses.asdict(jm.config)), dtype=F64,
                    device="cpu").set_params(_port_params(jm))
    ref = jm.train(jnp.asarray(feats), iters=3, eps=0.0, mask=jnp.asarray(mask))
    hist = tm.train(feats, iters=3, eps=0.0, mask=mask)
    np.testing.assert_allclose(hist, ref, rtol=1e-9)
    assert all(b >= a - 1e-9 * abs(a) for a, b in zip(hist, hist[1:]))
    for g, r in zip(tm.params, jm.params):
        _close(g, r, 1e-9)


def test_float32_sweep_within_bar():
    rng = np.random.default_rng(5)
    feats = _features(rng, b=4, t=30, d=6)
    mask = np.ones(feats.shape[:2], bool)
    jm = _jax_model(feats, n=3, m=2)
    kw = dict(var_floor=jm.config.var_floor)
    p64, l64 = tgh.gmmhmm_em_step(_port_params(jm), torch.as_tensor(feats),
                                  torch.as_tensor(mask), **kw)
    p32, l32 = tgh.gmmhmm_em_step(_port_params(jm, torch.float32),
                                  torch.as_tensor(feats, dtype=torch.float32),
                                  torch.as_tensor(mask), **kw)
    assert p32.mu.dtype == torch.float32
    np.testing.assert_allclose(float(l32), float(l64), rtol=1e-6)
    for name in ("mu", "cov"):
        a, b = getattr(p32, name).double(), getattr(p64, name)
        assert float((a - b).abs().max() / b.abs().max()) < 2e-3, name
    for name in ("log_a", "log_pi", "log_w"):
        np.testing.assert_allclose(torch.exp(getattr(p32, name)).double().numpy(),
                                   torch.exp(getattr(p64, name)).numpy(), atol=2e-3)
