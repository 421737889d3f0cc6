"""The port's GMM emissions and GMM-HMM inference against the JAX package,
with the JAX model's parameters carried over through ``convert.py``.

Emission tolerance: the diagonal scorer is one fp32 dot product of length
2D+1 whose terms (o^2 ivar/2, o mu ivar, the constant) are large and
cancel to a much smaller log-density. Summed in another order, two fp32
dot products may differ by up to about (2D+1) * 2^-24 * sum|terms| each,
so the bar is twice that, per frame and component, plus 1e-5 relative for
the logsumexp over mixtures on top.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lnasr_tpu.config import GMMHMMConfig as JGMMHMMConfig
from lnasr_tpu.models.gmmhmm import GMMHMM as JGMMHMM
from lnasr_tpu.ops import gaussian as jgauss
from lnasr_tpu_torch.config import GMMHMMConfig
from lnasr_tpu_torch.convert import params_from_numpy
from lnasr_tpu_torch.models.gmmhmm import GMMHMM
from lnasr_tpu_torch.ops import gaussian as tgauss

N, M, D = 5, 8, 39


def _jax_model(cov_type="diag", seed=0, n_frames=300):
    rng = np.random.default_rng(seed)
    obs = rng.normal(scale=10.0, size=(n_frames, D)).astype(np.float32)
    model = JGMMHMM(JGMMHMMConfig(N, M, D, cov_type=cov_type), dtype=jnp.float32)
    model.init_from_data(jnp.asarray(obs), jax.random.PRNGKey(seed))
    if cov_type == "full":  # make the covariances non-diagonal
        a = rng.normal(scale=0.3, size=(N, M, D, D))
        model.cov = jnp.asarray(np.asarray(model.cov) + a @ np.swapaxes(a, -1, -2), jnp.float32)
    return model


def _port(jmodel, cov_type="diag"):
    model = GMMHMM(GMMHMMConfig(N, M, D, cov_type=cov_type), device="cpu")
    return model.set_params(params_from_numpy(*jmodel.params, device="cpu"))


def _features(seed, b=3, t=40):
    rng = np.random.default_rng(100 + seed)
    return (rng.normal(scale=12.0, size=(b, t, D)) + 3.0).astype(np.float32)


def _emission_bound(obs, mu, var):
    """2 (2D+1) 2^-24 sum|terms| per (frame, component), max over components."""
    ivar = 1.0 / var.reshape(-1, D).astype(np.float64)
    mu2 = mu.reshape(-1, D).astype(np.float64)
    o = obs.astype(np.float64)
    terms = (0.5 * (o * o) @ ivar.T + np.abs(o) @ np.abs(mu2 * ivar).T
             + np.abs(0.5 * np.sum(mu2 * mu2 * ivar, -1) + 0.5 * np.sum(np.log(var.reshape(-1, D)), -1))
             + 0.5 * D * np.log(2 * np.pi))
    return 2 * (2 * D + 1) * 2.0 ** -24 * terms.max(-1)


def test_diag_emissions_match():
    jm = _jax_model()
    obs = _features(0)
    ref_b, ref_bm = jax.vmap(lambda o: jgauss.gmm_emissions_diag(o, *jm.params[2:]))(jnp.asarray(obs))
    got_b, got_bm = tgauss.gmm_emissions_diag(torch.as_tensor(obs), *_port(jm).params[2:])
    assert got_b.shape == (3, 40, N) and got_bm.shape == (3, 40, N, M)
    bound = _emission_bound(obs, np.asarray(jm.mu), np.asarray(jm.cov))
    err_bm = np.abs(got_bm.numpy() - np.asarray(ref_bm)).max(axis=(-1, -2))
    assert np.all(err_bm <= bound), (err_bm.max(), bound.min())
    ref_b = np.asarray(ref_b)
    err_b = np.abs(got_b.numpy() - ref_b)
    assert np.all(err_b <= bound[..., None] + 1e-5 * np.abs(ref_b)), err_b.max()


def test_full_emissions_match():
    jm = _jax_model("full")
    obs = _features(1, b=2, t=15)
    ref_b, _ = jax.vmap(lambda o: jgauss.gmm_emissions_full(o, *jm.params[2:]))(jnp.asarray(obs))
    got_b, _ = tgauss.gmm_emissions_full(torch.as_tensor(obs), *_port(jm, "full").params[2:])
    np.testing.assert_allclose(got_b.numpy(), np.asarray(ref_b), rtol=1e-4, atol=1e-2)


def test_decode_batch_matches_jax():
    jm = _jax_model(seed=1)
    tm = _port(jm)
    obs = _features(2, b=3, t=50)
    mask = np.arange(50)[None, :] < np.array([50, 33, 7])[:, None]
    ref = np.asarray(jm.decode_batch(jnp.asarray(obs), jnp.asarray(mask)))
    got = tm.decode_batch(obs, mask).numpy()
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(tm.decode(obs[0]).numpy(), np.asarray(jm.decode(obs[0])))


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_hdf5_roundtrip_between_packages(tmp_path, direction):
    jm = _jax_model(seed=2)
    tm = _port(jm)
    path = str(tmp_path / "model.h5")
    obs = _features(3, b=2, t=30)
    mask = np.ones((2, 30), bool)
    if direction == "jax_to_port":
        jm.save(path)
        loaded = GMMHMM(GMMHMMConfig(N, M, D), device="cpu").load(path)
        np.testing.assert_array_equal(loaded.decode_batch(obs, mask).numpy(),
                                      np.asarray(jm.decode_batch(jnp.asarray(obs), jnp.asarray(mask))))
        for a, b in zip(loaded.params, jm.params):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    else:
        tm.save(path)
        loaded = JGMMHMM(JGMMHMMConfig(N, M, D), dtype=jnp.float32).load(path)
        np.testing.assert_array_equal(np.asarray(loaded.decode_batch(jnp.asarray(obs), jnp.asarray(mask))),
                                      tm.decode_batch(obs, mask).numpy())
        for a, b in zip(loaded.params, tm.params):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())


def test_hdf5_full_covariance_and_si_only(tmp_path):
    import h5py

    jm = _jax_model("full", seed=3)
    path = str(tmp_path / "full.h5")
    jm.save(path)
    tm = GMMHMM(GMMHMMConfig(N, M, D, cov_type="full"), device="cpu").load(path)
    np.testing.assert_array_equal(tm.cov.numpy(), np.asarray(jm.cov))
    # a diagonal model read from a file without "var" takes si's diagonal
    dpath = str(tmp_path / "diag.h5")
    _jax_model(seed=4).save(dpath)
    with h5py.File(dpath, "a") as f:
        var = f["var"][...]
        del f["var"]
    td = GMMHMM(GMMHMMConfig(N, M, D), device="cpu").load(dpath)
    np.testing.assert_array_equal(td.cov.numpy(), var.astype(np.float32))


def test_init_from_data_follows_jax_rules():
    """Same rules as the JAX init (draws differ: torch.Generator vs
    jax.random): means are distinct data frames, A/pi/w uniform, the
    variance floor resolved identically from the same data."""
    rng = np.random.default_rng(9)
    obs = rng.normal(scale=[1.0] * 20 + [0.01] * 19, size=(200, D)).astype(np.float32)
    jm = JGMMHMM(JGMMHMMConfig(N, M, D), dtype=jnp.float32).init_from_data(
        jnp.asarray(obs), jax.random.PRNGKey(0))
    tm = GMMHMM(GMMHMMConfig(N, M, D), device="cpu").init_from_data(
        obs, torch.Generator().manual_seed(0))
    assert tm.config.var_floor == jm.config.var_floor
    np.testing.assert_allclose(tm.cov.numpy(), np.asarray(jm.cov), rtol=1e-5)
    for a, b in ((tm.log_a, jm.log_a), (tm.log_pi, jm.log_pi), (tm.log_w, jm.log_w)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    rows = tm.mu.numpy().reshape(-1, D)
    hits = [int(np.flatnonzero((obs == r).all(1))[0]) for r in rows]
    assert len(set(hits)) == N * M  # sampled without replacement
    # fewer frames than components: sampled with replacement
    small = GMMHMM(GMMHMMConfig(N, M, D), device="cpu").init_from_data(obs[:7])
    assert small.mu.shape == (N, M, D)
    # the same generator seed gives the same model
    again = GMMHMM(GMMHMMConfig(N, M, D), device="cpu").init_from_data(
        obs, torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(again.mu.numpy(), tm.mu.numpy())


@pytest.mark.parametrize("init_type", ["uniform", "random"])
@pytest.mark.parametrize("cov_type", ["diag", "full"])
def test_reset_shapes_and_normalization(init_type, cov_type):
    cfg = dataclasses.replace(GMMHMMConfig(3, 2, 4), cov_type=cov_type)
    m = GMMHMM(cfg, device="cpu").reset(init_type, torch.Generator().manual_seed(1))
    for x in (m.log_a, m.log_w):
        np.testing.assert_allclose(torch.logsumexp(x, dim=1).numpy(), 0.0, atol=1e-6)
    np.testing.assert_allclose(float(torch.logsumexp(m.log_pi, 0)), 0.0, atol=1e-6)
    assert m.cov.shape == ((3, 2, 4) if cov_type == "diag" else (3, 2, 4, 4))
    assert float(m.mu.abs().max()) <= 0.3
    with pytest.raises(ValueError):
        m.reset("bogus")
