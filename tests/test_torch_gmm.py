"""The port's standalone GMM against the JAX package: ``fit`` from the JAX
model's initial parameters (``convert.gmm_params_from_numpy``),
``logpdf``, ``score``, ``predict``, a starved component, and HDF5 files
across packages.

Tolerances (float64): EM is the same sums in another order, so the
histories agree to rtol 1e-10 and the parameters to 1e-9 after up to 20
sweeps; ``logpdf`` to 1e-12; ``predict`` exactly.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lnasr_tpu.models.gmm import GMM as JGMM
from lnasr_tpu.models.gmm import gmm_em_step as jgmm_em_step
from lnasr_tpu_torch.convert import gmm_params_from_numpy
from lnasr_tpu_torch.models.gmm import GMM, gmm_em_step

F64 = torch.float64


def _planted(rng, n_per=120):
    centers = np.array([[-4.0, 0.0], [4.0, 0.0], [0.0, 5.0]])
    x = np.concatenate([rng.normal(c, s, size=(n_per, 2))
                        for c, s in zip(centers, (0.5, 0.8, 0.6))])
    rng.shuffle(x)
    return x


def _pair(x, m, cov_type="diag", seed=1):
    jg = JGMM(m, x.shape[1], cov_type=cov_type, dtype=jnp.float64)
    jg.init_from_data(jnp.asarray(x), jax.random.PRNGKey(seed))
    tg = GMM(m, x.shape[1], cov_type=cov_type, dtype=F64, device="cpu")
    tg.set_params(gmm_params_from_numpy(*jg.params, device="cpu", dtype=F64))
    return jg, tg


def _params_close(tg, jg, rtol):
    for g, r in zip(tg.params, jg.params):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=rtol, atol=1e-12)


@pytest.mark.parametrize("cov_type", ["diag", "full"])
def test_fit_logpdf_predict_match_jax(cov_type):
    rng = np.random.default_rng(0)
    x = _planted(rng)
    jg, tg = _pair(x, 3, cov_type)
    ref = jg.fit(x, iters=20)
    hist = tg.fit(x, iters=20)
    assert len(hist) == len(ref) and hist[-1] > hist[0]
    np.testing.assert_allclose(hist, ref, rtol=1e-10)
    _params_close(tg, jg, 1e-9)
    q = rng.normal(scale=4.0, size=(40, 2))
    np.testing.assert_allclose(tg.logpdf(q).numpy(), np.asarray(jg.logpdf(jnp.asarray(q))),
                               rtol=1e-12)
    np.testing.assert_allclose(tg.score(q), jg.score(jnp.asarray(q)), rtol=1e-12)
    np.testing.assert_array_equal(tg.predict(x).numpy(), np.asarray(jg.predict(jnp.asarray(x))))


def test_starved_component_matches_jax():
    rng = np.random.default_rng(1)
    x = _planted(rng, n_per=60)
    jg, tg = _pair(x, 4)
    far = np.asarray(jg.mu).copy()
    far[3] = 1e3
    jg.mu = jnp.asarray(far)
    tg.mu = torch.as_tensor(far)
    ref_p, ref_l = jgmm_em_step(jg.params, jnp.asarray(x), "diag", 1e-4)
    got_p, got_l = gmm_em_step(tg.params, torch.as_tensor(x), "diag", 1e-4)
    np.testing.assert_allclose(float(got_l), float(ref_l), rtol=1e-12)
    for g, r in zip(got_p, ref_p):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-11)
    np.testing.assert_array_equal(got_p.mu[3].numpy(), far[3])


def test_init_from_data_draws_frames():
    rng = np.random.default_rng(2)
    x = _planted(rng, n_per=20)
    g = GMM(5, 2, dtype=F64, device="cpu").init_from_data(x, torch.Generator().manual_seed(3))
    rows = {int(np.flatnonzero((x == mu).all(1))[0]) for mu in g.mu.numpy()}
    assert len(rows) == 5
    np.testing.assert_allclose(g.cov.numpy(), np.broadcast_to(x.var(axis=0), (5, 2)), rtol=1e-12)
    np.testing.assert_allclose(torch.exp(g.log_w).sum().item(), 1.0, rtol=1e-12)


def test_hdf5_cross_load_both_ways(tmp_path):
    rng = np.random.default_rng(3)
    x = _planted(rng, n_per=40)
    for cov_type in ("diag", "full"):
        jg, tg = _pair(x, 3, cov_type)
        jg.fit(x, iters=5)
        tg.fit(x, iters=5)
        jg.save(str(tmp_path / f"jax_{cov_type}.h5"))
        tg.save(str(tmp_path / f"port_{cov_type}.h5"))
        got = GMM(1, 1, dtype=F64, device="cpu").load(str(tmp_path / f"jax_{cov_type}.h5"))
        back = JGMM(1, 1, dtype=jnp.float64).load(str(tmp_path / f"port_{cov_type}.h5"))
        assert got.cov_type == back.cov_type == cov_type and (got.m, got.d) == (3, 2)
        _params_close(got, jg, 0)
        for g, r in zip(tg.params, back.params):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        np.testing.assert_allclose(got.score(x), jg.score(jnp.asarray(x)), rtol=1e-12)
