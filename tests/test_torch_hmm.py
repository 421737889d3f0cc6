"""The port's discrete HMM (inference and Baum-Welch training) against the
JAX package, with the JAX model's parameters carried over
(``convert.hmm_params_from_numpy``).

Tolerances (float64): one EM sweep is the same sums in another order,
so parameters and logliks agree to rtol 1e-11; three chained sweeps of
``train`` to rtol 1e-10 (EM amplifies rounding a little each sweep).
-inf entries must match exactly. The order-fixed segment sum agrees with
``np.add.at`` to rtol 1e-13 and gives the same bits on every call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lnasr_tpu.models import hmm as jhmm
from lnasr_tpu_torch.convert import hmm_params_from_numpy
from lnasr_tpu_torch.models import hmm as thmm
from lnasr_tpu_torch.ops.numerics import segment_sum

F64 = torch.float64


def _jax_model(n=3, m=6, seed=7):
    return jhmm.HMM(n, m, dtype=jnp.float64).reset("random", key=jax.random.PRNGKey(seed))


def _port(jm):
    return thmm.HMM(device="cpu", dtype=F64).set_params(
        hmm_params_from_numpy(*jm.params, device="cpu", dtype=F64))


def _batch(rng, b=4, t=24, m=6):
    obs = rng.integers(0, m, size=(b, t))
    mask = np.ones((b, t), dtype=bool)
    mask[1, t - 5:] = False
    mask[3, t - 11:] = False
    return obs, mask


def _close(got, ref, rtol=1e-11):
    np.testing.assert_allclose(got.numpy() if torch.is_tensor(got) else got, np.asarray(ref),
                               rtol=rtol, atol=1e-13)


def test_inference_matches_jax():
    jm = _jax_model()
    tm = _port(jm)
    obs = np.random.default_rng(0).integers(0, 6, size=40)
    ref, got = jm.forward(jnp.asarray(obs)), tm.forward(obs)
    _close(got.alpha, ref.alpha)
    _close(tm.calc_prob(obs), jm.calc_prob(jnp.asarray(obs)))
    _close(tm.backward(obs), jm.backward(jnp.asarray(obs)))
    np.testing.assert_array_equal(tm.decode(obs).numpy(), np.asarray(jm.decode(jnp.asarray(obs))))
    obs_b, mask = _batch(np.random.default_rng(1))
    np.testing.assert_array_equal(tm.decode_batch(obs_b, mask).numpy(),
                                  np.asarray(jm.decode_batch(obs_b, mask)))


def test_em_step_matches_jax():
    jm = _jax_model()
    obs, mask = _batch(np.random.default_rng(2))
    ref_p, ref_l = jhmm.em_step(jm.params, jnp.asarray(obs), jnp.asarray(mask))
    got_p, got_l = thmm.em_step(_port(jm).params, torch.as_tensor(obs), torch.as_tensor(mask))
    _close(got_l, ref_l)
    for g, r in zip(got_p, ref_p):
        _close(g, r)
    assert got_p.n_states == 3 and got_p.n_symbols == 6


def test_train_matches_jax():
    jm = _jax_model(seed=3)
    tm = _port(jm)
    obs, mask = _batch(np.random.default_rng(3))
    ref_hist = jm.train(jnp.asarray(obs), iters=3, eps=0.0, mask=jnp.asarray(mask))
    hist = tm.train(obs, iters=3, eps=0.0, mask=mask)
    np.testing.assert_allclose(hist, ref_hist, rtol=1e-10)
    assert all(b >= a - 1e-9 for a, b in zip(hist, hist[1:]))  # EM never lowers the loglik
    for g, r in zip(tm.params, jm.params):
        _close(g, r, rtol=1e-10)
    # a single sequence is a batch of one
    seq = obs[0]
    ref1 = _jax_model(seed=4)
    got1 = _port(ref1)
    np.testing.assert_allclose(got1.train(seq, iters=2, eps=0.0),
                               ref1.train(jnp.asarray(seq), iters=2, eps=0.0), rtol=1e-10)


def test_batch_equals_combined_statistics_and_padding_changes_nothing():
    tm = _port(_jax_model())
    rng = np.random.default_rng(4)
    obs, mask = _batch(rng)
    stats = thmm._sequence_stats(tm.params, torch.as_tensor(obs), torch.as_tensor(mask))
    for k in range(len(obs)):
        length = int(mask[k].sum())
        one = thmm._sequence_stats(tm.params, torch.as_tensor(obs[k:k + 1, :length]),
                                   torch.ones((1, length), dtype=torch.bool))
        for g, r in zip(stats, one):
            _close(g[k], r[0].numpy(), rtol=1e-12)
    # a batch's update is the combination of the per-sequence statistics
    p_batch, l_batch = thmm.em_step(tm.params, torch.as_tensor(obs), torch.as_tensor(mask))
    combined = thmm._combine_stats(stats)
    for g, r in zip(p_batch, thmm._maximize(combined)):
        _close(g, r.numpy(), rtol=0)
    # padding every sequence with more masked frames changes nothing
    pad_obs = np.concatenate([obs, rng.integers(0, 6, size=(len(obs), 7))], axis=1)
    pad_mask = np.concatenate([mask, np.zeros((len(obs), 7), bool)], axis=1)
    p_pad, l_pad = thmm.em_step(tm.params, torch.as_tensor(pad_obs), torch.as_tensor(pad_mask))
    _close(l_pad, l_batch.numpy(), rtol=1e-13)
    for g, r in zip(p_pad, p_batch):
        _close(g, r.numpy(), rtol=1e-12)


def test_from_counts_matches_jax_with_unreachable_states():
    trans = np.array([[3.0, 1.0, 0.0], [0.0, 0.0, 0.0], [2.0, 0.0, 5.0]])  # state 1: no exits
    emit = np.array([[4.0, 0.0, 1.0, 0.0], [0.0, 0.0, 0.0, 0.0], [1.0, 1.0, 2.0, 0.0]])
    init = np.array([2.0, 0.0, 1.0])
    for add_one in (True, False):
        ref = jhmm.HMM.from_counts(trans, emit, init, emit_add_one=add_one)
        got = thmm.HMM.from_counts(trans, emit, init, emit_add_one=add_one, device="cpu")
        assert got.dtype == F64 and (got.n, got.m) == (3, 4)
        for g, r in zip(got.params, ref.params):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
        assert not any(torch.isnan(x).any() for x in got.params)
        assert torch.all(got.log_a[1] == -torch.inf)


def test_hdf5_cross_load_both_ways(tmp_path):
    jm = _jax_model()
    jm.save(str(tmp_path / "jax.h5"))
    got = thmm.HMM(device="cpu", dtype=F64).load(str(tmp_path / "jax.h5"))
    for g, r in zip(got.params, jm.params):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    tm = thmm.HMM(4, 9, device="cpu", dtype=F64).reset("random", torch.Generator().manual_seed(1))
    tm.save(str(tmp_path / "port.h5"))
    back = jhmm.HMM(dtype=jnp.float64).load(str(tmp_path / "port.h5"))
    assert (back.n, back.m) == (4, 9)
    for g, r in zip(tm.params, back.params):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_reset():
    tm = thmm.HMM(3, 5, device="cpu", dtype=F64)
    uni = tm.reset("uniform")
    np.testing.assert_allclose(torch.exp(uni.log_b).sum(1).numpy(), 1.0, rtol=1e-14)
    a = thmm.HMM(3, 5, device="cpu").reset("random", torch.Generator().manual_seed(2))
    b = thmm.HMM(3, 5, device="cpu").reset("random", torch.Generator().manual_seed(2))
    for x, y in zip(a.params, b.params):
        assert torch.equal(x, y) and torch.isfinite(x).all()
    np.testing.assert_allclose(torch.exp(a.log_a).sum(1).numpy(), 1.0, rtol=1e-6)
    with pytest.raises(ValueError):
        tm.reset("bogus")


def test_segment_sum_65536_symbols():
    rng = np.random.default_rng(5)
    n_sym, length = 65536, 3000
    # repeats (a small alphabet) and the whole range at once
    ids = np.concatenate([rng.integers(0, 40, size=length // 2),
                          rng.integers(0, n_sym, size=length // 2)])
    vals = rng.random(size=(length, 4)) * np.exp(rng.normal(scale=20.0, size=(length, 1)))
    ref = np.zeros((n_sym, 4))
    np.add.at(ref, ids, vals)
    got = segment_sum(torch.as_tensor(vals), torch.as_tensor(ids), n_sym)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-13, atol=0)
    again = segment_sum(torch.as_tensor(vals), torch.as_tensor(ids), n_sym)
    assert torch.equal(got, again)


def test_em_step_65536_symbols_matches_jax():
    """The segmenter's alphabet: the emission numerator is a segment sum
    over 65,536 symbols per sequence."""
    rng = np.random.default_rng(6)
    n, m, b, t = 4, 65536, 3, 30
    jm = jhmm.HMM(n, m, dtype=jnp.float64).reset("random", key=jax.random.PRNGKey(1))
    obs = np.where(rng.random((b, t)) < 0.5, rng.integers(0, 20, size=(b, t)),
                   rng.integers(0, m, size=(b, t)))
    mask = np.arange(t)[None, :] < np.array([[30], [22], [13]])
    ref_p, ref_l = jhmm.em_step(jm.params, jnp.asarray(obs), jnp.asarray(mask))
    got_p, got_l = thmm.em_step(_port(jm).params, torch.as_tensor(obs), torch.as_tensor(mask))
    _close(got_l, ref_l)
    for g, r in zip(got_p, ref_p):
        _close(g, r)
