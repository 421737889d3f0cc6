"""The port's sequence parallelism (``parallel/seqscan.py`` and the
time-sharded EM of ``parallel/training.py``) against the JAX package, on
a spawned world of 4 gloo ranks on the CPU; and ``entry.dryrun_multichip``.

Every sequence-parallel case of ``tests/test_parallel.py`` has its
counterpart here, run by :mod:`lnasr_tpu_torch.parallel.cases` inside ONE
spawned world (the module fixture ``world``); the JAX package's seq axis
of 8 maps to 4 ranks (a seq axis of 2 runs on a (2, 2, 1) mesh). Each
result is held against the JAX single-chip scan or EM sweep with the JAX
test's tolerances, float64: forward and backward rtol 1e-9 / atol 1e-11,
loglik rtol 1e-12; Viterbi paths equal, scores rtol 1e-12; the EM sweep's
loglik rtol 1e-10 and params rtol 1e-8 / atol 1e-10. Once per function
the JAX parallel function itself (on the conftest's virtual mesh) is the
reference.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lnasr_tpu import parallel as JP
from lnasr_tpu.config import GMMHMMConfig as JGMMHMMConfig
from lnasr_tpu.models.gmmhmm import GMMHMM as JGMMHMM
from lnasr_tpu.models.gmmhmm import gmmhmm_em_step as jgmm_step
from lnasr_tpu.models.hmm import HMM as JHMM
from lnasr_tpu.models.hmm import em_step as jhmm_step
from lnasr_tpu.ops.trellis import backward_scan, forward_scan, viterbi_scan
from lnasr_tpu_torch import entry
from lnasr_tpu_torch.config import GMMHMMConfig
from lnasr_tpu_torch.parallel import cases, distributed

WORLD = 4
FORWARD_CASES = [(2, 2), (4, 4), (4, 8)]  # (seq, seed): the JAX test's seq 8 maps to 4
BACKWARD_CASES = [(2, 64), (4, 37), (4, 64)]  # (seq, T)
EM_CASES = [(4, 64), (4, 53)]  # (seq, T)


def _mesh(seq):
    return (WORLD // seq, seq, 1)


def _jmesh(seq):
    return JP.make_mesh(JP.mesh_shape_for(seq, data=1, seq=seq), devices=jax.devices()[:seq])


def _pcfg(jcfg) -> dict:
    return {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(GMMHMMConfig)}


def _trellis(seed, n, t):
    rng = np.random.default_rng(seed)
    log_a = np.log(rng.dirichlet(np.ones(n), size=n))
    log_pi = np.log(rng.dirichlet(np.ones(n)))
    log_b = rng.normal(size=(t, n))
    return log_pi, log_a, log_b


def _masked_forward():
    log_pi, log_a, log_b = _trellis(41, 4, 45)  # not divisible by 4
    return log_pi, log_a, log_b, np.arange(45) < 39


def _masked_viterbi():
    log_pi, log_a, log_b = _trellis(42, 4, 30)  # not divisible by 4
    return log_pi, log_a, log_b, np.arange(30) < 26


def _backward(seq, t):
    rng = np.random.default_rng(seq * 100 + t)
    log_a = np.log(rng.dirichlet(np.ones(5), size=5))
    log_b = rng.normal(size=(t, 5))
    mask = np.ones(t, bool)
    mask[t - 4:] = False
    return log_a, log_b, mask


def _em(seq, t):
    rng = np.random.default_rng(seq + t)
    cfg = JGMMHMMConfig(n_states=3, n_mix=2, dim=4)
    obs = rng.normal(size=(t, 4)) + np.sin(np.arange(t))[:, None]
    mask = np.arange(t) < t - 3
    model = JGMMHMM(cfg, dtype=jnp.float64)
    model.init_from_data(obs, jax.random.PRNGKey(1))
    return cfg, model, obs, mask


def _em_discrete():
    rng = np.random.default_rng(5)
    t = 61
    obs = rng.integers(0, 3, size=t)
    mask = np.arange(t) < t - 4
    model = JHMM(n=2, m=3, dtype=jnp.float64)
    model.reset("random", jax.random.PRNGKey(3))
    return model, obs, mask


def _em_multi():
    rng = np.random.default_rng(77)
    cfg = JGMMHMMConfig(n_states=2, n_mix=2, dim=3)
    obs = rng.normal(size=(96, 3)) + np.sign(np.sin(np.arange(96)))[:, None]
    model = JGMMHMM(cfg, dtype=jnp.float64)
    model.init_from_data(obs, jax.random.PRNGKey(2))
    return cfg, model, obs


def _arrays(params):
    return [np.asarray(x) for x in params]


@pytest.fixture(scope="module")
def world():
    """Every case below, run once by each of 4 spawned gloo ranks:
    ``[{key: result}]`` in rank order."""
    todo = []
    for seq, seed in FORWARD_CASES:
        log_pi, log_a, log_b = _trellis(seed, 5, 64)
        todo.append((f"fwd_{seq}_{seed}", "seq_forward",
                     dict(log_pi=log_pi, log_a=log_a, log_b=log_b, mesh=_mesh(seq))))
    for seq in (2, 4):
        log_pi, log_a, log_b = _trellis(seq + 10, 4, 48)
        todo.append((f"vit_{seq}", "seq_viterbi",
                     dict(log_pi=log_pi, log_a=log_a, log_b=log_b, mesh=_mesh(seq))))
    for seq, t in BACKWARD_CASES:
        log_a, log_b, mask = _backward(seq, t)
        for tag, mk in (("full", None), ("masked", mask)):
            todo.append((f"bwd_{seq}_{t}_{tag}", "seq_backward",
                         dict(log_a=log_a, log_b=log_b, mesh=_mesh(seq), mask=mk)))
    log_pi, log_a, log_b, mask = _masked_forward()
    todo.append(("fwd_masked", "seq_forward", dict(log_pi=log_pi, log_a=log_a, log_b=log_b,
                                                   mesh=_mesh(4), mask=mask)))
    log_pi, log_a, log_b, mask = _masked_viterbi()
    todo.append(("vit_masked", "seq_viterbi", dict(log_pi=log_pi, log_a=log_a, log_b=log_b,
                                                   mesh=_mesh(4), mask=mask)))
    for seq, t in EM_CASES:
        cfg, model, obs, mask = _em(seq, t)
        todo.append((f"em_{seq}_{t}", "seq_train", dict(
            config=_pcfg(model.config), params=_arrays(model.params), obs=obs, mesh=_mesh(seq),
            mask=mask)))
    model, obs, mask = _em_discrete()
    todo.append(("em_discrete", "seq_train", dict(config=None, params=_arrays(model.params),
                                                  obs=obs, mesh=_mesh(4), mask=mask)))
    cfg, model, obs = _em_multi()
    todo.append(("em_multi", "seq_train", dict(config=_pcfg(model.config),
                                               params=_arrays(model.params), obs=obs,
                                               mesh=_mesh(4), iters=6)))
    return distributed.run_ranks(cases.run_cases, WORLD, args=(todo,), device="cpu")


def _res(world, key):
    return world[0][key]


def _assert_same(got, ref, what):
    if isinstance(ref, (list, tuple)):
        assert len(got) == len(ref), what
        for g, r in zip(got, ref):
            _assert_same(g, r, what)
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(ref), err_msg=what)
        assert np.asarray(got).dtype == np.asarray(ref).dtype, what


def test_every_rank_returns_the_same_results(world):
    for rank, got in enumerate(world[1:], start=1):
        for key, ref in world[0].items():
            _assert_same(got[key], ref, f"rank {rank}, {key}")


# -- forward, backward, Viterbi --------------------------------------------------


@pytest.mark.parametrize("seq,seed", FORWARD_CASES)
def test_seq_parallel_forward(world, seq, seed):
    ref = forward_scan(*(jnp.asarray(x) for x in _trellis(seed, 5, 64)))
    alpha, loglik = _res(world, f"fwd_{seq}_{seed}")
    np.testing.assert_allclose(alpha, np.asarray(ref.alpha), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(float(loglik), float(ref.loglik), rtol=1e-12)


def test_seq_parallel_forward_matches_jax_seq_parallel(world):
    alpha_ref, ll_ref = JP.forward_seq_parallel(
        *(jnp.asarray(x) for x in _trellis(4, 5, 64)), _jmesh(4))
    alpha, loglik = _res(world, "fwd_4_4")
    np.testing.assert_allclose(alpha, np.asarray(alpha_ref), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(float(loglik), float(ll_ref), rtol=1e-12)


@pytest.mark.parametrize("seq", [2, 4])
def test_seq_parallel_viterbi(world, seq):
    ref = viterbi_scan(*(jnp.asarray(x) for x in _trellis(seq + 10, 4, 48)))
    path, score = _res(world, f"vit_{seq}")
    np.testing.assert_array_equal(path, np.asarray(ref.path))
    assert path.dtype == np.int32
    np.testing.assert_allclose(float(score), float(ref.score), rtol=1e-12)


def test_seq_parallel_viterbi_matches_jax_seq_parallel(world):
    log_pi, log_a, log_b, mask = _masked_viterbi()
    path_ref, score_ref = JP.viterbi_seq_parallel(
        jnp.asarray(log_pi), jnp.asarray(log_a), jnp.asarray(log_b), _jmesh(4),
        jnp.asarray(mask))
    path, score = _res(world, "vit_masked")
    np.testing.assert_array_equal(path, np.asarray(path_ref))
    np.testing.assert_allclose(float(score), float(score_ref), rtol=1e-12)


@pytest.mark.parametrize("seq,t", BACKWARD_CASES)
def test_seq_parallel_backward(world, seq, t):
    """Backward over the seq axis equals the sequential scan, including
    non-divisible T (auto-padding) and masked tails."""
    log_a, log_b, mask = _backward(seq, t)
    for tag, mk in (("full", None), ("masked", mask)):
        ref = backward_scan(jnp.asarray(log_a), jnp.asarray(log_b),
                            None if mk is None else jnp.asarray(mk))
        np.testing.assert_allclose(_res(world, f"bwd_{seq}_{t}_{tag}"), np.asarray(ref),
                                   rtol=1e-9, atol=1e-11, err_msg=tag)


def test_seq_parallel_backward_matches_jax_seq_parallel(world):
    log_a, log_b, mask = _backward(4, 37)
    ref = JP.backward_seq_parallel(jnp.asarray(log_a), jnp.asarray(log_b), _jmesh(4),
                                   jnp.asarray(mask))
    np.testing.assert_allclose(_res(world, "bwd_4_37_masked"), np.asarray(ref), rtol=1e-9,
                               atol=1e-11)


def test_seq_parallel_forward_masked_nondivisible(world):
    log_pi, log_a, log_b, mask = _masked_forward()
    ref = forward_scan(jnp.asarray(log_pi), jnp.asarray(log_a), jnp.asarray(log_b),
                       jnp.asarray(mask))
    alpha, loglik = _res(world, "fwd_masked")
    np.testing.assert_allclose(alpha, np.asarray(ref.alpha), rtol=1e-9, atol=1e-11)
    np.testing.assert_allclose(float(loglik), float(ref.loglik), rtol=1e-12)


def test_seq_parallel_viterbi_masked_nondivisible(world):
    log_pi, log_a, log_b, mask = _masked_viterbi()
    ref = viterbi_scan(jnp.asarray(log_pi), jnp.asarray(log_a), jnp.asarray(log_b),
                       jnp.asarray(mask))
    path, score = _res(world, "vit_masked")
    np.testing.assert_array_equal(path, np.asarray(ref.path))
    np.testing.assert_allclose(float(score), float(ref.score), rtol=1e-12)


# -- time-sharded EM ------------------------------------------------------------


def _check(params, ref, fields):
    for name, g in zip(fields, params):
        np.testing.assert_allclose(g, np.asarray(getattr(ref, name)), rtol=1e-8, atol=1e-10,
                                   err_msg=name)


@pytest.mark.parametrize("seq,t", EM_CASES)
def test_seq_parallel_em_matches_single_chip(world, seq, t):
    """Baum-Welch on ONE long (masked, non-divisible) utterance sharded
    over the seq axis reproduces the single-chip EM sweep."""
    cfg, model, obs, mask = _em(seq, t)
    p_ref, ll_ref = jgmm_step(model.params, jnp.asarray(obs)[None], jnp.asarray(mask)[None],
                              cov_type="diag")
    hist, params = _res(world, f"em_{seq}_{t}")
    np.testing.assert_allclose(hist[0], float(ll_ref), rtol=1e-10)
    _check(params, p_ref, ("log_a", "log_pi", "log_w", "mu", "cov"))


def test_seq_parallel_em_matches_jax_seq_parallel(world):
    cfg, model, obs, mask = _em(4, 53)
    hist_ref = JP.train_seq_parallel(model, obs, _jmesh(4), iters=1, mask=mask)
    hist, params = _res(world, "em_4_53")
    np.testing.assert_allclose(hist, hist_ref, rtol=1e-10)
    _check(params, model, ("log_a", "log_pi", "log_w", "mu", "cov"))


def test_seq_parallel_discrete_hmm_em_matches_single_chip(world):
    model, obs, mask = _em_discrete()
    p_ref, ll_ref = jhmm_step(model.params, jnp.asarray(obs)[None], jnp.asarray(mask)[None])
    hist, params = _res(world, "em_discrete")
    np.testing.assert_allclose(hist[0], float(ll_ref), rtol=1e-10)
    _check(params, p_ref, ("log_a", "log_b", "log_pi"))


def test_seq_parallel_discrete_hmm_em_matches_jax_seq_parallel(world):
    model, obs, mask = _em_discrete()
    hist_ref = JP.train_seq_parallel(model, obs, _jmesh(4), iters=1, mask=mask)
    hist, params = _res(world, "em_discrete")
    np.testing.assert_allclose(hist, hist_ref, rtol=1e-10)
    _check(params, model.params, ("log_a", "log_b", "log_pi"))


def test_seq_parallel_em_multi_iteration_improves(world):
    cfg, model, obs = _em_multi()
    hist, params = _res(world, "em_multi")
    assert hist[-1] > hist[0]
    assert np.all(np.isfinite(hist))
    ref = model.train(obs, iters=6)
    np.testing.assert_allclose(hist, ref, rtol=1e-9)


# -- the entry point --------------------------------------------------------------


def test_dryrun_multichip_on_the_cpu():
    """``entry.dryrun_multichip`` runs every multi-rank path on 4 gloo
    ranks: equal results on every rank, finite, and the backoff hop's
    words equal to the dense hop's (checked inside)."""
    out = entry.dryrun_multichip(WORLD, device="cpu")
    assert all(r == out[0] for r in out)
    assert out[0]["backend"] == "gloo"
    for key in ("dp_em", "mp_em", "seq_forward", "seq_em", "decode_dense", "pipeline_scores",
                "pipeline_decode"):
        assert np.all(np.isfinite(out[0][key])), key
    if not torch.cuda.is_available():  # the default device is the card: no quiet CPU run
        with pytest.raises(RuntimeError, match="CUDA"):
            entry.dryrun_multichip(2)
