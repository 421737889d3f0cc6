"""The port's ``parallel/`` (data- and model-parallel EM, the sharded
decode, the streaming pipeline, the launcher and the backend rule)
against the JAX package, on a spawned world of 4 gloo ranks on the CPU.

Every case of ``tests/test_parallel.py`` has its counterpart here, run
by :mod:`lnasr_tpu_torch.parallel.cases` inside ONE spawned world (the
module fixture ``world``); the JAX package's axis sizes of 8 map to 4
ranks. Each port result is held against the JAX single-chip function on
the same inputs (the JAX parameters carried over as NumPy) with the JAX
test's tolerances, and once per function against the JAX parallel
function itself on the conftest's virtual mesh (``shard_map`` compiles
are slow, so one shape each). Tolerances, float64: EM loglik rtol 1e-10
(the statistics cross the collective in linear space: ~1 ulp), params
rtol 1e-9 / atol 1e-11 (log_a and cov 1e-8 / 1e-10 as in the JAX test);
model-parallel emissions rtol 1e-9 / atol 1e-11; pipeline paths equal,
scores rtol 1e-10. The sharded decode is bitwise the single-process
``decode_batch``; model-parallel kill and resume is bitwise.
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lnasr_tpu import parallel as JP
from lnasr_tpu.config import GMMHMMConfig as JGMMHMMConfig
from lnasr_tpu.models.decoder import DecoderConfig as JDecoderConfig
from lnasr_tpu.models.decoder import FactoredDecodingGraph as JGraph
from lnasr_tpu.models.gmmhmm import GMMHMM as JGMMHMM
from lnasr_tpu.models.gmmhmm import gmmhmm_em_step as jgmm_step
from lnasr_tpu.models.hmm import HMM as JHMM
from lnasr_tpu.models.hmm import em_step as jhmm_step
from lnasr_tpu.models.lexicon import Lexicon as JLexicon
from lnasr_tpu.ops.gaussian import gmm_emissions_diag
from lnasr_tpu.ops.trellis import forward_scan, viterbi_scan
from lnasr_tpu_torch import parallel as TP
from lnasr_tpu_torch.config import GMMHMMConfig
from lnasr_tpu_torch.parallel import cases, distributed

WORLD = 4
FIELDS = ("log_a", "log_pi", "log_w", "mu", "cov")


def _pcfg(jcfg) -> dict:
    """A JAX ``GMMHMMConfig`` as the port's fields (what a rank can unpickle)."""
    return {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(GMMHMMConfig)}


def _arrays(params):
    return [np.asarray(x) for x in params]


def _jmesh(shape):
    """A JAX mesh of ``shape`` (data, seq, model) over the first devices."""
    n = int(np.prod(shape))
    return JP.make_mesh(JP.mesh_shape_for(n, *shape), devices=jax.devices()[:n])


# -- inputs: the JAX test's, seeded; the world and the JAX side share them ------


def _dp_gmm():
    rng = np.random.default_rng(0)
    cfg = JGMMHMMConfig(n_states=3, n_mix=2, dim=4)
    obs = rng.normal(size=(8, 20, 4))
    mask = np.ones((8, 20), bool)
    model = JGMMHMM(cfg, dtype=jnp.float64).reset("random", jax.random.PRNGKey(1))
    return cfg, model, obs, mask


def _dp_hmm():
    rng = np.random.default_rng(2)
    obs = rng.integers(0, 5, size=(16, 30))
    mask = np.ones((16, 30), bool)
    model = JHMM(3, 5, dtype=jnp.float64).reset("random", jax.random.PRNGKey(3))
    return model, obs, mask


def _dp_multi():
    rng = np.random.default_rng(4)
    cfg = JGMMHMMConfig(n_states=2, n_mix=2, dim=3)
    obs = rng.normal(size=(8, 25, 3)) + rng.normal(size=(8, 1, 3))
    mask = np.ones((8, 25), bool)
    model = JGMMHMM(cfg, dtype=jnp.float64)
    model.init_from_data(obs.reshape(-1, 3), jax.random.PRNGKey(5))
    return cfg, model, obs, mask


def _single():
    rng = np.random.default_rng(7)
    cfg = JGMMHMMConfig(n_states=2, n_mix=1, dim=3)
    obs = rng.normal(size=(4, 10, 3))
    mask = np.ones((4, 10), bool)
    model = JGMMHMM(cfg, dtype=jnp.float64).reset("random", jax.random.PRNGKey(8))
    return cfg, model, obs, mask


def _mp_emis(seed):
    rng = np.random.default_rng(seed)
    n, m, d, t = 3, 16, 6, 40
    log_w = np.log(rng.dirichlet(np.ones(m), size=n))
    mu = rng.normal(size=(n, m, d))
    var = rng.uniform(0.5, 2.0, size=(n, m, d))
    obs = rng.normal(size=(t, d))
    return obs, log_w, mu, var


def _pipe(seed, t=64, n=4, m=3, d=6):
    rng = np.random.default_rng(seed)
    log_a = np.log(rng.dirichlet(np.ones(n), size=n))
    log_pi = np.log(rng.dirichlet(np.ones(n)))
    log_w = np.log(rng.dirichlet(np.ones(m), size=n))
    mu = rng.normal(size=(n, m, d))
    var = rng.uniform(0.5, 2.0, size=(n, m, d))
    feats = rng.normal(size=(t, d))
    return log_pi, log_a, log_w, mu, var, feats


def _pipe_kw(seed, **kw):
    names = ("log_pi", "log_a", "log_w", "mu", "var", "feats")
    return dict(zip(names, _pipe(seed)), **kw)


def _mp_em():
    rng = np.random.default_rng(5)
    cfg = JGMMHMMConfig(n_states=3, n_mix=4, dim=5)
    obs = rng.normal(size=(4, 18, 5))
    mask = np.ones((4, 18), bool)
    mask[2, 14:] = False
    model = JGMMHMM(cfg, dtype=jnp.float64).reset("random", jax.random.PRNGKey(2))
    return cfg, model, obs, mask


def _mp_loop():
    rng = np.random.default_rng(6)
    cfg = JGMMHMMConfig(n_states=2, n_mix=4, dim=3)
    obs = rng.normal(size=(4, 12, 3))
    mask = np.ones((4, 12), bool)
    model = JGMMHMM(cfg, dtype=jnp.float64)
    model.init_from_data(obs.reshape(-1, 3), jax.random.PRNGKey(3))
    return cfg, model, obs, mask


def _decode_units(rng, v=12, dim=5, n_states=3):
    """The JAX test's whole-word units: JAX namespaces and the port's dicts."""
    jcfg = JGMMHMMConfig(n_states=n_states, n_mix=1, dim=dim)
    means = rng.normal(scale=8.0, size=(v, dim))
    with np.errstate(divide="ignore"):
        log_a = np.log(np.where(np.eye(n_states) + np.eye(n_states, k=1) > 0, 0.5, 0.0)
                       ).astype(np.float32)
    jax_units, port_units = {}, {}
    for i in range(v):
        arrays = dict(log_a=log_a, log_w=np.zeros((n_states, 1), np.float32),
                      mu=(means[i][None, None, :]
                          + rng.normal(scale=0.3, size=(n_states, 1, dim))).astype(np.float32),
                      cov=np.full((n_states, 1, dim), 0.1, np.float32))
        jax_units[f"w{i:02d}"] = types.SimpleNamespace(n=n_states, config=jcfg, **arrays)
        port_units[f"w{i:02d}"] = dict(config=_pcfg(jcfg),
                                       log_pi=np.full(n_states, -np.log(n_states)), **arrays)
    return jax_units, port_units


def _decode():
    rng = np.random.default_rng(5)
    jax_units, port_units = _decode_units(rng)
    b, t = 8, 21
    feats = rng.normal(scale=8.0, size=(b, t, 5)).astype(np.float32)
    masks = np.ones((b, t), bool)
    masks[1, 15:] = False  # one bucket-padded segment
    return jax_units, port_units, feats, masks


def _mp_kw(make):
    cfg, model, obs, mask = make()
    return dict(config=_pcfg(cfg), params=_arrays(model.params), obs=obs, mask=mask)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Every case below, run once by each of 4 spawned gloo ranks:
    ``[{key: result}]`` in rank order."""
    ckdir = str(tmp_path_factory.mktemp("mp_ckpt"))
    cfg, model, obs, mask = _dp_gmm()
    hmm, hobs, hmask = _dp_hmm()
    mcfg, mmodel, mobs, mmask = _dp_multi()
    _, port_units, feats, masks = _decode()
    todo = [
        ("dp_gmm", "dp_train", dict(config=_pcfg(cfg), params=_arrays(model.params), obs=obs,
                                    mask=mask, mesh=(4, 1, 1))),
        ("dp_hmm", "dp_train", dict(config=None, params=_arrays(hmm.params), obs=hobs,
                                    mask=hmask, mesh=(4, 1, 1))),
        ("dp_multi", "dp_train", dict(config=_pcfg(mcfg), params=_arrays(mmodel.params),
                                      obs=mobs, mask=mmask, mesh=(4, 1, 1), iters=8)),
        ("mp_emis_2", "mp_emissions", dict(zip(("obs", "log_w", "mu", "var"), _mp_emis(2)),
                                           mesh=(2, 1, 2))),
        ("mp_emis_4", "mp_emissions", dict(zip(("obs", "log_w", "mu", "var"), _mp_emis(8)),
                                           mesh=(1, 1, 4))),
        ("pipe_max", "pipeline_scores", _pipe_kw(99, chunk=16, semiring="max")),
        ("pipe_bad_chunk", "raises:pipeline_scores", _pipe_kw(3, chunk=7)),
        ("pipe_bad_semiring", "raises:pipeline_scores", _pipe_kw(3, chunk=16, semiring="sum")),
        ("pipe_one_stage", "raises:pipeline_scores", _pipe_kw(3, chunk=16, n_stages=1)),
        ("mp_loop_ref", "mp_train", dict(_mp_kw(_mp_loop), mesh=(2, 1, 2), max_iters=4)),
        ("mp_loop_killed", "mp_train", dict(_mp_kw(_mp_loop), mesh=(2, 1, 2), max_iters=2,
                                            checkpoint_dir=ckdir)),
        ("mp_loop_resumed", "mp_train", dict(_mp_kw(_mp_loop), mesh=(2, 1, 2), max_iters=4,
                                             checkpoint_dir=ckdir)),
        ("mp_bad_axis", "raises:mp_steps", dict(_mp_kw(_mp_em), mesh=(1, 1, 4), iters=1)
         | {"config": _pcfg(JGMMHMMConfig(n_states=3, n_mix=6, dim=5))}),
        ("decode", "decode_sharded", dict(units=port_units, feats=feats, masks=masks,
                                          mesh=(4, 1, 1))),
        ("decode_backoff", "decode_sharded", dict(units=port_units, feats=feats, masks=masks,
                                                  mesh=(4, 1, 1), hop_mode="backoff")),
        ("decode_bad", "raises:decode_sharded", dict(units=port_units, feats=feats[:3],
                                                     masks=masks[:3], mesh=(4, 1, 1))),
    ]
    todo += [(f"pipe_fwd_{c}", "pipeline_scores", _pipe_kw(c, chunk=c)) for c in (8, 16, 64)]
    todo += [(f"pipe_stages_{s}_{seed}", "pipeline_scores", _pipe_kw(seed, chunk=16, n_stages=s))
             for s, seed in STAGE_CASES]
    todo += [(f"pipe_decode_{s}", "pipeline_decode", _pipe_kw(50 + s, chunk=16, n_stages=s))
             for s in (2, 4)]
    todo += [(f"mp_em_{d}x{m}", "mp_steps", dict(_mp_kw(_mp_em), mesh=(d, 1, m), iters=3))
             for d, m in MP_MESHES]
    out = distributed.run_ranks(cases.run_cases, WORLD, args=(todo,), device="cpu")
    return {"ranks": out, "ckdir": ckdir}


STAGE_CASES = [(3, 3), (4, 4), (4, 8)]  # (stages, seed): the JAX test's 8 stages map to 4
MP_MESHES = [(1, 4), (2, 2)]  # the JAX test's (1, 4) and (2, 4) on 4 ranks


def _res(world, key):
    return world["ranks"][0][key]


def _same(a, b) -> bool:
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(_same(x, y) for x, y in zip(a, b))
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return (a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8)))
    return a == b


def test_every_rank_returns_the_same_results(world):
    """Replicated outputs are equal on every rank, bit for bit."""
    first = world["ranks"][0]
    for rank, got in enumerate(world["ranks"][1:], start=1):
        for key in first:
            assert _same(got[key], first[key]), (rank, key)


def _check_params(got, ref, fields, rtol=1e-9, atol=1e-11, loose=("log_a", "cov")):
    for name, g in zip(fields, got):
        r = np.asarray(getattr(ref, name))
        tol = (1e-8, 1e-10) if name in loose else (rtol, atol)
        np.testing.assert_allclose(g, r, rtol=tol[0], atol=tol[1], err_msg=name)


# -- mesh, backend, launcher ---------------------------------------------------------


def test_mesh_shape_inference():
    assert TP.mesh_shape_for(8).shape == (8, 1, 1)
    assert TP.mesh_shape_for(8, seq=2).shape == (4, 2, 1)
    assert TP.mesh_shape_for(8, data=2, seq=2, model=2).shape == (2, 2, 2)
    with pytest.raises(ValueError):
        TP.mesh_shape_for(8, seq=3)
    with pytest.raises(ValueError):
        TP.mesh_shape_for(8, data=3)
    for kw in ({}, {"seq": 2}, {"data": 2, "seq": 2, "model": 2}, {"model": 4}):
        assert TP.mesh_shape_for(8, **kw).shape == JP.mesh_shape_for(8, **kw).shape


def test_backend_rule():
    """NCCL only when the ranks are on CUDA with a card each."""
    rule = distributed.choose_backend
    assert rule("cuda", 4, 4) == "nccl" and rule("cuda", 1, 1) == "nccl"
    assert rule("cuda", 1, 4) == "gloo" and rule("cuda", 3, 4) == "gloo"
    assert rule("cpu", 0, 4) == "gloo" and rule("cpu", 8, 1) == "gloo"


def test_initialize_refuses_nccl_and_cuda_without_cards(tmp_path):
    init = "file://" + str(tmp_path / "rendezvous")
    with pytest.raises(ValueError, match="nccl"):
        distributed.initialize(init, 1, 0, device="cpu", backend="nccl")
    if not torch.cuda.is_available():  # a rank asked for the card never runs on the CPU
        with pytest.raises(RuntimeError, match="CUDA"):
            distributed.initialize(init, 1, 0, device="cuda")
        with pytest.raises(RuntimeError, match="CUDA"):  # the launcher's default is the card
            distributed.run_ranks(os.getpid, 2)
    with pytest.raises(RuntimeError, match="initialize"):  # no world joined: no guessed device
        distributed.local_device()
    assert not torch.distributed.is_initialized()


def test_rank_failure_reaches_the_parent(tmp_path):
    """A rank's exception is raised in the caller with its rank; a rank
    that dies without a result is reported too."""
    victim = tmp_path / "once"
    victim.write_text("")
    with pytest.raises(distributed.RankError, match="FileNotFoundError") as err:
        distributed.run_ranks(os.remove, 2, args=(str(victim),), device="cpu")
    assert err.value.rank in (0, 1) and f"rank {err.value.rank}:" in str(err.value)
    with pytest.raises(distributed.RankError, match="exited with code 3"):
        distributed.run_ranks(os._exit, 2, args=(3,), device="cpu")


def test_result_put_just_before_exit_is_taken(monkeypatch):
    """A rank puts its result and then exits. Where the parent's wait for a
    result gives up just before the result arrives, and the rank has
    exited by the time the parent looks, the result is taken, not reported
    as a rank that died without one."""
    import queue

    class LateQueue:  # empty at the first wait, then the rank's result
        def __init__(self):
            self.waits = 0

        def get(self, timeout):
            self.waits += 1
            if self.waits == 1:
                raise queue.Empty
            return 0, True, "result"

    class ExitedRank:
        exitcode = 0

        def __init__(self, **kw):
            pass

        def start(self):
            pass

        def join(self, timeout=None):
            pass

        def is_alive(self):
            return False

    ctx = types.SimpleNamespace(Queue=LateQueue, Process=ExitedRank)
    monkeypatch.setattr(torch.multiprocessing, "get_context", lambda method: ctx)
    assert distributed.run_ranks(os.getpid, 1, device="cpu") == ["result"]


def test_result_of_an_exited_rank_is_waited_for(monkeypatch):
    """A rank that exited with code 0 has put its result. Where the result
    reaches the parent only 3 s after the rank has exited (a loaded host),
    the parent waits for it within the call's timeout and takes it."""
    import queue
    import time

    class SlowQueue:  # the rank's result arrives 3 s after the queue is made
        def __init__(self):
            self.ready = time.monotonic() + 3.0

        def get(self, timeout):
            wait = self.ready - time.monotonic()
            if wait > timeout:
                time.sleep(timeout)
                raise queue.Empty
            time.sleep(max(wait, 0.0))
            return 0, True, "result"

    class ExitedRank:
        exitcode = 0

        def __init__(self, **kw):
            pass

        def start(self):
            pass

        def join(self, timeout=None):
            pass

        def is_alive(self):
            return False

    ctx = types.SimpleNamespace(Queue=SlowQueue, Process=ExitedRank)
    monkeypatch.setattr(torch.multiprocessing, "get_context", lambda method: ctx)
    t0 = time.monotonic()
    assert distributed.run_ranks(os.getpid, 1, device="cpu", timeout=60) == ["result"]
    assert time.monotonic() - t0 >= 3.0


def test_rank_runs_fn_only_after_every_rank_joined(monkeypatch):
    """A rank meets the others at a barrier after it joins the world and
    before it runs ``fn``: a fast rank that ran ``fn`` and tore its group
    down while a peer was still connecting made the peer's gloo
    ``initialize`` fail ("Connection closed by peer")."""
    events = []
    monkeypatch.setattr(distributed, "initialize", lambda *a, **k: events.append("join"))
    monkeypatch.setattr(torch.distributed, "barrier", lambda *a, **k: events.append("barrier"))
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: False)
    results = types.SimpleNamespace(put=lambda item: events.append(item))
    distributed._rank_main(0, 2, "file:///unused", "cpu", None,
                           lambda: events.append("fn") or "result", (), results)
    assert events == ["join", "barrier", "fn", (0, True, "result")]


def test_rank_that_fails_after_its_result_raises(monkeypatch):
    """A rank that put its result and then exited with a nonzero code (a
    crash in its teardown) is reported, not taken as a success."""

    class Results:
        def get(self, timeout):
            return 0, True, "result"

    class FailedRank:
        exitcode = 1

        def __init__(self, **kw):
            pass

        def start(self):
            pass

        def join(self, timeout=None):
            pass

        def is_alive(self):
            return False

    ctx = types.SimpleNamespace(Queue=Results, Process=FailedRank)
    monkeypatch.setattr(torch.multiprocessing, "get_context", lambda method: ctx)
    with pytest.raises(distributed.RankError, match="rank 0: exited with code 1 after its result"):
        distributed.run_ranks(os.getpid, 1, device="cpu")


def test_process_local_slice_and_world_of_one():
    """Each rank's rows of a global batch; and the sharded trainer on a
    world of one, a (1, 1, 1) mesh (the JAX ``test_mesh_degrades_to_single
    _device``), equal to the JAX single-chip training."""
    assert distributed.process_local_slice(8) == (0, 8)
    got = distributed.run_ranks(distributed.process_local_slice, WORLD, args=(8,),
                                  device="cpu")
    assert got == [(0, 2), (2, 4), (4, 6), (6, 8)]
    cfg, model, obs, mask = _single()
    (res,) = distributed.run_ranks(cases.run_cases, 1, args=([(
        "one", "dp_train", dict(config=_pcfg(cfg), params=_arrays(model.params), obs=obs,
                                mask=mask, mesh=(1, 1, 1), iters=2))],), device="cpu")
    hist, params = res["one"]
    assert np.all(np.isfinite(hist))
    ref = model.train(obs, iters=2, mask=mask)
    np.testing.assert_allclose(hist, ref, rtol=1e-10)
    _check_params(params, model, FIELDS)


# -- data-parallel EM ---------------------------------------------------------------


def test_dp_gmmhmm_matches_single_chip(world):
    cfg, model, obs, mask = _dp_gmm()
    p_ref, ll_ref = jgmm_step(model.params, jnp.asarray(obs), jnp.asarray(mask), cov_type="diag")
    hist, params = _res(world, "dp_gmm")
    np.testing.assert_allclose(hist[0], float(ll_ref), rtol=1e-10)
    _check_params(params, p_ref, FIELDS)


def test_dp_gmmhmm_matches_jax_data_parallel(world):
    cfg, model, obs, mask = _dp_gmm()
    hist_ref = JP.train_data_parallel(model, obs, mask, _jmesh((4, 1, 1)), iters=1)
    hist, params = _res(world, "dp_gmm")
    np.testing.assert_allclose(hist, hist_ref, rtol=1e-10)
    _check_params(params, model, FIELDS)


def test_dp_hmm_matches_single_chip(world):
    model, obs, mask = _dp_hmm()
    p_ref, ll_ref = jhmm_step(model.params, jnp.asarray(obs), jnp.asarray(mask))
    hist, params = _res(world, "dp_hmm")
    np.testing.assert_allclose(hist[0], float(ll_ref), rtol=1e-10)
    _check_params(params, p_ref, ("log_a", "log_b", "log_pi"), loose=("log_a", "log_b"))


def test_dp_hmm_matches_jax_data_parallel(world):
    model, obs, mask = _dp_hmm()
    hist_ref = JP.train_data_parallel(model, obs, mask, _jmesh((4, 1, 1)), iters=1)
    hist, params = _res(world, "dp_hmm")
    np.testing.assert_allclose(hist, hist_ref, rtol=1e-10)
    _check_params(params, model.params, ("log_a", "log_b", "log_pi"))


def test_dp_multi_iteration_improves(world):
    cfg, model, obs, mask = _dp_multi()
    hist, params = _res(world, "dp_multi")
    assert hist[-1] > hist[0]
    assert np.all(np.isfinite(hist))
    ref = model.train(obs, iters=8, mask=mask)
    np.testing.assert_allclose(hist, ref, rtol=1e-10)
    _check_params(params, model, FIELDS)


# -- model-parallel emissions and EM ---------------------------------------------------


@pytest.mark.parametrize("model_axis,seed", [(2, 2), (4, 8)])
def test_model_parallel_emissions(world, model_axis, seed):
    ref, _ = gmm_emissions_diag(*(jnp.asarray(x) for x in _mp_emis(seed)))
    got = _res(world, f"mp_emis_{model_axis}")
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-9, atol=1e-11)


def test_model_parallel_emissions_match_jax_model_parallel(world):
    fn = JP.make_mp_emission_fn(_jmesh((2, 1, 2)))
    ref = fn(*(jnp.asarray(x) for x in _mp_emis(2)))
    np.testing.assert_allclose(_res(world, "mp_emis_2"), np.asarray(ref), rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("mesh_axes", MP_MESHES)
def test_mp_gmmhmm_em_matches_single_chip(world, mesh_axes):
    """Mixture-sharded Baum-Welch (updates per shard for its own
    components) equals the single-chip step, for one step and for three."""
    cfg, model, obs, mask = _mp_em()
    p_ref = model.params
    for it, (ll, params) in enumerate(_res(world, f"mp_em_{mesh_axes[0]}x{mesh_axes[1]}")):
        p_ref, ll_ref = jgmm_step(p_ref, jnp.asarray(obs), jnp.asarray(mask), cov_type="diag")
        np.testing.assert_allclose(ll, float(ll_ref), rtol=1e-12)
        for name, g in zip(FIELDS, params):
            np.testing.assert_allclose(g, np.asarray(getattr(p_ref, name)), rtol=1e-9,
                                       atol=1e-11, err_msg=f"{name} @ iter {it}")


def test_mp_gmmhmm_em_matches_jax_model_parallel(world):
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS

    cfg, model, obs, mask = _mp_em()
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("data", "model"))
    step = JP.make_mp_gmmhmm_em_step(mesh, cfg)
    p_mp = type(model.params)(*(jax.device_put(x, NamedSharding(mesh, s))
                                for x, s in zip(model.params, JP.mp_param_specs("diag"))))
    p_ref, ll_ref = step(p_mp, jax.device_put(jnp.asarray(obs), NamedSharding(mesh, PS("data"))),
                         jax.device_put(jnp.asarray(mask), NamedSharding(mesh, PS("data"))))
    ll, params = _res(world, "mp_em_2x2")[0]
    np.testing.assert_allclose(ll, float(ll_ref), rtol=1e-12)
    _check_params(params, p_ref, FIELDS, loose=())


def test_mp_rejects_a_model_axis_that_does_not_divide_n_mix(world):
    kind, msg = _res(world, "mp_bad_axis")
    assert kind == "ValueError" and "must divide n_mix=6" in msg


def test_train_model_parallel_loop_and_resume(world):
    """The MP trainer drives the EM loop (loglik improves, equal to the JAX
    single-chip training) and resumes bitwise: 2 sweeps, a checkpoint and a
    resume to 4 equal 4 sweeps straight."""
    cfg, model, obs, mask = _mp_loop()
    hist, params = _res(world, "mp_loop_ref")
    assert len(hist) == 4 and hist[-1] >= hist[0]
    ref = model.train(obs, iters=4, mask=mask, config=None)
    np.testing.assert_allclose(hist, ref, rtol=1e-10)
    _check_params(params, model, FIELDS)
    hist_r, params_r = _res(world, "mp_loop_resumed")
    assert _same(params_r, params) and hist_r == hist
    assert len(_res(world, "mp_loop_killed")[0]) == 2


def test_mp_checkpoint_is_the_single_device_layout(world):
    """The MP run's checkpoint holds the whole (gathered) parameters in
    the layout both packages read: the JAX package's ``load_train_state``
    gives the resumed run's parameters."""
    from lnasr_tpu.utils.checkpoints import load_train_state

    cfg, model, obs, mask = _mp_loop()
    state = load_train_state(os.path.join(world["ckdir"], "train_state.npz"), model.params)
    assert state.iteration == 4 and state.history == _res(world, "mp_loop_resumed")[0]
    assert _same([np.asarray(x) for x in state.params], _res(world, "mp_loop_resumed")[1])


# -- the sharded decode -------------------------------------------------------------


def test_dp_sharded_decode_matches_local_batch(world):
    """``decode_batch_sharded`` over 4 ranks is the single-process
    ``decode_batch``, bitwise (words, paths, scores)."""
    sharded, local = _res(world, "decode")
    assert len(sharded) == 8
    for (gw, gp, gs), (rw, rp, rs) in zip(sharded, local):
        assert gw == rw and gs == rs
        np.testing.assert_array_equal(gp, rp)
        assert gp.dtype == np.int32


def test_dp_sharded_decode_matches_jax(world):
    """The same words and paths as the JAX package's sharded decode (and
    its single-chip decode); scores within float32 rounding of the
    emission GEMM, which each package computes its own way."""
    jax_units, _, feats, masks = _decode()
    graph = JGraph.build(JLexicon.whole_word(sorted(jax_units)), jax_units, None,
                         JDecoderConfig(loop=True), dtype=jnp.float32)
    ref = JP.decode_batch_sharded(graph, feats, masks, _jmesh((4, 1, 1)))
    ref_local = graph.decode_batch(feats, masks)
    for (gw, gp, gs), (rw, rp, rs), (lw, _, _) in zip(_res(world, "decode")[0], ref, ref_local):
        assert gw == rw == lw
        np.testing.assert_array_equal(gp, rp)
        np.testing.assert_allclose(gs, rs, rtol=1e-5)


def test_dp_sharded_decode_backoff_hop(world):
    """Backoff factors (the scan on every rank) decode the dense hop's
    words and paths."""
    for (gw, gp, _), (rw, rp, _) in zip(_res(world, "decode_backoff")[0], _res(world, "decode")[0]):
        assert gw == rw
        np.testing.assert_array_equal(gp, rp)
    sharded, local = _res(world, "decode_backoff")
    assert _same(sharded, local)


def test_dp_sharded_decode_rejects_indivisible_batch(world):
    kind, msg = _res(world, "decode_bad")
    assert kind == "ValueError" and "divide" in msg


# -- the streaming pipeline --------------------------------------------------------


def _pipe_ref(seed):
    log_pi, log_a, log_w, mu, var, feats = (jnp.asarray(x) for x in _pipe(seed))
    log_b, _ = gmm_emissions_diag(feats, log_w, mu, var)
    return log_pi, log_a, log_b


@pytest.mark.parametrize("chunk", [8, 16, 64])
def test_pipeline_forward_matches_scan(world, chunk):
    ref = forward_scan(*_pipe_ref(chunk))
    np.testing.assert_allclose(_res(world, f"pipe_fwd_{chunk}"), float(ref.loglik), rtol=1e-10)


def test_pipeline_max_semiring_matches_viterbi(world):
    ref = viterbi_scan(*_pipe_ref(99))
    np.testing.assert_allclose(_res(world, "pipe_max"), float(ref.score), rtol=1e-10)


@pytest.mark.parametrize("n_stages,seed", STAGE_CASES)
def test_pipeline_multistage_matches_scan(world, n_stages, seed):
    """S-stage pipelines (S-1 mixture-sharded emission stages + decoder),
    stage counts that do not divide the mixtures (padding) included, and
    the rank outside a 3-stage mesh gets the result too."""
    ref = forward_scan(*_pipe_ref(seed))
    np.testing.assert_allclose(_res(world, f"pipe_stages_{n_stages}_{seed}"), float(ref.loglik),
                               rtol=1e-10)


@pytest.mark.parametrize("n_stages", [2, 4])
def test_pipeline_decode_matches_viterbi(world, n_stages):
    ref = viterbi_scan(*_pipe_ref(50 + n_stages))
    path, score = _res(world, f"pipe_decode_{n_stages}")
    np.testing.assert_array_equal(path, np.asarray(ref.path))
    assert path.dtype == np.int32
    np.testing.assert_allclose(score, float(ref.score), rtol=1e-10)


def test_pipeline_matches_jax_pipeline(world):
    args = [jnp.asarray(x) for x in _pipe(16)]
    ref = JP.streaming_pipeline_scores(*args, JP.make_stage_mesh(jax.devices()[:2]), chunk=16)
    np.testing.assert_allclose(_res(world, "pipe_fwd_16"), float(ref), rtol=1e-10)
    args = [jnp.asarray(x) for x in _pipe(54)]
    path, score = JP.streaming_pipeline_decode(
        *args, JP.make_stage_mesh(jax.devices()[:4], n_stages=4), chunk=16)
    got_path, got_score = _res(world, "pipe_decode_4")
    np.testing.assert_array_equal(got_path, np.asarray(path))
    np.testing.assert_allclose(got_score, float(score), rtol=1e-10)


def test_pipeline_rejects_bad_args(world):
    assert _res(world, "pipe_bad_chunk")[0] == "ValueError"
    assert "chunk" in _res(world, "pipe_bad_chunk")[1]
    assert "semiring" in _res(world, "pipe_bad_semiring")[1]
    assert "at least 2 stages" in _res(world, "pipe_one_stage")[1]
