"""Training-state checkpoints of the port: kill and resume end bitwise equal
to an uninterrupted run (discrete HMM and GMM-HMM), a converged run is
terminal, and ``train_state.npz`` files cross-load between the JAX package
and the port (the same ``__meta__`` / ``leaf_i`` layout).

Cross-package resumes continue in the other package, so they agree with
an uninterrupted run of either to float64 rounding (rtol 1e-10), not
bitwise; a file round trip itself keeps every bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from lnasr_tpu.config import GMMHMMConfig as JGMMHMMConfig
from lnasr_tpu.config import TrainConfig as JTrainConfig
from lnasr_tpu.models.gmmhmm import GMMHMM as JGMMHMM
from lnasr_tpu.models.hmm import HMM as JHMM
from lnasr_tpu.utils import checkpoints as jckpt
from lnasr_tpu_torch.config import GMMHMMConfig, TrainConfig
from lnasr_tpu_torch.convert import hmm_params_from_numpy
from lnasr_tpu_torch.models.gmmhmm import GMMHMM
from lnasr_tpu_torch.models.hmm import HMM
from lnasr_tpu_torch.utils import checkpoints as tckpt

F64 = torch.float64


def _toy_batch(seed, b=4, t=24, m=6):
    rng = np.random.default_rng(seed)
    obs = rng.integers(0, m, size=(b, t))
    mask = np.ones((b, t), dtype=bool)
    mask[1, t - 5:] = False
    return obs, mask


def _fresh_hmm(m=6):
    return HMM(3, m, dtype=F64, device="cpu").reset("random", torch.Generator().manual_seed(7))


def _equal(a, b):
    for x, y in zip(a, b):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


def test_hmm_kill_and_resume_bitwise(tmp_path):
    obs, mask = _toy_batch(0)
    ref = _fresh_hmm()
    ref_hist = ref.train(obs, mask=mask, config=TrainConfig(max_iters=6, eps=0.0))
    run = dict(checkpoint_every=2, checkpoint_dir=str(tmp_path / "run"))
    _fresh_hmm().train(obs, mask=mask, config=TrainConfig(max_iters=3, eps=0.0, **run))
    state = tckpt.load_train_state(str(tmp_path / "run" / "train_state.npz"), ref.params)
    assert state.iteration == 2 and len(state.history) == 2 and not state.done
    resumed = _fresh_hmm()
    hist = resumed.train(obs, mask=mask, config=TrainConfig(max_iters=6, eps=0.0, **run))
    _equal(resumed.params, ref.params)
    assert hist == ref_hist


def test_converged_run_is_terminal(tmp_path):
    obs, mask = _toy_batch(1)
    cfg = TrainConfig(max_iters=10, eps=1e10, checkpoint_every=100,
                      checkpoint_dir=str(tmp_path / "run"))
    model = _fresh_hmm()
    hist = model.train(obs, mask=mask, config=cfg)
    assert len(hist) == 2  # |delta| < the huge eps on the second sweep
    again = _fresh_hmm()
    assert again.train(obs, mask=mask, config=cfg) == hist
    _equal(again.params, model.params)
    assert tckpt.load_train_state(cfg.checkpoint_dir + "/train_state.npz", model.params).done


def test_gmmhmm_kill_and_resume_bitwise(tmp_path):
    rng = np.random.default_rng(2)
    feats = rng.normal(size=(3, 20, 4))
    cfg = GMMHMMConfig(n_states=2, n_mix=2, dim=4)

    def fresh():
        return GMMHMM(cfg, dtype=F64, device="cpu").init_left_to_right(
            feats.reshape(-1, 4), torch.Generator().manual_seed(3))

    ref = fresh()
    ref_hist = ref.train(feats, config=TrainConfig(max_iters=5, eps=0.0))
    run = dict(checkpoint_every=1, checkpoint_dir=str(tmp_path / "run"))
    fresh().train(feats, config=TrainConfig(max_iters=2, eps=0.0, **run))
    resumed = fresh()
    hist = resumed.train(feats, config=TrainConfig(max_iters=5, eps=0.0, **run))
    _equal(resumed.params, ref.params)
    assert hist == ref_hist


def test_checkpoints_cross_load_between_packages(tmp_path):
    """A JAX-written state resumes in the port and a port-written one in
    the JAX package; both land on an uninterrupted run's parameters."""
    obs, mask = _toy_batch(3)
    jm = JHMM(3, 6, dtype=jnp.float64).reset("random", key=jax.random.PRNGKey(7))
    start = jm.params

    def port_model():
        return HMM(dtype=F64, device="cpu").set_params(
            hmm_params_from_numpy(*start, device="cpu", dtype=F64))

    def jax_model():
        return JHMM(3, 6, *start, dtype=jnp.float64)

    ref = port_model()
    ref_hist = ref.train(obs, mask=mask, config=TrainConfig(max_iters=4, eps=0.0))

    jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_model().train(jnp.asarray(obs), mask=jnp.asarray(mask),
                      config=JTrainConfig(max_iters=2, eps=0.0, checkpoint_every=1,
                                          checkpoint_dir=jdir))
    in_port = port_model()
    hist = in_port.train(obs, mask=mask, config=TrainConfig(max_iters=4, eps=0.0,
                                                            checkpoint_every=1,
                                                            checkpoint_dir=jdir))
    np.testing.assert_allclose(hist, ref_hist, rtol=1e-10)
    for g, r in zip(in_port.params, ref.params):
        np.testing.assert_allclose(g.numpy(), r.numpy(), rtol=1e-10, atol=1e-12)

    port_model().train(obs, mask=mask, config=TrainConfig(max_iters=2, eps=0.0,
                                                          checkpoint_every=1,
                                                          checkpoint_dir=tdir))
    state = jckpt.load_train_state(tdir + "/train_state.npz", start)
    assert state.iteration == 2 and type(state.params).__name__ == "HMMParams"
    in_jax = jax_model()
    hist = in_jax.train(jnp.asarray(obs), mask=jnp.asarray(mask),
                        config=JTrainConfig(max_iters=4, eps=0.0, checkpoint_every=1,
                                            checkpoint_dir=tdir))
    np.testing.assert_allclose(hist, ref_hist, rtol=1e-10)
    for g, r in zip(in_jax.params, ref.params):
        np.testing.assert_allclose(np.asarray(g), r.numpy(), rtol=1e-10, atol=1e-12)


def test_gmmhmm_state_round_trips_across_packages(tmp_path):
    """The GMM-HMM's five leaves keep their bits through a file written by
    one package and read by the other."""
    rng = np.random.default_rng(4)
    feats = rng.normal(size=(40, 3))
    jm = JGMMHMM(JGMMHMMConfig(n_states=2, n_mix=2, dim=3), dtype=jnp.float64)
    jm.init_left_to_right(feats, jax.random.PRNGKey(0))
    jckpt.save_train_state(str(tmp_path / "j.npz"), jckpt.TrainState(jm.params, 3, [1.0, 2.0]))
    tm = GMMHMM(GMMHMMConfig(n_states=2, n_mix=2, dim=3), dtype=F64, device="cpu")
    tm.init_left_to_right(feats, torch.Generator().manual_seed(0))
    got = tckpt.load_train_state(str(tmp_path / "j.npz"), tm.params)
    assert (got.iteration, got.history, got.done) == (3, [1.0, 2.0], False)
    _equal(got.params, jm.params)
    assert type(got.params).__name__ == "GMMHMMParams" and got.params.mu.dtype == F64
    tckpt.save_train_state(str(tmp_path / "t.npz"), tckpt.TrainState(tm.params, 1, [5.0], True))
    back = jckpt.load_train_state(str(tmp_path / "t.npz"), jm.params)
    assert (back.iteration, back.history, back.done) == (1, [5.0], True)
    _equal(tm.params, back.params)
