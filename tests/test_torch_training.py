"""Isolated-unit training and the port's training entry points against the
JAX package.

``train_unit_models`` of both packages run on the same examples, with
``<sil>`` given its own topology, ``pad_to`` and per-unit checkpoint
directories. ``jax.random`` and ``torch.Generator`` draw different
initial means, so the JAX package's ``init_left_to_right`` is wrapped
here (test side only) to start each unit from the port's draw.
Tolerances (float64): the pooled floors equal, the initial parameters
equal bitwise, each unit's trained parameters and history within rtol
1e-9 (EM sums in another order for a few sweeps).
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import torch

import lnasr_tpu.models.recognizer as jrec
from lnasr_tpu.config import GMMHMMConfig as JGMMHMMConfig
from lnasr_tpu.config import TrainConfig as JTrainConfig
from lnasr_tpu.models.gmmhmm import GMMHMMParams as JGMMHMMParams
from lnasr_tpu.models.gmmhmm import gmmhmm_em_step as j_em_step
from lnasr_tpu_torch import entry
from lnasr_tpu_torch.config import GMMHMMConfig, TrainConfig
from lnasr_tpu_torch.models import gmmhmm as tgh
from lnasr_tpu_torch.models.decoder import SILENCE
from lnasr_tpu_torch.models.recognizer import train_unit_models

F64 = torch.float64
D = 4
WORD = dict(n_states=3, n_mix=2, dim=D)
SIL = dict(n_states=2, n_mix=3, dim=D)


def _examples(seed=0):
    rng = np.random.default_rng(seed)
    ex = {}
    for k, unit in enumerate(("wa", "wb", SILENCE)):
        ex[unit] = [(rng.normal(size=(t, D)) * (1.0 + k) + np.linspace(-k, k, t)[:, None])
                    .astype(np.float32) for t in rng.integers(12, 22, size=3)]
    return ex


def _close(got, ref, rtol):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), rtol=rtol, atol=1e-12)


def test_train_unit_models_matches_jax(tmp_path, monkeypatch):
    ex = _examples()
    draws = []
    port_init = tgh.GMMHMM.init_left_to_right

    def record(self, obs, generator=None, self_loop=0.5):
        port_init(self, obs, generator, self_loop)
        draws.append([x.numpy().copy() for x in self.params])
        return self

    monkeypatch.setattr(tgh.GMMHMM, "init_left_to_right", record)
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    kw = dict(iters=3, seed=5, pad_to=24)
    got = train_unit_models(ex, GMMHMMConfig(**WORD), dtype=F64, device="cpu",
                            unit_configs={SILENCE: GMMHMMConfig(**SIL)},
                            train_config=TrainConfig(max_iters=3, eps=0.0, checkpoint_every=1,
                                                     checkpoint_dir=tdir), **kw)

    jax_init = jrec.GMMHMM.init_left_to_right
    starts = []

    def from_port_draw(self, obs, key=None, self_loop=0.5):
        jax_init(self, obs, key, self_loop)
        starts.append(self.params)
        self.mu = jnp.asarray(draws[len(starts) - 1][3])
        return self

    monkeypatch.setattr(jrec.GMMHMM, "init_left_to_right", from_port_draw)
    ref = jrec.train_unit_models(ex, JGMMHMMConfig(**WORD), dtype=jnp.float64,
                                 unit_configs={SILENCE: JGMMHMMConfig(**SIL)},
                                 train_config=JTrainConfig(max_iters=3, eps=0.0,
                                                           checkpoint_every=1,
                                                           checkpoint_dir=jdir), **kw)
    assert sorted(got) == sorted(ref) == sorted(ex) and len(draws) == 3
    for i, unit in enumerate(sorted(ex)):
        g, r = got[unit], ref[unit]
        assert dataclasses.asdict(g.config) == dataclasses.asdict(r.config)
        assert (g.n, g.m) == ((2, 3) if unit == SILENCE else (3, 2))
        # the JAX start differs from the port's only in the means it drew
        for k in (0, 1, 2):
            np.testing.assert_array_equal(np.asarray(starts[i][k]), draws[i][k])
        _close(starts[i][4], draws[i][4], 1e-14)
        for x, y in zip(g.params, r.params):
            _close(x.numpy(), y, 1e-9)
        state = np.load(f"{tdir}/{unit}/train_state.npz")
        assert int(state["leaf_3"].shape[0]) == g.n
    # every unit shares the floor resolved from the pooled frames
    floors = {got[u].config.var_floor for u in got}
    assert len(floors) == 1 and isinstance(floors.pop(), tuple)

    # a finished run restores from its checkpoints with the same bits
    again = train_unit_models(ex, GMMHMMConfig(**WORD), dtype=F64, device="cpu",
                              unit_configs={SILENCE: GMMHMMConfig(**SIL)},
                              train_config=TrainConfig(max_iters=3, eps=0.0, checkpoint_every=1,
                                                       checkpoint_dir=tdir), **kw)
    for unit in ex:
        for x, y in zip(again[unit].params, got[unit].params):
            assert torch.equal(x, y)


def test_training_entry_matches_jax():
    """``entry.training`` at a small depth: features from the port's
    frontend, one sweep from the flagship start, equal to the JAX sweep on
    the same features and parameters (float64)."""
    run = entry.training(device="cpu", dtype=F64, batch=2, seconds=0.5)
    assert run.features.shape == (2, 49, 39) and run.features.dtype == F64
    assert bool(run.mask.all())
    params, loglik = run.step(run.params)
    ref_p, ref_l = j_em_step(JGMMHMMParams(*(jnp.asarray(x.numpy()) for x in run.params)),
                             jnp.asarray(run.features.numpy()), jnp.asarray(run.mask.numpy()))
    _close(float(loglik), float(ref_l), 1e-12)
    for x, y in zip(params, ref_p):
        _close(x.numpy(), y, 1e-9)
    assert float(run.step(params)[1]) >= float(loglik)
    # the same features handed in (as a second device would) give the same step
    again = entry.training(device="cpu", dtype=F64, features=run.features)
    for x, y in zip(again.step(run.params)[0], params):
        assert torch.equal(x, y)


def test_unit_training_entry():
    am, ex = entry.unit_training(3, device="cpu", iters=2)
    assert sorted(am.units) == [SILENCE, "w0000", "w0001", "w0002"]
    assert all(len(v) == entry.UNIT_EXAMPLES for v in ex.values())
    assert all(f.shape[1] == 39 and f.dtype == np.float32 for v in ex.values() for f in v)
    sil, word = am.units[SILENCE], am.units["w0001"]
    assert (sil.n, sil.m, word.n, word.m) == (3, 4, 8, 2)
    assert sil.config.var_floor == word.config.var_floor
    assert all(torch.isfinite(x).all() for u in am.units.values() for x in (u.mu, u.cov))
    rec = entry.unit_recognizer(am, vocab=3)
    words, score = rec.decode_segment(entry.unit_utterance(["w0002", "w0000"]))
    assert np.isfinite(score) and set(words) <= {"w0000", "w0001", "w0002"}
