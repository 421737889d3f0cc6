"""Rank programs over NumPy inputs, for spawned worlds.

A rank of :func:`~lnasr_tpu_torch.parallel.distributed.run_ranks` can
only run a function it can import, so the CPU tests that hold this
package against the JAX package hand their inputs over as NumPy arrays
and name one of the programs below; each builds its mesh on every rank,
calls one public function of :mod:`lnasr_tpu_torch.parallel` on
this rank's device and returns NumPy results. :func:`run_cases` runs a
list of them in order (the same order on every rank, since building a
mesh is collective).
"""

from __future__ import annotations

import types
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from lnasr_tpu_torch import parallel as P
from lnasr_tpu_torch.config import GMMHMMConfig, MeshConfig, TrainConfig
from lnasr_tpu_torch.models.gmmhmm import GMMHMM, GMMHMMParams
from lnasr_tpu_torch.models.hmm import HMM, HMMParams
from lnasr_tpu_torch.parallel.distributed import local_device
from lnasr_tpu_torch.parallel.mesh import local_rows, mesh_axis


def _t(x, dtype=None) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=local_device())


def _np(x):
    if torch.is_tensor(x):
        return x.detach().cpu().numpy()
    if isinstance(x, (list, tuple)):
        return type(x)(_np(v) for v in x) if not hasattr(x, "_fields") else [_np(v) for v in x]
    if isinstance(x, dict):
        return {k: _np(v) for k, v in x.items()}
    return x


def _mesh(shape: Sequence[int]):
    return P.make_mesh(MeshConfig(*shape))


def _model(config: Dict, params: Sequence[np.ndarray]):
    """A float64 model on this rank's device: a GMM-HMM from ``config``
    (GMMHMMConfig fields), or a discrete HMM when ``config`` is None."""
    dev = local_device()
    if config is None:
        return HMM(dtype=torch.float64, device=dev).set_params(HMMParams(*params))
    return GMMHMM(GMMHMMConfig(**config), dtype=torch.float64, device=dev).set_params(
        GMMHMMParams(*params))


def dp_train(config, params, obs, mask, mesh, iters=1):
    """``train_data_parallel``: ``(history, params)``."""
    model = _model(config, params)
    hist = P.train_data_parallel(model, obs, mask, _mesh(mesh), iters=iters)
    return hist, _np(model.params)


def mp_steps(config, params, obs, mask, mesh, iters=1):
    """``make_mp_gmmhmm_em_step`` applied ``iters`` times to this rank's
    slice: ``[(loglik, gathered params)]`` per step."""
    m = _mesh(mesh)
    step = P.make_mp_gmmhmm_em_step(m, GMMHMMConfig(**config))
    specs = P.mp_param_specs()
    data = mesh_axis(m, "data")
    obs, mask = local_rows(_t(obs, torch.float64), data), local_rows(_t(mask, torch.bool), data)
    p = specs.local(_model(config, params).params, m)
    out = []
    for _ in range(iters):
        p, ll = step(p, obs, mask)
        out.append((float(ll), _np(specs.gather(p, m))))
    return out


def mp_train(config, params, obs, mask, mesh, max_iters, checkpoint_dir=None):
    """``train_model_parallel`` under a ``TrainConfig`` (eps 0, a
    checkpoint every sweep when ``checkpoint_dir`` is set)."""
    model = _model(config, params)
    cfg = TrainConfig(max_iters=max_iters, eps=0.0, checkpoint_every=1 if checkpoint_dir else 0,
                      checkpoint_dir=checkpoint_dir)
    hist = P.train_model_parallel(model, obs, mask, _mesh(mesh), config=cfg)
    return hist, _np(model.params)


def mp_emissions(obs, log_w, mu, var, mesh):
    fn = P.make_mp_emission_fn(_mesh(mesh))
    return _np(fn(*(_t(x, torch.float64) for x in (obs, log_w, mu, var))))


def seq_forward(log_pi, log_a, log_b, mesh, mask=None):
    out = P.forward_seq_parallel(_t(log_pi), _t(log_a), _t(log_b), _mesh(mesh),
                                 None if mask is None else _t(mask))
    return _np(out)


def seq_backward(log_a, log_b, mesh, mask=None):
    return _np(P.backward_seq_parallel(_t(log_a), _t(log_b), _mesh(mesh),
                                       None if mask is None else _t(mask)))


def seq_viterbi(log_pi, log_a, log_b, mesh, mask=None):
    out = P.viterbi_seq_parallel(_t(log_pi), _t(log_a), _t(log_b), _mesh(mesh),
                                 None if mask is None else _t(mask))
    return _np(out)


def seq_train(config, params, obs, mesh, iters=1, mask=None):
    """``train_seq_parallel`` (a discrete HMM when ``config`` is None)."""
    model = _model(config, params)
    hist = P.train_seq_parallel(model, obs, _mesh(mesh), iters=iters, mask=mask)
    return hist, _np(model.params)


def pipeline_scores(log_pi, log_a, log_w, mu, var, feats, n_stages=2, chunk=None,
                    semiring="log"):
    mesh = P.make_stage_mesh(n_stages=n_stages)
    args = (_t(x, torch.float64) for x in (log_pi, log_a, log_w, mu, var, feats))
    return float(P.streaming_pipeline_scores(*args, mesh, chunk=chunk, semiring=semiring))


def pipeline_decode(log_pi, log_a, log_w, mu, var, feats, n_stages=2, chunk=None):
    mesh = P.make_stage_mesh(n_stages=n_stages)
    args = (_t(x, torch.float64) for x in (log_pi, log_a, log_w, mu, var, feats))
    return _np(P.streaming_pipeline_decode(*args, mesh, chunk=chunk))


def _graph(units: Dict[str, Dict[str, Any]], hop_mode: str):
    """A float32 factored graph (``loop=True``, no LM) over whole-word units
    given as dicts of ``config`` (GMMHMMConfig fields) and parameter arrays."""
    from lnasr_tpu_torch.convert import units_from_numpy
    from lnasr_tpu_torch.models.decoder import DecoderConfig, FactoredDecodingGraph
    from lnasr_tpu_torch.models.lexicon import Lexicon

    ns = {k: types.SimpleNamespace(**{**u, "config": GMMHMMConfig(**u["config"])})
          for k, u in units.items()}
    models = units_from_numpy(ns, device=local_device())
    return FactoredDecodingGraph.build(Lexicon.whole_word(sorted(models)), models, None,
                                       DecoderConfig(loop=True), hop_mode=hop_mode,
                                       device=local_device())


def decode_sharded(units, feats, masks, mesh, hop_mode="dense"):
    """``decode_batch_sharded`` and the single-process ``decode_batch`` on
    the same graph: ``(sharded, local)`` lists of ``(words, path, score)``."""
    graph = _graph(units, hop_mode)
    return (P.decode_batch_sharded(graph, feats, masks, _mesh(mesh)),
            graph.decode_batch(feats, masks))


CASES = {f.__name__: f for f in (dp_train, mp_steps, mp_train, mp_emissions, seq_forward,
                                 seq_backward, seq_viterbi, seq_train, pipeline_scores,
                                 pipeline_decode, decode_sharded)}


def run_cases(cases: List[Tuple[str, str, Dict]]) -> Dict[str, Any]:
    """Run ``(key, program, kwargs)`` cases in order; ``{key: result}``. A
    program name prefixed ``raises:`` records the exception the program
    raises, as ``(type name, message)``, or ``None`` when it returns."""
    out = {}
    for key, name, kwargs in cases:
        if name.startswith("raises:"):
            try:
                CASES[name[len("raises:"):]](**kwargs)
                out[key] = None
            except (ValueError, RuntimeError) as e:
                out[key] = (type(e).__name__, str(e))
        else:
            out[key] = CASES[name](**kwargs)
    return out
