"""Carry model parameters from the JAX package into the port.

The tests hand the JAX models' ``GMMHMMParams``, ``HMMParams`` and
``GMMParams`` fields over as NumPy arrays so both packages compute, and
train, from the same weights (``jax.random`` and ``torch.Generator`` draw
different numbers from the same seed).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from lnasr_tpu_torch.config import GMMHMMConfig
from lnasr_tpu_torch.models.gmm import GMMParams
from lnasr_tpu_torch.models.gmmhmm import GMMHMM, GMMHMMParams
from lnasr_tpu_torch.models.hmm import HMMParams


def _tensors(arrays, device, dtype):
    return (torch.as_tensor(np.array(x), dtype=dtype, device=device) for x in arrays)


def params_from_numpy(log_a, log_pi, log_w, mu, cov, device="cuda",
                      dtype=torch.float32) -> GMMHMMParams:
    """``GMMHMMParams`` on ``device`` in ``dtype`` from array-likes, in
    the field order of both packages' ``GMMHMMParams``."""
    return GMMHMMParams(*_tensors((log_a, log_pi, log_w, mu, cov), device, dtype))


def hmm_params_from_numpy(log_a, log_b, log_pi, device="cuda",
                          dtype=torch.float32) -> HMMParams:
    """The discrete HMM's ``HMMParams`` from array-likes, in both
    packages' field order."""
    return HMMParams(*_tensors((log_a, log_b, log_pi), device, dtype))


def gmm_params_from_numpy(log_w, mu, cov, device="cuda", dtype=torch.float32) -> GMMParams:
    """The standalone mixture's ``GMMParams`` from array-likes, in both
    packages' field order."""
    return GMMParams(*_tensors((log_w, mu, cov), device, dtype))


def units_from_numpy(units: Mapping[str, object], device="cuda",
                     dtype=torch.float32) -> Dict[str, GMMHMM]:
    """A unit inventory (name -> model with ``config``, ``log_a``,
    ``log_pi``, ``log_w``, ``mu``, ``cov`` as array-likes, such as the JAX
    package's ``GMMHMM``) as the port's :class:`GMMHMM` s on ``device``,
    with the config carried field by field."""
    names = [f.name for f in dataclasses.fields(GMMHMMConfig)]
    out = {}
    for name, unit in units.items():
        cfg = GMMHMMConfig(**{k: getattr(unit.config, k) for k in names
                              if hasattr(unit.config, k)})
        params = params_from_numpy(unit.log_a, unit.log_pi, unit.log_w, unit.mu, unit.cov,
                                   device=device, dtype=dtype)
        out[name] = GMMHMM(cfg, dtype=dtype, device=device).set_params(params)
    return out
