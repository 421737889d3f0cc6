"""Carry GMM-HMM parameters from the JAX package into the port.

The tests hand the JAX model's ``GMMHMMParams`` fields over as NumPy
arrays so both packages compute with the same weights (``jax.random`` and
``torch.Generator`` draw different numbers from the same seed).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping

import numpy as np
import torch

from lnasr_tpu_torch.config import GMMHMMConfig
from lnasr_tpu_torch.models.gmmhmm import GMMHMM, GMMHMMParams


def params_from_numpy(log_a, log_pi, log_w, mu, cov, device="cuda",
                      dtype=torch.float32) -> GMMHMMParams:
    """``GMMHMMParams`` on ``device`` in ``dtype`` from array-likes, in
    the field order of both packages' ``GMMHMMParams``."""
    return GMMHMMParams(*(
        torch.as_tensor(np.array(x), dtype=dtype, device=device)
        for x in (log_a, log_pi, log_w, mu, cov)
    ))


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
