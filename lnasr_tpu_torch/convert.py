"""Carry GMM-HMM parameters from the JAX package into the port.

The tests hand the JAX model's ``GMMHMMParams`` fields over as NumPy
arrays so both packages compute with the same weights (``jax.random`` and
``torch.Generator`` draw different numbers from the same seed).
"""

from __future__ import annotations

import numpy as np
import torch

from lnasr_tpu_torch.models.gmmhmm import GMMHMMParams


def params_from_numpy(log_a, log_pi, log_w, mu, cov, device="cuda",
                      dtype=torch.float32) -> GMMHMMParams:
    """``GMMHMMParams`` on ``device`` in ``dtype`` from array-likes, in
    the field order of both packages' ``GMMHMMParams``."""
    return GMMHMMParams(*(
        torch.as_tensor(np.array(x), dtype=dtype, device=device)
        for x in (log_a, log_pi, log_w, mu, cov)
    ))
