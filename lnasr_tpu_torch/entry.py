"""The port's main path: the flagship serving step.

``signals (B, S)`` -> 39-dim MFCCs ``(B, T, 39)`` (fused mel frontend
kernel on CUDA) -> diagonal-GMM emissions ``log_b (B, T, 5)`` -> batched
Viterbi (small-N kernel on CUDA) -> ``(path (B, T) int32, score (B,))``,
on the 5-state x 8-mixture x 39-dim model; the counterpart of the JAX
package's ``__graft_entry__.py:entry``.
"""

from __future__ import annotations

import numpy as np
import torch

from lnasr_tpu_torch._device import resolve_device
from lnasr_tpu_torch.config import GMMHMMConfig, MFCCConfig
from lnasr_tpu_torch.models.gmmhmm import GMMHMM, GMMHMMParams
from lnasr_tpu_torch.models.mfcc import MFCC
from lnasr_tpu_torch.ops.viterbi import viterbi_batched

MODEL_CONFIG = GMMHMMConfig(n_states=5, n_mix=8, dim=39)
MFCC_CONFIG = MFCCConfig(energy_floor=1e-10)


def flagship_model(device="cuda", dtype=torch.float32) -> GMMHMM:
    """The flagship GMM-HMM, initialized from seeded random frames."""
    model = GMMHMM(MODEL_CONFIG, dtype=dtype, device=device)
    rng = np.random.default_rng(0)
    return model.init_from_data(rng.normal(scale=10.0, size=(256, MODEL_CONFIG.dim)),
                                torch.Generator().manual_seed(0))


def flagship(device="cuda", dtype=torch.float32, params: GMMHMMParams = None):
    """The serving step ``forward_step(signals) -> (paths, scores)`` on
    ``device``, with ``params`` carried over (else :func:`flagship_model`'s)."""
    dev = resolve_device(device)
    if params is None:
        model = flagship_model(dev, dtype)
    else:
        model = GMMHMM(MODEL_CONFIG, dtype=dtype, device=dev).set_params(params)
    mfcc = MFCC(MFCC_CONFIG, dtype=dtype, device=dev)

    def forward_step(signals):  # (B, S) batch of utterances
        feats, _ = mfcc.features_fast(signals)
        log_b = model.emissions(feats)
        return viterbi_batched(model.log_pi, model.log_a, log_b)

    return forward_step


def entry(device="cuda"):
    """(forward step, example args) on the flagship model."""
    dev = resolve_device(device)
    rng = np.random.default_rng(1)
    example = rng.normal(scale=3000.0, size=(4, 16000)).astype(np.float32)
    return flagship(dev), (torch.as_tensor(example, device=dev),)
