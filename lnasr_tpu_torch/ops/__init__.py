"""Tensor ops of the port: framing, spectra, Gaussians, trellis, kernels.

The package re-exports the JAX package's ``lnasr_tpu.ops`` surface, the
same 18 functions from the port's own modules. The kernel wrappers
(``ops.mel_frontend``, ``ops.viterbi``, ``ops.viterbi_dense``,
``ops.factored``) are imported from their modules; nothing is compiled on
import.
"""

from lnasr_tpu_torch.ops.numerics import logsumexp, log_matvec, log_matmul
from lnasr_tpu_torch.ops.framing import (
    num_frames,
    pad_length,
    preemphasis,
    split_frames,
    hamming_window,
)
from lnasr_tpu_torch.ops.spectral import (
    mel_from_hz,
    hz_from_mel,
    mel_filterbank,
    power_spectrum,
    dct2_ortho_matrix,
)
from lnasr_tpu_torch.ops.trellis import (
    forward_scan,
    backward_scan,
    viterbi_scan,
    forward_assoc,
    posteriors,
)

__all__ = [
    "logsumexp",
    "log_matvec",
    "log_matmul",
    "num_frames",
    "pad_length",
    "preemphasis",
    "split_frames",
    "hamming_window",
    "mel_from_hz",
    "hz_from_mel",
    "mel_filterbank",
    "power_spectrum",
    "dct2_ortho_matrix",
    "forward_scan",
    "backward_scan",
    "viterbi_scan",
    "forward_assoc",
    "posteriors",
]
