"""PyTorch + CUDA port of ``lnasr_tpu`` for NVIDIA Hopper (H100).

Slice 1 holds the serving step: MFCC features (fused mel frontend kernel)
-> diagonal-GMM emissions -> batched Viterbi (small-N kernel). Slice 2
adds the recognizer's 1-best decode over composed word graphs: the dense
graph (dense-graph Viterbi kernel) and the factored graph (forward and
replay-backtrace kernels), with the lexicon and n-gram LM that compose
them (``models/``, entry point ``entry.recognizer_serving``). Step 3
adds live serving (VAD, the streaming recognizer, the trigram graph) and
training: Baum-Welch EM for the GMM-HMM, the discrete HMM and the GMM,
checkpointed EM loops, isolated-unit training and the HMM word segmenter
(entry points ``entry.training``, ``entry.unit_training``), and
``parallel/``: data-, model-, sequence- and pipeline-parallel EM and
decoding on ``torch.distributed``, one process per rank
(``entry.dryrun_multichip``); and the command line
(``python -m lnasr_tpu_torch.cli``), the bench harnesses
(``lnasr_tpu_torch.bench``) and the examples
(``lnasr_tpu_torch.examples``). The CUDA
kernels live in ``csrc/`` and are compiled with ``nvcc`` at first use
(:mod:`lnasr_tpu_torch._build`); nothing is compiled on import. The port
imports neither JAX nor the JAX package.

TF32 is off for the whole port. The reference pins its DFT, mel, DCT and
emission GEMMs to full fp32 (``Precision.HIGHEST``): reduced-precision
passes made the features wrong (p999 relative error 3.0 against a float64
oracle, instead of 1.2e-3; ``docs/performance.md``, "Matmul precision"),
and the emission GEMM's quadratic terms cancel against each other. TF32
keeps about three decimal digits, so both switches are set to fp32 here.
"""

import torch

__version__ = "0.1.0"

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

from lnasr_tpu_torch.config import (  # noqa: E402
    GMMHMMConfig,
    HMMConfig,
    LTSDConfig,
    MeshConfig,
    MFCCConfig,
    NGramConfig,
    TrainConfig,
)
from lnasr_tpu_torch.models import GMM, Seg, train_unit_models  # noqa: E402

__all__ = [
    "MFCCConfig",
    "HMMConfig",
    "GMMHMMConfig",
    "NGramConfig",
    "LTSDConfig",
    "MeshConfig",
    "TrainConfig",
    "GMM",
    "Seg",
    "train_unit_models",
    "__version__",
]
