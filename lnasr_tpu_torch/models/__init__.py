"""Models of the port: MFCC frontend, HMM and GMM-HMM (inference),
lexicon, n-gram LM, the composed word-graph decoders, word lattices and
the recognizer (1-best, N-best and streaming)."""

from lnasr_tpu_torch.models.mfcc import MFCC, mfcc_features
from lnasr_tpu_torch.models.hmm import HMM
from lnasr_tpu_torch.models.gmmhmm import GMMHMM
from lnasr_tpu_torch.models.lexicon import Lexicon
from lnasr_tpu_torch.models.ngram import NGramCounter, NGramModel, NGramModelARPA, Tokenizer
from lnasr_tpu_torch.models.decoder import (
    DecoderConfig,
    DecodingGraph,
    FactoredDecodingGraph,
    HopFactors,
    TrigramDecodingGraph,
)
from lnasr_tpu_torch.models.lattice import Hypothesis, WordLattice, WordToken
from lnasr_tpu_torch.models.recognizer import (
    AcousticModel,
    LanguageModel,
    Recognizer,
    SegmentResult,
    StreamingRecognizer,
    StreamingStats,
    segment_speech,
)

__all__ = [
    "MFCC",
    "mfcc_features",
    "HMM",
    "GMMHMM",
    "Lexicon",
    "NGramCounter",
    "NGramModel",
    "NGramModelARPA",
    "Tokenizer",
    "DecoderConfig",
    "DecodingGraph",
    "FactoredDecodingGraph",
    "HopFactors",
    "TrigramDecodingGraph",
    "Hypothesis",
    "WordLattice",
    "WordToken",
    "AcousticModel",
    "LanguageModel",
    "Recognizer",
    "SegmentResult",
    "StreamingRecognizer",
    "StreamingStats",
    "segment_speech",
]
