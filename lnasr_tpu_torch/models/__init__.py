"""Models of the port: MFCC frontend, HMM, GMM-HMM and GMM (inference and
EM training), lexicon, n-gram LM, the composed word-graph decoders, word
lattices, the recognizer (1-best, N-best and streaming) with isolated-unit
training, and the word segmenter."""

from lnasr_tpu_torch.models.mfcc import MFCC, mfcc_features
from lnasr_tpu_torch.models.hmm import HMM
from lnasr_tpu_torch.models.gmmhmm import GMMHMM
from lnasr_tpu_torch.models.gmm import GMM
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
    train_unit_models,
)
from lnasr_tpu_torch.models.seg import Seg, SegDataSet

__all__ = [
    "MFCC",
    "mfcc_features",
    "HMM",
    "GMMHMM",
    "GMM",
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
    "train_unit_models",
    "Seg",
    "SegDataSet",
]
