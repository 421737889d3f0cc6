"""End-to-end isolated/connected word recognition demo (synthetic audio).

    python -m lnasr_tpu_torch.examples.isolated_word_demo [--device cpu]

Trains per-word GMM-HMMs on synthesized tone-burst "words", builds a
bigram LM and a whole-word lexicon, then recognizes a connected utterance
with VAD segmentation (the native WebRTC detector) and reports WER. The
port of the JAX package's ``examples/isolated_word_demo.py``. On CUDA the
decode runs the mel frontend kernel and the dense-graph Viterbi kernel
once a segment (the 12-state graph); training computes its features with
the plain pipeline, as the JAX demo does.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from lnasr_tpu_torch.config import GMMHMMConfig, MFCCConfig
from lnasr_tpu_torch.models import Lexicon, NGramCounter, NGramModel, Tokenizer
from lnasr_tpu_torch.models.decoder import DecoderConfig
from lnasr_tpu_torch.models.recognizer import (
    AcousticModel,
    LanguageModel,
    Recognizer,
    train_unit_models,
)
from lnasr_tpu_torch.utils.metrics import wer
from lnasr_tpu_torch.vad.native import WebRtcVad

SR = 16000
WORDS = {"low": 220.0, "mid": 560.0, "high": 1400.0}
TRUTH = ["low", "mid", "high", "mid", "low", "high"]


def word_audio(word, rng, dur=0.35):
    n = int(SR * dur)
    t = np.arange(n) / SR
    f0 = WORDS[word] * (1 + 0.01 * rng.normal())
    sig = sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 2 * np.pi)) / k
              for k in range(1, 4))
    x = (sig * np.hanning(n) * 0.3 + rng.normal(0, 0.01, n)) * 12000
    return np.clip(x, -32768, 32767).astype(np.int16)


def gap(rng, dur):
    return rng.normal(0, 60.0, int(SR * dur)).astype(np.int16)


def utterance(words, rng, g=0.3):
    parts = [gap(rng, g)]
    for w in words:
        parts += [word_audio(w, rng), gap(rng, g)]
    return np.concatenate(parts)


def run(device, seed: int = 0):
    """Train, decode :data:`TRUTH` and return ``(hypothesis words, WER)``."""
    rng = np.random.default_rng(seed)
    print("== training per-word GMM-HMMs (3 states x 2 mixtures, 39-dim MFCC)")
    mfcc_cfg = MFCCConfig(energy_floor=1e-10, mean_norm=False)
    am = AcousticModel(mfcc_config=mfcc_cfg, device=device)

    def feats(audio):
        return am.mfcc(audio).features.cpu().numpy()

    examples = {w: [feats(word_audio(w, rng)) for _ in range(5)] for w in WORDS}
    examples["<sil>"] = [feats(gap(rng, 0.4)) for _ in range(4)]
    am.units = train_unit_models(examples, GMMHMMConfig(n_states=3, n_mix=2, dim=39), iters=6,
                                 verbose=True, device=device)

    print("== bigram LM + whole-word lexicon + composed decoder")
    corpus = ["low mid high", "high mid low", "low high mid"]
    lm = LanguageModel(NGramModel(NGramCounter(2, [Tokenizer.get_tokens(s) for s in corpus])))
    rec = Recognizer(am, Lexicon.whole_word(list(WORDS)), lm, vad=WebRtcVad(mode=0),
                     decoder_config=DecoderConfig(lm_scale=0.5))

    audio = utterance(TRUTH, rng)
    print(f"== recognizing a {len(audio) / SR:.1f}s utterance: truth = {' '.join(TRUTH)}")
    for seg in rec.recognize_segments(audio):
        words = " ".join(seg.words) or "(silence)"
        print(f"   [{seg.start_s:5.2f}s – {seg.end_s:5.2f}s] {words}")
    hyp = rec.recognize(audio).split()
    err = wer(TRUTH, hyp)
    print(f"== hypothesis: {' '.join(hyp)}")
    print(f"== WER: {err:.2f}")
    return hyp, err


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args(argv)
    run(args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
