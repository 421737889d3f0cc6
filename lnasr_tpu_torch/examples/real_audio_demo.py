"""End-to-end connected-word recognition on speech recordings (protocol v2).

    python -m lnasr_tpu_torch.examples.real_audio_demo --fixtures A.raw B.raw \\
        [--workdir DIR] [--device cpu]

The port of the JAX package's ``examples/real_audio_demo.py``. The
recordings (raw 16 kHz/16-bit PCM) are arguments; there is no default
path. The JAX demo reads the reference's ``test/third/data-vad.raw``
(12.6 s) and ``test/data.raw`` (1.36 s); ``entry.recording_pair`` writes a
seeded stand-in for them.

Protocol v2, with the JAX demo's constants and its random draws in its
order (seed 0 for the data, seed 1 for the condition noise):

1. VAD-segment the recordings (the native WebRTC detector, mode 0) into
   speech chunks, long chunks split into ~0.45 s pieces; drop chunks at
   the noise floor. Each chunk is a vocabulary word.
2. Train per-word 8-state x 2-mixture GMM-HMMs (12 sweeps) on augmented
   copies of every word (gain, offset, noise at the SNRs of
   :data:`TRAIN_SNRS`) and a ``<sil>`` unit on the recordings' noise floor.
3. Build :data:`N_TEST_UTTS` connected utterances from held-out copies
   between gap audio; a bigram LM from 60 random sentences; decode each
   utterance under every condition of :data:`CONDITIONS` with the native
   VAD and shape-bucketed serving (``bucket_frames`` 128, ``lm_scale`` 0.5,
   word penalty -4).
4. Report the WER per condition; ``bench/wer.py`` gates on it.

Two ways to run it:

- :func:`protocol`, the core: trains through ``cli.train_am_units`` and
  decodes through ``cli.build_recognizer``/``decode_with``/
  ``recognize_with`` with the acoustic model in memory (a machine without
  h5py cannot write the model's files). Its CLI check holds
  ``recognize_with`` against the in-process recognizer on the same
  objects.
- :func:`main`, the JAX demo's flow: a manifest and
  ``python -m lnasr_tpu_torch.cli train-am``, ``lm-train`` and
  ``recognize`` in subprocesses, with ``--device`` passed to each command
  that takes it (the CLI defaults to the card).

On CUDA each segment's features run the mel frontend kernel and its
decode the dense-graph Viterbi kernel (a vocabulary of up to 31 words
composes at most 256 states; above that, the factored forward and
backtrace kernels); the N-best check with trigram rescoring records a
word lattice with the lattice kernel. Training computes its features with
the plain pipeline, as ``train-am`` does.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import os
import subprocess
import sys
import tempfile
from typing import Dict, Iterator, List, NamedTuple, Sequence, Tuple

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

SR = 16000
# snr5/snr0 come after the gated conditions, so the condition noise they
# draw leaves the gated rows' draws as they were
CONDITIONS = [("clean", None), ("snr20", 20.0), ("snr10", 10.0),
              ("reverb", "reverb"), ("snr5", 5.0), ("snr0", 0.0)]
N_TEST_UTTS = 20
PROTOCOL_VERSION = 2
STATES, MIX, ITERS = 8, 2, 12
LM_ORDER, LM_SCALE, WORD_PENALTY = 2, 0.5, -4.0
BUCKET_FRAMES = 128
LM_SENTENCES = 60
# the CLI check's options: the in-process recognizer's configuration
CLI_CHECK = ("--vad", "webrtc", "--vad-mode", "0", "--bucket-frames", str(BUCKET_FRAMES))
# multi-condition training: clean and noisy copies of each word, so the
# models match every test condition
TRAIN_SNRS = [None, None, None, None, 20.0, 20.0, 20.0, 10.0, 10.0, 10.0]


def add_reverb(x: np.ndarray, rng, rt60_s: float = 0.3) -> np.ndarray:
    """Convolve with a synthetic exponential-decay room impulse response
    (an unmatched condition: training never sees reverb)."""
    n_rir = int(SR * rt60_s)
    t = np.arange(n_rir) / SR
    rir = rng.normal(0.0, 1.0, n_rir) * np.exp(-6.9 * t / rt60_s)
    rir[0] = 1.0  # direct path
    rir /= np.sqrt(np.sum(rir**2))
    y = np.convolve(x.astype(np.float64), rir)[: len(x)]
    y *= np.sqrt(np.mean(x.astype(np.float64) ** 2) / max(np.mean(y**2), 1e-9))
    return np.clip(y, -32768, 32767).astype(np.int16)


def vad_words(audio: np.ndarray, min_s: float = 0.12, split_s: float = 0.45):
    """``(speech chunks, noise-floor chunks)`` of one recording. Chunks
    longer than ~1.5x ``split_s`` are cut into equal pieces, so a phrase
    gives several vocabulary words."""
    from lnasr_tpu_torch.models.recognizer import segment_speech
    from lnasr_tpu_torch.vad.native import WebRtcVad

    vad = WebRtcVad(mode=0)
    flags = vad.process(audio)
    segs = segment_speech(flags, vad.FRAME_LEN, min_gap_frames=6, min_len_frames=4, pad_frames=2)
    words, gaps, prev = [], [], 0
    for a, b in segs:
        if a - prev > SR // 4:
            gaps.append(audio[prev:a])
        prev = b
        dur = (b - a) / SR
        if dur < min_s:
            continue
        n_pieces = max(1, int(round(dur / split_s)))
        for piece in np.array_split(audio[a:b], n_pieces):
            if len(piece) / SR >= min_s:
                words.append(piece)
    if len(audio) - prev > SR // 4:
        gaps.append(audio[prev:])
    return words, gaps


def augment(x: np.ndarray, rng, snr_db=None) -> np.ndarray:
    """Label-preserving training copy: gain, offset, optional exact-SNR
    additive noise."""
    y = x.astype(np.float64) * rng.uniform(0.8, 1.2)
    shift = rng.integers(0, SR // 50)
    y = np.concatenate([np.zeros(shift), y])
    y = np.clip(y, -32768, 32767).astype(np.int16)
    return add_noise(y, snr_db, rng)


def held_out_copy(x: np.ndarray, rng) -> np.ndarray:
    """Test copy: gain and offset only; noise is added per condition."""
    y = x.astype(np.float64) * rng.uniform(0.8, 1.2)
    shift = rng.integers(0, SR // 50)
    y = np.concatenate([np.zeros(shift), y])
    return np.clip(y, -32768, 32767).astype(np.int16)


def add_noise(x: np.ndarray, snr_db, rng, ref_rms=None) -> np.ndarray:
    """Additive white noise at an exact SNR. ``ref_rms`` fixes the signal
    level (the speech rms, when ``x`` holds silence too)."""
    if snr_db is None:
        return x
    y = x.astype(np.float64)
    rms = ref_rms if ref_rms is not None else np.sqrt(np.mean(y**2))
    noise = rng.normal(0.0, rms / (10.0 ** (snr_db / 20.0)), len(y))
    return np.clip(y + noise, -32768, 32767).astype(np.int16)


def _rms(x: np.ndarray) -> float:
    return np.sqrt(np.mean(x.astype(np.float64) ** 2))


def recording_words(recordings: Sequence[np.ndarray]):
    """``(words, gaps)`` of the recordings: :func:`vad_words` of each, then
    the vocabulary hygiene filter (a chunk at most 5x the median gap rms is
    a detector false positive and would decode like silence)."""
    words, gaps = [], []
    for audio in recordings:
        w, g = vad_words(audio)
        words += w
        gaps += g
    gap_rms = np.median([_rms(g) for g in gaps])
    return [w for w in words if _rms(w) > 5 * gap_rms], gaps


class Inputs(NamedTuple):
    """Everything the protocol draws from seed 0, in the JAX demo's order:
    the training clips as ``(unit, int16 samples)`` in manifest order, the
    LM corpus lines, the test utterances as ``(truth words, int16
    samples)``; and the speech level the condition noise refers to."""

    words: List[np.ndarray]
    gaps: List[np.ndarray]
    names: List[str]
    speech_rms: float
    training: List[Tuple[str, np.ndarray]]
    corpus: List[str]
    utts: List[Tuple[List[str], np.ndarray]]


def protocol_inputs(words, gaps) -> Inputs:
    """Draw the protocol's data from ``words`` and ``gaps``
    (:func:`recording_words`)."""
    rng = np.random.default_rng(0)
    names = [f"w{i}" for i in range(len(words))]
    training = [(name, augment(w, rng, snr)) for name, w in zip(names, words) for snr in TRAIN_SNRS]
    # <sil>: raw and tiled gap audio at every training SNR, the noise at
    # speech-referenced levels (the level the test gaps carry)
    speech_rms = float(np.median([_rms(w) for w in words]))
    for g in gaps:
        tiled = np.tile(g, -(-int(SR * 0.4) // len(g)))[: int(SR * 0.4)]
        for snr in [None, 20.0, 10.0]:
            for x in (g, tiled):
                training.append(("<sil>", add_noise(augment(x, rng), snr, rng, ref_rms=speech_rms)))
    corpus = []
    for _ in range(LM_SENTENCES):
        k = rng.integers(2, 6)
        corpus.append(" ".join(rng.choice(names, size=k)))

    def gap_audio():
        g = gaps[rng.integers(len(gaps))]
        n = int(SR * rng.uniform(0.3, 0.5))
        return augment(np.tile(g, -(-n // len(g)))[:n], rng)

    utts = []
    for _ in range(N_TEST_UTTS):
        truth = [str(w) for w in rng.choice(names, size=int(rng.integers(3, 8)))]
        parts = [gap_audio()]
        for name in truth:
            parts.append(held_out_copy(words[names.index(name)], rng))
            parts.append(gap_audio())
        utts.append((truth, np.concatenate(parts)))
    return Inputs(words, gaps, names, speech_rms, training, corpus, utts)


def condition_audio(inputs: Inputs) -> Iterator[Tuple[str, object, int, np.ndarray]]:
    """``(condition, snr, utterance index, samples)`` for every condition of
    :data:`CONDITIONS` and every test utterance, in order, the noise and
    reverb drawn from one generator of seed 1."""
    noise_rng = np.random.default_rng(1)
    for cond, snr in CONDITIONS:
        for u, (_, clean) in enumerate(inputs.utts):
            if snr == "reverb":
                yield cond, snr, u, add_reverb(clean, noise_rng)
            else:
                yield cond, snr, u, add_noise(clean, snr, noise_rng, ref_rms=inputs.speech_rms)


def recognize_args(*extra: str):
    """``recognize``'s parsed options at the protocol's decoder settings,
    plus ``extra``; the model, lexicon and LM are given as objects (the
    recognizer runs on the acoustic model's device)."""
    from lnasr_tpu_torch import cli

    return cli.build_parser().parse_args(
        ["recognize", "in-memory", "--am", "in-memory", "--lex", "in-memory",
         "--lm-scale", str(LM_SCALE), "--word-penalty", str(WORD_PENALTY), *extra])


def train_units(inputs: Inputs, device: str = "cuda", f64: bool = False):
    """``train-am`` on the training clips, in memory: each clip's features
    by the plain pipeline, then ``cli.train_am_units`` with the protocol's
    options. Returns the acoustic model (its per-unit log lines are
    dropped)."""
    from lnasr_tpu_torch import cli

    args = cli.build_parser().parse_args(
        ["train-am", "in-memory", "in-memory", "--states", str(STATES), "--mix", str(MIX),
         "--iters", str(ITERS), "--device", device] + (["--f64"] if f64 else []))
    am = cli.new_acoustic_model(args)
    examples: Dict[str, List[np.ndarray]] = {}
    for unit, clip in inputs.training:
        examples.setdefault(unit, []).append(cli.unit_features(am, clip))
    with contextlib.redirect_stdout(io.StringIO()):
        return cli.train_am_units(examples, args, am)


def write_lexicon(names: Sequence[str], path: str) -> None:
    with open(path, "w", encoding="utf-8") as fp:
        fp.writelines(f"{n} {n}\n" for n in names)


def write_corpus(corpus: Sequence[str], path: str) -> None:
    with open(path, "w", encoding="utf-8") as fp:
        fp.writelines(line + "\n" for line in corpus)


def train_lm(corpus_path: str, path: str, order: int) -> None:
    """``lm-train``'s ARPA file, the command run in this process."""
    from lnasr_tpu_torch import cli

    with contextlib.redirect_stdout(io.StringIO()):
        cli.main(["lm-train", corpus_path, path, "--order", str(order)])


def decode_conditions(rec, inputs: Inputs):
    """Decode every test utterance under every condition with ``rec``
    (``cli.decode_with``): ``(conditions, per_utt, hypotheses)``, where
    ``per_utt`` holds the clean rows and ``hypotheses`` maps each condition
    to its hypotheses."""
    from lnasr_tpu_torch import cli
    from lnasr_tpu_torch.utils.metrics import wer_details

    args = recognize_args(*CLI_CHECK)
    conditions, per_utt, hyps = {}, [], {}
    total = {}
    for cond, snr, u, noisy in condition_audio(inputs):
        truth = inputs.utts[u][0]
        hyp = cli.decode_with(rec, noisy, args)[0].split()
        hyps.setdefault(cond, []).append(" ".join(hyp))
        d = wer_details(truth, hyp)
        t = total.setdefault(cond, {"err": 0, "n": 0})
        t["err"] += d["sub"] + d["ins"] + d["del"]
        t["n"] += d["n_ref"]
        if cond == "clean":
            per_utt.append({"ref": " ".join(truth), "hyp": " ".join(hyp),
                            "wer": round(d["wer"], 4)})
        if u == len(inputs.utts) - 1:
            conditions[cond] = {"wer": round(t["err"] / t["n"], 4),
                                "snr_db": None if snr == "reverb" else snr,
                                "n_ref_words": t["n"]}
            print(f"{cond:6s}: WER {conditions[cond]['wer']:.3f} "
                  f"({t['n']} ref words, {len(inputs.utts)} utterances)")
    return conditions, per_utt, hyps


def make_report(conditions, per_utt, inputs: Inputs, fixtures) -> dict:
    """The report ``bench/wer.py`` gates on, with the JAX demo's keys."""
    return {
        "protocol_version": PROTOCOL_VERSION,
        "wer": conditions["clean"]["wer"],  # the headline number
        "conditions": conditions,
        "n_ref_words": conditions["clean"]["n_ref_words"],
        "n_test_utts": len(inputs.utts),
        "per_utt": per_utt,
        "vocab_words": len(inputs.words),
        "fixtures": list(fixtures),
        "config": {"seed": 0, "states": STATES, "mix": MIX, "iters": ITERS,
                   "lm_order": LM_ORDER, "lm_scale": LM_SCALE, "word_penalty": WORD_PENALTY,
                   "bucket_frames": BUCKET_FRAMES},
    }


def add_cli_checks(report: dict, truth, hyp: str, hyp_default: str) -> None:
    """The CLI check (the in-process configuration, so the hypothesis must
    equal the in-process one) and the CLI defaults' hypothesis (no VAD,
    the whole utterance unbucketed), recorded for visibility."""
    from lnasr_tpu_torch.utils.metrics import wer_details

    inproc_hyp = report["per_utt"][-1]["hyp"]
    print(f"CLI check: ref={' '.join(truth)!r} hyp={hyp!r} in-process={inproc_hyp!r} "
          f"default-config={hyp_default!r}")
    report["cli_check"] = {
        "ref": " ".join(truth), "hyp": hyp, "inprocess_hyp": inproc_hyp,
        "match": hyp == inproc_hyp,
        "config": " ".join(CLI_CHECK) + " (matches the in-process Recognizer)",
    }
    report["cli_default_check"] = {
        "ref": " ".join(truth), "hyp": hyp_default,
        "config": "CLI defaults: no VAD, unbucketed whole-utterance search",
        "wer": round(wer_details(truth, hyp_default.split())["wer"], 4),
    }


class Protocol(NamedTuple):
    """What :func:`protocol` ran: the report, the acoustic model, the
    drawn inputs, each condition's hypotheses, and the stderr lines of the
    trigram-rescored N-best call on the last utterance."""

    report: dict
    am: object
    inputs: Inputs
    hypotheses: Dict[str, List[str]]
    nbest_lines: List[str]


def protocol(words, gaps, device: str = "cuda", fixtures: Sequence[str] = (), am=None
             ) -> Protocol:
    """Protocol v2 on ``words``/``gaps`` (:func:`recording_words`) with the
    acoustic model in memory: ``am`` as given, or trained by
    :func:`train_units` on ``device``. The lexicon and the bigram and
    trigram LMs are written as text and read back, as the CLI reads them."""
    from lnasr_tpu_torch import cli
    from lnasr_tpu_torch.models.lexicon import Lexicon
    from lnasr_tpu_torch.models.recognizer import LanguageModel

    inputs = protocol_inputs(words, gaps)
    if am is None:
        am = train_units(inputs, device)
    with tempfile.TemporaryDirectory(prefix="lnasr_protocol_") as tmp:
        lex_path, corpus_path = os.path.join(tmp, "words.lex"), os.path.join(tmp, "corpus.txt")
        lm_path, lm3_path = os.path.join(tmp, "words.lm"), os.path.join(tmp, "words3.lm")
        write_lexicon(inputs.names, lex_path)
        write_corpus(inputs.corpus, corpus_path)
        train_lm(corpus_path, lm_path, LM_ORDER)
        train_lm(corpus_path, lm3_path, 3)
        lexicon, lm = Lexicon.load(lex_path), LanguageModel(lm_path)
        rec, _ = cli.build_recognizer(am, lexicon, lm, recognize_args(*CLI_CHECK))
        conditions, per_utt, hyps = decode_conditions(rec, inputs)
        report = make_report(conditions, per_utt, inputs, fixtures)
        truth, clean = inputs.utts[-1]
        hyp, _ = cli.recognize_with(am, lexicon, lm, clean, recognize_args(*CLI_CHECK))
        hyp_default, _ = cli.recognize_with(am, lexicon, lm, clean, recognize_args())
        add_cli_checks(report, truth, hyp, hyp_default)
        _, nbest = cli.recognize_with(am, lexicon, lm, clean,
                                      recognize_args("--nbest", "3", "--rescore-lm", lm3_path))
    return Protocol(report, am, inputs, hyps, nbest)


def cli(*args: str) -> subprocess.CompletedProcess:
    """Run a subcommand of ``python -m lnasr_tpu_torch.cli`` in a
    subprocess, as a user would; raise if it fails."""
    cmd = [sys.executable, "-m", "lnasr_tpu_torch.cli", *args]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, text=True)
    if out.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)} failed:\n{out.stderr}")
    return out


def main(workdir=None, fixtures: Sequence[str] = None, device: str = "cuda") -> float:
    """The JAX demo's flow on the recordings ``fixtures``: files in
    ``workdir`` (a temporary directory by default, removed at the end), the
    acoustic model trained by the ``train-am`` command and written to
    ``workdir/am``, the LMs by ``lm-train``, the CLI check and the N-best
    call by ``recognize``; every command that takes ``--device`` gets
    ``device``. Returns the clean WER; the report is ``main.last_report``."""
    from lnasr_tpu_torch import cli as cli_mod
    from lnasr_tpu_torch._device import resolve_device
    from lnasr_tpu_torch.models.lexicon import Lexicon
    from lnasr_tpu_torch.models.recognizer import LanguageModel
    from lnasr_tpu_torch.utils.audio import read_pcm, write_pcm

    if not fixtures:
        raise ValueError("fixtures: give the paths of the speech recordings (raw 16 kHz PCM)")
    resolve_device(device)  # no card: raise before any file is written
    scratch = tempfile.TemporaryDirectory(prefix="lnasr_demo_") if workdir is None else None
    tmp = workdir or scratch.name
    os.makedirs(tmp, exist_ok=True)
    try:
        words, gaps = recording_words([read_pcm(p) for p in fixtures])
        print(f"vocabulary: {len(words)} real speech chunks "
              f"({', '.join(f'{len(w) / SR:.2f}s' for w in words)}), "
              f"{len(gaps)} noise-floor chunks")
        inputs = protocol_inputs(words, gaps)

        # -- manifest: multi-condition training copies per word + <sil> -----
        lines, counts = [], {}
        for unit, clip in inputs.training:
            k = counts.get(unit, 0)
            counts[unit] = k + 1
            stem = "sil" if unit == "<sil>" else unit
            p = os.path.join(tmp, f"{stem}_train{k}.pcm")
            write_pcm(p, clip)
            lines.append(f"{unit}\t{p}")
        manifest = os.path.join(tmp, "train.manifest")
        with open(manifest, "w") as fp:
            fp.write("\n".join(lines) + "\n")
        amdir = os.path.join(tmp, "am")
        print(cli("train-am", manifest, amdir, "--states", str(STATES), "--mix", str(MIX),
                  "--iters", str(ITERS), "--device", device).stdout.strip())

        # -- lexicon + LM ----------------------------------------------------
        lex_path, corpus = os.path.join(tmp, "words.lex"), os.path.join(tmp, "corpus.txt")
        lm_path, lm3 = os.path.join(tmp, "words.lm"), os.path.join(tmp, "words3.lm")
        write_lexicon(inputs.names, lex_path)
        write_corpus(inputs.corpus, corpus)
        cli("lm-train", corpus, lm_path, "--order", str(LM_ORDER))

        # -- decode under each condition through the in-process recognizer ----
        am = cli_mod.load_am(amdir, device)
        lexicon, lm = Lexicon.load(lex_path), LanguageModel(lm_path)
        rec, _ = cli_mod.build_recognizer(am, lexicon, lm, recognize_args(*CLI_CHECK))
        conditions, per_utt, _ = decode_conditions(rec, inputs)
        main.last_report = make_report(conditions, per_utt, inputs, fixtures)

        # -- the CLI recognize path + trigram rescoring on one utterance -------
        truth, clean = inputs.utts[-1]
        upath = os.path.join(tmp, "utt_cli.pcm")
        write_pcm(upath, clean)
        base = ["recognize", upath, "--am", amdir, "--lex", lex_path, "--lm", lm_path,
                "--lm-scale", str(LM_SCALE), "--word-penalty", str(WORD_PENALTY),
                "--device", device]
        hyp = " ".join(cli(*base, *CLI_CHECK).stdout.split())
        hyp_default = " ".join(cli(*base).stdout.split())
        add_cli_checks(main.last_report, truth, hyp, hyp_default)
        cli("lm-train", corpus, lm3, "--order", "3")
        out = subprocess.run([sys.executable, "-m", "lnasr_tpu_torch.cli", *base,
                              "--nbest", "3", "--rescore-lm", lm3],
                             cwd=REPO, capture_output=True, text=True)
        if out.returncode == 0:
            print("\ntrigram-rescored N-best (last utterance):")
            print(out.stderr.strip())
    finally:
        if scratch is not None:
            scratch.cleanup()
    return main.last_report["wer"]


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fixtures", nargs="+", required=True, metavar="PATH",
                    help="the speech recordings, raw 16 kHz 16-bit PCM")
    ap.add_argument("--workdir", default=None,
                    help="where the files go (default: a temporary directory, removed)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = ap.parse_args()
    sys.exit(0 if main(args.workdir, args.fixtures, args.device) <= 0.25 else 1)
