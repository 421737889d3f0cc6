"""Command-line interface of the port.

The nine subcommands of the JAX package's ``cli.py``, with the same
arguments, defaults, messages and exit codes:

    python -m lnasr_tpu_torch.cli mfcc IN.pcm OUT.npy        # features
    python -m lnasr_tpu_torch.cli vad IN.pcm                 # speech segments
    python -m lnasr_tpu_torch.cli train-seg CORPUS OUT.hdf5  # segmenter training
    python -m lnasr_tpu_torch.cli seg MODEL.hdf5 "文本..."    # segmentation
    python -m lnasr_tpu_torch.cli lm-train CORPUS OUT.lm     # ARPA n-gram LM
    python -m lnasr_tpu_torch.cli lm-ppl MODEL.lm "text"     # perplexity
    python -m lnasr_tpu_torch.cli train-am MANIFEST OUT/     # acoustic models
    python -m lnasr_tpu_torch.cli recognize AUDIO --am OUT/ --lex WORDS.lex \\
        [--lm M.lm --vad webrtc --ref "truth ..."]           # audio -> text (+WER)
    python -m lnasr_tpu_torch.cli bench                      # headline benchmark

Two differences from the JAX CLI:

- Device. Every subcommand that builds tensors (``mfcc``, ``train-seg``,
  ``seg``, ``train-am``, ``recognize``, ``bench``) takes ``--device
  {cuda,cpu}``, default ``cuda``, in place of the JAX CLI's ``--tpu``
  (which pins the host CPU unless it is given). Without a card,
  ``--device cuda`` raises; nothing runs on the CPU unless asked.
  ``lm-train``, ``lm-ppl`` and ``vad`` (the native detectors) are host
  code.
- Structure. Each file-bound subcommand is a shell that reads and writes
  the files around a core that works on objects
  (:func:`mfcc_features`, :func:`vad_segments`, :func:`train_am_units`,
  :func:`recognize_with`), so a caller with its models in memory runs the
  same branch logic; :func:`build_parser` returns the parser.

On CUDA, ``mfcc`` runs the mel frontend kernel once; ``recognize`` runs it
once a segment and then the dense-graph Viterbi kernel (``--graph auto``
on a small vocabulary, or ``dense``), the factored forward and backtrace
kernels (``--graph factored``) or the lattice-recording kernel
(``--nbest``, ``--rescore-lm``, ``--confidence``); ``train-am`` computes
its features with the plain pipeline (``MFCC.__call__``) and trains with
torch ops.
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Dict, List, Sequence, Tuple

import numpy as np

DEVICES = ("cuda", "cpu")


class Refusal(Exception):
    """A combination of options or inputs the CLI refuses (exit code 2);
    ``notes`` are the stderr lines printed before the refusal."""

    def __init__(self, message: str, notes: Sequence[str] = ()):
        super().__init__(message)
        self.notes = list(notes)


def _np(x) -> np.ndarray:
    """A tensor or array as a NumPy array on the host."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _dtype(f64: bool):
    import torch

    return torch.float64 if f64 else torch.float32


def _read_audio(path: str, sample_rate: int = 16000) -> np.ndarray:
    from lnasr_tpu_torch.utils.audio import read_audio

    return read_audio(path, sample_rate)[0]


# -- mfcc -------------------------------------------------------------------------


def mfcc_config(args):
    from lnasr_tpu_torch.config import MFCCConfig

    return MFCCConfig(spectrum_method=args.spectrum, sample_rate=args.sample_rate,
                      frontend=args.frontend, fused_passes=args.fused_passes)


def mfcc_features(audio, args):
    """``(features (T, 39) NumPy, MFCCResult or None)`` of one utterance:
    the serving path (``features_fast``: the mel frontend kernel on CUDA)
    or, with ``--plot``, the plain pipeline that keeps the power spectrum
    and cepstrum for the figure."""
    from lnasr_tpu_torch.models.mfcc import MFCC

    mfcc = MFCC(mfcc_config(args), device=args.device)
    if args.plot:
        res = mfcc(audio)
        return _np(res.features), res
    return _np(mfcc.features_fast(audio)[0]), None


def _cmd_mfcc(args) -> int:
    cfg = mfcc_config(args)
    audio = _read_audio(args.input, cfg.sample_rate)
    feats, res = mfcc_features(audio, args)
    if args.plot:
        _plot_mfcc(args.plot, audio, res, cfg)
    np.save(args.output, feats)
    print(f"{args.input}: {len(audio) / cfg.sample_rate:.2f}s -> {feats.shape} "
          f"features -> {args.output}")
    if args.plot:
        print(f"per-stage plot -> {args.plot}")
    return 0


def _pyplot():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _plot_mfcc(path: str, audio, res, cfg) -> None:
    """Waveform, power spectrogram, mel cepstrum, and final features —
    the per-stage view for debugging acoustic regressions."""
    plt = _pyplot()
    sr = cfg.sample_rate
    power = _np(res.power)
    fig, axes = plt.subplots(4, 1, figsize=(11, 10), constrained_layout=True)
    t = np.arange(len(audio)) / sr
    axes[0].plot(t, audio, lw=0.3, color="#336")
    axes[0].set_title("waveform")
    axes[0].set_xlim(0, t[-1] if len(t) else 1)
    db = 10.0 * np.log10(np.maximum(power, 1e-12))
    im = axes[1].imshow(db.T, origin="lower", aspect="auto", cmap="magma",
                        extent=[0, power.shape[0], 0, sr / 2 / 1000.0])
    axes[1].set_title("power spectrum (dB)")
    axes[1].set_ylabel("kHz")
    fig.colorbar(im, ax=axes[1], shrink=0.8)
    im = axes[2].imshow(_np(res.cepstrum).T, origin="lower", aspect="auto", cmap="viridis")
    axes[2].set_title(f"mel cepstrum ({cfg.n_mels} filters, DCT)")
    fig.colorbar(im, ax=axes[2], shrink=0.8)
    im = axes[3].imshow(_np(res.features).T, origin="lower", aspect="auto", cmap="coolwarm")
    axes[3].set_title(f"features ({cfg.feature_dim} dims: cepstra + logE "
                      "+ delta + delta-delta)")
    axes[3].set_xlabel("frame")
    fig.colorbar(im, ax=axes[3], shrink=0.8)
    fig.savefig(path, dpi=110)
    plt.close(fig)


# -- vad --------------------------------------------------------------------------


def vad_segments(audio, args) -> Tuple[np.ndarray, int, List[Tuple[int, int]]]:
    """``(flags, frame length, speech segments in samples)`` by the native
    detector ``args.detector``; the AMR-WB detector refuses a rate other
    than 16 kHz."""
    from lnasr_tpu_torch.models.recognizer import segment_speech
    from lnasr_tpu_torch.vad.native import AmrWbVad, WebRtcVad

    if args.detector == "amrwb" and args.sample_rate != 16000:
        raise Refusal("the AMR-WB detector is 16 kHz-only")
    if args.detector == "webrtc":
        vad = WebRtcVad(mode=args.mode, sample_rate=args.sample_rate)
        flags = vad.process(audio)
    else:
        vad = AmrWbVad()
        flags, _ = vad.process(audio)
    return flags, vad.FRAME_LEN, segment_speech(flags, vad.FRAME_LEN)


def _cmd_vad(args) -> int:
    sr = args.sample_rate
    if args.detector == "amrwb" and sr != 16000:
        print("error: the AMR-WB detector is 16 kHz-only", file=sys.stderr)
        return 2
    audio = _read_audio(args.input, sr)
    flags, frame, segments = vad_segments(audio, args)
    for a, b in segments:
        print(f"speech\t{a / sr:.2f}\t{b / sr:.2f}")
    if args.plot:
        _plot_vad(args.plot, audio, flags, frame, segments, sr, args.detector)
        print(f"decision overlay -> {args.plot}", file=sys.stderr)
    return 0


def _plot_vad(path, audio, flags, frame, segments, sr, detector) -> None:
    """Waveform with the raw per-frame decisions and the smoothed speech
    segments overlaid (the reference's test/third/vadlstd-test.py:29-38
    diagnostic view)."""
    plt = _pyplot()
    fig, ax = plt.subplots(figsize=(12, 4), constrained_layout=True)
    t = np.arange(len(audio)) / sr
    ax.plot(t, audio, lw=0.3, color="#336", label="waveform")
    peak = float(np.max(np.abs(audio))) or 1.0
    ft = (np.arange(len(flags)) + 0.5) * frame / sr
    ax.step(ft, np.asarray(flags, float) * peak, where="mid",
            color="#c33", lw=0.8, label="frame decision")
    for i, (a, b) in enumerate(segments):
        ax.axvspan(a / sr, b / sr, color="#2a2", alpha=0.18,
                   label="speech segment" if i == 0 else None)
    ax.set_xlabel("seconds")
    ax.set_title(f"{detector} VAD decisions")
    ax.legend(loc="upper right", fontsize=8)
    fig.savefig(path, dpi=110)
    plt.close(fig)


# -- segmenter and language model -----------------------------------------------------


def _cmd_train_seg(args) -> int:
    from lnasr_tpu_torch.models.seg import Seg, SegDataSet

    seg = Seg(device=args.device).train(SegDataSet(args.corpus))
    seg.save(args.output)
    print(f"segmenter trained on {args.corpus} -> {args.output}")
    return 0


def _cmd_seg(args) -> int:
    from lnasr_tpu_torch.models.seg import Seg

    seg = Seg(device=args.device).load(args.model)
    print(" ".join(seg.segment(args.text)))
    return 0


def _cmd_lm_train(args) -> int:
    from lnasr_tpu_torch.models.ngram import NGramCounter, NGramModel, NGramModelARPA, Tokenizer

    with open(args.corpus, encoding="utf-8") as fp:
        tokens = [Tokenizer.get_tokens(line.strip()) for line in fp if line.strip()]
    model = NGramModel(NGramCounter(args.order, tokens))
    NGramModelARPA().save(model, args.output)
    print(f"{args.order}-gram LM over {len(tokens)} sentences -> {args.output}")
    return 0


def _cmd_lm_ppl(args) -> int:
    from lnasr_tpu_torch.models.ngram import NGramModel, NGramModelARPA, Tokenizer

    model = NGramModel(NGramModelARPA().load(args.model))
    sent = Tokenizer.get_tokens(args.text)
    print(f"logprob={model.calc_prob(sent):.4f} ppl={model.calc_ppl(sent):.3f}")
    return 0


# -- acoustic models ------------------------------------------------------------------


def am_mfcc_config(args):
    """The acoustic model's MFCC pipeline: ``energy_floor=1e-10``,
    ``--mean-norm`` and ``--sample-rate``."""
    from lnasr_tpu_torch.config import MFCCConfig

    return MFCCConfig(energy_floor=1e-10, mean_norm=args.mean_norm, sample_rate=args.sample_rate)


def new_acoustic_model(args):
    """An acoustic model with no units yet, on ``args.device`` in float64
    with ``--f64`` (else float32)."""
    from lnasr_tpu_torch.models.recognizer import AcousticModel

    return AcousticModel(mfcc_config=am_mfcc_config(args), dtype=_dtype(args.f64),
                         device=args.device)


def unit_features(am, audio) -> np.ndarray:
    """One training example's features on the host: the plain pipeline
    (``MFCC.__call__``) in the model's dtype, as the JAX CLI computes them."""
    return _np(am.mfcc(audio).features)


def train_am_units(examples: Dict[str, List[np.ndarray]], args, am=None):
    """Isolated-unit training of ``examples`` (unit -> feature arrays) with
    ``train-am``'s options: ``--states``/``--mix`` word units, a
    ``--sil-states``/``--sil-mix`` ``<sil>`` unit, ``--iters`` sweeps,
    checkpoints every ``--checkpoint-every`` sweeps. Returns ``am`` (or a
    new :func:`new_acoustic_model`) with its units set."""
    from lnasr_tpu_torch.config import GMMHMMConfig, TrainConfig
    from lnasr_tpu_torch.models.recognizer import train_unit_models

    if am is None:
        am = new_acoustic_model(args)
    dim = am.mfcc.config.feature_dim
    am_cfg = GMMHMMConfig(n_states=args.states, n_mix=args.mix, dim=dim)
    train_cfg = None
    if args.checkpoint_every > 0:
        ckpt_dir = args.checkpoint_dir or f"{args.output}/checkpoints"
        train_cfg = TrainConfig(max_iters=args.iters, checkpoint_every=args.checkpoint_every,
                                checkpoint_dir=ckpt_dir)
    # silence is stationary: a few-state/many-mixture topology instead of
    # the words' left-to-right one (an LTR silence model grows starved
    # middle states that price silence out of the decoding graph)
    sil_cfg = GMMHMMConfig(n_states=args.sil_states, n_mix=args.sil_mix, dim=dim)
    am.units = train_unit_models(examples, am_cfg, iters=args.iters, dtype=am.dtype,
                                 verbose=True, train_config=train_cfg,
                                 unit_configs={"<sil>": sil_cfg}, device=am.device)
    return am


def am_config(args) -> dict:
    """The ``am_config.json`` record of a ``train-am`` run."""
    cfg = am_mfcc_config(args)
    return {
        "n_states": args.states, "n_mix": args.mix,
        "dim": cfg.feature_dim, "mean_norm": args.mean_norm,
        "energy_floor": cfg.energy_floor,
        "sample_rate": cfg.sample_rate,
        "dtype": "float64" if args.f64 else "float32",
    }


def _cmd_train_am(args) -> int:
    """Isolated-unit acoustic-model training from a manifest of labeled
    audio (lines: ``unit  path/to/audio``), the bootstrap the reference's
    hard-coded ``AcousticModel`` never had (``recognizer.py:20-26``)."""
    am = new_acoustic_model(args)
    examples: dict = {}
    with open(args.manifest, encoding="utf-8") as fp:
        for line in fp:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            unit, path = line.split(None, 1)
            feats = unit_features(am, _read_audio(path.strip(), args.sample_rate))
            examples.setdefault(unit, []).append(feats)
    if not examples:
        print(f"no examples in {args.manifest}", file=sys.stderr)
        return 1
    train_am_units(examples, args, am)
    am.save(args.output)
    if args.plot:
        _plot_am(args.plot, examples, am.units)
        print(f"mixture-ellipse plot -> {args.plot}", file=sys.stderr)
    with open(f"{args.output}/am_config.json", "w", encoding="utf-8") as fp:
        json.dump(am_config(args), fp, indent=2)
    n_ex = sum(len(v) for v in examples.values())
    print(f"{len(examples)} units / {n_ex} examples -> {args.output}")
    return 0


def _plot_am(path: str, examples, units) -> None:
    """Trained-model inspection: training frames projected onto the
    pooled features' top-2 PCA plane with each unit's per-state mixture
    components drawn as 2-sigma ellipses — the debugging view the
    reference's Gaussian surface/contour plots provide in 1-D/2-D
    (``test/gmm-test.py:20-94``), adapted to 39-dim acoustic models."""
    plt = _pyplot()
    from matplotlib.patches import Ellipse

    pooled = np.concatenate([f for exs in examples.values() for f in exs],
                            axis=0).astype(np.float64)
    mean = pooled.mean(axis=0)
    centered = pooled - mean
    cov = centered.T @ centered / max(len(pooled) - 1, 1)
    _, evecs = np.linalg.eigh(cov)
    proj = evecs[:, -2:][:, ::-1]  # (D, 2) top-2 plane

    fig, ax = plt.subplots(figsize=(10, 8), constrained_layout=True)
    pts = centered @ proj
    step = max(1, len(pts) // 3000)
    ax.scatter(pts[::step, 0], pts[::step, 1], s=2, color="#bbb", label="training frames",
               zorder=1)

    names = sorted(units)
    shown = names[:12] + (["<sil>"] if "<sil>" in names[12:] else [])
    cmap = plt.get_cmap("tab20")
    for ui, unit in enumerate(shown):
        m = units[unit]
        color = cmap(ui % 20)
        mu = _np(m.mu).astype(np.float64)  # (N, M, D)
        var = _np(m.cov).astype(np.float64)  # (N, M, D) diag
        if var.ndim == 4:
            var = np.einsum("nmii->nmi", var)
        first = True
        for s in range(mu.shape[0]):
            for k in range(mu.shape[1]):
                c2 = proj.T @ (var[s, k][:, None] * proj)  # (2, 2)
                ev, evec = np.linalg.eigh(c2)
                ang = float(np.degrees(np.arctan2(evec[1, 1], evec[0, 1])))
                center = (mu[s, k] - mean) @ proj
                ax.add_patch(Ellipse(center, 4 * np.sqrt(max(ev[1], 0)),
                                     4 * np.sqrt(max(ev[0], 0)), angle=ang, fill=False,
                                     color=color, lw=1.0, label=unit if first else None,
                                     zorder=2))
                first = False
    if len(names) > len(shown):
        ax.set_title(f"unit mixtures over PCA plane (first {len(shown)} of {len(names)} units)")
    else:
        ax.set_title("unit mixtures over the pooled-feature PCA plane")
    ax.set_xlabel("PC 1")
    ax.set_ylabel("PC 2")
    ax.legend(loc="upper right", fontsize=7, ncol=2)
    fig.savefig(path, dpi=110)
    plt.close(fig)


def load_am(directory: str, device="cuda"):
    """A ``train-am`` output directory (either package's) as an acoustic
    model on ``device``."""
    from lnasr_tpu_torch.config import GMMHMMConfig, MFCCConfig
    from lnasr_tpu_torch.models.recognizer import AcousticModel

    with open(f"{directory}/am_config.json", encoding="utf-8") as fp:
        meta = json.load(fp)
    mfcc_cfg = MFCCConfig(energy_floor=meta["energy_floor"], mean_norm=meta["mean_norm"],
                          sample_rate=meta.get("sample_rate", 16000))
    am_cfg = GMMHMMConfig(n_states=meta["n_states"], n_mix=meta["n_mix"], dim=meta["dim"])
    return AcousticModel.load(directory, am_cfg, mfcc_cfg,
                              dtype=_dtype(meta["dtype"] == "float64"), device=device)


# -- recognize --------------------------------------------------------------------------


def _lattice_options(args) -> bool:
    return args.nbest > 1 or bool(args.rescore_lm) or args.confidence


def build_recognizer(am, lexicon, lm, args):
    """``(Recognizer, notes)`` with ``recognize``'s options, the notes being
    stderr lines. Raises :class:`Refusal` for the AMR-WB detector on a
    model not at 16 kHz, for ``--graph trigram`` with a lattice option and
    for ``--bucket-frames`` with a ``--mean-norm`` model. A lattice option
    moves ``--graph auto``/``dense`` to the factored graph."""
    from lnasr_tpu_torch.models.decoder import DecoderConfig
    from lnasr_tpu_torch.models.recognizer import Recognizer

    sr = am.mfcc.config.sample_rate  # the AM owns the pipeline rate
    notes: List[str] = []
    vad = None
    if args.vad == "webrtc":
        from lnasr_tpu_torch.vad.native import WebRtcVad

        vad = WebRtcVad(mode=args.vad_mode, sample_rate=sr)
    elif args.vad == "amrwb":
        from lnasr_tpu_torch.vad.native import AmrWbVad

        if sr != 16000:
            raise Refusal("the AMR-WB detector is 16 kHz-only but the "
                          f"acoustic model was trained at {sr} Hz", notes)
        vad = AmrWbVad()
    graph = args.graph
    if _lattice_options(args):
        if args.word_times:
            notes.append("note: --word-times applies to the 1-best decode path "
                         "and is ignored with --nbest/--rescore-lm/--confidence")
        # lattices (N-best / rescoring / confidence) live on the factored
        # search; reject or redirect the other graphs explicitly
        if graph == "trigram":
            raise Refusal("--nbest/--rescore-lm/--confidence need the word "
                          "lattice, which only the factored search produces; drop "
                          "--graph trigram (use --rescore-lm with a trigram LM for "
                          "the same objective at scale)", notes)
        if graph == "dense":
            notes.append("note: --graph dense has no lattice path; using "
                         "--graph factored (identical words and scores)")
        graph = "factored"
    if args.bucket_frames and am.mfcc.config.mean_norm:
        raise Refusal("--bucket-frames needs an acoustic model trained "
                      "without --mean-norm (padded frames must not shift "
                      "per-utterance statistics)", notes)
    rec = Recognizer(am, lexicon, lm, vad=vad, graph=graph,
                     decoder_config=DecoderConfig(lm_scale=args.lm_scale,
                                                  word_insertion_penalty=args.word_penalty),
                     bucket_frames=args.bucket_frames, hop_mode=args.hop_mode)
    return rec, notes


def decode_with(rec, audio, args) -> Tuple[str, List[str]]:
    """``(hypothesis, stderr lines)`` of ``recognize`` on ``audio``: the
    N-best lists (with confidences) or the 1-best segments (with word
    times), the WER report against ``--ref`` and the ``--plot`` figure."""
    from lnasr_tpu_torch.models.recognizer import LanguageModel
    from lnasr_tpu_torch.utils.metrics import wer_details

    lines: List[str] = []
    segs_for_plot = None
    if _lattice_options(args):
        rescore = LanguageModel(args.rescore_lm) if args.rescore_lm else None
        seg_lists = rec.recognize_nbest(audio, n=args.nbest, rescore_lm=rescore,
                                        with_confidence=args.confidence)
        hyp = " ".join(w for hyps in seg_lists if hyps for w in hyps[0].words)
        for si, hyps in enumerate(seg_lists):
            for rank, h in enumerate(hyps):
                if args.confidence and h.confidence is not None:
                    rendered = " ".join(f"{w}({c:.2f})" for w, c in zip(h.words, h.confidence))
                else:
                    rendered = " ".join(h.words)
                lines.append(f"seg {si} #{rank + 1} {h.score:.3f}  {rendered}")
    else:
        segs = rec.recognize_segments(audio, word_times=args.word_times or bool(args.plot))
        hyp = " ".join(w for seg in segs for w in seg.words)
        if args.word_times:
            for seg in segs:
                for w, a, b in seg.word_times or []:
                    lines.append(f"time\t{w}\t{a:.3f}\t{b:.3f}")
        segs_for_plot = segs
    if args.ref is not None:
        d = wer_details(args.ref.split(), hyp.split())
        lines.append(f"WER {d['wer']:.3f}  (sub {d['sub']} del {d['del']} "
                     f"ins {d['ins']} / {d['n_ref']} ref words)")
    if args.plot:
        # the non-nbest branch already decoded with word times; only the
        # N-best branch needs a fresh aligned pass
        segs_t = segs_for_plot or rec.recognize_segments(audio, word_times=True)
        _plot_decode(args.plot, rec, audio, segs_t)
        lines.append(f"decode-trellis plot -> {args.plot}")
    return hyp, lines


def recognize_with(am, lexicon, lm, audio, args) -> Tuple[str, List[str]]:
    """``recognize`` on objects: :func:`build_recognizer` then
    :func:`decode_with`; ``(hypothesis, stderr lines)``, the notes first.
    Raises :class:`Refusal` where the command exits with code 2."""
    rec, notes = build_recognizer(am, lexicon, lm, args)
    hyp, lines = decode_with(rec, audio, args)
    return hyp, notes + lines


def _cmd_recognize(args) -> int:
    """Audio in, transcript out — the end-to-end capability the reference
    stubs (``recognizer.py:46-48``). With ``--ref`` prints a WER report."""
    from lnasr_tpu_torch.models.lexicon import Lexicon
    from lnasr_tpu_torch.models.recognizer import LanguageModel

    am = load_am(args.am, args.device)
    lexicon = Lexicon.load(args.lex)
    lm = LanguageModel(args.lm) if args.lm else None
    try:
        rec, notes = build_recognizer(am, lexicon, lm, args)
    except Refusal as e:
        for line in e.notes:
            print(line, file=sys.stderr)
        print(f"error: {e}", file=sys.stderr)
        return 2
    for line in notes:
        print(line, file=sys.stderr)
    audio = _read_audio(args.audio, rec.sample_rate)
    hyp, lines = decode_with(rec, audio, args)
    print(hyp)
    for line in lines:
        print(line, file=sys.stderr)
    return 0


def _plot_decode(path: str, rec, audio, segs) -> None:
    """Decode inspection: per-frame best-state emission log-likelihood
    per word (top rows by peak) as a trellis heatmap, with the decoded
    word spans overlaid — the view that shows WHY a word won."""
    plt = _pyplot()
    from lnasr_tpu_torch.ops.gaussian import gmm_emissions_diag, gmm_emissions_full

    graph = rec.graph
    obs = rec.am.features(np.asarray(audio))
    emissions = gmm_emissions_diag if graph.cov_type == "diag" else gmm_emissions_full
    log_b = _np(emissions(obs, graph.log_w, graph.mu, graph.cov)[0])  # (T, rows)
    obs = _np(obs)
    if hasattr(graph, "state_map"):  # factored / trigram (V, S) grid
        sm, pm = _np(graph.state_map), _np(graph.pad_mask)
        rows_of = [sm[w][pm[w]] for w in range(len(graph.words))]
    else:  # dense graph: emission rows ARE the composed states
        sw = _np(graph.state_word)
        rows_of = [np.flatnonzero(sw == w) for w in range(len(graph.words))]
    per_word = np.stack([log_b[:, rows].max(axis=1) for rows in rows_of])  # (V, T)
    peak = per_word.max(axis=1)
    top = np.argsort(-peak)[: min(30, len(graph.words))]
    top = top[np.argsort([graph.words[i] for i in top])]

    cfg = rec.am.mfcc.config
    sr = float(rec.sample_rate)
    t_axis = len(obs) * cfg.frame_step / sr

    fig, ax = plt.subplots(figsize=(12, 7), constrained_layout=True)
    img = ax.imshow(per_word[top], aspect="auto", origin="lower", cmap="viridis",
                    extent=(0, t_axis, -0.5, len(top) - 0.5),
                    vmin=np.percentile(per_word[top], 5))
    fig.colorbar(img, ax=ax, label="best-state emission log-likelihood")
    ax.set_yticks(range(len(top)))
    ax.set_yticklabels([graph.words[i] for i in top], fontsize=7)
    row_of = {int(i): r for r, i in enumerate(top)}
    word_idx = {w: i for i, w in enumerate(graph.words)}
    for seg in segs:
        for w, a, b in seg.word_times or []:
            r = row_of.get(word_idx.get(w, -1))
            if r is None:
                continue
            ax.plot([a, b], [r, r], color="#f33", lw=3, alpha=0.9)
            ax.text(a, r + 0.25, w, color="#f33", fontsize=7)
    ax.set_xlabel("seconds")
    ax.set_title("decode trellis: per-word emission heatmap + decoded spans")
    fig.savefig(path, dpi=110)
    plt.close(fig)


# -- bench ------------------------------------------------------------------------------


def _cmd_bench(args) -> int:
    from lnasr_tpu_torch.bench import headline

    # the CLI's own argv must not leak into the harness's parser
    return headline.main(["--device", args.device])


# -- the parser -------------------------------------------------------------------------


def _device_arg(p) -> None:
    p.add_argument("--device", choices=DEVICES, default="cuda",
                   help="where tensors live: the CUDA kernels on 'cuda' (default; raises "
                        "without a card), the plain PyTorch paths on 'cpu'")


def build_parser() -> argparse.ArgumentParser:
    """The CLI's parser: the JAX CLI's subcommands and arguments, with
    ``--device`` in place of ``--tpu``."""
    parser = argparse.ArgumentParser(prog="lnasr_tpu_torch", description=__doc__,
                                     formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("mfcc", help="extract MFCC features")
    p.add_argument("input"), p.add_argument("output")
    p.add_argument("--spectrum", choices=["matmul", "fft"], default="matmul")
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--frontend", choices=["auto", "fused", "xla"], default="auto",
                   help="auto rides the fused mel frontend kernel on CUDA, the plain "
                        "PyTorch pipeline on the CPU")
    p.add_argument("--fused-passes", type=int, choices=[3, 6], default=6,
                   help="kept for parity with the JAX CLI; the CUDA kernel computes in "
                        "fp32 for both values")
    p.add_argument("--plot", default=None, metavar="FILE.png",
                   help="write a per-stage diagnostic figure (waveform, "
                        "power spectrum, cepstrum, features)")
    _device_arg(p)
    p.set_defaults(fn=_cmd_mfcc)

    p = sub.add_parser("vad", help="voice activity segments")
    p.add_argument("input")
    p.add_argument("--detector", choices=["webrtc", "amrwb"], default="webrtc")
    p.add_argument("--mode", type=int, default=0)
    p.add_argument("--sample-rate", type=int, default=16000)
    p.add_argument("--plot", default=None, metavar="FILE.png",
                   help="write the waveform with VAD decisions and "
                        "speech segments overlaid")
    p.set_defaults(fn=_cmd_vad)

    p = sub.add_parser("train-seg", help="train the word segmenter")
    p.add_argument("corpus"), p.add_argument("output")
    _device_arg(p)
    p.set_defaults(fn=_cmd_train_seg)

    p = sub.add_parser("seg", help="segment text")
    p.add_argument("model"), p.add_argument("text")
    _device_arg(p)
    p.set_defaults(fn=_cmd_seg)

    p = sub.add_parser("lm-train", help="train an ARPA n-gram LM")
    p.add_argument("corpus"), p.add_argument("output")
    p.add_argument("--order", type=int, default=3)
    p.set_defaults(fn=_cmd_lm_train)

    p = sub.add_parser("lm-ppl", help="sentence perplexity under an ARPA LM")
    p.add_argument("model"), p.add_argument("text")
    p.set_defaults(fn=_cmd_lm_ppl)

    p = sub.add_parser("train-am", help="train per-unit acoustic models "
                       "from a 'unit  audiofile' manifest")
    p.add_argument("manifest"), p.add_argument("output")
    p.add_argument("--states", type=int, default=3)
    p.add_argument("--mix", type=int, default=2)
    p.add_argument("--sil-states", type=int, default=3,
                   help="states for the '<sil>' unit (silence is "
                        "stationary; keep this small)")
    p.add_argument("--sil-mix", type=int, default=4,
                   help="mixtures for the '<sil>' unit (covers varied "
                        "noise conditions)")
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--plot", default=None, metavar="FILE.png",
                   help="write a mixture-ellipse inspection figure of the "
                        "trained units over the pooled-feature PCA plane")
    p.add_argument("--mean-norm", action="store_true",
                   help="per-utterance cepstral mean subtraction (off by "
                        "default: connected decoding must match isolated "
                        "training features)")
    p.add_argument("--sample-rate", type=int, default=16000,
                   help="pipeline rate: audio is resampled to this on "
                        "ingest, features and decoding use it, and it is "
                        "recorded in the model directory")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save training state every K EM iterations; a "
                        "re-run of the same command resumes from the last "
                        "checkpoint (0 disables)")
    p.add_argument("--checkpoint-dir", default=None,
                   help="training-state directory (default: "
                        "OUTPUT/checkpoints)")
    p.add_argument("--f64", action="store_true")
    _device_arg(p)
    p.set_defaults(fn=_cmd_train_am)

    p = sub.add_parser("recognize", help="audio -> text")
    p.add_argument("audio")
    p.add_argument("--am", required=True, help="train-am output directory")
    p.add_argument("--lex", required=True, help="lexicon file")
    p.add_argument("--lm", default=None, help="ARPA language model")
    p.add_argument("--vad", choices=["none", "webrtc", "amrwb"], default="none")
    p.add_argument("--vad-mode", type=int, default=0)
    p.add_argument("--graph", choices=["auto", "dense", "factored", "trigram"], default="auto")
    p.add_argument("--lm-scale", type=float, default=1.0)
    p.add_argument("--word-penalty", type=float, default=0.0)
    p.add_argument("--nbest", type=int, default=1,
                   help="print the N best hypotheses per segment (stderr)")
    p.add_argument("--rescore-lm", default=None,
                   help="ARPA LM (usually trigram+) for lattice N-best "
                        "rescoring — the scalable alternative to "
                        "--graph trigram")
    p.add_argument("--confidence", action="store_true",
                   help="annotate hypotheses with per-word lattice-"
                        "posterior confidences")
    p.add_argument("--word-times", action="store_true",
                   help="print per-word time alignments "
                        "(time\tword\tstart\tend, stderr)")
    p.add_argument("--ref", default=None,
                   help="reference transcript; prints a WER report to stderr")
    p.add_argument("--bucket-frames", type=int, default=0,
                   help="shape-bucketed serving: pad each segment's frame "
                        "count to a multiple of this and decode with a frame "
                        "mask (one copy of the samples in, one of the results "
                        "out; requires a model trained without --mean-norm)")
    p.add_argument("--hop-mode", choices=["auto", "dense", "backoff", "rank1"], default="auto",
                   help="factored-graph word-hop realization: dense (V,V) "
                        "matrix, backoff = exact rank-1+sparse Katz "
                        "factors (large vocabularies), rank1 = word-loop "
                        "pruning for the CUDA kernels (pair with "
                        "--rescore-lm); auto picks by vocabulary size")
    p.add_argument("--plot", default=None, metavar="FILE.png",
                   help="write a decode-trellis figure: per-word emission "
                        "heatmap with the decoded word spans overlaid")
    _device_arg(p)
    p.set_defaults(fn=_cmd_recognize)

    p = sub.add_parser("bench", help="run the headline benchmark")
    _device_arg(p)
    p.set_defaults(fn=_cmd_bench)
    return parser


def main(argv: Sequence[str] = None) -> int:
    args = build_parser().parse_args(argv)
    if hasattr(args, "device"):
        from lnasr_tpu_torch._device import resolve_device

        resolve_device(args.device)  # no card: raise before any file is touched
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
