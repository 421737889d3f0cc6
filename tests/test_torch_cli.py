"""The port's CLI (``python -m lnasr_tpu_torch.cli``) against the JAX
package's (``lnasr_tpu.cli.main``), both on the CPU (the port with
``--device cpu``), on the same files.

The words are the synthetic tone bursts of ``tests/test_cli.py``. The JAX
CLI writes the acoustic models, the lexicon's LMs and the segmenter; the
port reads them. Tolerances: features within 0.01 (the two packages'
fp32 DFT/mel/DCT chains reassociate differently), ``train-am --f64``
parameters within 1e-8 (with the JAX package's initial means drawn as the
port draws them, as in ``tests/test_torch_training.py``), N-best scores
within 1e-4; every other printed line (hypotheses, WER reports, speech
spans, perplexities, segmentations, refusals) equal.
"""

import json
import re
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import lnasr_tpu.models.recognizer as jrec
from lnasr_tpu.cli import main as jax_main
from lnasr_tpu.utils.audio import write_pcm
from lnasr_tpu_torch import cli
from lnasr_tpu_torch.models import gmmhmm as tgh
from tests.test_cli import WORD_F0, _gap, _word_audio
from tests.test_seg import CORPUS as SEG_CORPUS

CPU = ["--device", "cpu"]


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the port's plain CPU paths are frame loops of
    tiny ops, and with the suite's workers sharing the host's cores each op
    of a many-thread pool waits on the others (~10x slower under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _run(main, argv, capsys):
    """``(rc, stdout, stderr)`` of one CLI call."""
    capsys.readouterr()
    rc = main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def _both(argv, capsys, port_extra=CPU):
    """The JAX CLI and the port's on the same arguments."""
    return _run(jax_main, argv, capsys), _run(cli.main, argv + port_extra, capsys)


def _utterance(rng, words):
    parts = [_gap(rng, 0.2)]
    for w in words:
        parts += [_word_audio(w, rng), _gap(rng, 0.2)]
    return np.concatenate(parts)


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    """The JAX CLI's model directory, lexicon, bigram and trigram LMs, and
    test utterances."""
    tmp = tmp_path_factory.mktemp("torch_cli")
    rng = np.random.default_rng(3)
    lines = []
    for w in WORD_F0:
        for k in range(4):
            p = tmp / f"{w}{k}.pcm"
            write_pcm(str(p), _word_audio(w, rng))
            lines.append(f"{w}\t{p}")
    for k in range(3):
        p = tmp / f"sil{k}.pcm"
        write_pcm(str(p), _gap(rng, 0.4))
        lines.append(f"<sil>\t{p}")
    manifest = tmp / "train.manifest"
    manifest.write_text("\n".join(lines) + "\n")
    amdir = tmp / "am"
    assert jax_main(["train-am", str(manifest), str(amdir), "--states", "3", "--mix", "2",
                     "--iters", "5"]) == 0
    lex = tmp / "words.lex"
    lex.write_text("".join(f"{w} {w}\n" for w in WORD_F0))
    corpus = tmp / "corpus.txt"
    corpus.write_text("low mid high\nhigh mid low\nlow high\nmid mid low\n")
    lm2, lm3 = tmp / "words.lm", tmp / "words3.lm"
    assert jax_main(["lm-train", str(corpus), str(lm2), "--order", "2"]) == 0
    assert jax_main(["lm-train", str(corpus), str(lm3), "--order", "3"]) == 0
    utts = {}
    for name, words in (("three", ["high", "low", "mid"]), ("one", ["mid"]),
                        ("two", ["low", "high"])):
        utts[name] = tmp / f"{name}.pcm"
        write_pcm(str(utts[name]), _utterance(rng, words))
    return dict(tmp=tmp, manifest=manifest, am=str(amdir), lex=str(lex), lm=str(lm2),
                lm3=str(lm3), corpus=corpus, utts=utts)


def test_mfcc_matches_jax(tmp_path, speech_audio, capsys):
    wav = tmp_path / "in.pcm"
    write_pcm(str(wav), np.asarray(speech_audio[:16000], np.int16))
    for spectrum in ("matmul", "fft"):
        outs = [tmp_path / f"{who}_{spectrum}.npy" for who in ("jax", "port")]
        (rc_j, out_j, _), (rc_p, out_p, _) = (
            _run(jax_main, ["mfcc", str(wav), str(outs[0]), "--spectrum", spectrum], capsys),
            _run(cli.main, ["mfcc", str(wav), str(outs[1]), "--spectrum", spectrum] + CPU,
                 capsys))
        assert rc_j == rc_p == 0
        assert out_p == out_j.replace(str(outs[0]), str(outs[1]))
        ref, got = np.load(outs[0]), np.load(outs[1])
        assert got.shape == ref.shape == (99, 39) and got.dtype == np.float32
        assert np.abs(got - ref).max() < 0.01


def test_lm_train_and_ppl_match_jax(files, tmp_path, capsys):
    for order in (2, 3):
        paths = [str(tmp_path / f"{who}{order}.lm") for who in ("jax", "port")]
        (rc_j, out_j, _), (rc_p, out_p, _) = (
            _run(jax_main, ["lm-train", str(files["corpus"]), paths[0], "--order", str(order)],
                 capsys),
            _run(cli.main, ["lm-train", str(files["corpus"]), paths[1], "--order", str(order)],
                 capsys))
        assert rc_j == rc_p == 0 and out_p == out_j.replace(paths[0], paths[1])
        # each package loads the other's file with identical probabilities
        text = "low mid high mid"
        lines = set()
        for main in (jax_main, cli.main):
            for path in paths:
                rc, out, _ = _run(main, ["lm-ppl", path, text], capsys)
                assert rc == 0 and out.startswith("logprob=")
                lines.add(out)
        assert len(lines) == 1


def test_seg_matches_jax(tmp_path, capsys):
    corpus = tmp_path / "seg.txt"
    corpus.write_text("\n".join(SEG_CORPUS) + "\n", encoding="utf-8")
    models = [str(tmp_path / f"{who}.hdf5") for who in ("jax", "port")]
    (rc_j, out_j, _), (rc_p, out_p, _) = (
        _run(jax_main, ["train-seg", str(corpus), models[0]], capsys),
        _run(cli.main, ["train-seg", str(corpus), models[1]] + CPU, capsys))
    assert rc_j == rc_p == 0 and out_p == out_j.replace(models[0], models[1])
    for text in ("我们喜欢学习中文", "他们使用语言模型", "我在图书馆学习隐马尔可夫模型。"):
        lines = {_run(jax_main, ["seg", m, text], capsys)[1] for m in models}
        lines |= {_run(cli.main, ["seg", m, text] + CPU, capsys)[1] for m in models}
        assert len(lines) == 1 and lines.pop().strip()


@pytest.mark.parametrize("opts", [[], ["--mode", "3"], ["--detector", "amrwb"],
                                  ["--sample-rate", "8000"]])
def test_vad_matches_jax(tmp_path, vad_audio, opts, capsys):
    wav = tmp_path / "vad.pcm"
    write_pcm(str(wav), np.asarray(vad_audio, np.int16))
    jax_res, port_res = [_run(main, ["vad", str(wav)] + opts, capsys)
                         for main in (jax_main, cli.main)]
    assert port_res == jax_res and jax_res[0] == 0
    if not opts:
        assert jax_res[1].count("speech\t") >= 2


def test_vad_amrwb_refuses_8khz(tmp_path, vad_audio, capsys):
    wav = tmp_path / "vad.pcm"
    write_pcm(str(wav), np.asarray(vad_audio[:8000], np.int16))
    argv = ["vad", str(wav), "--detector", "amrwb", "--sample-rate", "8000"]
    jax_res, port_res = [_run(main, argv, capsys) for main in (jax_main, cli.main)]
    assert port_res == jax_res and jax_res[0] == 2 and "16 kHz-only" in jax_res[2]


def _unit_arrays(path):
    import h5py

    with h5py.File(path, "r") as f:
        return {k: f[k][...] for k in f}


def test_train_am_f64_matches_jax(files, tmp_path, monkeypatch, capsys):
    """Each unit's HDF5 parameters within 1e-8 of the JAX CLI's, the JAX
    units started from the port's initial means (``jax.random`` and
    ``torch.Generator`` draw differently); ``am_config.json`` equal."""
    draws = []
    port_init = tgh.GMMHMM.init_left_to_right

    def record(self, obs, generator=None, self_loop=0.5):
        port_init(self, obs, generator, self_loop)
        draws.append(self.mu.numpy().copy())
        return self

    monkeypatch.setattr(tgh.GMMHMM, "init_left_to_right", record)
    opts = ["--states", "3", "--mix", "2", "--iters", "4", "--f64"]
    dirs = [tmp_path / who for who in ("port", "jax")]
    rc, out_p, _ = _run(cli.main, ["train-am", str(files["manifest"]), str(dirs[0])] + opts + CPU,
                        capsys)
    assert rc == 0 and len(draws) == 4

    jax_init = jrec.GMMHMM.init_left_to_right
    starts = []

    def from_port_draw(self, obs, key=None, self_loop=0.5):
        jax_init(self, obs, key, self_loop)
        self.mu = jnp.asarray(draws[len(starts)])
        starts.append(self)
        return self

    monkeypatch.setattr(jrec.GMMHMM, "init_left_to_right", from_port_draw)
    rc, out_j, _ = _run(jax_main, ["train-am", str(files["manifest"]), str(dirs[1])] + opts,
                        capsys)
    assert rc == 0 and len(starts) == 4
    assert out_p.replace(str(dirs[0]), "OUT") == out_j.replace(str(dirs[1]), "OUT")
    names = sorted(p.name for p in dirs[1].iterdir())
    assert names == sorted(p.name for p in dirs[0].iterdir())
    assert names == ["<sil>.hdf5", "am_config.json", "high.hdf5", "low.hdf5", "mid.hdf5"]
    for name in names[:1] + names[2:]:
        got, ref = _unit_arrays(dirs[0] / name), _unit_arrays(dirs[1] / name)
        assert sorted(got) == sorted(ref)
        for key in ref:
            np.testing.assert_allclose(got[key], ref[key], rtol=1e-8, atol=1e-8, err_msg=key)
    configs = [json.loads((d / "am_config.json").read_text()) for d in dirs]
    assert configs[0] == configs[1] and configs[0]["dtype"] == "float64"


def test_train_am_empty_manifest(tmp_path, capsys):
    manifest = tmp_path / "empty.manifest"
    manifest.write_text("# nothing here\n")
    jax_res, port_res = _both(["train-am", str(manifest), str(tmp_path / "am")], capsys)
    assert port_res == jax_res and jax_res[0] == 1


RECOGNIZE = {
    "lm_wer": (["--lm", "LM", "--lm-scale", "0.5", "--word-penalty", "-40.0",
                "--ref", "high low mid"], "three"),
    "no_lm": ([], "one"),
    "nbest_rescore": (["--lm", "LM", "--lm-scale", "0.5", "--word-penalty", "-40.0",
                       "--nbest", "3", "--rescore-lm", "LM"], "three"),
    "nbest_trigram": (["--lm", "LM", "--lm-scale", "0.5", "--word-penalty", "-40.0",
                       "--nbest", "3", "--rescore-lm", "LM3", "--ref", "high low mid"],
                      "three"),
    "confidence": (["--lm", "LM", "--lm-scale", "0.5", "--word-penalty", "-40.0",
                    "--confidence", "--word-times"], "one"),
    "bucketed": (["--lm", "LM", "--lm-scale", "0.5", "--bucket-frames", "64",
                  "--ref", "low high"], "two"),
    "word_times": (["--lm", "LM", "--word-times", "--graph", "factored"], "two"),
    "dense_nbest": (["--lm", "LM", "--graph", "dense", "--nbest", "2"], "two"),
    "vad": (["--lm", "LM", "--vad", "webrtc", "--ref", "low high"], "two"),
    "trigram_graph": (["--lm", "LM3", "--graph", "trigram", "--lm-scale", "0.5"], "three"),
    "refuse_trigram_nbest": (["--lm", "LM3", "--graph", "trigram", "--nbest", "2",
                              "--word-times"], "one"),
}

_SCORE = re.compile(r"(#\d+ )(-?[\d.]+)")


def _split_scores(err):
    """stderr with the N-best scores taken out, and the scores."""
    return _SCORE.sub(r"\1S", err), [float(s) for _, s in _SCORE.findall(err)]


@pytest.mark.parametrize("case", sorted(RECOGNIZE))
def test_recognize_matches_jax(files, case, capsys):
    opts, utt = RECOGNIZE[case]
    opts = [{"LM": files["lm"], "LM3": files["lm3"]}.get(o, o) for o in opts]
    argv = ["recognize", str(files["utts"][utt]), "--am", files["am"], "--lex",
            files["lex"]] + opts
    (rc_j, out_j, err_j), (rc_p, out_p, err_p) = _both(argv, capsys)
    assert rc_p == rc_j
    assert out_p == out_j
    (text_j, scores_j), (text_p, scores_p) = _split_scores(err_j), _split_scores(err_p)
    assert text_p == text_j
    np.testing.assert_allclose(scores_p, scores_j, rtol=1e-4, atol=1e-4)
    if case.startswith("refuse"):
        assert rc_j == 2 and "error:" in err_j and "note: --word-times" in err_j
        return
    assert rc_j == 0 and out_j.strip()
    if "--ref" in opts:
        assert "WER 0.000" in err_j
    if "--nbest" in opts:
        assert "seg 0 #1" in err_j and scores_j == sorted(scores_j, reverse=True)
    if "--confidence" in opts:
        assert re.search(r"\(\d\.\d\d\)", err_j) and "note: --word-times" in err_j


def _edited_am(files, tmp_path, **meta):
    """A copy of the JAX CLI's model directory with ``am_config.json``
    fields overridden."""
    amdir = tmp_path / "am_edit"
    shutil.copytree(files["am"], amdir)
    cfg = json.loads((amdir / "am_config.json").read_text())
    (amdir / "am_config.json").write_text(json.dumps(cfg | meta))
    return str(amdir)


def test_recognize_refuses_bucketing_with_mean_norm(files, tmp_path, capsys):
    argv = ["recognize", str(files["utts"]["one"]), "--am",
            _edited_am(files, tmp_path, mean_norm=True), "--lex", files["lex"],
            "--bucket-frames", "64"]
    jax_res, port_res = _both(argv, capsys)
    assert port_res == jax_res and jax_res[0] == 2 and "--mean-norm" in jax_res[2]


def test_8khz_train_and_recognize_match_jax(tmp_path, capsys):
    """An 8 kHz model of the JAX CLI: the port recognizes with it as the JAX
    CLI does, and both refuse the 16 kHz-only AMR-WB detector."""
    sr = 8000
    rng = np.random.default_rng(11)

    def tone(f0, dur=0.4):
        t = np.arange(int(sr * dur)) / sr
        sig = sum(np.sin(2 * np.pi * k * f0 * t) / k for k in (1, 2, 3))
        x = (sig * np.hanning(len(t)) * 0.3 + rng.normal(0, 0.01, len(t))) * 12000
        return np.clip(x, -32768, 32767).astype(np.int16)

    lines = []
    for name, f0 in (("lo", 300.0), ("hi", 1100.0)):
        for k in range(4):
            p = tmp_path / f"{name}{k}.pcm"
            write_pcm(str(p), tone(f0 * (1 + 0.01 * rng.normal())))
            lines.append(f"{name}\t{p}")
    manifest = tmp_path / "m.txt"
    manifest.write_text("\n".join(lines) + "\n")
    am = str(tmp_path / "am8k")
    assert jax_main(["train-am", str(manifest), am, "--states", "3", "--mix", "1", "--iters",
                     "5", "--sample-rate", str(sr)]) == 0
    lex = tmp_path / "w.lex"
    lex.write_text("lo lo\nhi hi\n")
    for truth, f0 in (("hi", 1100.0), ("lo", 300.0)):
        utt = tmp_path / f"utt_{truth}.pcm"
        write_pcm(str(utt), tone(f0))
        jax_res, port_res = _both(["recognize", str(utt), "--am", am, "--lex", str(lex),
                                   "--ref", truth], capsys)
        assert port_res == jax_res and jax_res[1].split()[-1] == truth
    jax_res, port_res = _both(["recognize", str(utt), "--am", am, "--lex", str(lex),
                               "--vad", "amrwb"], capsys)
    assert port_res == jax_res and jax_res[0] == 2 and "16 kHz-only" in jax_res[2]


def test_plots_write_pngs(files, tmp_path, speech_audio, vad_audio, capsys):
    """Every ``--plot`` writes its figure headlessly (matplotlib imported
    lazily, the port's tensors drawn)."""
    wav = tmp_path / "speech.pcm"
    write_pcm(str(wav), np.asarray(speech_audio[:16000], np.int16))
    vad_wav = tmp_path / "vad.pcm"
    write_pcm(str(vad_wav), np.asarray(vad_audio[:48000], np.int16))
    pngs = {k: tmp_path / f"{k}.png" for k in ("mfcc", "vad", "am", "decode")}
    runs = [
        ["mfcc", str(wav), str(tmp_path / "f.npy"), "--plot", str(pngs["mfcc"])] + CPU,
        ["vad", str(vad_wav), "--plot", str(pngs["vad"])],
        ["train-am", str(files["manifest"]), str(tmp_path / "am2"), "--iters", "2",
         "--plot", str(pngs["am"])] + CPU,
        ["recognize", str(files["utts"]["one"]), "--am", files["am"], "--lex", files["lex"],
         "--lm", files["lm"], "--vad", "webrtc", "--nbest", "2", "--plot",
         str(pngs["decode"])] + CPU,
    ]
    for argv in runs:
        rc, out, err = _run(cli.main, argv, capsys)
        assert rc == 0, err
        assert f"-> {argv[argv.index('--plot') + 1]}" in out + err
    assert np.load(tmp_path / "f.npy").shape == (99, 39)
    for k, png in pngs.items():
        assert png.stat().st_size > 10_000, k


@pytest.mark.parametrize("argv", [
    ["mfcc", "in.pcm", "out.npy"], ["train-seg", "c.txt", "m.hdf5"], ["seg", "m.hdf5", "文本"],
    ["train-am", "m.txt", "out"], ["recognize", "a.pcm", "--am", "am", "--lex", "l.lex"],
    ["bench"],
])
def test_device_cuda_raises_without_a_card(argv, monkeypatch):
    """``--device`` defaults to ``cuda``; without a card the CLI raises
    before it touches a file, and never runs on the CPU unasked."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        cli.main(argv + ["--device", "cuda"])


def _options(main, command, capsys):
    with pytest.raises(SystemExit):
        main([command, "--help"])
    return set(re.findall(r"(?<![\w-])--[a-z][a-z0-9-]*", capsys.readouterr().out))


@pytest.mark.parametrize("command", ["mfcc", "vad", "train-seg", "seg", "lm-train", "lm-ppl",
                                     "train-am", "recognize", "bench"])
def test_same_arguments_as_jax(command, capsys):
    jax_opts = _options(jax_main, command, capsys) - {"--tpu"}
    port_opts = _options(cli.main, command, capsys)
    expect = jax_opts | ({"--device"} if command not in ("vad", "lm-train", "lm-ppl") else set())
    assert port_opts == expect
    sub = cli.build_parser()._subparsers._group_actions[0].choices
    assert sorted(sub) == sorted(["mfcc", "vad", "train-seg", "seg", "lm-train", "lm-ppl",
                                  "train-am", "recognize", "bench"])


def test_recognize_with_holds_the_branch_logic(files, capsys):
    """The core on objects: the same hypothesis and stderr lines as the
    file-bound command, and :class:`cli.Refusal` where it exits 2."""
    from lnasr_tpu_torch.models.lexicon import Lexicon
    from lnasr_tpu_torch.models.recognizer import LanguageModel
    from lnasr_tpu_torch.utils.audio import read_audio

    am = cli.load_am(files["am"], "cpu")
    lexicon, lm = Lexicon.load(files["lex"]), LanguageModel(files["lm"])
    audio = read_audio(str(files["utts"]["three"]))[0]
    opts = ["--lm", files["lm"], "--lm-scale", "0.5", "--word-penalty", "-40.0", "--nbest",
            "3", "--confidence", "--graph", "dense", "--ref", "high low mid"]
    argv = ["recognize", str(files["utts"]["three"]), "--am", files["am"], "--lex",
            files["lex"]] + opts + CPU
    hyp, lines = cli.recognize_with(am, lexicon, lm, audio, cli.build_parser().parse_args(argv))
    rc, out, err = _run(cli.main, argv, capsys)
    assert rc == 0 and out == hyp + "\n" and err == "".join(f"{x}\n" for x in lines)
    assert lines[0].startswith("note: --graph dense") and lines[-1].startswith("WER 0.000")
    bad = cli.build_parser().parse_args(argv + ["--graph", "trigram"])
    with pytest.raises(cli.Refusal, match="need the word lattice"):
        cli.recognize_with(am, lexicon, lm, audio, bad)
