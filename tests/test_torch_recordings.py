"""The port's recording harnesses (``bench/stream.py``, ``bench/wer.py``,
``examples/real_audio_demo.py``) against the JAX package's root scripts,
on the seeded stand-in for the reference's recordings
(``entry.recording_pair``) written to a temporary directory. The JAX
scripts read fixed paths; pytest's ``monkeypatch`` points their
``FIXTURE``/``FIXTURES`` at the stand-in, and stubs the parts that would
train or decode under JAX, to capture what the scripts draw.

- The demo's augmentation helpers are bitwise equal on the same seeds;
  ``vad_words`` cuts the same chunks and gaps.
- The demo's draws (training clips in manifest order, LM corpus, test
  utterances and their truths, every condition's noisy audio) are those
  of the JAX demo.
- ``bench/wer.py``'s ``gate`` and ``best_previous`` decide as the JAX
  script's on hand-made reports.
- ``bench/stream.py``'s segmentation, augmented training batch and unit
  training options are those of the JAX script.
- The demo's core runs end to end on the CPU at a reduced size (fewer
  utterances, conditions and sweeps), with the CLI check matching; the
  file-bound flow (``bench/wer.py`` -> the demo's ``main`` -> CLI
  subprocesses with ``--device cpu``) gives the core's report.
- The stream harness runs on the CPU; every harness raises on the
  default device without a card.
"""

import contextlib
import importlib.util
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from lnasr_tpu_torch import entry
from lnasr_tpu_torch.bench import stream as tstream
from lnasr_tpu_torch.bench import wer as twer
from lnasr_tpu_torch.examples import real_audio_demo as tdemo
from lnasr_tpu_torch.utils.audio import read_pcm, write_pcm

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPORT_KEYS = {"protocol_version", "wer", "conditions", "n_ref_words", "n_test_utts", "per_utt",
               "vocab_words", "fixtures", "config", "cli_check", "cli_default_check"}


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain CPU paths are frame loops of tiny ops: one intra-op thread
    runs them faster than a pool shared with the suite's other workers
    (module-wide, so that the module fixtures' protocol run has it too)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _load(name, path):
    """A root script of the JAX package, loaded as a module."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", os.path.join(REPO, path))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """The stand-in recordings as raw PCM files: ``(long path, short path)``."""
    d = tmp_path_factory.mktemp("recordings")
    paths = []
    for name, audio in zip(("data-vad.raw", "data.raw"), entry.recording_pair()):
        paths.append(str(d / name))
        write_pcm(paths[-1], audio)
    return tuple(paths)


@pytest.fixture(scope="module")
def jdemo():
    return _load("real_audio_demo", os.path.join("examples", "real_audio_demo.py"))


def test_recording_pair_is_seeded_and_has_the_reference_lengths():
    a, b = entry.recording_pair()
    a2, b2 = entry.recording_pair()
    assert a.dtype == b.dtype == np.int16
    assert (len(a), len(b)) == (201600, 21760)
    assert np.array_equal(a, a2) and np.array_equal(b, b2)
    assert not np.array_equal(a, entry.recording_pair(seed=1)[0])


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_augmentation_helpers_are_bitwise_those_of_jax(jdemo, seed):
    x = entry.recording_pair()[0][20000:36000]
    for fn, args in (("add_reverb", ()), ("augment", ()), ("augment", (20.0,)),
                     ("held_out_copy", ()), ("add_noise", (10.0,)),
                     ("add_noise", (None,)), ("add_noise", (5.0,))):
        kw = {"ref_rms": 1234.5} if fn == "add_noise" and seed == 7 else {}
        rj, rt = np.random.default_rng(seed), np.random.default_rng(seed)
        if fn == "add_noise":
            got = tdemo.add_noise(x, args[0], rt, **kw)
            ref = jdemo.add_noise(x, args[0], rj, **kw)
        else:
            got = getattr(tdemo, fn)(x, rt, *args)
            ref = getattr(jdemo, fn)(x, rj, *args)
        assert got.dtype == ref.dtype == np.int16 and np.array_equal(got, ref), (fn, args)
        assert rt.bit_generator.state == rj.bit_generator.state, (fn, args)
    assert (tdemo.SR, tdemo.N_TEST_UTTS, tdemo.TRAIN_SNRS, tdemo.CONDITIONS) == (
        jdemo.SR, jdemo.N_TEST_UTTS, jdemo.TRAIN_SNRS, jdemo.CONDITIONS)


def test_vad_words_cuts_the_jax_chunks_and_gaps(jdemo):
    for audio in entry.recording_pair():
        got, ref = tdemo.vad_words(audio), jdemo.vad_words(audio)
        for a, b in zip(got, ref):
            assert len(a) == len(b) and all(np.array_equal(x, y) for x, y in zip(a, b))
    words, gaps = tdemo.recording_words(entry.recording_pair())
    assert len(words) >= 15 and len(gaps) >= 3


def test_protocol_draws_are_those_of_the_jax_demo(jdemo, pair, tmp_path, monkeypatch):
    """The JAX demo runs with its CLI calls, model loading and recognizer
    stubbed: the stubs capture the manifest's clips, the LM corpus and every
    audio the recognizer is given, which the port's draws must equal."""
    import lnasr_tpu.cli as jcli
    import lnasr_tpu.models.recognizer as jrec

    n_utts = 4
    monkeypatch.setattr(jdemo, "FIXTURES", list(pair))
    monkeypatch.setattr(jdemo, "N_TEST_UTTS", n_utts)
    monkeypatch.setattr(tdemo, "N_TEST_UTTS", n_utts)
    captured = {"manifest": [], "corpus": None, "decoded": [], "cli": []}

    def fake_cli(*args):
        captured["cli"].append(args[0])
        if args[0] == "train-am":
            with open(args[1]) as fp:
                captured["manifest"] = [(u, read_pcm(p)) for u, p in
                                        (line.split("\t") for line in fp.read().splitlines())]
        elif args[0] == "lm-train":
            with open(args[1]) as fp:
                captured["corpus"] = fp.read().splitlines()
            tdemo.train_lm(args[1], args[2], int(args[4]))
        return ""

    class FakeRecognizer:
        def __init__(self, am, lexicon, lm, vad=None, decoder_config=None, bucket_frames=0):
            captured["config"] = (decoder_config.lm_scale, decoder_config.word_insertion_penalty,
                                  bucket_frames, type(vad).__name__, list(lexicon))

        def recognize(self, audio):
            captured["decoded"].append(np.asarray(audio).copy())
            return ""

    run = subprocess.run

    def no_cli_subprocess(cmd, *a, **kw):
        if "lnasr_tpu.cli" in cmd:
            return subprocess.CompletedProcess(cmd, 1, "", "")
        return run(cmd, *a, **kw)

    monkeypatch.setattr(jdemo, "cli", fake_cli)
    monkeypatch.setattr(jcli, "_load_am", lambda directory: None)
    monkeypatch.setattr(jrec, "Recognizer", FakeRecognizer)
    monkeypatch.setattr(subprocess, "run", no_cli_subprocess)
    with contextlib.redirect_stdout(io.StringIO()):
        jdemo.main(str(tmp_path / "jax"))
    ref = jdemo.main.last_report

    words, gaps = tdemo.recording_words([read_pcm(p) for p in pair])
    inputs = tdemo.protocol_inputs(words, gaps)
    assert len(inputs.training) == len(captured["manifest"]) > 0
    for (u, x), (ju, jx) in zip(inputs.training, captured["manifest"]):
        assert u == ju and np.array_equal(x, jx)
    assert inputs.corpus == captured["corpus"]
    assert [" ".join(t) for t, _ in inputs.utts] == [r["ref"] for r in ref["per_utt"]]
    assert ref["vocab_words"] == len(words) == len(inputs.names)
    audio = [x for *_, x in tdemo.condition_audio(inputs)]
    assert len(audio) == len(captured["decoded"]) == n_utts * len(tdemo.CONDITIONS)
    assert all(np.array_equal(a, b) for a, b in zip(audio, captured["decoded"]))
    assert all(np.array_equal(x, a) for (_, x), a in zip(inputs.utts, audio))  # clean first
    assert captured["config"] == (tdemo.LM_SCALE, tdemo.WORD_PENALTY, tdemo.BUCKET_FRAMES,
                                  "WebRtcVad", inputs.names)
    assert ref["config"] == {**ref["config"], "states": tdemo.STATES, "mix": tdemo.MIX,
                             "iters": tdemo.ITERS, "lm_order": tdemo.LM_ORDER}


def _report(clean, snr10, pv=2, match=True):
    return {"protocol_version": pv,
            "conditions": {"clean": {"wer": clean}, "snr10": {"wer": snr10}},
            "cli_check": {"match": match, "hyp": "a b", "inprocess_hyp": "a c" if not match
                          else "a b"}}


def test_wer_gate_and_ratchet_decide_as_the_jax_script(tmp_path, monkeypatch):
    jwer = _load("bench_wer", "bench_wer.py")
    history = tmp_path / "history"
    history.mkdir()
    for k, rep in enumerate([_report(0.10, 0.30), _report(0.08, 0.35), _report(0.01, 0.01, pv=1)]):
        (history / f"WER_r{k + 1:02d}.json").write_text(json.dumps(rep))
    monkeypatch.setattr(jwer, "REPO", str(history))
    for pv in (1, 2, 3):
        assert twer.best_previous(str(history), pv) == jwer.best_previous(99, pv)
    assert twer.best_previous(str(history), 2) == (0.08, 0.30)
    assert twer.best_previous(None, 2) is None is jwer.best_previous(1, 2)
    cases = [_report(0.05, 0.2, match=False), _report(0.11, 0.2), _report(0.09, 0.41),
             _report(0.09, 0.39), _report(0.2, 0.9), _report(0.3, 0.1)]
    for rep in cases:
        for best in (None, (0.08, 0.30)):
            assert twer.gate(rep, best) == jwer.gate(rep, best)
    assert twer.gate(cases[0], None)[0] is False and twer.gate(cases[4], None)[0] is True
    assert (twer.CLEAN_TOL, twer.NOISY_TOL, twer.BRINGUP_BAR) == (
        jwer.CLEAN_TOL, jwer.NOISY_TOL, jwer.BRINGUP_BAR)


def test_wer_harness_writes_only_to_out(tmp_path, monkeypatch, capsys):
    """With ``--history`` and ``--out`` the report goes to the file and the
    summary line to stdout (the demo's run is stubbed with a hand-made
    report); nothing else is written."""
    history = tmp_path / "history"
    history.mkdir()
    (history / "earlier.json").write_text(json.dumps(_report(0.10, 0.30)))
    (history / "notes.json").write_text(json.dumps(["not a report"]))
    rep = {**_report(0.15, 0.2), "wer": 0.15, "n_ref_words": 10}

    def fake_main(workdir=None, fixtures=None, device="cuda"):
        fake_main.last_report = rep
        print("a line of the demo")
        return rep["wer"]

    monkeypatch.setattr(tdemo, "main", fake_main)
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "report.json"
    rc = twer.main(["--fixtures", "a.raw", "--history", str(history), "--out", str(out),
                    "--device", "cpu"])
    stdout, stderr = capsys.readouterr()
    assert rc == 1 and "a line of the demo" in stderr
    summary = json.loads(stdout)
    written = json.loads(out.read_text())
    assert summary["gate"] == written["gate"] and not written["gate"]["pass"]
    assert "best-so-far 0.100" in written["gate"]["detail"] and written["value"] == 0.15
    assert sorted(os.listdir(tmp_path)) == ["history", "report.json"]


def test_stream_segmentation_and_batch_are_those_of_the_jax_script(pair, monkeypatch):
    """The JAX ``build_recognizer`` runs up to its unit training, which a
    stub captures with the frontend's batch; the port's segmentation,
    augmented batch, features and training options must match."""
    import lnasr_tpu.models.recognizer as jrec
    import lnasr_tpu_torch.models.recognizer as trec
    from lnasr_tpu.vad.native import WebRtcVad as JWebRtcVad

    jstream = _load("bench_stream", "bench_stream.py")
    monkeypatch.setattr(jstream, "FIXTURE", pair[0])
    seen = {}

    class Stop(Exception):
        pass

    def batch_recorder(original, key):
        def features_batch(self, signals, lengths=None):
            seen[key + "batch"] = (np.asarray(signals), np.asarray(lengths))
            return original(self, signals, lengths)
        return features_batch

    def training_stub(key):
        def train_unit_models(examples, config, **kw):
            seen[key + "train"] = ({u: [np.asarray(e) for e in v] for u, v in examples.items()},
                                   config, kw)
            raise Stop
        return train_unit_models

    for mod, key in ((jrec, "jax "), (trec, "port ")):
        monkeypatch.setattr(mod.AcousticModel, "features_batch",
                            batch_recorder(mod.AcousticModel.features_batch, key))
        monkeypatch.setattr(mod, "train_unit_models", training_stub(key))
    with pytest.raises(Stop):
        jstream.build_recognizer()
    with pytest.raises(Stop):
        tstream.build_recognizer(pair[0], device="cpu")

    audio = read_pcm(pair[0])
    segs, words, gaps = tstream.stream_inventory(audio)
    vad = JWebRtcVad(mode=0)
    jsegs = jrec.segment_speech(vad.process(audio), vad.FRAME_LEN, min_gap_frames=12,
                                min_len_frames=8, pad_frames=2)
    assert segs == jsegs and len(words) >= 8 and len(gaps) == 1
    (jb, jl), (tb, tl) = seen["jax batch"], seen["port batch"]
    assert jb.dtype == tb.dtype == np.float32 and np.array_equal(jb, tb)
    assert np.array_equal(jl, tl)
    labels, batch, lengths = tstream.training_batch(words, gaps,
                                                    tstream.augmenter(np.random.default_rng(0)))
    assert np.array_equal(batch, tb) and np.array_equal(lengths, tl)
    (jex, jcfg, jkw), (tex, tcfg, tkw) = seen["jax train"], seen["port train"]
    assert list(jex) == list(tex) == list(dict.fromkeys(labels))
    for unit in jex:
        assert [e.shape for e in jex[unit]] == [e.shape for e in tex[unit]]
        err = max(float(np.abs(a - b).max()) for a, b in zip(jex[unit], tex[unit]))
        assert err < 0.01, (unit, err)
    assert (jcfg.n_states, jcfg.n_mix, jcfg.dim) == (tcfg.n_states, tcfg.n_mix, tcfg.dim) == (
        6, 2, 39)
    sil_j, sil_t = jkw["unit_configs"]["<sil>"], tkw["unit_configs"]["<sil>"]
    assert (sil_j.n_states, sil_j.n_mix) == (sil_t.n_states, sil_t.n_mix) == (3, 4)
    assert (jkw["iters"], jkw["pad_to"]) == (tkw["iters"], tkw["pad_to"]) == (
        5, max(e.shape[0] for v in tex.values() for e in v))


def test_stream_harness_runs_on_the_cpu(pair, tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(tstream, "TIMING_TRIALS", 1)
    monkeypatch.setattr(tstream, "TIMING_REPS", 1)
    monkeypatch.chdir(tmp_path)
    rc = tstream.main(["--recording", pair[0], "--minutes", "0.4", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert rc == 0 and len(lines) == 1 and os.listdir(tmp_path) == []
    out = json.loads(lines[0])
    assert out["segments"] > 10 and out["audio_seconds"] >= 24.0 and out["rtf"] < 0.5
    assert 0 < out["max_buffer_samples"] < 30 * 16000 and out["device"] == "cpu"
    lat = out["latency_ms"]
    assert 0 < lat["p50"] <= lat["p95"] <= lat["p99"] <= lat["max"]
    assert sorted(out["decomposition_ms"]["device_by_bucket_count"]) == ["1", "2", "3", "4", "5"]


def test_harnesses_default_to_the_card_and_raise_without_it(pair, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    words, gaps = tdemo.recording_words([read_pcm(p) for p in pair])
    for call in (lambda: tstream.build_recognizer(pair[0]),
                 lambda: tdemo.main(fixtures=list(pair)),
                 lambda: tdemo.protocol(words, gaps),
                 lambda: twer.main(["--fixtures", *pair])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    with pytest.raises(ValueError, match="fixtures"):
        tdemo.main(device="cpu")


@pytest.fixture(scope="module")
def reduced(pair):
    """The protocol cut to 3 utterances, two conditions and 2 sweeps."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tdemo, "N_TEST_UTTS", 3)
        mp.setattr(tdemo, "CONDITIONS", [("clean", None), ("snr10", 10.0)])
        mp.setattr(tdemo, "ITERS", 2)
        yield


@pytest.fixture(scope="module")
def core(one_torch_thread, pair, reduced):
    words, gaps = tdemo.recording_words([read_pcm(p) for p in pair])
    with contextlib.redirect_stdout(io.StringIO()):
        return tdemo.protocol(words, gaps, device="cpu", fixtures=list(pair))


def test_demo_core_runs_end_to_end_on_the_cpu(core):
    rep = core.report
    assert set(rep) == REPORT_KEYS and rep["protocol_version"] == 2
    assert rep["cli_check"]["match"] and rep["n_test_utts"] == 3 and rep["vocab_words"] >= 15
    assert list(rep["conditions"]) == ["clean", "snr10"] and rep["config"]["iters"] == 2
    assert [len(v) for v in core.hypotheses.values()] == [3, 3]
    assert core.hypotheses["clean"] == [r["hyp"] for r in rep["per_utt"]]
    assert sorted(core.am.units) == sorted(core.inputs.names + ["<sil>"])
    assert core.nbest_lines and core.nbest_lines[0].startswith("seg 0 #1 ")
    assert 0.0 <= rep["wer"] <= 1.0 and rep["n_ref_words"] == sum(
        len(t) for t, _ in core.inputs.utts)


def test_file_bound_flow_gives_the_cores_report(core, pair, tmp_path, monkeypatch, capsys):
    """``bench/wer.py`` -> the demo's ``main``: ``train-am``, ``lm-train``
    and ``recognize`` in subprocesses with ``--device cpu`` (the CLI's
    default is the card); one JSON line on stdout and no file written."""
    monkeypatch.chdir(tmp_path)
    rc = twer.main(["--fixtures", *pair, "--device", "cpu"])
    out, err = capsys.readouterr()
    assert len(out.splitlines()) == 1 and os.listdir(tmp_path) == []
    rep = json.loads(out)
    assert {k: rep[k] for k in REPORT_KEYS} == json.loads(json.dumps(core.report))
    assert rep["gate"]["pass"] == (rc == 0) and "vocabulary:" in err
    assert "trigram-rescored N-best" in err


@pytest.mark.slow
def test_whole_jax_demo_and_the_ports_flow_agree(jdemo, pair, tmp_path, monkeypatch):
    """The JAX demo unstubbed (its CLI subprocesses under JAX on the CPU)
    and the port's file-bound flow, both at the reduced size: the same
    vocabulary, truths and reference-word counts, and each CLI check
    matching its in-process decode. The trained units differ (the two
    packages draw their initial means from different generators), so the
    hypotheses are not compared."""
    for mod in (jdemo, tdemo):
        monkeypatch.setattr(mod, "N_TEST_UTTS", 3)
        monkeypatch.setattr(mod, "CONDITIONS", [("clean", None), ("snr10", 10.0)])
    monkeypatch.setattr(jdemo, "FIXTURES", list(pair))
    monkeypatch.setattr(tdemo, "ITERS", 12)  # the JAX demo's, whatever the module fixture set
    with contextlib.redirect_stdout(io.StringIO()):
        jdemo.main(str(tmp_path / "jax"))
        tdemo.main(str(tmp_path / "port"), list(pair), device="cpu")
    ref, got = jdemo.main.last_report, tdemo.main.last_report
    assert set(got) == set(ref) == REPORT_KEYS
    for key in ("protocol_version", "n_ref_words", "n_test_utts", "vocab_words", "config"):
        assert got[key] == ref[key], key
    assert [r["ref"] for r in got["per_utt"]] == [r["ref"] for r in ref["per_utt"]]
    assert got["cli_check"]["match"] and ref["cli_check"]["match"]
