"""The port's bench harnesses (``lnasr_tpu_torch/bench/``) at tiny sizes on
the CPU, with their module constants patched: each runs and prints valid
JSON, and where the JAX package's harness computes the same thing the
two agree.

- headline: the seeded audio and model equal the JAX bench's, the
  reference-style baseline pipeline's features equal the float64 oracle
  of ``tests/reference_impl``; ``cli bench`` runs the harness;
- train: one sweep timed, ``--out`` written;
- corpus: the perplexities, the ARPA round trip, the planted decode, the
  backoff decode and the N-best/rescoring outcomes equal the JAX
  harness's on the same seeds (at sizes where the JAX harness's own
  checks hold);
- decoder: five rows, no error, every route equal to its scan; an error
  in a row is recorded in it and the run exits 1;
- scaling: a world of 1 and 2 gloo ranks; the collective payload equals
  the JAX harness's exact count from its statistics pytree.
"""

import io
import json
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from lnasr_tpu_torch import cli
from lnasr_tpu_torch.bench import corpus, decoder, headline, scaling, train


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the port's plain CPU paths are frame loops of
    tiny ops, and with the suite's workers sharing the host's cores each op
    of a many-thread pool waits on the others (~10x slower under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lines(fn, *args):
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = fn(*args)
    return rc, [json.loads(x) for x in buf.getvalue().splitlines() if x.startswith("{")]


@pytest.fixture
def tiny_headline(monkeypatch):
    monkeypatch.setattr(headline, "BATCH", 2)
    monkeypatch.setattr(headline, "UTT_SECONDS", 0.5)
    monkeypatch.setattr(headline, "SERVING_VOCABS", (22,))
    monkeypatch.setattr(headline, "DEFAULT_TRIALS", 2)
    monkeypatch.setattr(headline, "DEFAULT_REPS", 1)
    monkeypatch.setattr(headline, "BASELINE_SECONDS", 0.5)


def test_headline_runs(tiny_headline):
    rc, lines = _lines(headline.main, ["--device", "cpu", "--trials", "3", "--reps", "2"])
    assert rc == 0 and len(lines) == 1
    out = lines[0]
    assert out["unit"] == "audio-seconds/s" and out["value"] > 0 and out["device"] == "cpu"
    assert len(out["spread"]["trials"]) == 3 and "vs_baseline" not in out
    assert out["topology"] == {"batch": 2, "utt_seconds": 0.5, "n_states": 5, "n_mix": 8,
                               "dim": 39, "t_frames": 49, "dtype": "float32"}
    assert sorted(out["stages"]) == ["emissions", "frontend", "viterbi"]
    for stage in out["stages"].values():
        assert stage["seconds_per_call"] > 0 and stage["flops"] > 0 and stage["bytes"] > 0
        assert "bound_s" not in stage  # no peaks for the CPU
    assert out["serving"]["value"] > 0
    row = out["recognizer_serving"]["v22"]
    assert row["graph_states"] == 179 and row["segment_audio_s"] == 5.115
    assert row["decode_segment"]["seconds_per_call"] > 0
    assert row["lattice_records"]["seconds_per_call"] > 0


def test_headline_inputs_and_baseline_match_the_jax_bench(tiny_headline):
    import bench as jbench
    from tests.reference_impl.mfcc_ref import mfcc_ref

    np.testing.assert_array_equal(headline.make_audio(3, 0.25), jbench._make_audio(3, 0.25))
    for got, ref in zip(headline.model_params(np.random.default_rng(0)),
                        jbench._model_params(np.random.default_rng(0))):
        np.testing.assert_array_equal(got, ref)
    audio = headline.make_audio(1, 0.5)[0]
    np.testing.assert_allclose(headline._reference_mfcc(audio), mfcc_ref(audio)[2],
                               rtol=1e-12, atol=1e-9)
    rc, lines = _lines(headline.main, ["--measure-baseline"])
    base = lines[0]
    assert rc == 0 and base["audio_seconds"] == 0.5 and "cores" in base["host"]
    b = base["baseline_audio_s_per_s"]
    assert 0 < b["min"] <= b["median"] <= b["max"] and len(b["trials"]) == 11


def test_cli_bench_runs_the_headline(tiny_headline):
    rc, lines = _lines(cli.main, ["bench", "--device", "cpu"])
    assert rc == 0 and len(lines) == 1 and lines[0]["metric"].startswith("audio-seconds/s")
    assert len(lines[0]["spread"]["trials"]) == 2


def test_train_bench_runs(monkeypatch, tmp_path):
    monkeypatch.setattr(train, "BATCH", 2)
    monkeypatch.setattr(train, "UTT_SECONDS", 0.5)
    out = tmp_path / "train.json"
    rc, lines = _lines(train.main, ["--device", "cpu", "--trials", "2", "--out", str(out)])
    assert rc == 0 and len(lines) == 1
    row = lines[0]
    assert json.loads(out.read_text()) == row
    assert row["value"] > 0 and row["loglik_finite"] and row["topology"]["t_frames"] == 49
    stages = row["stages"]
    assert stages["emissions"]["flops"] > 0 and stages["fwd_bwd_scans"]["seconds_per_call"] > 0
    assert stages["m_step"]["seconds_derived"] >= 0


CORPUS_ARGS = ["--sentences", "2000", "--vocab", "300", "--decode-vocab", "200"]


def test_corpus_bench_matches_jax():
    import bench_corpus as jcorpus

    rc, port = _lines(corpus.main, ["--device", "cpu"] + CORPUS_ARGS)
    assert rc == 0 and len(port) == 1
    rc, ref = _lines(jcorpus.main, CORPUS_ARGS)
    assert rc == 0
    port, ref = port[0], ref[0]
    for key in ("sentences", "train_vocab", "value"):
        assert port[key] == ref[key]
    for key in ("katz_fixed", "good_turing"):
        assert port[key]["held_out_ppl"] == ref[key]["held_out_ppl"]
    for key in ("ppl_before", "ppl_after", "roundtrip_ok", "size_mb"):
        assert port["arpa"][key] == ref["arpa"][key]
    assert port["score_tables"]["bigram_finite_frac"] == ref["score_tables"]["bigram_finite_frac"]
    for key in ("vocab", "frames", "planted_recovered", "edit_distance_to_planted"):
        assert port["decode"][key] == ref["decode"][key]
    for key in ("k_max_in_degree", "clamped_arcs", "words_match_dense"):
        assert port["decode"]["backoff_mode"][key] == ref["decode"]["backoff_mode"][key]
    for key in ("top_matches_planted", "n_hyps", "n_distinct_bigram_hyps",
                "rescoring_reordered", "planted_in_rescored_list", "rescored_top_edit_distance"):
        assert port["lattice"][key] == ref["lattice"][key], key
    assert port["lattice"]["n_hyps"] >= 5


def test_corpus_make_corpus_matches_jax():
    import bench_corpus as jcorpus

    assert (corpus.make_corpus(50, 200, np.random.default_rng(4))
            == jcorpus.make_corpus(50, 200, np.random.default_rng(4)))


@pytest.fixture
def tiny_decoder(monkeypatch):
    monkeypatch.setattr(decoder, "LARGE_VOCABS", (300, 400))
    monkeypatch.setattr(decoder, "LM_SENTENCES", 400)


DECODER_ARGS = ["--device", "cpu", "--vocab", "40", "--frames", "60", "--n", "40", "--t", "50"]


def test_decoder_bench_runs(tiny_decoder, tmp_path):
    out = tmp_path / "rows.json"
    rc, rows = _lines(decoder.main, DECODER_ARGS + ["--out", str(out)])
    assert rc == 0 and json.loads(out.read_text()) == rows
    assert [r["row"] for r in rows] == ["factored_1k", "lattice_1k", "dense_kernel",
                                        "large_vocab_5k", "large_vocab_10k"]
    assert not any("error" in r for r in rows)
    fac, lat, dense, big5, big10 = rows
    assert fac["paths_equal_scan"] and fac["value"] > 0 and fac["frames"] == 60
    assert lat["records_equal_scan"] and lat["value"] > 0
    assert dense["paths_bit_identical"] and dense["value"] > 0
    assert sorted(big5["realizations"]) == ["backoff", "dense_scan", "hyp_lengths", "rank1"]
    assert sorted(big10["realizations"]) == ["backoff", "hyp_lengths", "rank1"]
    for big in (big5, big10):
        assert not any("error" in r for r in big["realizations"].values())
        assert big["value"] == big["realizations"]["backoff"]["audio_s_per_s"] > 0
        assert big["realizations"]["backoff"]["paths_equal_scan"]
        assert big["realizations"]["backoff"]["arcs"] > 0
        assert big["realizations"]["rank1"]["pruned_arcs"] > 0
        assert big["realizations"]["rank1"]["paths_equal_scan"]


def test_decoder_bench_records_a_failed_row(tiny_decoder, monkeypatch):
    def broken(*args):
        raise RuntimeError("no such kernel")

    monkeypatch.setattr(decoder, "bench_dense_kernel", broken)
    rc, rows = _lines(decoder.main, DECODER_ARGS)
    assert rc == 1 and len(rows) == 5
    assert rows[2] == {"row": "dense_kernel", "metric": "dense_kernel",
                       "error": "RuntimeError: no such kernel"}
    assert all("error" not in r for i, r in enumerate(rows) if i != 2)


def test_scaling_bench_runs(tmp_path):
    import jax.numpy as jnp

    import bench_scaling as jscaling
    from lnasr_tpu.config import GMMHMMConfig as JGMMHMMConfig
    from lnasr_tpu.models.gmmhmm import GMMHMM as JGMMHMM

    out = tmp_path / "scaling.json"
    rc = scaling.main(["--devices", "1,2", "--batch", "2", "--t", "20", "--steps", "1",
                       "--out", str(out)])
    assert rc == 0
    report = json.loads(out.read_text())
    rows, summary = report["rows"], report["summary"]
    assert [r["devices"] for r in rows] == [1, 2]
    assert {r["backend"] for r in rows} == {"gloo"}
    for row in rows:
        assert row["step_seconds"] > 0 and row["utterances_per_s"] > 0
        assert row["losses_equal_across_ranks"]
        assert row["psum_payload_bytes_per_device"] == rows[0]["psum_payload_bytes_per_device"]
    assert rows[0]["weak_scaling_efficiency"] == 1.0
    assert rows[0]["ring_allreduce_bytes_per_device"] == 0
    assert rows[0]["collective_bytes_per_step"] == 0  # a world of one sums nothing
    assert (rows[1]["ring_allreduce_bytes_per_device"] == rows[1]["collective_bytes_per_step"]
            == rows[1]["psum_payload_bytes_per_device"])
    # the payload is the JAX harness's exact count of its statistics pytree
    cfg = JGMMHMMConfig(n_states=5, n_mix=8, dim=39)
    model = JGMMHMM(cfg, dtype=jnp.float32)
    model.reset("random")
    obs = np.zeros((2, 20, 39), np.float32)
    assert rows[0]["psum_payload_bytes_per_device"] == jscaling._psum_payload_bytes(
        model.params, obs, np.ones((2, 20), bool), "diag")
    assert [r["model_axis"] for r in report["model_parallel_rows"][:-1]] == [1, 2]
    assert report["model_parallel_rows"][1]["collectives_per_step"] > 0
    assert [r["devices"] for r in report["dp_decode_rows"][:-1]] == [1, 2]
    assert summary["value"] == rows[-1]["weak_scaling_efficiency"]
    assert summary["overhead_not_scaling"] and "not hardware scaling" in summary["note"]


def test_bench_modules_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (headline.main, train.main, corpus.main, decoder.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main([])
    with pytest.raises(Exception, match="CUDA"):
        scaling.main(["--devices", "1", "--device", "cuda"])
    bench = sys.modules["lnasr_tpu_torch.bench"]
    assert bench.device_peaks("cpu") is None
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA H100 80GB HBM3")
    assert bench.device_peaks("cuda") == bench.H100_PEAKS == (67e12, 3.35e12)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda dev=None: "NVIDIA A100-SXM4-80GB")
    with pytest.raises(ValueError, match="H100 only"):
        bench.device_peaks("cuda")
