"""The port's observability helpers and examples on the CPU.

- ``utils.logging``: ``MetricsLogger`` writes the JAX package's records
  (apart from the elapsed time ``t``), ``Stopwatch`` accumulates;
- ``utils.profiling``: the names of ``annotate`` scopes (context manager
  and decorator) appear in the trace ``device_trace`` writes; the wall
  timer accumulates and waits for the device on a CUDA device;
- ``examples``: ``multihost_train`` converges on 2 gloo ranks and on a
  world of one, and its 2-rank logliks are those of the JAX data-parallel
  step on the same rows from the same start; the segmenter demo prints
  the JAX demo's output; the isolated-word demo prints the JAX demo's
  segments, hypothesis and WER from the same audio and starts.
"""

import io
import json
import os
import re
import sys
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from lnasr_tpu.utils.logging import MetricsLogger as JMetricsLogger
from lnasr_tpu_torch.utils import MetricsLogger, Stopwatch
from lnasr_tpu_torch.utils import profiling

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def one_torch_thread():
    """One intra-op thread: the port's plain CPU paths are frame loops of
    tiny ops, and with the suite's workers sharing the host's cores each op
    of a many-thread pool waits on the others (~10x slower under load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

EVENTS = [("em_step", dict(iteration=3, loglik=-1234.5)),
          ("decode", dict(wer=0.125, words=["a", "b"], rtf=np.float32(0.5))),
          ("done", {})]


def _records(cls, path, capsys):
    with cls(str(path), stdout=True) as log:
        returned = [log.write(event, **m) for event, m in EVENTS]
    err = capsys.readouterr().err
    lines = [json.loads(x) for x in path.read_text().splitlines()]
    assert [json.loads(x) for x in err.splitlines()] == lines
    assert [r["t"] for r in returned] == [r["t"] for r in lines]
    for r in lines + returned:
        assert r.pop("t") >= 0
    assert json.loads(json.dumps(returned, default=float)) == lines
    return lines


def test_metrics_logger_writes_the_jax_records(tmp_path, capsys):
    got = _records(MetricsLogger, tmp_path / "port.jsonl", capsys)
    ref = _records(JMetricsLogger, tmp_path / "jax.jsonl", capsys)
    assert got == ref and got[0] == {"event": "em_step", "iteration": 3, "loglik": -1234.5}
    # append mode: a second logger adds to the file
    with MetricsLogger(str(tmp_path / "port.jsonl")) as log:
        log.write("again")
    assert len((tmp_path / "port.jsonl").read_text().splitlines()) == 4


def test_stopwatch_accumulates():
    sw = Stopwatch()
    for _ in range(2):
        sw.start("phase")
        assert sw.stop("phase") >= 0
    assert list(sw.times) == ["phase"] and sw.times["phase"] >= 0
    with pytest.raises(KeyError):
        sw.stop("never started")


def test_device_trace_holds_the_annotations(tmp_path):
    @profiling.annotate("decorated_scope")
    def work():
        return torch.ones(64) * 2

    with profiling.device_trace(str(tmp_path / "trace")) as prof:
        with profiling.annotate("context_scope"):
            torch.ones(64).sum()
        work()
    assert prof is not None
    trace = (tmp_path / "trace" / "trace.json").read_text()
    names = {e.get("name") for e in json.loads(trace)["traceEvents"]}
    assert {"context_scope", "decorated_scope"} <= names


def test_wall_timer_accumulates_and_waits_for_the_card(monkeypatch):
    results = {}
    for _ in range(2):
        with profiling.wall_timer("step", results, device="cpu"):
            torch.ones(8).sum()
    assert list(results) == ["step"] and results["step"] > 0
    synced = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda device=None: synced.append(device))
    with profiling.wall_timer("card", results, device="cuda"):
        pass
    assert synced == ["cuda"] and results["card"] >= 0
    with profiling.wall_timer("none"):  # no results dict: nothing kept
        pass
    assert "none" not in results


def test_multihost_train_converges_on_two_ranks(capfd):
    from lnasr_tpu_torch.examples import multihost_train

    assert multihost_train.main(["--fake-devices", "2", "--global-batch", "8", "--frames",
                                 "60", "--iters", "4"]) == 0
    out = capfd.readouterr().out
    assert sorted(re.findall(r"^process (\d)/2: gloo on cpu$", out, re.M)) == ["0", "1"]
    lls = [float(x) for x in re.findall(r"iter \d+: loglik (-?[\d.]+)", out)]
    assert len(lls) == 4 and lls == sorted(lls) and lls[-1] > lls[0]
    assert "converging" in out


def test_multihost_train_world_of_one(capfd):
    from lnasr_tpu_torch.examples import multihost_train

    assert multihost_train.main(["--device", "cpu", "--global-batch", "4", "--frames", "40",
                                 "--iters", "3"]) == 0
    out = capfd.readouterr().out
    assert "process 0/1: gloo on cpu" in out and out.count("iter ") == 3
    import torch.distributed as dist

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost_train.main(["--iters", "1"])  # the card by default


def test_multihost_train_writes_each_line_at_once(monkeypatch):
    """Every line the trainer prints goes out in one write, so the lines of
    ranks that share one output cannot interleave (``print`` writes the
    text and the newline apart, and under ``PYTHONUNBUFFERED`` each write
    is a system call: two ranks' lines came out as one)."""
    from lnasr_tpu_torch.examples import multihost_train

    writes = []

    class Recorder(io.StringIO):
        def write(self, s):
            writes.append(s)
            return super().write(s)

    monkeypatch.setattr(sys, "stdout", Recorder())
    assert multihost_train.main(["--device", "cpu", "--global-batch", "4", "--frames", "40",
                                 "--iters", "2"]) == 0
    assert len(writes) == 4 and writes[0] == "process 0/1: gloo on cpu\n"
    assert all(w.endswith("\n") and w.count("\n") == 1 for w in writes), writes


def test_multihost_train_matches_jax_data_parallel():
    """The 2-rank run's per-sweep logliks against the JAX package's
    ``make_dp_gmmhmm_em_step`` on a 2-device mesh in this process, on the
    same global rows from the same start (rank 0's draw, which every rank
    takes). float32 on both sides: rtol 1e-6 (1.1e-7 seen)."""
    import jax
    import jax.numpy as jnp

    from lnasr_tpu import parallel as JP
    from lnasr_tpu.config import GMMHMMConfig as JGMMHMMConfig
    from lnasr_tpu.models.gmmhmm import GMMHMMParams as JParams
    from lnasr_tpu_torch.config import GMMHMMConfig
    from lnasr_tpu_torch.examples import multihost_train
    from lnasr_tpu_torch.models.gmmhmm import GMMHMM
    from lnasr_tpu_torch.parallel.distributed import run_ranks

    batch, frames, iters, dims = 8, 60, 4, dict(n_states=5, n_mix=4, dim=13)
    hist = run_ranks(multihost_train.train, 2, args=(batch, frames, iters), device="cpu")
    assert hist[0] == hist[1]
    rank0 = torch.as_tensor(multihost_train._rows(0, batch // 2, frames, 13)).reshape(-1, 13)
    start = GMMHMM(GMMHMMConfig(**dims), device="cpu").init_from_data(
        rank0, torch.Generator().manual_seed(0)).params
    mesh = JP.make_mesh(JP.mesh_shape_for(2, data=2), devices=jax.devices()[:2])
    step = JP.make_dp_gmmhmm_em_step(mesh, JGMMHMMConfig(**dims))
    params = JParams(*(jnp.asarray(x.numpy()) for x in start))
    obs = jnp.asarray(multihost_train._rows(0, batch, frames, 13))
    mask = jnp.ones((batch, frames), bool)
    ref = []
    for _ in range(iters):
        params, loglik = step(params, obs, mask)
        ref.append(float(loglik))
    np.testing.assert_allclose(hist[0], ref, rtol=1e-6)


def _stdout(fn, *args):
    buf = io.StringIO()
    with redirect_stdout(buf):
        fn(*args)
    return buf.getvalue()


def _jax_example(name):
    """The JAX package's ``examples/<name>.py``, loaded as a module."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(REPO, "examples", f"{name}.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_segmenter_demo_prints_the_jax_demo(monkeypatch):
    from lnasr_tpu_torch.examples import segmenter_demo

    jdemo = _jax_example("segmenter_demo")
    monkeypatch.setattr(sys, "argv", ["segmenter_demo.py"])
    ref = _stdout(jdemo.main)
    got = _stdout(segmenter_demo.main, ["--device", "cpu"])
    assert got == ref and "我们 / 喜欢" in got


UNIT_LINE = re.compile(r"^unit '(.+)': loglik (-?[\d.]+) -> (-?[\d.]+)$", re.M)


def test_isolated_word_demo_recognizes_its_utterance(monkeypatch):
    """The port's demo against the JAX demo run in-process on the same
    seeded audio, each JAX unit starting from the port's draw of its means
    (the two packages draw from different generators): every line equal
    but the per-unit training logliks, which agree within 3e-5 relative
    (float32 EM over six sweeps in two packages, printed to 0.1 at ~2e4;
    4e-6 seen)."""
    import jax.numpy as jnp

    import lnasr_tpu.models.gmmhmm as jgh
    import lnasr_tpu_torch.models.gmmhmm as tgh
    from lnasr_tpu_torch.examples import isolated_word_demo

    draws = []
    port_init = tgh.GMMHMM.init_left_to_right

    def record(self, obs, generator=None, self_loop=0.5):
        port_init(self, obs, generator, self_loop)
        draws.append(self.params[3].numpy().copy())
        return self

    monkeypatch.setattr(tgh.GMMHMM, "init_left_to_right", record)
    buf = io.StringIO()
    with redirect_stdout(buf):
        hyp, err = isolated_word_demo.run("cpu")
    got = buf.getvalue()
    assert hyp == isolated_word_demo.TRUTH and err == 0.0
    assert "== WER: 0.00" in got

    jax_init = jgh.GMMHMM.init_left_to_right
    starts = []

    def from_port_draw(self, obs, key=None, self_loop=0.5):
        jax_init(self, obs, key, self_loop)
        self.mu = jnp.asarray(draws[len(starts)])
        starts.append(self.mu)
        return self

    monkeypatch.setattr(jgh.GMMHMM, "init_left_to_right", from_port_draw)
    ref = _stdout(_jax_example("isolated_word_demo").main)
    assert len(starts) == len(draws) == 4
    assert UNIT_LINE.sub("", got) == UNIT_LINE.sub("", ref)
    units, units_ref = UNIT_LINE.findall(got), UNIT_LINE.findall(ref)
    assert [u[0] for u in units] == [u[0] for u in units_ref] == ["<sil>", "high", "low", "mid"]
    np.testing.assert_allclose([float(x) for u in units for x in u[1:]],
                               [float(x) for u in units_ref for x in u[1:]], rtol=3e-5)
