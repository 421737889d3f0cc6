"""``kernel_timing.py``'s dry run on the CPU (``--device cpu``: the plain
versions, the host clock) over the groups that read the flagship batch
(A and B), at a cut batch: the script's calls into ``chip_smoke.py`` and
into the port keep their signatures (it once passed ``make_signals`` two
of its three arguments, and every group that reads the batch failed)."""

import json
import sys

import numpy as np
import pytest
import torch

import chip_smoke
import kernel_timing
from lnasr_tpu_torch.config import LTSDConfig


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The dry runs are frame loops of tiny ops on the CPU: one intra-op
    thread runs them faster than a pool shared with the suite's other
    workers (8 threads a worker on 8 cores: ~8x slower under that load)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_dry_run_of_the_flagship_groups(monkeypatch, tmp_path):
    monkeypatch.setattr(chip_smoke, "B", 2)
    monkeypatch.setattr(chip_smoke, "SECONDS", 1)
    out = tmp_path / "rows.jsonl"
    monkeypatch.setattr(sys, "argv", ["kernel_timing.py", "--device", "cpu", "--kernels", "A,B",
                                      "--reps", "1", "--out", str(out)])
    assert kernel_timing.main() == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["kernel"] for r in rows if "kernel" in r] == ["A", "A", "B"]
    assert all(r["ms"] > 0 for r in rows if "kernel" in r)


def test_dry_run_of_the_trigram_group(monkeypatch, tmp_path):
    """Group H at a cut vocabulary: the forward on every route of
    ``ops.trigram.ROUTES`` that takes each dtype at an H100's 132 SMs (the
    resident route at float32 only), in turns, and the backtrace, each
    first held to its plain version."""
    from lnasr_tpu_torch.ops import trigram as tri

    monkeypatch.setattr(kernel_timing, "H_VOCAB", 6)
    out = tmp_path / "rows.jsonl"
    monkeypatch.setattr(sys, "argv", ["kernel_timing.py", "--device", "cpu", "--kernels", "H",
                                      "--reps", "1", "--out", str(out)])
    assert kernel_timing.main() == 0
    rows = [json.loads(line) for line in out.read_text().splitlines() if '"kernel"' in line]
    fwd = [(r["what"].split()[3], r["route"], r["turn"], r["chosen"]) for r in rows
           if "forward" in r["what"]]
    want = [("float32", "smem"), ("float32", "global"), ("float32", "resident"),
            ("float64", "smem"), ("float64", "global")]
    assert [f[:2] for f in fwd] == want * 2 and [f[2] for f in fwd] == [1] * 5 + [2] * 5
    assert {f[:2] for f in fwd if f[3]} == {("float32", "resident"), ("float64", "smem")}
    assert tri.ROUTES == ("smem", "global", "resident")
    assert [r["what"] for r in rows][0].startswith("H decode core V=6")
    assert rows[-1]["what"] == "H V=6 backtrace" and all(r["ms"] > 0 for r in rows)


def test_dry_run_of_the_backtrace_floor_group(monkeypatch, tmp_path):
    """Group Hbt at a cut vocabulary: H's backtrace held to the plain
    gathers and timed (the chain floor and the cold timing need the card)."""
    monkeypatch.setattr(kernel_timing, "H_VOCAB", 6)
    out = tmp_path / "rows.jsonl"
    monkeypatch.setattr(sys, "argv", ["kernel_timing.py", "--device", "cpu", "--kernels", "Hbt",
                                      "--reps", "1", "--out", str(out)])
    assert kernel_timing.main() == 0
    rows = [json.loads(line) for line in out.read_text().splitlines() if '"kernel"' in line]
    assert len(rows) == 1 and rows[0]["what"].startswith("H V=6 backtrace and its chain floor")
    assert rows[0]["bt_ms"] > 0 and "floor_ms" not in rows[0]


def test_dry_run_of_the_ltsd_and_trellis_groups(monkeypatch, tmp_path):
    """Groups J and K on a cut stream and batch: the adaptive ``detect``,
    J at float32 and float64 held to its plain loop, K at
    ``decode_batch``'s inputs held to its plain loop, each with its bound
    and chain floor (the plain versions here)."""
    from lnasr_tpu_torch import entry

    training, stream = entry.training, entry.serving_stream
    monkeypatch.setattr(entry, "training",
                        lambda device="cuda": training(device=device, batch=3, seconds=1))
    monkeypatch.setattr(entry, "serving_stream", lambda seed=0: stream(seed)[:16000 * 4])
    out = tmp_path / "rows.jsonl"
    monkeypatch.setattr(sys, "argv", ["kernel_timing.py", "--device", "cpu", "--kernels", "J,K",
                                      "--reps", "1", "--out", str(out)])
    assert kernel_timing.main() == 0
    rows = [json.loads(line) for line in out.read_text().splitlines() if '"kernel"' in line]
    assert [r["kernel"] for r in rows] == ["J", "J", "J", "J", "K"]
    assert rows[0]["what"].startswith("J detect adaptive, 4.0 s")
    assert rows[1]["what"].startswith("J detect fixed, 4.0 s") and rows[1]["ms"] > 0
    assert [r["what"].split()[-1] for r in rows[2:4]] == ["float32", "float64"]
    assert all(r["ms"] > 0 and r["floor_ms"] > 0 and r["bound_ms"] > 0 for r in rows[2:])
    # J's bound: the LTSE rows of the valid band, the noise and the scores
    for r, itemsize in zip(rows[2:4], (4, 8)):
        valid, f = int(r["what"].split()[2]), int(r["what"].split()[5])
        t = valid + 2 * LTSDConfig().order
        want = itemsize * (valid * f + f + t) / chip_smoke.HBM_BYTES_PER_S * 1e3
        assert r["bound_ms"] == pytest.approx(want, rel=1e-12)
    k = rows[-1]
    assert k["kernel_k"] and k["what"] == "K viterbi_scan at decode_batch's inputs B=3 T=99 N=5"
    assert k["plain_ms"] > 0 and k["decode_ms"] > 0
    # K's bound: emission rows of the valid frames only, the mask and every output
    b, t, n = 3, 99, 5
    lengths = np.random.default_rng(17).integers(t // 3, t + 1, size=b)
    lengths[0] = t
    want = (4 * int(lengths.sum()) * n + b * t + 8 * b * t * n + 4 * b * t + 4 * b)
    assert k["bound_ms"] == pytest.approx(want / chip_smoke.HBM_BYTES_PER_S * 1e3, rel=1e-12)


@pytest.mark.parametrize("kernel", ["A", "B", "D", "G", "H", "I", "J", "K"])
def test_phase_stamps_fit_the_committed_kernels(kernel):
    """``kernel_phases.py``'s CPU side: a patch set of each kernel finds
    every anchor once in the committed source (J's and K's the newest), and
    the stamped copy
    declares the stamps and writes each unit's phases (J: five a frame for
    the division warps and five for the combiner, K: the warp route's
    nine) without dropping a line of the source."""
    import os

    import kernel_phases

    name = kernel_phases.KERNEL_NAMES[kernel]
    with open(os.path.join(os.path.dirname(kernel_phases.__file__), "lnasr_tpu_torch", "csrc",
                           f"{name}.cu")) as f:
        src = f.read()
    stamped, (version, stride, phases) = kernel_phases.stamped_source(src, name)
    if kernel in "JK":
        assert version == kernel_phases.PATCH_SETS[name][0][0]
    assert "g_stamps" in stamped and "read_stamps" in stamped and stride > len(phases)
    kept = iter(stamped.splitlines())
    assert all(any(line == s for s in kept) for line in src.splitlines())  # in order
    if kernel == "J":  # five phases a role, each role's totals written once
        assert phases == kernel_phases.J_PHASES and stamped.count("ph_acc[") == 14
        assert stride == kernel_phases.J_STRIDE and version in kernel_phases.RAW
    if kernel == "K":
        assert phases == kernel_phases.K_PHASES and stride == kernel_phases.K_STRIDE
        assert stamped.count("STAMP(blockIdx.x * 10 + ") == 3


def test_dry_run_of_the_pipeline_stage_group(monkeypatch, tmp_path):
    """Group P: the decoder stage over the flagship utterance as the plain
    frame loop and as kernel P's calls, both semirings, in turns (plain,
    kernel, kernel, plain), and the walk against its plain loop, each
    first held to the other."""
    out = tmp_path / "rows.jsonl"
    monkeypatch.setattr(sys, "argv", ["kernel_timing.py", "--device", "cpu", "--kernels", "P",
                                      "--reps", "1", "--out", str(out)])
    assert kernel_timing.main() == 0
    rows = [json.loads(line) for line in out.read_text().splitlines() if '"kernel"' in line]
    stage = [(r["what"].split()[3].rstrip(","), r["turn"], r["version"]) for r in rows
             if "decoder stage" in r["what"]]
    assert stage == [(s, turn, v) for s in ("max", "log")
                     for turn, order in ((1, ("plain frame loop", "kernel P")),
                                         (2, ("kernel P", "plain frame loop")))
                     for v in order]
    assert "T=999 in 9 chunks of 111, N=5, float64" in rows[0]["what"]
    walks = [(r["turn"], r["version"]) for r in rows if r["what"] == "P walk T=999 N=5"]
    assert walks == [(1, "plain host loop"), (1, "walk kernel"), (2, "walk kernel"),
                     (2, "plain host loop")]
    assert sum("back-to-back" in r["what"] for r in rows) == 1
