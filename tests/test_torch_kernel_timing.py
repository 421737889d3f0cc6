"""``kernel_timing.py``'s dry run on the CPU (``--device cpu``: the plain
versions, the host clock) over the groups that read the flagship batch
(A and B), at a cut batch: the script's calls into ``chip_smoke.py`` and
into the port keep their signatures (it once passed ``make_signals`` two
of its three arguments, and every group that reads the batch failed)."""

import json
import sys

import chip_smoke
import kernel_timing


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
