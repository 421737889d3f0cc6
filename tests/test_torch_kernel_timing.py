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
