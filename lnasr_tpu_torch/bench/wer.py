"""Accuracy harness: the connected-word WER of protocol v2 on speech
recordings, gated against earlier reports.

    python -m lnasr_tpu_torch.bench.wer --fixtures A.raw B.raw \\
        [--history DIR] [--out FILE] [--device cpu]

The port of the JAX package's ``bench_wer.py``. It runs the file-bound
flow of :mod:`lnasr_tpu_torch.examples.real_audio_demo` (``main``: the
CLI's ``train-am``, ``lm-train`` and ``recognize`` in subprocesses, the
conditions decoded in process) on the recordings ``--fixtures`` and gates
the report:

- FAIL when the CLI hypothesis differs from the in-process one under the
  same configuration (``cli_check.match``);
- with earlier reports of the same protocol in ``--history``: FAIL when
  the clean WER is more than +0.02 above the best of them, or the 10 dB
  WER more than +0.10 above its best;
- otherwise (no comparable report) FAIL above the bring-up bar, a clean
  WER of 0.25.

Two differences from the JAX script:

- Files. The recordings are arguments, with no default path. Earlier
  reports are read only from ``--history`` (every ``*.json`` there that
  holds a report), and the report is written only to ``--out``; without
  it the report is printed to stdout as one JSON line (with ``--out``,
  the one line is the JAX script's summary). The demo's own lines go to
  stderr. No file is written beside the repository and no round number
  is inferred from its files.
- Device. ``--device`` defaults to the card (``cuda``, raising without
  one). The JAX script pins JAX to the CPU so that the recorded WER moves
  only with the code; here the decoders are bitwise equal to their plain
  CPU versions and ``chip_smoke.py`` holds the card's hypotheses word for
  word against a CPU decode of the same model, so the card is no source
  of drift either.
"""

from __future__ import annotations

import argparse
import contextlib
import glob
import json
import os
import sys
from typing import Optional, Tuple

CLEAN_TOL = 0.02  # allowed clean-WER regression against the best so far
NOISY_TOL = 0.10  # allowed 10 dB-WER regression against its best so far
BRINGUP_BAR = 0.25  # absolute clean bar when no comparable report exists


def best_previous(history: Optional[str], protocol_version: int
                  ) -> Optional[Tuple[float, float]]:
    """Best-so-far ``(clean, snr10)`` WER over the reports in the directory
    ``history`` with ``protocol_version``: the ratchet's base. ``None``
    without a directory or a comparable report."""
    if history is None:
        return None
    best_clean = best_noisy = None
    for p in sorted(glob.glob(os.path.join(history, "*.json"))):
        with open(p, encoding="utf-8") as fp:
            rep = json.load(fp)
        if not isinstance(rep, dict) or rep.get("protocol_version") != protocol_version:
            continue
        c = rep["conditions"]["clean"]["wer"]
        n = rep["conditions"]["snr10"]["wer"]
        best_clean = c if best_clean is None else min(best_clean, c)
        best_noisy = n if best_noisy is None else min(best_noisy, n)
    if best_clean is None:
        return None
    return best_clean, best_noisy


def gate(report: dict, best) -> Tuple[bool, str]:
    """``(pass, why)`` of ``report`` against ``best`` (:func:`best_previous`)."""
    clean = report["conditions"]["clean"]["wer"]
    noisy = report["conditions"]["snr10"]["wer"]
    cli = report.get("cli_check", {})
    if "match" in cli and not cli["match"]:
        return False, (f"CLI hypothesis diverges from the in-process decode "
                       f"under the same configuration: CLI {cli['hyp']!r} "
                       f"vs in-process {cli['inprocess_hyp']!r}")
    if best is not None:
        bc, bn = best
        if clean > bc + CLEAN_TOL:
            return False, (f"clean WER regressed past the ratchet: "
                           f"{clean:.3f} > best-so-far {bc:.3f} + {CLEAN_TOL}")
        if noisy > bn + NOISY_TOL:
            return False, (f"10 dB WER regressed past the ratchet: "
                           f"{noisy:.3f} > best-so-far {bn:.3f} + {NOISY_TOL}")
        return True, (f"clean {clean:.3f} (best-so-far {bc:.3f}), "
                      f"10 dB {noisy:.3f} (best-so-far {bn:.3f}); "
                      f"CLI matches in-process")
    if clean > BRINGUP_BAR:
        return False, f"clean WER {clean:.3f} > bring-up bar {BRINGUP_BAR}"
    return True, f"clean {clean:.3f} <= bring-up bar {BRINGUP_BAR} (no comparable previous round)"


def main(argv=None) -> int:
    from lnasr_tpu_torch.cli import DEVICES
    from lnasr_tpu_torch.examples import real_audio_demo

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fixtures", nargs="+", required=True, metavar="PATH",
                    help="the speech recordings, raw 16 kHz 16-bit PCM")
    ap.add_argument("--history", default=None, metavar="DIR",
                    help="directory of earlier reports to ratchet against")
    ap.add_argument("--out", default=None, help="write the report here")
    ap.add_argument("--device", choices=DEVICES, default="cuda")
    args = ap.parse_args(argv)

    with contextlib.redirect_stdout(sys.stderr):
        real_audio_demo.main(fixtures=args.fixtures, device=args.device)
    report = dict(real_audio_demo.main.last_report)
    report["metric"] = ("WER (recorded-speech connected-word e2e, fixed seed; "
                        "clean / 20 dB / 10 dB SNR / reverb)")
    report["value"] = report["wer"]
    ok, why = gate(report, best_previous(args.history, report["protocol_version"]))
    report["gate"] = {"pass": ok, "detail": why, "ratchet": "best-so-far",
                      "clean_tol": CLEAN_TOL, "noisy_tol": NOISY_TOL,
                      "bringup_bar": BRINGUP_BAR}
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fp:
            json.dump(report, fp, indent=1)
        print(json.dumps({
            "metric": report["metric"], "value": report["wer"], "unit": "WER",
            "conditions": {k: v["wer"] for k, v in report["conditions"].items()},
            "n_ref_words": report["n_ref_words"], "gate": report["gate"],
        }))
    else:
        print(json.dumps(report))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
