"""Structured metrics logging.

The port's own copy of the JAX package's ``utils/logging.py`` (standard
library only).

The reference's only observability is ad-hoc ``print`` of per-iteration
log-likelihoods (``lnasr/hmm.py:306-311``). Here: a tiny structured
metrics writer — one JSON object per step to a file and/or stderr — so
training/decoding jobs emit machine-readable logL, WER, audio-seconds/s,
and timing series without dragging in a heavyweight dependency.
"""

from __future__ import annotations

import json
import sys
import time
from typing import Any, Dict, IO, Optional


class MetricsLogger:
    """Append-only JSONL metrics stream.

    >>> log = MetricsLogger(stdout=True)
    >>> log.write("em_step", iteration=3, loglik=-1234.5)
    """

    def __init__(self, path: Optional[str] = None, stdout: bool = False):
        self._fp: Optional[IO[str]] = open(path, "a", encoding="utf-8") if path else None
        self._stdout = stdout
        self._start = time.time()

    def write(self, event: str, **metrics: Any) -> Dict[str, Any]:
        record = {"event": event, "t": round(time.time() - self._start, 4), **metrics}
        line = json.dumps(record, default=float)
        if self._fp is not None:
            self._fp.write(line + "\n")
            self._fp.flush()
        if self._stdout:
            print(line, file=sys.stderr)
        return record

    def close(self) -> None:
        if self._fp is not None:
            self._fp.close()
            self._fp = None

    def __enter__(self) -> "MetricsLogger":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class Stopwatch:
    """Wall-clock timing of named phases; pairs with MetricsLogger."""

    def __init__(self):
        self.times: Dict[str, float] = {}
        self._open: Dict[str, float] = {}

    def start(self, name: str) -> None:
        self._open[name] = time.perf_counter()

    def stop(self, name: str) -> float:
        elapsed = time.perf_counter() - self._open.pop(name)
        self.times[name] = self.times.get(name, 0.0) + elapsed
        return elapsed
