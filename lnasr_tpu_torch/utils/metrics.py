"""Evaluation metrics: edit distance, word error rate.

The port's own copy of the JAX package's ``utils/metrics.py`` (NumPy only).

The reference has no scoring harness at all; BASELINE.md's acceptance bar
is WER-matching decodes, so WER is a first-class utility here.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np


def edit_distance(ref: Sequence, hyp: Sequence) -> Tuple[int, Dict[str, int]]:
    """Levenshtein distance with operation counts
    (substitutions/insertions/deletions)."""
    n, m = len(ref), len(hyp)
    dist = np.zeros((n + 1, m + 1), dtype=np.int64)
    dist[:, 0] = np.arange(n + 1)
    dist[0, :] = np.arange(m + 1)
    for i in range(1, n + 1):
        for j in range(1, m + 1):
            sub = dist[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1])
            dist[i, j] = min(sub, dist[i - 1, j] + 1, dist[i, j - 1] + 1)

    # backtrace for op counts
    i, j = n, m
    ops = {"sub": 0, "ins": 0, "del": 0, "hit": 0}
    while i > 0 or j > 0:
        if i > 0 and j > 0 and dist[i, j] == dist[i - 1, j - 1] + (ref[i - 1] != hyp[j - 1]):
            ops["hit" if ref[i - 1] == hyp[j - 1] else "sub"] += 1
            i, j = i - 1, j - 1
        elif j > 0 and dist[i, j] == dist[i, j - 1] + 1:
            ops["ins"] += 1
            j -= 1
        else:
            ops["del"] += 1
            i -= 1
    return int(dist[n, m]), ops


def wer(ref: Sequence, hyp: Sequence) -> float:
    """Word error rate: (S + I + D) / len(ref)."""
    if len(ref) == 0:
        return 0.0 if len(hyp) == 0 else float("inf")
    dist, _ = edit_distance(ref, hyp)
    return dist / len(ref)


def wer_details(ref: Sequence, hyp: Sequence) -> Dict[str, float]:
    """WER plus its operation breakdown, for scoring reports."""
    dist, ops = edit_distance(ref, hyp)
    n_ref = len(ref)
    rate = (dist / n_ref) if n_ref else (0.0 if not len(hyp) else float("inf"))
    return {"wer": rate, "sub": ops["sub"], "ins": ops["ins"],
            "del": ops["del"], "hit": ops["hit"], "n_ref": n_ref}


def cer(ref: str, hyp: str) -> float:
    """Character error rate (for the Chinese segmentation/recognition path)."""
    return wer(list(ref), list(hyp))
