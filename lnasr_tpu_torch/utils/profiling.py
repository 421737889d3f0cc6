"""Profiling hooks on ``torch.profiler``.

The port of the JAX package's ``utils/profiling.py``, which wraps
``jax.profiler``: named trace scopes around kernels, a context manager
that captures a trace Perfetto reads, and a host wall timer that waits
for the device before it reads the clock.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Iterator, Optional

import torch
from torch.profiler import ProfilerActivity, profile, record_function


@contextlib.contextmanager
def device_trace(log_dir: str, cuda: Optional[bool] = None) -> Iterator[profile]:
    """Capture a profile into ``log_dir/trace.json`` (Chrome trace format,
    which Perfetto and TensorBoard read): host activity always, and CUDA
    activity when ``cuda`` is true (default: when a card is present).
    Yields the running ``torch.profiler.profile``."""
    if cuda is None:
        cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str) -> record_function:
    """Named scope that shows up in profiler timelines; usable as a
    decorator or context manager (``torch.profiler.record_function``)."""
    return record_function(name)


@contextlib.contextmanager
def wall_timer(label: str, results: Optional[dict] = None, device=None) -> Iterator[None]:
    """Host-side wall timing that waits for the device at exit: on a CUDA
    ``device`` (default: the current card, when there is one) it
    synchronizes before it reads the clock, so asynchronous launches do
    not make the block look fast. Seconds accumulate in
    ``results[label]``."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    sync = torch.device(device).type == "cuda"
    start = time.perf_counter()
    try:
        yield
    finally:
        if sync:
            torch.cuda.synchronize(device)
        elapsed = time.perf_counter() - start
        if results is not None:
            results[label] = results.get(label, 0.0) + elapsed
