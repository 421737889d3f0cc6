"""The port's bench harnesses, run as ``python -m lnasr_tpu_torch.bench.<name>``:

- :mod:`.headline`: the flagship step (audio-seconds per second) with its
  stages and the recognizer's serving segments (``cli bench`` runs it);
- :mod:`.train`: one Baum-Welch sweep at the flagship geometry;
- :mod:`.corpus`: corpus-scale LM estimation and a 1,000-word decode;
- :mod:`.decoder`: the word-graph decoders and kernels against their scans;
- :mod:`.scaling`: data- and model-parallel EM and the sharded decode over
  ``torch.distributed`` ranks;
- :mod:`.stream`: per-segment latency and real-time factor of the
  streaming recognizer on a looped speech recording (``--recording``);
- :mod:`.wer`: the connected-word WER of protocol v2 on speech recordings
  (``--fixtures``), gated against earlier reports (``--history``).

Each prints JSON lines and writes a file only when given ``--out``; the
recordings are arguments, with no default path. Times
are medians after a warm-up: CUDA events on the card, the host clock on
the CPU. Speed-of-light accounting divides each stage's operations by the
card's fp32 peak and its bytes (each input read once, each output written
once) by its memory rate; TF32 stays off (see :mod:`lnasr_tpu_torch`), so
every GEMM is fp32 and the tensor cores' reduced-precision peaks do not
apply. This module holds the helpers they share.
"""

from __future__ import annotations

import subprocess
import time
from typing import Callable, List, Optional, Tuple

import torch

from lnasr_tpu_torch.entry import MODEL_CONFIG, TRAIN_BATCH, TRAIN_SECONDS

# The flagship geometry every harness times: entry's model (5 states x 8
# mixtures x 39 dims) over its training batch (64 utterances of 10 s).
N_STATES, N_MIX, DIM = MODEL_CONFIG.n_states, MODEL_CONFIG.n_mix, MODEL_CONFIG.dim
BATCH, UTT_SECONDS = TRAIN_BATCH, float(TRAIN_SECONDS)

# The H100 SXM's public peaks, the one card the port targets: fp32 FLOP/s
# outside the tensor cores and HBM3 bytes/s.
H100_PEAKS = (67e12, 3.35e12)


def device_peaks(device) -> Optional[Tuple[float, float]]:
    """``(fp32 FLOP/s, bytes/s)`` of ``device``'s card: :data:`H100_PEAKS`
    on an H100, ``None`` on the CPU. Any other card raises: its peaks are
    not known here, and a bound taken from the H100's would be wrong."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return None
    name = torch.cuda.get_device_name(dev)
    if "h100" not in name.lower():
        raise ValueError(f"speed-of-light peaks are known for the H100 only, not for {name!r}")
    return H100_PEAKS


def describe_device(device) -> str:
    """The card's name and power limit as ``nvidia-smi`` reports them (its
    name alone where ``nvidia-smi`` cannot be run), or ``"cpu"``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        out = subprocess.run(["nvidia-smi", f"--id={index}", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60, check=True)
        return out.stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return torch.cuda.get_device_name(dev)


def synchronize(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def time_calls(fn: Callable, device, trials: int, reps: int = 1, warmup: int = 1) -> List[float]:
    """Seconds per call of ``fn()``, one value a trial: each trial times
    ``reps`` calls in a row, after ``warmup`` untimed calls. CUDA events on
    a CUDA device (so a trial counts the device's work to its end), the
    host clock around a final synchronization elsewhere."""
    cuda = torch.device(device).type == "cuda"
    for _ in range(warmup):
        fn()
    synchronize(device)
    out = []
    for _ in range(trials):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(reps):
                fn()
            end.record()
            end.synchronize()
            out.append(start.elapsed_time(end) / 1e3 / reps)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            out.append((time.perf_counter() - t0) / reps)
    return out


def speed_of_light(flops: float, n_bytes: float, seconds: float, peaks) -> dict:
    """Achieved rates of a stage that does ``flops`` fp32 operations and
    must move ``n_bytes`` in ``seconds``, and, with the card's ``peaks``,
    its bound (the larger of the two times), what sets it and the share of
    the bound the measurement reached."""
    out = {"flops": flops, "bytes": n_bytes, "seconds_per_call": seconds,
           "achieved_gflops": flops / seconds / 1e9, "achieved_gbps": n_bytes / seconds / 1e9}
    if peaks is not None:
        t_ops, t_bytes = flops / peaks[0], n_bytes / peaks[1]
        out["bound_s"] = max(t_ops, t_bytes)
        out["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        out["pct_of_bound"] = 100.0 * out["bound_s"] / seconds
    return out


def rounded(d: dict, digits: int = 6) -> dict:
    """``d`` with its float values rounded (lists and dicts left alone)."""
    return {k: (round(v, digits) if isinstance(v, float) else v) for k, v in d.items()}
