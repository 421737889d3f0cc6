#!/usr/bin/env python3
"""Drive the PyTorch port of lnasr_tpu on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``lnasr_tpu_torch/csrc`` (one
``nvcc`` per source, all at once) and holds each kernel against its plain
PyTorch version at the serving shapes (the mel frontend also on a signal
too short for one frame: empty outputs and no launch; the trigram
decode's forward and backtrace and the WebRTC VAD's GMM in their phases
below; the Baum-Welch
forward-backward kernel G at float64 within 1e-12 and at float32 within
2x the plain loops' distance from float64, on every route, N = 3 to 1100,
two launches bitwise; the Viterbi kernels bitwise: the
dense-graph kernel on sparse and dense graphs of 33 to 2000 states, ties
across the lanes that split one source list, and batches with masks; the
factored forward and the lattice-recording forward also over 60
back-to-back launches; the replay backtrace also on a planted path of 21
words with masks at its windows' edges, for every hop kind). Then
it drives the port's main paths through their entry points, each with the
kernels' launch counters reset just before and read just after:

- the flagship serving step (B=64 utterances of 10 s -> MFCC -> GMM
  emissions -> small-N Viterbi), ``entry.flagship``;
- the recognizer's bucketed 1-best segment decode at V = 1000 (factored
  word graph with a dense hop: mel frontend, forward and backtrace
  kernels) and V = 22 (179-state dense graph: mel frontend and dense-graph
  Viterbi kernels), ``entry.recognizer_serving(...).decode_segment``;
- the recognizer's bucketed N-best segment decode at V = 1000 (mel
  frontend and lattice-recording kernels, then the host's word lattice),
  ``entry.recognizer_serving(1000)[0].decode_segment_nbest``;
- the exact backoff search at V = 5000, ``backoff_phase``: the forward,
  backtrace and lattice kernels with the backoff hop (rank-1 plus the
  sparse seen-bigram arcs, in CSR) bitwise against their plain versions,
  each launched twice, on the 5000-word serving segment, on
  ``bench/decoder``'s 5k and 10k graphs and on small graphs with planted
  ties, no silence word, rows without arcs, all-``-inf`` starts, masked
  frames (the last one too) and T = 1; then
  ``entry.recognizer_serving(5000)``'s ``decode_segment`` (mel frontend,
  forward and backtrace once each) and ``decode_segment_nbest`` (mel
  frontend and lattice once each) with a spy on the scans (never
  called), against the CPU recognizer and a planted word sequence;
- the factored graph's batched decodes, ``batch_phase``: kernels D, E
  and F once a batch (a launch decodes B utterances), at V = 1000 (dense
  hop) and V = 5000 (backoff hop) on ``entry.parallel_serving``'s 8 ragged
  segments, bitwise against 8 single launches and the batched plain
  versions, also with masks that differ by utterance at every kind of
  frame; ``decode_batch_arrays`` (D and E once) against looping
  ``decode_arrays`` and the CPU's batched plain decode,
  ``decode_lattice_batch`` at V = 1000 (F once) against looping
  ``decode_lattice``, a 64-row V = 5000 batch cut into launches by
  ``ops.factored.cut_batch``; the batched launches timed against their
  single launches and ``decode_batch`` against looping ``decode``;
- live serving at V = 1000, ``entry.streaming_serving(1000)``: a ~60 s
  stream in 100 ms chunks through ``StreamingRecognizer`` (the native
  VAD, built with ``g++``, closes segments; each segment launches the mel
  frontend, forward and backtrace kernels once), against the CPU stream,
  with a ``reset()`` replay and ``Recognizer.recognize_segments``;
- the exact trigram graph at V = 200, ``entry.recognizer_serving(200,
  graph="trigram", lm_order=3)``: the trigram kernel's forward and
  backtrace held bitwise against their plain frame loops (the segment's
  inputs at float32 and float64, planted ties, masks, T = 1 and 2, every
  route that takes each), then its segment decode launches the mel
  frontend, the trigram forward (on its resident route, by the route's own
  counter) and the trigram backtrace once each;
- the trigram graph's batch, ``trigram_batch_phase``, at
  ``entry.parallel_serving(200, 8, graph="trigram", lm_order=3)``'s 8
  ragged bucketed segments (two rows planted with 6 words each): the
  batched trigram forward and backtrace, one launch each on every route
  that takes the batch (float32 resident, ``smem`` and global; float64
  ``smem`` in the pieces of ``ops.trigram.trigram_cut`` and global),
  bitwise equal to the 8 single launches and to the batched plain
  versions on the card, on the batch's masks and on masks that differ at
  every kind of frame; the batch's features (the mel frontend once) and
  ``decode_batch_arrays`` launch the mel frontend, the forward (resident
  route) and the backtrace once each, bitwise equal to looping
  ``decode_arrays`` and to the batched plain decode, the planted rows
  decoding to their words; a 24-row batch, cut into 2 launches of 12 by
  the 8 GiB backpointer budget, equal to the loop;
- the device VADs on the stream's audio (LTSD fixed and adaptive, whose
  noise recursion is one launch of its kernel a call; the WebRTC-style
  torch VAD in modes 0-3, whose GMM recursion is one launch of its kernel
  a call; modes 1-3 on the stream's first 10 s) against their CPU runs,
  the plain loops on the card and the
  native detector, the LTSD kernel bit for bit at float32 and float64 on
  the stream, a batch, a silent start and no valid frame, the GMM kernel
  also at the edges of its ring of stages and on runs of frames without
  power;
- the Viterbi trellis behind every HMM decode, ``trellis_phase``: its
  kernel bit for bit against the plain loop (scores, backpointers, path,
  score) on both routes, masks, ties, ``-inf``, T = 1 and N = 1 to 1024,
  float32 and float64; then ``GMMHMM.decode_batch`` at B = 64 x 10 s with
  ragged masks (the kernel once) against the plain loop and the CPU;
- the streaming pipeline's decoder stage, ``stage_phase``: kernel P
  (one launch an arrived chunk) bit for bit against its plain frame loop
  in the max-plus semiring (alpha and pointers) and within G's bars in the
  log semiring, N = 1 to 1024, chunks of 1, 111 and 1000, row 0 at frame
  0 and later, float32 and float64, ties and ``-inf``; the walk bit for
  bit against its plain host loop up to T = 100,000; both timed at the
  pipeline's geometry (the pipelines themselves run in ``parallel/``
  below, where their launches are counted);
- training, ``entry.training()``: B=64 utterances of 10 s -> MFCC (mel
  frontend once) -> Baum-Welch sweeps of the flagship GMM-HMM (kernel G
  once a sweep for the forward-backward recursion, torch GEMMs for the
  rest), float64 against the CPU and float32 against a float64 oracle,
  timed and split, G against its plain loops at the sweep's inputs; kill
  and resume bitwise (the GMM-HMM and a 65,536-symbol discrete HMM);
  ``entry.unit_training(22)`` (mel frontend once, G once a sweep) against
  the CPU, with a planted decode by the trained units (mel frontend,
  dense-graph Viterbi); the word segmenter against the CPU (the trellis
  kernel once a sentence, at float64);
- ``parallel/`` on one world of 4 ranks spawned on the card (gloo; the
  kernels built here first): data-parallel EM on the flagship batch (16
  utterances a rank, the mel frontend once on each rank's signals, G once
  a sweep on every rank) and mixture-sharded EM (G once a sweep on every
  rank) against the single-process sweep, kill and resume
  bitwise; the time-sharded forward, backward, Viterbi and EM on the
  stream's features against the scans; ``parallel.decode_batch_sharded``
  at V = 1000 (8 segments, two planted; the mel frontend, the forward
  and backtrace kernels once on every rank, for its two rows) bitwise equal to
  ``decode_batch``; the 2- and 4-stage pipelines (kernel P once a chunk
  on the decoder rank, the walk once a decode on every rank); then one sweep on a
  world of one under NCCL. Several ranks on one card show correctness
  and overhead, not scaling;
- the command line (``lnasr_tpu_torch.cli``), ``cli_phase``: ``mfcc``
  (mel frontend once) against ``--device cpu``; ``lm-train``, ``lm-ppl``
  and ``vad`` against the port's objects; ``train-am --f64`` and
  ``recognize`` through ``build_parser()`` and the cores with the models in
  memory, card against CPU, ``recognize`` in five forms (default graph:
  mel frontend and dense-graph Viterbi; ``--graph factored``: mel
  frontend, forward and backtrace; ``--nbest 3 --confidence``: mel
  frontend and lattice; ``--bucket-frames 16``; ``--graph trigram`` over
  an order-3 LM: mel frontend and the trigram kernels); ``cli bench`` (the
  headline harness: mel frontend, small-N Viterbi, forward, backtrace and
  lattice kernels), ``bench/train`` and ``bench/decoder`` reduced; and
  ``examples/multihost_train`` as a world of one under NCCL; every kernel
  call these paths make through the MFCC pipeline and the decoders is
  held, at each distinct shape, against its plain version on the path's
  own inputs;
- the recording harnesses, ``recording_phase``, on the seeded stand-in
  for the reference's two speech recordings (``entry.recording_pair``,
  written as raw PCM into a temporary directory): ``bench/stream.py`` for
  one minute of stream (mel frontend and dense-graph Viterbi a segment;
  RTF and buffer bounds) and the core of ``examples/real_audio_demo.py``,
  the protocol ``bench/wer.py`` gates (20 utterances under 6 conditions:
  mel frontend and dense-graph Viterbi a segment, the lattice kernel for
  the N-best check; the CLI check must match), its units trained in
  float64 on the card against the CPU, and the card's float32 model
  decoded on the CPU to the same clean and 10 dB hypotheses; every kernel
  call of both held, at each distinct shape, against its plain version;

checks each against the plain CPU path on the same weights and input
(plus planted word sequences, decoded and lattice-searched), and times
each kernel, its plain version and the paths with CUDA events or the host
clock (medians after warm-up), with torch.profiler breakdowns.

Ends with a ``{"kernels": [...]}`` line, the card's name and power limit,
and ``{"ok": true, "device": {...}}`` as the last line. Any failed check
exits non-zero before those lines are printed. Needs a CUDA device and the
repository around it; without either it fails.
"""

import contextlib
import ctypes
import dataclasses
import importlib
import io
import json
import os
import statistics
import subprocess
import sys
import time
import types

import numpy as np

B, SECONDS, SR = 64, 10, 16000
VAD_MODE_SECONDS = 10  # WebRTC VAD modes 1-3 run on the stream's first 10 s (mode 0 on all of it)
S = SECONDS * SR
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_FLOPS = 67e12  # H100 SXM fp32 peak outside the tensor cores
FP64_FLOPS = 34e12  # H100 SXM fp64 peak outside the tensor cores


class CheckFailed(RuntimeError):
    pass


def require(cond, msg):
    if not cond:
        raise CheckFailed(msg)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def cuda_ms(fn, reps, warmup=3):
    """Median milliseconds of ``fn()`` on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


PROFILE_WINDOWS = 5  # torch.profiler windows tried before a reading is taken as it is


def profiled_device(torch, fn, calls=10, name=None):
    """``(ms, count, window)``: the device time per call of ``fn``, of the
    kernels whose name contains ``name`` or else of every kernel and memset
    it launches (torch.profiler over ``calls`` calls after one warm-up), how
    many such launches the profiler recorded, and in which window. On the
    H100 the profiler drops every device record of some sessions (PERF.md
    §7), so a window that recorded fewer than ``calls`` launches is
    profiled again, up to ``PROFILE_WINDOWS`` windows."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for window in range(1, PROFILE_WINDOWS + 1):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        hits = [e for e in prof.key_averages()
                if on_device(torch, e) and (name is None or name in e.key)]
        count = sum(e.count for e in hits)
        if count >= calls:
            break
    return sum(e.self_device_time_total for e in hits) / 1e3 / calls, count, window


def device_ms(torch, fn, calls=10):
    """Device milliseconds per call of ``fn``: the device time of the
    kernels and memsets it launches (:func:`profiled_device`), without the
    host time between them that CUDA events around a short wrapper call
    also catch."""
    return profiled_device(torch, fn, calls)[0]


def kernel_device_ms(torch, fn, name, calls=10):
    """``(ms, count, window)`` of :func:`profiled_device` for the kernels
    whose name contains ``name``."""
    return profiled_device(torch, fn, calls, name)


QUEUE_CYCLES = 20_000_000  # ~10 ms of a spinning kernel ahead of a burst


def burst_ms(fn, launches=20, reps=5, queued=True):
    """Milliseconds per call of ``fn`` over ``launches`` back-to-back calls
    between two CUDA events (median of ``reps``). ``queued``: a spinning
    kernel (``torch.cuda._sleep``) holds the card while the host queues the
    burst, so the events time the kernels back to back, the device's time;
    else the events also catch the host's time to launch a kernel shorter
    than that."""
    import torch

    def burst():
        for _ in range(launches):
            fn()
    burst()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if queued:
            torch.cuda._sleep(QUEUE_CYCLES)
        start.record()
        burst()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times) / launches


def device_breakdown(torch, fn, step_ms, card, steps=5):
    """Print device time per step by kernel (torch.profiler over ``steps``
    calls) and the device's busy share of the event-timed step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3 / steps, e.count // steps, e.key)
                   for e in prof.key_averages() if on_device(torch, e)), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"step breakdown on {card} (torch.profiler, {steps} steps): device busy {busy:.4f} ms "
          f"of {step_ms:.4f} ms per step ({100 * busy / step_ms:.1f}%), {len(rows)} kernel kinds")
    for ms, count, name in rows[:10]:
        print(f"  {ms:.4f} ms  x{count}  {name[:90]}")
    host = sorted(((e.self_cpu_time_total / 1e3 / steps, e.count // steps, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU), reverse=True)
    print(f"  host side: {sum(r[0] for r in host):.4f} ms of profiled op self time per step "
          f"(profiler overhead included), {sum(r[1] for r in host)} ops; the largest:")
    for ms, count, name in host[:6]:
        print(f"  {ms:.4f} ms  x{count}  {name[:90]}")


def on_device(torch, e):
    """A profiler entry of device work (a kernel or a copy), not the device
    side of a ``record_function`` range, which spans its idle time too."""
    return (e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False))


def bound(n_bytes, n_ops, flops=FP32_FLOPS):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / flops * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def reset_counts(*wrappers):
    for w in wrappers:
        w.launches = 0


def host_ms(fn, reps, warmup=2):
    """Median wall milliseconds of ``fn()``, which ends in a device->host copy."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def make_signals(torch, entry, device):
    """The flagship batch: the training path's seeded speech-like noise
    (amplitude-modulated, never digital silence), B x S."""
    return torch.as_tensor(entry.training_signals(B, SECONDS), device=device)


def model(rng, n, kind):
    """A Viterbi check graph ``(log_pi, log_a)``: random, all-tied, or
    left-to-right with -inf off the band."""
    if kind == "ties":
        return np.zeros(n, np.float32), np.zeros((n, n), np.float32)
    if kind == "left_to_right":
        with np.errstate(divide="ignore"):
            a = np.log(np.eye(n) * 0.6 + np.eye(n, k=1) * 0.4)
        a[-1, -1] = 0.0
        pi = np.full(n, -np.inf)
        pi[0] = 0.0
        return pi.astype(np.float32), a.astype(np.float32)
    return (np.log(rng.dirichlet(np.ones(n))).astype(np.float32),
            np.log(rng.dirichlet(np.ones(n), size=n)).astype(np.float32))


def check_a_shape(torch, mf, sig, cfg, lens, where, got=None):
    """Kernel A against its plain version on ``sig`` (with ``lens``): mel
    energies and frame energy within ``2e-6 * max_energy + 1e-4 * |ref|``,
    the feature masks equal, features within 0.01. ``got`` is the kernel's
    ``(mel, energy)`` where a path already launched it on these inputs.
    Returns ``(mel max err, energy scale, features max err)``."""
    from lnasr_tpu_torch.models.mfcc import mfcc_features, mfcc_features_fused

    def within_bars(got, ref, what, scale):
        require(got.shape == ref.shape, f"kernel A {what} shape {tuple(got.shape)} ({where})")
        err = (got - ref).abs()
        require(bool((err <= 2e-6 * scale + 1e-4 * ref.abs()).all()),
                f"kernel A {what} off the bar ({where}): max err {float(err.max())}, "
                f"scale {scale}")
        return float(err.max())

    mel_k, en_k = mf.mel_frontend(sig, cfg, lengths=lens) if got is None else got
    mel_p, en_p = mf.mel_frontend_plain(mf.preemphasize(sig, cfg, lens), cfg)
    torch.cuda.synchronize()
    scale = float(en_p.max())
    mel_err = within_bars(mel_k, mel_p, "mel", scale)
    within_bars(en_k, en_p, "energy", scale)
    feats_k, mask_k = mfcc_features_fused(sig, cfg, lengths=lens)
    ref = mfcc_features(sig, cfg, lens)
    require(torch.equal(mask_k, ref.mask), f"kernel A feature masks differ ({where})")
    ferr = float(((feats_k - ref.features).abs() * ref.mask[..., None]).max())
    require(ferr < 0.01, f"kernel A features off by {ferr} ({where})")
    return mel_err, scale, ferr


def a_route(mf, sig, cfg):
    """Kernel A's route at this shape: the warp FFT with its frames a
    block, or the block-wide FFT."""
    from lnasr_tpu_torch.ops.framing import num_frames

    if not mf.fft_plan(cfg.fft_n):
        return "block-wide route"
    b, t = sig.shape[0], num_frames(sig.shape[1], cfg.frame_len, cfg.frame_step)
    return f"warp route, {mf.frames_per_block(b, t, mf.sm_count(sig.device))} frames a block"


def check_mel_frontend(torch, mf, cfg, x, dev):
    """Kernel A against its plain version (:func:`check_a_shape`) at the
    serving geometry (with and without lengths), at the segment's shape,
    and at other geometries: both routes of the kernel (the warp FFT at
    fft_n 256 to 2048, the block-wide FFT at 128 and 4096). Prints both
    fp32 paths' feature errors against a float64 oracle (the kernel's
    within 0.0057). Returns the largest mel error at the serving
    geometry."""
    from lnasr_tpu_torch.models.mfcc import cepstral_epilogue, mfcc_features, mfcc_features_fused

    lengths = torch.as_tensor(np.random.default_rng(1).integers(S // 2, S + 1, size=x.shape[0]),
                              device=dev)
    lengths[0] = S
    mel_err = 0.0
    for lens in (None, lengths):
        where = (f"{'variable lengths' if lens is not None else 'full length'}, "
                 f"{a_route(mf, x, cfg)}")
        err, scale, ferr = check_a_shape(torch, mf, x, cfg, lens, where)
        mel_err = max(mel_err, err)
        print(f"kernel A vs plain ({where}): mel max err {err:.6g} of energy scale {scale:.6g} "
              f"(bar 2e-6*scale + 1e-4*|ref|), features max err {ferr:.3g} (bar 0.01): ok")
    # which side is nearer the truth: both fp32 paths against the plain chain in float64
    mel64, en64 = mf.mel_frontend_plain(mf.preemphasize(x, cfg).double(), cfg)
    all_frames = torch.ones(mel64.shape[:2], dtype=torch.bool, device=dev)
    f64 = cepstral_epilogue(mel64, en64, all_frames, cfg, torch.float64, False)[1]
    k_err = float((mfcc_features_fused(x, cfg)[0].double() - f64).abs().max())
    p_err = float((mfcc_features(x, cfg).features.double() - f64).abs().max())
    print(f"features vs a float64 oracle: kernel path max err {k_err:.3g}, "
          f"plain fp32 path max err {p_err:.3g}")
    # the block-wide float32 FFT of the first port sat 0.0057 from the
    # oracle on these signals; no kernel may drift farther
    require(k_err <= 0.0057, f"kernel A features {k_err} from the float64 oracle (bar 0.0057)")
    # the segment's shape (one utterance of 511 frames: four frames a block)
    # and other geometries: any n_mels, other frame lengths and FFT sizes
    seg_len = 510 * cfg.frame_step + cfg.frame_len
    for sig, other in ((x[:1, :seg_len], cfg),
                       (x[:4, :SR], dataclasses.replace(cfg, frame_t=20e-3, n_mels=26)),
                       (x[:4, :SR], dataclasses.replace(cfg, fft_n=1024, n_mels=80)),
                       (x[:4, :SR], dataclasses.replace(cfg, frame_t=15e-3, fft_n=256)),
                       (x[:4, :SR], dataclasses.replace(cfg, fft_n=2048)),
                       (x[:4, :SR], dataclasses.replace(cfg, frame_t=8e-3, fft_n=128)),
                       (x[:4, :SR], dataclasses.replace(cfg, fft_n=4096))):
        where = (f"B={sig.shape[0]}, frame_len {other.frame_len}, fft_n {other.fft_n}, "
                 f"n_mels {other.n_mels}, {a_route(mf, sig, other)}")
        err, scale, ferr = check_a_shape(torch, mf, sig, other, None, where)
        print(f"kernel A vs plain ({where}): within the mel bar (max err {err:.6g} of scale "
              f"{scale:.6g}), features max err {ferr:.3g}")
    check_a_no_frame(torch, mf, cfg, x, dev)
    return mel_err


def check_a_no_frame(torch, mf, cfg, x, dev):
    """A signal of frame_len - frame_step samples has no frame: kernel A's
    wrapper and ``MFCC.features_fast`` (the serving path) return the plain
    version's empty shapes and launch nothing (no grid of zero blocks)."""
    from lnasr_tpu_torch.models.mfcc import MFCC

    short = x[:3, : cfg.frame_len - cfg.frame_step].contiguous()
    before = mf.mel_frontend.launches
    mel_k, en_k = mf.mel_frontend(short, cfg)
    mel_p, en_p = mf.mel_frontend_plain(mf.preemphasize(short, cfg), cfg)
    feats, mask = MFCC(cfg, device=dev).features_fast(short, lengths=[short.shape[1]] * 3)
    one, _ = MFCC(cfg, device=dev).features_fast(short[0])
    torch.cuda.synchronize()
    shapes = [tuple(t.shape) for t in (mel_k, en_k, mel_p, en_p, feats, mask, one)]
    require(shapes == [(3, 0, cfg.n_mels), (3, 0)] * 2 + [(3, 0, 39), (3, 0), (0, 39)]
            and mel_k.is_cuda and feats.is_cuda and mf.mel_frontend.launches == before,
            f"kernel A at {short.shape[1]} samples (no frame): shapes {shapes}, "
            f"{mf.mel_frontend.launches - before} launches")
    print(f"kernel A at {short.shape[1]} samples (no frame): the wrapper and features_fast give "
          f"the plain version's empty shapes {shapes[:2]}, {shapes[4:]}; no launch")


def check_viterbi_small(torch, vt, vd, dev, t_frames):
    """Kernel B against its plain scan, bitwise, on the card and on the
    CPU: the serving shape (random, ties, left-to-right), short utterances
    (T = 1, 2, 33) at N = 1, 8, 9, 16, 32, an all -inf column, and
    utterances past the shared-memory capacity (backpointers in device
    memory); then ``viterbi_batched`` above 32 states, which takes kernel C."""
    rng = np.random.default_rng(2)
    past5, past32 = vt.BP_SMEM_BYTES // 5 + 1, vt.BP_SMEM_BYTES // 32 + 7
    cases = [(5, B, t_frames, "random"), (32, 16, t_frames, "random"), (5, B, t_frames, "ties"),
             (5, B, t_frames, "left_to_right"), (5, 8, t_frames, "column")]
    cases += [(n, 4, t, kind) for t in (1, 2, 33) for n in (1, 8, 9, 16, 32)
              for kind in ("random", "ties")]
    cases += [(5, 2, past5, "ties"), (32, 3, past32, "random"), (9, 2, past32 * 4, "column")]
    routes = set()
    for n, b, t, kind in cases:
        log_pi, log_a = model(rng, n, "random" if kind == "column" else kind)
        if kind == "column" and n > 1:
            log_a[:, n // 2] = -np.inf
        lb = rng.normal(scale=3.0, size=(b, t, n)).astype(np.float32)
        if kind == "ties":
            lb = np.round(lb)
        args = [torch.as_tensor(v, device=dev) for v in (log_pi, log_a, lb)]
        path_k, score_k = vt.viterbi_small(*args)
        path_p, score_p = vt.viterbi_plain(*args)
        path_c, score_c = vt.viterbi_plain(*[a.cpu() for a in args])
        torch.cuda.synchronize()
        route = "shared memory" if vt.viterbi_smem_ok(t, n) else "device memory"
        routes.add(route)
        where = f"{kind}, B={b}, T={t}, N={n}, backpointers in {route}"
        require(torch.equal(path_k, path_p) and torch.equal(score_k, score_p),
                f"kernel B differs from the plain scan on the card ({where}): "
                f"{int((path_k != path_p).sum())} path entries")
        require(torch.equal(path_k.cpu(), path_c) and torch.equal(score_k.cpu(), score_c),
                f"kernel B differs from the plain scan on the CPU ({where})")
        print(f"kernel B vs plain ({where}): paths and scores bitwise equal")
    require(routes == {"shared memory", "device memory"}, f"kernel B routes run: {routes}")
    # viterbi_batched above 32 states takes kernel C
    log_pi, log_a = model(rng, 33, "random")
    lb = torch.as_tensor(rng.normal(scale=3.0, size=(16, t_frames, 33)).astype(np.float32),
                         device=dev)
    args = [torch.as_tensor(v, device=dev) for v in (log_pi, log_a)] + [lb]
    before = vd.viterbi_dense.launches
    path_k, score_k = vt.viterbi_batched(*args)
    path_p, score_p = vt.viterbi_plain(*args)
    torch.cuda.synchronize()
    require(vd.viterbi_dense.launches == before + 1,
            "viterbi_batched N=33 on CUDA did not launch the dense-graph kernel")
    require(torch.equal(path_k, path_p) and torch.equal(score_k, score_p),
            "viterbi_batched N=33 on CUDA differs from the plain scan")
    print(f"viterbi_batched (B=16, T={t_frames}, N=33) on CUDA: kernel C, bitwise equal to the "
          "plain scan")


# kernel G's checks: (N, kind, B, T, forced route or None); N = 5, 8, 3, 4
# as the EM paths run them on the warp route (forced: at T = 300 the
# chunked route is chosen), 13 and 32 on the warp route's 16- and 32-lane
# steps, 64 and 179 on the block routes (179 x 179 float64 goes through
# L2), 1100 past a block's 1024 threads, and N = 5 and 64 forced onto
# every block route; then the chunked route at N = 2, 5 and 8 (one lane an
# entry, two rows a lane), chosen at T = 300 and 2100 (chunks past two
# tiles, streamed twice), forced at T = 1, 31 and 33
FB_CASES = [(5, "random", 8, 300, "warp"), (8, "random", 8, 300, "warp"),
            (3, "left_to_right", 8, 300, "warp"), (4, "inf", 8, 300, "warp"),
            (13, "random", 4, 200, None), (32, "inf", 4, 200, None),
            (64, "random", 4, 200, None), (179, "left_to_right", 4, 200, None),
            (179, "inf", 4, 200, None), (1100, "random", 2, 12, None),
            (5, "inf", 4, 120, "smem"), (5, "random", 4, 120, "global"),
            (64, "inf", 4, 120, "l2"), (64, "left_to_right", 4, 120, "global"),
            (2, "inf", 4, 300, None), (5, "left_to_right", 8, 300, None),
            (8, "inf", 4, 300, None), (5, "inf", 4, 2100, None),
            (8, "left_to_right", 2, 2100, None), (2, "left_to_right", 4, 1, "chunked"),
            (5, "inf", 4, 1, "chunked"), (8, "inf", 4, 31, "chunked"),
            (2, "inf", 4, 33, "chunked"), (5, "left_to_right", 4, 31, "chunked"),
            (8, "left_to_right", 4, 33, "chunked")]


def fb_inputs(rng, n, t_len, b, kind):
    """Kernel G's check inputs, float64 NumPy ``(log_pi, log_a, log_b,
    mask)``: random, left-to-right (-inf off the band), or ``"inf"``: an
    unreachable state (an all--inf column of ``log_a``, -inf in
    ``log_pi``), a state with no way out (an all--inf row) and one frame
    of one utterance with every emission -inf. Ragged masks, one utterance
    of a single frame."""
    if kind == "left_to_right":
        with np.errstate(divide="ignore"):
            a = np.log(np.eye(n) * 0.6 + np.eye(n, k=1) * 0.4)
        a[-1, -1] = 0.0
        pi = np.full(n, -np.inf)
        pi[0] = 0.0
    else:
        a = np.log(rng.dirichlet(np.ones(n), size=n))
        pi = np.log(rng.dirichlet(np.ones(n)))
    log_b = rng.normal(scale=2.0, size=(b, t_len, n)) - 3.0
    if kind == "inf":
        a[:, n // 2] = -np.inf
        pi[n // 2] = -np.inf
        a[n - 1, :] = -np.inf
        log_b[-1, t_len // 3, :] = -np.inf
    lengths = rng.integers(t_len // 2, t_len + 1, size=b)
    lengths[0], lengths[1] = t_len, 1
    return pi, a, log_b, np.arange(t_len)[None, :] < lengths[:, None]


def fb_rel(torch, got, ref):
    """``(max, rms)`` of ``|got - ref| / max(|ref|, 1)`` over the finite
    entries of ``ref``; ``inf`` where the ``-inf`` patterns differ or a NaN
    appears."""
    got, ref = got.double().cpu(), ref.double().cpu()
    if not torch.equal(torch.isneginf(got), torch.isneginf(ref)) or bool(torch.isnan(got).any()):
        return np.inf, np.inf
    fin = torch.isfinite(ref)
    if not bool(fin.any()):
        return 0.0, 0.0
    e = (got[fin] - ref[fin]).abs() / ref[fin].abs().clamp(min=1.0)
    return float(e.max()), float(e.square().mean().sqrt())


def same_bits(torch, xs, ys):
    """Float tensors equal bit for bit (``-inf`` and signed zeros too)."""
    ints = {torch.float32: torch.int32, torch.float64: torch.int64}
    return all(torch.equal(x.view(ints[x.dtype]), y.view(ints[y.dtype])) for x, y in zip(xs, ys))


def check_fb_at(torch, tr, args, route=None):
    """Kernel G on ``args = (log_pi, log_a, log_b, mask)`` (CUDA tensors of
    one dtype; on ``route``, else the wrapper's own) against its plain loops
    on the same tensors: float64 within 1e-12 (max relative), the ``-inf``
    pattern identical; two launches bitwise equal, and so are
    ``forward_backward``, ``forward_scan`` and ``backward_scan``. Returns
    ``(G's outputs, the plain outputs, max rel err)``."""
    got = tr._launch(*args, 3, route=route)
    again = tr._launch(*args, 3, route=route)
    ref = (*tr.forward_scan_plain(*args), tr.backward_scan_plain(*args[1:]))
    if route is None:
        fwd, beta = tr.forward_backward(*args)
        one = tr.forward_scan(*args)
        same = (fwd.alpha, fwd.loglik, beta), (one.alpha, one.loglik, tr.backward_scan(*args[1:]))
    torch.cuda.synchronize()
    require(same_bits(torch, got, again), "kernel G: two launches on the same input differ")
    require(route is not None or all(same_bits(torch, got, x) for x in same),
            "kernel G: forward_backward, forward_scan and backward_scan differ")
    err = max(fb_rel(torch, g, r)[0] for g, r in zip(got, ref))
    if args[2].dtype == torch.float64:
        require(err <= 1e-12, f"kernel G differs from its plain loops by {err} at float64")
    return got, ref, err


def check_forward_backward(torch, tr, dev):
    """Kernel G against its plain loops over :data:`FB_CASES`: float64
    within 1e-12 with identical ``-inf`` patterns; float32 no farther from
    the float64 plain result than 2x the float32 plain loops are (RMS
    relative error over the finite entries: the largest single error is a
    few ulps in both, and its ratio swings by chance); two launches bitwise
    equal. On the chunked route also against its plain mirror
    (``forward_backward_chunked_plain``: the same chunks, products and
    replay) at float64 within 1e-12. Returns the largest float64 error."""
    worst, lines = 0.0, []
    for k, (n, kind, b, t_len, route) in enumerate(FB_CASES):
        pi, a, log_b, mask = fb_inputs(np.random.default_rng(70 + k), n, t_len, b, kind)
        m = torch.as_tensor(mask, device=dev)
        on = lambda x, dt: torch.as_tensor(x, dtype=dt, device=dev)  # noqa: E731
        args64 = tuple(on(x, torch.float64) for x in (pi, a, log_b)) + (m,)
        got64, ref64, e64 = check_fb_at(torch, tr, args64, route)
        got32, ref32, _ = check_fb_at(torch, tr, tuple(on(x, torch.float32)
                                                       for x in (pi, a, log_b)) + (m,), route)
        d_g = max(fb_rel(torch, g, r)[1] for g, r in zip(got32, ref64))
        d_p = max(fb_rel(torch, p, r)[1] for p, r in zip(ref32, ref64))
        require(d_g <= 2 * d_p, f"kernel G at float32 (N={n}, {kind}): {d_g} from the float64 "
                f"plain result, the float32 plain loops {d_p}")
        worst = max(worst, e64)
        where = route or "/".join(dict.fromkeys((tr.fb_route(n, 8), tr.fb_route(n, 4))))
        mirror = ""
        if where == "chunked":
            fwd, beta = tr.forward_backward_chunked_plain(*args64)
            e_m = max(fb_rel(torch, g, r)[0] for g, r in zip(got64, (fwd.alpha, fwd.loglik, beta)))
            require(e_m <= 1e-12, f"kernel G's chunked route (N={n}, {kind}, T={t_len}) differs "
                    f"from its plain mirror by {e_m} at float64")
            mirror = f", mirror {e_m:.3g}"
        lines.append(f"N={n} {kind} B={b} T={t_len} {where}: f64 {e64:.3g}{mirror}, "
                     f"f32 rms {d_g:.3g} (plain {d_p:.3g})")
    print("kernel G vs its plain loops (float64 bar 1e-12 max rel, -inf identical; float32 within "
          "2x the plain float32 loops' RMS distance from the float64 result; two launches and "
          "the one-direction wrappers bitwise; the chunked route also vs its plain mirror at "
          "float64, 1e-12): " + "; ".join(lines))
    return worst


def dense_cases(rng, n, t_len):
    """Kernel C's check inputs: ``(name, log_pi, log_a, log_b, mask,
    log_final)`` NumPy arrays: random dense graphs (one with a target no
    source reaches), all-tied ones, and left-to-right bands."""
    bucket = np.arange(t_len) < t_len - 37
    bucket[100] = False
    out = []
    for kind, masked in (("random", False), ("random", True), ("column", True), ("ties", True),
                         ("left_to_right", True)):
        log_pi, log_a = model(rng, n, "random" if kind == "column" else kind)
        if kind == "column":
            log_a[:, n // 2] = -np.inf
        lb = rng.normal(scale=3.0, size=(t_len, n)).astype(np.float32)
        if kind == "ties":
            lb = np.round(lb)
        fin = None
        if masked:
            fin = rng.normal(size=n).astype(np.float32)
            if kind == "left_to_right":
                fin[:-1] = -np.inf
        out.append((f"{kind}{', masked, log_final' if masked else ''}", log_pi, log_a, lb,
                    bucket if masked else None, fin))
    return out


def check_dense_viterbi(torch, vd, dev, rng, n, t_len):
    """Kernel C against its plain scan, bitwise, on the card and on the CPU."""
    for name, *arrays in dense_cases(rng, n, t_len):
        args = [None if x is None else torch.as_tensor(x, device=dev) for x in arrays]
        path_k, score_k = vd.viterbi_dense(*args)
        path_p, score_p = vd.viterbi_dense_plain(*args)
        path_c, score_c = vd.viterbi_dense_plain(*[None if x is None else x.cpu() for x in args])
        torch.cuda.synchronize()
        require(torch.equal(path_k, path_p) and torch.equal(score_k, score_p),
                f"kernel C differs from the plain scan on the card ({name}, N={n}): "
                f"{int((path_k != path_p).sum())} path entries, scores {float(score_k)} "
                f"vs {float(score_p)}")
        require(torch.equal(path_k.cpu(), path_c) and torch.equal(score_k.cpu(), score_c),
                f"kernel C differs from the plain scan on the CPU ({name}, N={n})")
        print(f"kernel C vs plain ({name}, T={t_len}, N={n}): paths and scores bitwise equal "
              f"(score {float(score_k)})")


def sparse_graph(rng, n, per_col):
    """A random graph ``(log_pi, log_a)`` whose every target has
    ``per_col`` finite sources (log-probabilities) and -inf elsewhere."""
    log_a = np.full((n, n), -np.inf, np.float32)
    for j in range(n):
        src = rng.choice(n, size=per_col, replace=False)
        log_a[src, j] = np.log(rng.dirichlet(np.ones(per_col)))
    return np.log(rng.dirichlet(np.ones(n))).astype(np.float32), log_a


def check_dense_lists(torch, vd, dev, g22, t_len):
    """Kernel C on source lists: the V = 22 graph's own (its 24-25-long
    word-entry lists split over 4 lanes) with every finite transition 0 and
    integer emissions, so that equal maxima fall in different lanes'
    sub-ranges; a batch of 4 utterances with their own masks; and sparse
    graphs whose lists are too long for registers (N = 179, 40 sources a
    target over 2 lanes, beside log_a in shared memory; N = 1000, 20
    sources, one lane each) or whose lanes take two rounds of the block's
    threads (N = 2000, 8 sources a target)."""
    rng = np.random.default_rng(9)
    n = g22.n_states
    log_a = torch.where(torch.isfinite(g22.log_a), torch.zeros_like(g22.log_a), g22.log_a)
    lb = torch.as_tensor(np.round(rng.normal(scale=2.0, size=(4, t_len, n))).astype(np.float32),
                         device=dev)
    masks = torch.arange(t_len, device=dev)[None, :] < torch.tensor([[t_len], [400], [129], [1]],
                                                                      device=dev)
    masks[0, 50:60] = False
    on = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    cases = [("V=22 lists, all transitions 0, integer emissions",
              (g22.log_pi, log_a, lb[0], None, g22.log_final)),
             ("V=22 graph, B=4 with masks",
              (g22.log_pi, g22.log_a, on(rng.normal(scale=3.0, size=(4, t_len, n))
                                         .astype(np.float32)), masks, g22.log_final)),
             ("V=22 lists tied, B=4 with masks", (g22.log_pi, log_a, lb, masks, g22.log_final))]
    for big, per_col in ((179, 40), (1000, 20), (2000, 8)):
        log_pi, la = sparse_graph(rng, big, per_col)
        cases.append((f"sparse, {per_col} sources a target, masked",
                      (on(log_pi), on(la), on(rng.normal(scale=3.0, size=(t_len, big))
                                               .astype(np.float32)), masks[1], None)))
    for what, args in cases:
        path_k, score_k = vd.viterbi_dense(*args)
        path_p, score_p = vd.viterbi_dense_plain(*args)
        torch.cuda.synchronize()
        require(torch.equal(path_k, path_p) and torch.equal(score_k, score_p),
                f"kernel C differs from the plain scan ({what}): "
                f"{int((path_k != path_p).sum())} path entries")
        print(f"kernel C vs plain ({what}, T={t_len}, N={args[1].shape[0]}): paths and scores "
              "bitwise equal")


def cpu_hop(torch, hop):
    """A kernel hop operand (dense matrix, Rank1Hop or None) on the CPU."""
    if hop is None or torch.is_tensor(hop):
        return None if hop is None else hop.cpu()
    return type(hop)(*(x.cpu() if torch.is_tensor(x) else x for x in hop))


def check_factored(torch, F, tdec, dev, graph, log_b, pi_grid, final_grid, mask, what):
    """Kernels D and E against their plain versions and the scan decoder:
    grids bitwise at feasible states, paths and scores bitwise, on the card
    and on the CPU. Returns the largest grid difference at feasible states."""
    hop = graph._kernel_hop
    hop_t = graph.hop_t
    grids_k = F.factored_forward(pi_grid, graph.inner_a, graph.exit_idx, hop, log_b, mask,
                                 hop_t=hop_t)
    path_k, score_k = F.factored_backtrace(grids_k, graph.inner_a, graph.exit_idx, hop,
                                           final_grid, mask, hop_t=hop_t)
    grids_p = F.factored_forward_plain(pi_grid, graph.inner_a, graph.exit_idx, hop, log_b, mask)
    path_p, score_p = F.factored_backtrace_plain(grids_p, graph.inner_a, graph.exit_idx, hop,
                                                 final_grid, mask)
    path_s, score_s = tdec.factored_trellis_scan(log_b, graph.inner_a, graph.hop, pi_grid,
                                                 final_grid, graph.exit_idx, mask)
    cpu = lambda x: None if x is None else x.cpu()  # noqa: E731
    hop_c = cpu_hop(torch, hop)
    grids_c = F.factored_forward_plain(cpu(pi_grid), cpu(graph.inner_a), cpu(graph.exit_idx),
                                       hop_c, cpu(log_b), cpu(mask))
    path_c, score_c = F.factored_backtrace_plain(grids_c, cpu(graph.inner_a),
                                                 cpu(graph.exit_idx), hop_c, cpu(final_grid),
                                                 cpu(mask))
    torch.cuda.synchronize()
    feasible = torch.isfinite(grids_p)
    err = float((grids_k - grids_p)[feasible].abs().max()) if bool(feasible.any()) else 0.0
    require(bool(feasible.any()), f"kernel D check ({what}): no feasible state")
    require(torch.equal(grids_k[feasible], grids_p[feasible]),
            f"kernel D grids differ from the plain forward at feasible states ({what}): "
            f"max err {err}")
    same_inf = torch.equal(torch.isfinite(grids_k), feasible)
    require(torch.equal(grids_k.cpu()[feasible.cpu()], grids_c[feasible.cpu()]),
            f"kernel D grids differ from the plain forward on the CPU ({what})")
    for ref_path, ref_score, ref in ((path_p, score_p, "plain backtrace"),
                                     (path_s, score_s, "scan decoder")):
        require(torch.equal(path_k, ref_path) and torch.equal(score_k, ref_score),
                f"kernel E differs from the {ref} on the card ({what}): "
                f"{int((path_k != ref_path).sum())} path entries, scores {float(score_k)} vs "
                f"{float(ref_score)}")
    require(torch.equal(path_k.cpu(), path_c) and torch.equal(score_k.cpu(), score_c),
            f"kernels D+E differ from the plain versions on the CPU ({what})")
    entries, hops, windows = replay_counts(torch, F, path_k, mask, graph.grid_shape[1])
    print(f"kernels D+E vs plain ({what}, T={log_b.shape[0]}, V={log_b.shape[1]}, "
          f"S={log_b.shape[2]}): grids bitwise at feasible states (infeasible states "
          f"{'also' if same_inf else 'NOT'} -inf in both), paths and scores bitwise equal to "
          f"the plain replay and the scan (score {float(score_k)}; E's walk: {entries} steps at "
          f"a word's first state, {hops} word changes, {len(windows)} windows)")
    return err


def replay_counts(torch, F, path, mask, s_max):
    """Kernel E's walk over ``path``: its valid steps at a word's first
    state (where the replay's hop rule applies), its word changes, and the
    frames its windows start from (``ops.factored.backtrace_windows``)."""
    path = path.cpu()
    mask = torch.ones(len(path), dtype=torch.bool) if mask is None else mask.cpu().to(torch.bool)
    entries = int(((path[1:] % s_max == 0) & mask[1:]).sum())
    hops = int(((path[1:] // s_max) != (path[:-1] // s_max)).sum())
    return entries, hops, F.backtrace_windows(path, mask, s_max)


def check_repeats(torch, wrapper, plain, graph, log_b, pi_grid, mask, launches):
    """A forward kernel (D: ``factored_forward``, F: ``factored_lattice``)
    launched back to back on the same inputs, each launch's outputs bitwise
    (float bits, ``-inf`` included) equal to the plain version's: an
    ordering race in the exit exchange, or a stale tag taken as ready from
    the previous launch's buffer, would show as a differing output."""
    def bits(out):
        out = out if isinstance(out, tuple) else (out,)
        return [x.view(torch.int32) if x.is_floating_point() else x for x in out]

    args = (pi_grid, graph.inner_a, graph.exit_idx, graph._kernel_hop, log_b, mask)
    ref = bits(plain(*args))
    got = [wrapper(*args, hop_t=graph.hop_t) for _ in range(launches)]
    torch.cuda.synchronize()
    bad = [k for k, out in enumerate(got)
           if not all(torch.equal(a, b) for a, b in zip(bits(out), ref))]
    require(not bad, f"{wrapper.__name__} differs from its plain version in launches {bad} of "
                     f"{launches} back to back")
    print(f"{wrapper.__name__}, {launches} back-to-back launches at T={log_b.shape[0]}, "
          f"V={log_b.shape[1]}, S={log_b.shape[2]}: every launch's output bitwise equal to the "
          "plain version's (-inf included)")


def window_edge_mask(torch, F, path, mask, s_max):
    """``mask`` with frames also masked at the edges of kernel E's windows
    over ``path``: each window's first frame and, for the first few, the
    frame 31 steps on (a full window's last step) and the one past it."""
    out = mask.clone()
    starts = F.backtrace_windows(path.cpu(), mask.cpu(), s_max)
    for k, t0 in enumerate(starts):
        out[t0] = False
        if k < 6:
            out[max(t0 - 31, 0)] = out[max(t0 - 32, 0)] = False
    return out


def check_lattice(torch, F, graph, log_b, pi_grid, mask, what):
    """Kernel F against its plain version, on the card and on the CPU:
    scores bitwise (``-inf`` included), starts and preds equal at every
    record. Returns the largest score difference (0.0 when bitwise)."""
    hop, ia, ei = graph._kernel_hop, graph.inner_a, graph.exit_idx
    got = F.factored_lattice(pi_grid, ia, ei, hop, log_b, mask, hop_t=graph.hop_t)
    ref = F.factored_lattice_plain(pi_grid, ia, ei, hop, log_b, mask)
    cpu = lambda x: None if x is None else x.cpu()  # noqa: E731
    ref_c = F.factored_lattice_plain(cpu(pi_grid), cpu(ia), cpu(ei), cpu_hop(torch, hop),
                                     cpu(log_b), cpu(mask))
    torch.cuda.synchronize()
    finite = torch.isfinite(ref[0])
    err = float((got[0] - ref[0])[finite].abs().max()) if bool(finite.any()) else 0.0
    for rs, where in ((ref, "on the card"), (ref_c, "on the CPU")):
        gs = [x.to(rs[0].device) for x in got]
        same_inf = torch.equal(torch.isfinite(gs[0]), torch.isfinite(rs[0]))
        require(torch.equal(gs[0].view(torch.int32), rs[0].view(torch.int32)),
                f"kernel F scores differ from the plain version {where} ({what}): max err {err}, "
                f"-inf at the same records: {same_inf}")
        for k, name in ((1, "starts"), (2, "preds")):
            require(torch.equal(gs[k], rs[k]),
                    f"kernel F {name} differ from the plain version {where} ({what}): "
                    f"{int((gs[k] != rs[k]).sum())} records")
    t_len, v_words = got[0].shape
    entered = int((got[1] > 0).sum())
    print(f"kernel F vs plain ({what}, T={t_len}, V={v_words}, S={log_b.shape[2]}): records "
          f"bitwise on the card and the CPU ({int(finite.sum())} finite, the rest -inf in both; "
          f"{entered} records of tokens entered after frame 0)")
    return err


def near_limit_graph(torch, F, dev, rng, n_sm, s_max, hop):
    """A random factored graph (as :func:`check_factored` reads one) whose
    forward blocks are as large as the capacity rule admits: ``wpb * S``
    threads with ``wpb = MAX_THREADS // S`` words per block."""
    wpb = F.MAX_THREADS // s_max
    v = wpb * (n_sm - 1) + 1  # ceil(v / n_sm) == wpb
    f32 = lambda *shape, scale=1.0: torch.as_tensor(  # noqa: E731
        rng.normal(scale=scale, size=shape).astype(np.float32), device=dev)
    if hop == "rank1":
        hop = F.Rank1Hop(f32(v), f32(v), f32(v), 0)
    g = types.SimpleNamespace(
        inner_a=f32(v, s_max, s_max, scale=2.0), hop=hop, _kernel_hop=hop, hop_t=None,
        exit_idx=torch.as_tensor(rng.integers(0, s_max, size=v).astype(np.int32), device=dev),
        grid_shape=(v, s_max))
    return g, wpb


def planted_features(torch, graph, rng, words):
    """Frames drawn near the model's own means along ``words``: a decode
    that must come back with those words."""
    mu = graph.mu[:, 0].cpu().numpy()
    if hasattr(graph, "state_map"):
        sm, pm = graph.state_map.cpu().numpy(), graph.pad_mask.cpu().numpy()
        rows = [sm[graph.words.index(w)][pm[graph.words.index(w)]] for w in words]
    else:
        rows = [np.flatnonzero(graph.state_word == graph.words.index(w)) for w in words]
    frames = [mu[r] + rng.normal(scale=0.5, size=mu.shape[1]) for rr in rows for r in rr
              for _ in range(3)]
    return np.asarray(frames, np.float32)


def ambiguous_features(graph, in_lm, n_frames, rng, n_words=21, sites=(3, 9, 15)):
    """Planted frames with real N-best alternatives, at a segment's geometry:
    ``n_words`` words of the LM's vocabulary (3 frames per state), where
    each of ``sites`` sits at the midpoint of one of the vocabulary's
    closest word pairs, so both words of the pair score within the
    lattice's beam there. Returns ``(features (n_frames, D), n_valid,
    pairs)``, zero-padded past ``n_valid`` as a bucket would be."""
    mu = graph.mu[:, 0].cpu().numpy()
    sm, pm = graph.state_map.cpu().numpy(), graph.pad_mask.cpu().numpy()
    cands = [w for w in graph.words if w in in_lm]
    rows = {w: sm[graph.words.index(w)][pm[graph.words.index(w)]] for w in cands}
    cen = np.stack([mu[rows[w]].mean(0) for w in cands])
    dist = ((cen[:, None] - cen[None]) ** 2).sum(-1)
    np.fill_diagonal(dist, np.inf)
    pairs, used = [], set()
    for k in np.argsort(dist, axis=None):
        i, j = divmod(int(k), len(cands))
        if not used & {i, j}:
            pairs.append((cands[i], cands[j]))
            used |= {i, j}
        if len(pairs) == len(sites):
            break
    rest = sorted(set(cands) - {w for p in pairs for w in p})
    words = list(rng.choice(rest, size=n_words))
    for site, (a, _) in zip(sites, pairs):
        words[site] = a
    blend = dict(zip(sites, pairs))
    frames = []
    for i, w in enumerate(words):
        m = 0.5 * (mu[rows[blend[i][0]]] + mu[rows[blend[i][1]]]) if i in blend else mu[rows[w]]
        frames += [x + rng.normal(scale=0.5, size=mu.shape[1]) for x in m for _ in range(3)]
    n_valid = len(frames)
    require(n_valid <= n_frames, f"{n_valid} planted frames exceed the segment's {n_frames}")
    feats = np.zeros((n_frames, mu.shape[1]), np.float32)
    feats[:n_valid] = frames
    return feats, n_valid, pairs


def host_records(tdec, graph, feats, mask, n_valid):
    """The device part of ``decode_segment_nbest`` after its MFCC, on given
    features: the lattice records and their one device->host copy."""
    return tdec.records_to_host(*(r[:n_valid] for r in graph.lattice_records_arrays(feats, mask)))


def lattice_nbest(graph, recs):
    """The host lattice work of an N-best segment decode: ``from_records``,
    ``nbest(5)``, ``posteriors`` and each hypothesis's confidences.
    Returns ``(hyps, tokens)``."""
    lat = graph.lattice_from_records(*recs)
    hyps = lat.nbest(5)
    post = lat.posteriors()
    for h in hyps:
        h.confidence = lat.confidences(h, post)
    return hyps, len(lat)


def check_planted_lattice(torch, F, entry, NGramCounter, NGramModel, rec, graph_cpu, obs,
                          planted, score_1best):
    """The V = 1000 graph's word lattice on planted frames: its top
    hypothesis is the planted sequence with the 1-best decode's score; a
    trigram LM counted from the bigram's own corpus rescores it as the CPU
    graph's lattice does; a masked 2-utterance ``decode_lattice_batch``
    (kernel F once for the batch) equals looping ``decode_lattice``."""
    g = rec.graph
    top = g.decode_lattice(obs).nbest(5)
    print(f"V=1000 lattice of the planted frames: top hypotheses "
          f"{[(h.words, h.score) for h in top[:3]]}; the 1-best decode scored {score_1best}")
    require(len(top) >= 1 and top[0].words == planted,
            f"the lattice's top hypothesis {top[0].words if top else None} is not {planted}")
    require(abs(top[0].score - score_1best) <= 1e-4 * abs(score_1best),
            f"the lattice's top score {top[0].score} is not the 1-best's {score_1best}")
    cfg = rec.decoder_config
    kw = dict(lm_scale=cfg.lm_scale, word_insertion_penalty=cfg.word_insertion_penalty,
              exit_logp=cfg.exit_logp)
    tri = NGramModel(NGramCounter(3, entry.serving_corpus(len(g.words) - 1)))
    got = g.decode_lattice(obs).rescore(tri, n=5, **kw)
    ref = graph_cpu.decode_lattice(obs).rescore(tri, n=5, **kw)
    require(len(got) >= 1 and [h.words for h in got] == [h.words for h in ref],
            f"trigram rescoring: {[h.words for h in got]} on the card, {[h.words for h in ref]} "
            "on the CPU")
    rel = max(abs(a.score - b.score) / abs(b.score) for a, b in zip(got, ref))
    require(rel < 1e-4, f"trigram rescoring scores differ by {rel} relative")
    print(f"trigram rescoring of the planted lattice: {len(got)} hypotheses, top "
          f"{got[0].words} ({got[0].score}), as on the CPU (max score rel err {rel:.3g})")
    cut = 9
    feats = np.stack([obs, np.concatenate([obs[cut:], np.zeros((cut, obs.shape[1]), obs.dtype)])])
    masks = np.stack([np.ones(len(obs), bool), np.arange(len(obs)) < len(obs) - cut])
    before = F.factored_lattice.launches
    batch = g.decode_lattice_batch(feats, masks)
    require(F.factored_lattice.launches - before == 1,
            "decode_lattice_batch of 2 utterances did not launch kernel F once")
    for b in range(2):
        solo = g.decode_lattice(feats[b], masks[b])
        require(batch[b].tokens == solo.tokens and
                [(h.words, h.score) for h in batch[b].nbest(5)]
                == [(h.words, h.score) for h in solo.nbest(5)],
                f"decode_lattice_batch utterance {b} differs from decode_lattice")
    print(f"decode_lattice_batch (B=2, masks of {len(obs)} and {len(obs) - cut} frames): kernel F "
          "once, tokens and N-best equal to looping decode_lattice")

def percentile(xs, q):
    return float(np.percentile(np.asarray(xs), q)) if xs else float("nan")


def same_segments(got, ref, what, rel=1e-4):
    """Segment boundaries and words equal, scores within ``rel``."""
    require([(g.start_s, g.end_s) for g in got] == [(r.start_s, r.end_s) for r in ref],
            f"{what}: segment boundaries differ: {[(g.start_s, g.end_s) for g in got][:6]} vs "
            f"{[(r.start_s, r.end_s) for r in ref][:6]}")
    require([g.words for g in got] == [r.words for r in ref],
            f"{what}: segment words differ: {[g.words for g in got]} vs {[r.words for r in ref]}")
    err = max((abs(g.score - r.score) / abs(r.score) for g, r in zip(got, ref)), default=0.0)
    require(err < rel, f"{what}: segment scores differ by {err} relative")
    return err


def feed_stream(torch, srec, audio, chunk, wrappers=None, on_path=()):
    """Feed ``audio`` in ``chunk``-sample pieces, then flush. With
    ``wrappers``, the launch counters are reset before every call and each
    call must launch each kernel of ``on_path`` once per segment it closed,
    and no other kernel. Returns ``(segments, per-segment latencies in ms,
    the largest buffer in samples, launch totals)``."""
    segs, lat, peak = [], [], 0
    totals = {w.__name__: 0 for w in wrappers or ()}
    pieces = [audio[i: i + chunk] for i in range(0, len(audio), chunk)] + [None]
    for piece in pieces:
        if wrappers:
            torch.cuda.synchronize()
            reset_counts(*wrappers)
        before = srec.stats.decode_seconds
        out = srec.flush() if piece is None else srec.process(piece)
        if wrappers:
            counts = {w.__name__: w.launches for w in wrappers}
            require(all(counts[n] == (len(out) if n in on_path else 0) for n in counts),
                    f"a stream call that closed {len(out)} segments launched {counts}; "
                    f"expected each of {list(on_path)} once a segment and nothing else")
            for n, c in counts.items():
                totals[n] += c
        if out:  # a call that closes k segments gives each the mean
            lat += [1e3 * (srec.stats.decode_seconds - before) / len(out)] * len(out)
        segs += out
        peak = max(peak, srec.stats.buffer_samples)
    return segs, lat, peak, totals


BACKOFF_VOCAB = 5000  # the serving recognizer of the exact backoff search
BACKOFF_BENCH_VOCABS = (5000, 10000)  # bench/decoder's large_vocab rows
BACKOFF_BENCH_FRAMES = 500


@contextlib.contextmanager
def counted_scans(tdec, F):
    """Count the calls of the scans the JAX package jits (the port's
    ``factored_trellis_scan`` and ``factored_lattice_scan``) while the
    block runs, with a spy in each module that holds one. Yields the list
    of the names called."""
    calls = []
    sites = [(tdec, "factored_trellis_scan"), (tdec, "factored_lattice_scan"),
             (F, "factored_lattice_scan")]
    saved = [(m, n, getattr(m, n)) for m, n in sites]
    for m, n, fn in saved:
        def spy(*args, _fn=fn, _n=n, **kw):
            calls.append(_n)
            return _fn(*args, **kw)
        setattr(m, n, spy)
    try:
        yield calls
    finally:
        for m, n, fn in saved:
            setattr(m, n, fn)


def backoff_graph(torch, F, dev, rng, v, s, k, sil, ties, dead=False, scale=2.0, heavy=None):
    """A random factored graph with a backoff hop, as :func:`check_backoff`
    reads one: rows of 0 to ``k`` arcs (sources ascending), some scored at
    their own backoff estimate ``from_w[src] + uni[dst]`` (ties between the
    rank-1 and the sparse families), with ``ties`` integer scores (ties
    between two arcs' ``exit + val``; a small ``scale`` makes many words
    tie, so that the achieving sources lie in different blocks), a silence
    word or none; ``dead``: every start is ``-inf``; ``heavy``: ``{word:
    arcs}`` rows longer than the rest. Returns ``(graph, pi_grid,
    final_grid, draw)``, ``draw(*shape)`` the scores' distribution."""
    def draw(*shape):
        x = rng.normal(scale=scale, size=shape)
        return np.round(x) if ties else x

    heavy = heavy or {}
    k_rest, k = k, max([k, *heavy.values()])

    from_w, uni = draw(v), draw(v)
    sil_idx = v - 1 if sil else -1
    sil_from = np.full(v, -np.inf)
    if sil:
        sil_from = draw(v)
        sil_from[sil_idx] = uni[sil_idx] = -np.inf
    pred = np.zeros((v, k), np.int32)
    val = np.full((v, k), -np.inf)
    for w in range(v):
        n = heavy.get(w, int(rng.integers(0, k_rest + 1)))
        src = np.sort(rng.choice(v, size=n, replace=False))
        x = from_w[src] + uni[w] + np.abs(draw(n))
        at = rng.random(n) < 0.4
        x[at] = from_w[src[at]] + uni[w]
        pred[w, :n], val[w, :n] = src, x
    f32 = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=dev)  # noqa: E731
    hop = F.backoff_hop(types.SimpleNamespace(
        from_w=f32(from_w), uni=f32(uni), sil_from=f32(sil_from), sil_idx=sil_idx,
        pred=torch.as_tensor(pred, device=dev), val=f32(val)))
    inner = np.full((v, s, s), -np.inf)
    exit_idx = rng.integers(0, s, size=v)
    for w in range(v):
        for j in range(exit_idx[w] + 1):
            inner[w, j, j] = -1.0 if ties else np.log(0.5)
            if j < exit_idx[w]:
                inner[w, j, j + 1] = -1.0 if ties else np.log(0.5)
    pi = np.full((v, s), -np.inf)
    if not dead:
        pi[:, 0] = draw(v)
    final = np.where(np.arange(s)[None] == exit_idx[:, None], 0.0, -np.inf)
    g = types.SimpleNamespace(inner_a=f32(inner), hop=hop, _kernel_hop=hop, hop_t=None,
                              exit_idx=torch.as_tensor(exit_idx.astype(np.int32), device=dev),
                              grid_shape=(v, s))
    return g, f32(pi), f32(final), draw


def map_line(F, hop, s, n_sm, what, bound=False):
    """Print the word-to-block map that kernels D and F take for a backoff
    hop (``ops.factored.block_layout``): its blocks and threads, the
    largest block's words, arcs and distinct sources, and the exchange
    slots a block polls a frame, against the V of a full poll; with
    ``bound``, require that the largest block holds at most the largest row
    plus an even share of the arcs. Returns the layout."""
    lay = F.block_layout(hop, s, n_sm)
    ptr = np.asarray(hop.cache["ptr"], np.int64)
    blk = np.asarray(lay.blk_ptr)
    words, arcs, srcs = np.diff(blk), np.diff(ptr[blk]), np.diff(np.asarray(lay.src_ptr))
    big = int(np.argmax(arcs))
    v, nnz, row = len(ptr) - 1, int(ptr[-1]), int(np.diff(ptr).max())
    share = row + -(-nnz // lay.n_blocks)
    threads = max(256, -(-lay.max_words * s // 32) * 32)
    print(f"word-to-block map ({what}; V={v}, S={s}, {nnz} arcs, largest row {row}): "
          f"{lay.n_blocks} blocks of {threads} threads; largest block {lay.max_words} words; the "
          f"block with the most arcs {int(arcs[big])} arcs (words {int(blk[big])}-"
          f"{int(blk[big + 1]) - 1}, {int(words[big])} words, {int(srcs[big])} distinct sources; "
          f"largest row + even share {share}); most sources a block {lay.max_src}; slots a block "
          f"polls a frame: {4 * lay.n_blocks} partial words (D and F) + <= {lay.max_src} "
          f"sources (a full poll: {v} exits)")
    require(not bound or lay.max_arcs <= share,
            f"{what}: the map's largest block holds {lay.max_arcs} arcs, past {share}")
    return lay


def check_backoff(torch, F, tdec, graph, log_b, pi_grid, final_grid, mask, what, scan=True):
    """Kernels D, E and F with a backoff hop against their plain versions on
    the card, bit for bit in every output (``-inf`` included), each kernel
    launched twice (the same bits both times); with ``scan`` also the path
    and score of the port's ``factored_trellis_scan`` on the graph's own
    hop (the padded factors for a built graph). Then D, E and F again with
    the graph's rank-1 family alone (a ``Rank1Hop``: the partials without
    arcs, the even word map) against their plain versions."""
    hop, ia, ei = graph._kernel_hop, graph.inner_a, graph.exit_idx
    require(F.hop_kind(hop) == "backoff", f"{what}: not a backoff hop")
    bits = lambda x: x.view(torch.int32) if x.is_floating_point() else x  # noqa: E731
    same = lambda a, b: all(torch.equal(bits(x), bits(y)) for x, y in zip(a, b))  # noqa: E731
    r1 = F.Rank1Hop(hop.from_w, hop.uni, hop.sil_from, hop.sil_idx)
    d = [F.factored_forward(pi_grid, ia, ei, r1, log_b, mask) for _ in range(2)]
    d_p = F.factored_forward_plain(pi_grid, ia, ei, r1, log_b, mask)
    e = F.factored_backtrace(d[0], ia, ei, r1, final_grid, mask)
    e_p = F.factored_backtrace_plain(d_p, ia, ei, r1, final_grid, mask)
    f = [F.factored_lattice(pi_grid, ia, ei, r1, log_b, mask) for _ in range(2)]
    f_p = F.factored_lattice_plain(pi_grid, ia, ei, r1, log_b, mask)
    torch.cuda.synchronize()
    require(same(d, [d_p, d_p]), f"kernel D (rank-1) differs from the plain forward ({what}): "
                                 f"{int((bits(d[0]) != bits(d_p)).sum())} grid entries")
    require(same(e, e_p), f"kernel E (rank-1) differs from the plain replay ({what})")
    require(same(f[0], f_p) and same(f[1], f_p),
            f"kernel F (rank-1) differs from the plain records ({what}): "
            + ", ".join(f"{int((bits(a) != bits(b)).sum())} {n}" for a, b, n in
                        zip(f[0], f_p, ("scores", "starts", "preds"))))
    d = [F.factored_forward(pi_grid, ia, ei, hop, log_b, mask) for _ in range(2)]
    d_p = F.factored_forward_plain(pi_grid, ia, ei, hop, log_b, mask)
    e = [F.factored_backtrace(d[0], ia, ei, hop, final_grid, mask) for _ in range(2)]
    e_p = F.factored_backtrace_plain(d_p, ia, ei, hop, final_grid, mask)
    f = [F.factored_lattice(pi_grid, ia, ei, hop, log_b, mask) for _ in range(2)]
    f_p = F.factored_lattice_plain(pi_grid, ia, ei, hop, log_b, mask)
    torch.cuda.synchronize()
    require(same(d, [d_p, d_p]), f"kernel D (backoff) differs from the plain forward ({what}): "
                                 f"{int((bits(d[0]) != bits(d_p)).sum())} grid entries")
    require(same(e[0], e_p) and same(e[1], e_p),
            f"kernel E (backoff) differs from the plain replay ({what}): "
            f"{int((e[0][0] != e_p[0]).sum())} path entries, score {float(e[0][1])} vs "
            f"{float(e_p[1])}")
    require(same(f[0], f_p) and same(f[1], f_p),
            f"kernel F (backoff) differs from the plain records ({what}): "
            + ", ".join(f"{int((bits(a) != bits(b)).sum())} {n}" for a, b, n in
                        zip(f[0], f_p, ("scores", "starts", "preds"))))
    if scan:
        path_s, score_s = tdec.factored_trellis_scan(log_b, ia, graph.hop, pi_grid, final_grid,
                                                     ei, mask)
        require(torch.equal(e[0][0], path_s) and torch.equal(e[0][1], score_s),
                f"kernels D+E (backoff) differ from the scan decoder ({what})")
    t_len, v, s = log_b.shape
    entries, hops, _ = replay_counts(torch, F, e[0][0], mask, s)
    sil = f"word {hop.sil_idx}" if hop.sil_idx >= 0 else "none"
    print(f"kernels D, E, F with a backoff hop vs plain ({what}; T={t_len}, V={v}, S={s}, "
          f"{len(hop.arc_src)} arcs, silence {sil}): grids, path, score and records bitwise, "
          f"two launches each the same bits{', path and score the scan decoder' if scan else ''}"
          f" ({int(torch.isfinite(d_p).sum())} finite grid entries; E's walk: {entries} steps "
          f"at a word's first state, {hops} word changes); with the rank-1 family alone D, E, F "
          f"bitwise too")


def cross_block_ties(torch, F, graph, log_b, pi_grid, n_sm):
    """Count, over the plain forward's frames of ``graph`` (a backoff hop),
    the frames whose rank-1 maximum is reached by words of two or more
    blocks of the kernels' map, and the words whose entry ties a rank-1
    source and an arc source in different blocks; require both, so that
    the bitwise checks on this graph covered the tie rules across blocks."""
    hop, s = graph._kernel_hop, log_b.shape[2]
    blk = np.asarray(F.block_layout(hop, s, n_sm).blk_ptr)
    grids = F.factored_forward_plain(pi_grid, graph.inner_a, graph.exit_idx, hop, log_b)
    exits = grids[:, torch.arange(grids.shape[1], device=grids.device),
                  graph.exit_idx.long()].cpu().numpy()
    from_w, uni = hop.from_w.cpu().numpy(), hop.uni.cpu().numpy()
    src, dst, val = (x.cpu().numpy() for x in (hop.arc_src, hop.arc_dst, hop.arc_val))
    block_of = np.searchsorted(blk, np.arange(len(from_w)), side="right") - 1
    r1_frames = mixed = 0
    for ex in exits[:-1]:
        c = ex + from_w
        top = np.flatnonzero(c == c.max())
        r1_frames += len(set(block_of[top])) > 1
        a1 = top[0]
        cand = ex[src] + val
        r1 = c.max() + uni[dst]
        mixed += int(((cand == r1) & np.isfinite(cand) & (block_of[src] != block_of[a1])).sum())
    print(f"  cross-block ties: {r1_frames} of {len(exits) - 1} frames with the rank-1 maximum "
          f"in two or more blocks; {mixed} arcs tying the rank-1 entry from another block")
    require(r1_frames > 0 and mixed > 0, "the tie graph planted no tie across blocks")


def backoff_bench_graph(torch, dev, vocab, n_frames):
    """``bench/decoder``'s large-vocabulary backoff graph and frames at
    ``vocab`` words (its corpus-trained bigram, in-degree <= 256, S = 3, no
    silence word), built as its ``large_vocab`` rows build them."""
    from lnasr_tpu_torch.bench import decoder as bdec
    from lnasr_tpu_torch.bench.corpus import make_corpus
    from lnasr_tpu_torch.config import NGramConfig
    from lnasr_tpu_torch.models.ngram import NGramCounter, NGramModel

    sents = make_corpus(bdec.LM_SENTENCES, vocab, np.random.default_rng(1))
    lm = NGramModel(NGramCounter(2, sents), NGramConfig(order=2))
    rng = np.random.default_rng(0)
    g = bdec._graph(vocab, dev, rng, lm, hop_mode="backoff", width=5, hop_max_in_degree=256)
    return g, bdec._frames(rng, n_frames, dev)


def backoff_phase(torch, entry, wrappers, card, launches):
    """The exact backoff search on the card (kernels D, E and F with the
    backoff hop: rank-1 plus the sparse seen-bigram arcs, in CSR). Holds the
    three kernels bitwise to their plain versions on the V = 5000 serving
    segment, on ``bench/decoder``'s 5k and 10k graphs, and on small graphs
    with planted ties, no silence word, rows without arcs, all-``-inf``
    starts, masked frames (the last one too) and T = 1; then drives
    ``entry.recognizer_serving(5000)``'s ``decode_segment`` (A, D, E once
    each) and ``decode_segment_nbest`` (A, F once each) with a spy on the
    scans (called zero times), against the CPU recognizer on the same
    weights (words; N-best lists, scores within 1e-6 relative) and a
    planted word sequence; times the kernels, their plain versions, the
    scans they replace and the segment decodes."""
    from lnasr_tpu_torch.models import decoder as tdec
    from lnasr_tpu_torch.ops import factored as F

    dev = torch.device(DEVICE)
    n_sm = F.sm_count(dev)
    t_phase = time.perf_counter()
    rec, seg = entry.recognizer_serving(BACKOFF_VOCAB, device=dev)
    rec_c = entry.recognizer_serving(BACKOFF_VOCAB, device="cpu")[0]
    g = rec.graph
    hop = g._kernel_hop
    require(isinstance(g, tdec.FactoredDecodingGraph) and isinstance(hop, F.BackoffHop),
            f"V={BACKOFF_VOCAB} did not compose the factored graph with a backoff hop")
    padded, n_seg, _ = rec._pad_to_bucket(seg)
    feats, mask = rec.am.mfcc.features_fast(torch.from_numpy(padded).to(dev),
                                            lengths=torch.tensor([n_seg], device=dev))
    log_b, pi_g, fin_g = g._grid_inputs(feats)
    t_len, v, s = log_b.shape
    require(F.factored_kernel_ok(t_len, v, s, hop, n_sm) and F.lattice_kernel_ok(v, s, hop, n_sm),
            f"the V={v} backoff graph is past the kernels' capacity")
    print(f"backoff slice geometry: V={BACKOFF_VOCAB} words + <sil>, grid ({v}, {s}), "
          f"{len(hop.arc_src)} finite arcs in CSR (padded rows {tuple(g.hop.val.shape)}), "
          f"segment T={t_len} ({int(mask.sum())} valid), grids {4 * t_len * v * s / 1e6:.1f} MB")

    maps = {"V=5000 segment": map_line(F, hop, s, n_sm, "the V=5000 serving graph")}

    # -- D, E, F bitwise against their plain versions ----------------------
    inputs = {"V=5000 segment": (g, log_b, pi_g, fin_g, mask)}
    check_backoff(torch, F, tdec, g, log_b, pi_g, fin_g, mask, "the V=5000 segment, bucket mask")
    # planted words at the segment's geometry: a path with hops between words
    in_lm = set(rec.lm.ngram.vocabulary())
    alt_feats, alt_n, alt_pairs = ambiguous_features(g, in_lm, t_len, np.random.default_rng(7))
    alt_obs = torch.as_tensor(alt_feats, device=dev)
    alt_mask = torch.arange(t_len, device=dev) < alt_n
    lb_alt, pi_alt, fin_alt = g._grid_inputs(alt_obs)
    check_backoff(torch, F, tdec, g, lb_alt, pi_alt, fin_alt, alt_mask,
                  "V=5000, 21 planted words at the segment's geometry")
    for vocab in BACKOFF_BENCH_VOCABS:
        gb, frames = backoff_bench_graph(torch, dev, vocab, BACKOFF_BENCH_FRAMES)
        require(F.factored_kernel_ok(BACKOFF_BENCH_FRAMES, *gb.grid_shape, gb._kernel_hop, n_sm),
                f"bench/decoder's {vocab}-word backoff graph is past the kernels' capacity")
        maps[f"bench V={vocab}"] = map_line(F, gb._kernel_hop, gb.grid_shape[1], n_sm,
                                            f"bench/decoder's {vocab}-word graph", bound=True)
        lb, pi_b, fin_b = gb._grid_inputs(frames)
        inputs[f"bench V={vocab}"] = (gb, lb, pi_b, fin_b, None)
        check_backoff(torch, F, tdec, gb, lb, pi_b, fin_b, None,
                      f"bench/decoder's large_vocab_{vocab // 1000}k graph, no silence word")
        last = torch.arange(BACKOFF_BENCH_FRAMES, device=dev) < BACKOFF_BENCH_FRAMES - 1
        last[[1, BACKOFF_BENCH_FRAMES // 2]] = False
        check_backoff(torch, F, tdec, gb, lb, pi_b, fin_b, last,
                      f"large_vocab_{vocab // 1000}k, frames 1, T/2 and the last masked",
                      scan=False)
    rng = np.random.default_rng(19)
    # the last two: rows far past an even block share (the map's floor: a
    # block of their own), at the low ids and in the middle; and integer
    # scores in a narrow range, so that the rank-1 maxima and the arcs tie
    # across many blocks
    heavy = {0: 256, 1: 200, 2: 180, 1500: 256}
    for v_t, s_t, k_t, sil, ties, t_t, dead, scale, rows in (
            (12, 3, 4, True, True, 40, False, 2.0, None),
            (12, 3, 4, False, True, 40, False, 2.0, None),
            (40, 4, 8, True, False, 64, False, 2.0, None),
            (300, 3, 6, True, True, 50, False, 2.0, None),
            (12, 3, 4, True, False, 30, True, 2.0, None),
            (9, 3, 3, True, False, 1, False, 2.0, None),
            (9, 3, 3, False, True, 2, False, 2.0, None),
            (3000, 3, 4, True, False, 60, False, 2.0, heavy),
            (2000, 3, 6, True, True, 60, False, 0.4, None)):
        gt, pi_t, fin_t, draw = backoff_graph(torch, F, dev, rng, v_t, s_t, k_t, sil, ties, dead,
                                              scale=scale, heavy=rows)
        if rows or v_t > 1000:
            what = "rows of 180-256 arcs" if rows else "narrow integer scores"
            lay = map_line(F, gt._kernel_hop, s_t, n_sm, what, bound=True)
            if rows:
                blk = np.asarray(lay.blk_ptr)
                alone = [int(np.diff(blk)[np.searchsorted(blk, w, side="right") - 1])
                         for w in rows]
                print(f"  the heavy rows' blocks hold {alone} words")
        lb = torch.as_tensor(np.asarray(draw(t_t, v_t, s_t), np.float32), device=dev)
        m = torch.arange(t_t, device=dev) < t_t - 1
        if t_t > 4:
            m[[1, t_t // 2]] = False
        for mm, what in ((None, "no mask"), (m, "masks, the last frame masked")):
            check_backoff(torch, F, tdec, gt, lb, pi_t, fin_t, mm,
                          f"random, at most {k_t} arcs a row, {'integer ties, ' if ties else ''}"
                          f"{'all -inf starts, ' if dead else ''}"
                          f"{f'heavy rows {rows}, ' if rows else ''}"
                          f"{f'scores at scale {scale}, ' if scale != 2.0 else ''}{what}")
        if v_t > 1000 and not rows:
            cross_block_ties(torch, F, gt, lb, pi_t, n_sm)

    # -- the main paths, through the recognizer ------------------------------
    torch.cuda.synchronize()
    reset_counts(*wrappers)
    with counted_scans(tdec, F) as scans:
        words, score = rec.decode_segment(seg)
    counts = {w.__name__: w.launches for w in wrappers}
    launches["V=5000 backoff"] = counts
    one_best = ("mel_frontend", "factored_forward", "factored_backtrace")
    print(f"main path: Recognizer.decode_segment at V={BACKOFF_VOCAB} (factored graph, backoff "
          f"hop) on {len(seg) / 16000} s -> {len(words)} words {words[:8]}, score {score}; "
          f"launches {counts}; scans called {len(scans)} times")
    require(all(counts[n] == 1 for n in one_best)
            and all(counts[n] == 0 for n in counts if n not in one_best),
            f"the V=5000 segment decode did not launch exactly {one_best} once each: {counts}")
    require(not scans, f"the V=5000 segment decode called the scans: {scans}")
    words_c, score_c = rec_c.decode_segment(seg)
    rel = abs(score - score_c) / abs(score_c)
    require(words == words_c and rel < 1e-4,
            f"V=5000: card {words} ({score}) vs CPU {words_c} ({score_c})")
    torch.cuda.synchronize()
    reset_counts(*wrappers)
    with counted_scans(tdec, F) as scans:
        hyps = rec.decode_segment_nbest(seg, n=5, with_confidence=True)
    counts = {w.__name__: w.launches for w in wrappers}
    launches["V=5000 backoff nbest"] = counts
    nb_path = ("mel_frontend", "factored_lattice")
    require(all(counts[n] == 1 for n in nb_path)
            and all(counts[n] == 0 for n in counts if n not in nb_path),
            f"the V=5000 N-best decode did not launch exactly {nb_path} once each: {counts}")
    require(not scans, f"the V=5000 N-best decode called the scans: {scans}")
    hyps_c = rec_c.decode_segment_nbest(seg, n=5, with_confidence=True)
    nb_rel = max(abs(a.score - b.score) / abs(b.score) for a, b in zip(hyps, hyps_c))
    require(len(hyps) >= 1 and [h.words for h in hyps] == [h.words for h in hyps_c]
            and nb_rel < 1e-6,
            f"V=5000 N-best: card {[h.words for h in hyps]} vs CPU {[h.words for h in hyps_c]}, "
            f"score rel err {nb_rel}")
    print(f"main path: Recognizer.decode_segment_nbest(n=5, with_confidence=True) at "
          f"V={BACKOFF_VOCAB} -> {len(hyps)} hypotheses; launches {counts}; scans called "
          f"{len(scans)} times; vs the CPU recognizer on the same weights: words equal (1-best "
          f"score rel err {rel:.3g}), N-best lists equal (max score rel err {nb_rel:.3g})")
    # planted words: the 1-best decode recovers them, and the N-best list
    # with alternatives (three word sites between close word pairs) is the CPU's
    planted = [w for w in g.words if w in in_lm][3:9]
    obs = planted_features(torch, g, np.random.default_rng(BACKOFF_VOCAB), planted)
    got, path_g, score_g = g.decode(obs)
    got_c, path_gc, score_gc = rec_c.graph.decode(obs)
    require(got == planted and got_c == planted and np.array_equal(path_g, path_gc),
            f"V=5000 planted {planted}: card {got}, CPU {got_c}")
    alt = lattice_nbest(g, host_records(tdec, g, alt_obs, alt_mask, alt_n))[0]
    g_c = rec_c.graph
    alt_c = lattice_nbest(g_c, host_records(tdec, g_c, alt_obs.cpu(), alt_mask.cpu(), alt_n))[0]
    alt_rel = max(abs(a.score - b.score) / abs(b.score) for a, b in zip(alt, alt_c))
    require(len({tuple(h.words) for h in alt}) >= 2
            and [h.words for h in alt] == [h.words for h in alt_c] and alt_rel < 1e-6,
            f"V=5000 planted N-best: card {[h.words for h in alt]} vs CPU "
            f"{[h.words for h in alt_c]} (score rel err {alt_rel})")
    print(f"V=5000 planted decode {planted} -> {got} (paths equal to the CPU's); N-best with "
          f"alternatives ({alt_n} planted frames, word sites between {alt_pairs}): {len(alt)} "
          f"hypotheses {[(len(h.words), h.score) for h in alt]}, equal to the CPU's (max score "
          f"rel err {alt_rel:.3g})")

    # -- timing ----------------------------------------------------------------
    out = {}
    for name, (gi, lb, pi_i, fin_i, m) in inputs.items():
        h, ia, ei = gi._kernel_hop, gi.inner_a, gi.exit_idx
        grids = F.factored_forward(pi_i, ia, ei, h, lb, m)
        t_i, v_i, s_i = lb.shape
        nnz = len(h.arc_src)
        row = {"d_ms": cuda_ms(lambda: F.factored_forward(pi_i, ia, ei, h, lb, m), reps=20),
               "e_ms": cuda_ms(lambda: F.factored_backtrace(grids, ia, ei, h, fin_i, m), reps=20),
               "f_ms": cuda_ms(lambda: F.factored_lattice(pi_i, ia, ei, h, lb, m), reps=20),
               "scan_ms": cuda_ms(lambda: tdec.factored_trellis_scan(
                   lb, ia, gi.hop, pi_i, fin_i, ei, m), reps=2, warmup=1),
               "lattice_scan_ms": cuda_ms(lambda: F.factored_lattice_scan(
                   lb, ia, gi.hop, pi_i, ei, m), reps=2, warmup=1)}
        # what the arcs cost D: the same frames with the rank-1 family alone
        r1 = F.Rank1Hop(h.from_w, h.uni, h.sil_from, h.sil_idx)
        row["d_rank1_ms"] = cuda_ms(lambda: F.factored_forward(pi_i, ia, ei, r1, lb, m), reps=20)
        row["f_rank1_ms"] = cuda_ms(lambda: F.factored_lattice(pi_i, ia, ei, r1, lb, m), reps=20)
        row["map"] = {k: getattr(maps[name], k) for k in ("n_blocks", "max_words", "max_arcs",
                                                           "max_src")}
        # the work these inputs need: valid steps, the replay's steps at a
        # word's first state; each input read once, each output written once
        steps = t_i - 1 if m is None else int(m[1:].sum())
        entries = replay_counts(torch, F, F.factored_backtrace(grids, ia, ei, h, fin_i, m)[0],
                                m, s_i)[0]
        graph_bytes = 4 * (v_i * s_i + v_i * s_i * s_i + 5 * v_i + 1) + 12 * nnz
        # emission rows of frame 0 and of the valid steps (a masked frame
        # reads none); every frame's grid written
        emis_bytes = 4 * (1 + steps) * v_i * s_i
        grid_bytes = 4 * t_i * v_i * s_i
        fwd_ops = steps * (2 * v_i * s_i * s_i + 5 * v_i + 2 * nnz + v_i * s_i)
        row["d_bound"] = bound(graph_bytes + emis_bytes + grid_bytes + t_i, fwd_ops)
        row["e_bound"] = bound(4 * (2 * v_i * s_i + 2 * s_i * steps + 2 * v_i * entries + v_i)
                               + 8 * nnz + 5 * t_i + 4,
                               2 * v_i * s_i + steps * 2 * s_i + entries * 4 * v_i + 2 * nnz)
        row["f_bound"] = bound(graph_bytes + emis_bytes + 12 * t_i * v_i + t_i, fwd_ops)
        if name == "V=5000 segment":
            row |= {"d_plain_ms": cuda_ms(lambda: F.factored_forward_plain(pi_i, ia, ei, h, lb, m),
                                          reps=3, warmup=1),
                    "e_plain_ms": cuda_ms(lambda: F.factored_backtrace_plain(
                        grids, ia, ei, h, fin_i, m), reps=3, warmup=1),
                    "f_plain_ms": cuda_ms(lambda: F.factored_lattice_plain(pi_i, ia, ei, h, lb, m),
                                          reps=3, warmup=1),
                    "d_dev_ms": device_ms(torch, lambda: F.factored_forward(
                        pi_i, ia, ei, h, lb, m)),
                    "e_dev_ms": device_ms(torch, lambda: F.factored_backtrace(
                        grids, ia, ei, h, fin_i, m)),
                    "f_dev_ms": device_ms(torch, lambda: F.factored_lattice(
                        pi_i, ia, ei, h, lb, m))}
            print(f"timing on {card}: {name}: plain versions on the card D {row['d_plain_ms']:.4f} "
                  f"ms, E {row['e_plain_ms']:.4f} ms, F {row['f_plain_ms']:.4f} ms; device time "
                  f"per call (torch.profiler) D {row['d_dev_ms']:.4f} ms, E {row['e_dev_ms']:.4f} "
                  f"ms, F {row['f_dev_ms']:.4f} ms")
        print(f"timing on {card}: {name} (T={t_i}, V={v_i}, S={s_i}, {nnz} arcs, {steps} valid "
              f"steps): kernel D {row['d_ms']:.4f} ms (bound {row['d_bound'][0]:.5f} ms by "
              f"{row['d_bound'][1]}; {row['d_rank1_ms']:.4f} ms with the rank-1 family alone, no "
              f"arcs), E {row['e_ms']:.4f} ms (bound {row['e_bound'][0]:.5f} ms by "
              f"{row['e_bound'][1]}; {entries} steps at a word's first state), F "
              f"{row['f_ms']:.4f} ms (bound {row['f_bound'][0]:.5f} ms by {row['f_bound'][1]}; "
              f"{row['f_rank1_ms']:.4f} ms with the rank-1 family alone); "
              f"the scans they replace on the card: factored_trellis_scan {row['scan_ms']:.4f} ms, "
              f"factored_lattice_scan {row['lattice_scan_ms']:.4f} ms (CUDA events)")
        out[name] = row
    seg_ms = host_ms(lambda: rec.decode_segment(seg), reps=10)
    nb_ms = host_ms(lambda: rec.decode_segment_nbest(seg, n=5, with_confidence=True), reps=10)
    seg_s = len(seg) / 16000
    print(f"timing on {card}: segment decode V={BACKOFF_VOCAB} (backoff hop): {seg_ms:.4f} ms per "
          f"{seg_s} s segment = {seg_s / (seg_ms / 1e3):.1f} audio-s/s; N-best (n=5, with "
          f"confidences) {nb_ms:.4f} ms (host clock, one device->host copy each)")
    device_breakdown(torch, lambda: rec.decode_segment(seg), seg_ms,
                     f"{card}, segment decode V={BACKOFF_VOCAB} backoff")
    print(f"backoff phase: {time.perf_counter() - t_phase:.1f} s")
    return out | {"segment_ms": seg_ms, "nbest_ms": nb_ms}


BATCH_ROWS = 8  # entry.parallel_serving's segments: one launch each of D, E and F
CUT_ROWS = 64  # a V = 5000 batch whose grids (~5.2 GB) pass GRID_BUDGET: cut by ops.factored.cut_batch


def planted_rows(torch, graph, lm, feats, masks):
    """The serving batch with rows 2 and 5 replaced by frames planted along
    six words of the LM each, so that part of the batch decodes to words
    (the random segments decode to silence). Returns ``(feats, masks,
    planted)``."""
    in_lm = [w for w in graph.words if w in set(lm.vocabulary())]
    planted = {2: in_lm[3:9], 5: in_lm[20:26]}
    feats, masks = feats.clone(), masks.clone()
    for row, words in planted.items():
        obs = torch.as_tensor(planted_features(torch, graph, np.random.default_rng(300 + row),
                                               words), device=feats.device)
        feats[row] = 0.0
        feats[row, :len(obs)] = obs
        masks[row] = torch.arange(feats.shape[1], device=feats.device) < len(obs)
    return feats, masks, planted


def edge_masks(torch, masks):
    """``masks`` with row 1 masked after its first frame, row 3 with
    interior gaps (single frames and a run of 9) and row 0 valid to its
    last frame: masks that differ by utterance at every kind of frame."""
    out = masks.clone()
    out[0] = True
    out[1] = False
    out[1, 0] = True
    t_len = out.shape[1]
    out[3, 5:min(40, t_len):3] = False
    out[3, t_len // 2:t_len // 2 + 9] = False
    return out


def check_batch(torch, F, graph, log_b, pi_grid, final_grid, masks, what):
    """Kernels D, E and F on a batch ``log_b (B, T, V, S)``, ``masks (B,
    T)``: one launch each, bitwise (``-inf`` included) equal to looping the
    single-utterance launches on the card and to the batched plain versions
    on the card. Returns the batch's grids."""
    hop, hop_t, ia, ei = graph._kernel_hop, graph.hop_t, graph.inner_a, graph.exit_idx
    b = log_b.shape[0]
    kernels = (F.factored_forward, F.factored_backtrace, F.factored_lattice)
    before = [k.launches for k in kernels]
    grids = F.factored_forward(pi_grid, ia, ei, hop, log_b, masks, hop_t=hop_t)
    path, score = F.factored_backtrace(grids, ia, ei, hop, final_grid, masks, hop_t=hop_t)
    recs = F.factored_lattice(pi_grid, ia, ei, hop, log_b, masks, hop_t=hop_t)
    made = [k.launches - n for k, n in zip(kernels, before)]
    require(made == [1, 1, 1], f"the batch of {b} ({what}) launched D, E and F {made} times")
    loop_g = [F.factored_forward(pi_grid, ia, ei, hop, log_b[r], masks[r], hop_t=hop_t)
              for r in range(b)]
    loop_e = [F.factored_backtrace(loop_g[r], ia, ei, hop, final_grid, masks[r], hop_t=hop_t)
              for r in range(b)]
    loop_f = [F.factored_lattice(pi_grid, ia, ei, hop, log_b[r], masks[r], hop_t=hop_t)
              for r in range(b)]
    plain_g = F.factored_forward_plain(pi_grid, ia, ei, hop, log_b, masks)
    plain_e = F.factored_backtrace_plain(plain_g, ia, ei, hop, final_grid, masks)
    plain_f = F.factored_lattice_plain(pi_grid, ia, ei, hop, log_b, masks)
    torch.cuda.synchronize()
    stack = lambda xs: [torch.stack(x) for x in zip(*xs)]  # noqa: E731
    for ref, where in ((torch.stack(loop_g), "looped single launches"),
                       (plain_g, "the batched plain forward")):
        bad = [r for r in range(b) if not same_bits(torch, [grids[r]], [ref[r]])]
        require(not bad, f"kernel D's batch ({what}) differs from {where} in rows {bad}")
    for (ref_p, ref_s), where in ((stack(loop_e), "looped single launches"),
                                  (plain_e, "the batched plain replay")):
        bad = [r for r in range(b) if not (torch.equal(path[r], ref_p[r])
                                           and same_bits(torch, [score[r]], [ref_s[r]]))]
        require(not bad, f"kernel E's batch ({what}) differs from {where} in rows {bad}")
    for ref, where in ((stack(loop_f), "looped single launches"),
                       (plain_f, "the batched plain version")):
        bad = [r for r in range(b)
               if not (same_bits(torch, [recs[0][r]], [ref[0][r]])
                       and torch.equal(recs[1][r], ref[1][r]) and torch.equal(recs[2][r], ref[2][r]))]
        require(not bad, f"kernel F's batch ({what}) differs from {where} in rows {bad}")
    valid = masks.sum(1).tolist()
    print(f"kernels D, E, F on a batch ({what}: B={b}, T={log_b.shape[1]}, V={log_b.shape[2]}, "
          f"S={log_b.shape[3]}, {F.hop_kind(hop)} hop, valid frames {valid}): one launch each, "
          f"grids, paths, scores and records bitwise equal to {b} single launches each and to "
          f"the batched plain versions on the card")
    return grids


def batch_bounds(torch, F, graph, log_b, masks, paths):
    """The least times of the batched D, E and F on these inputs, as
    ``main`` (dense hop) and ``backoff_phase`` (backoff hop) count one
    utterance's: the graph read once a launch, every utterance's emission
    rows of its first and valid frames, its grids, mask and records, and
    the work of its valid steps and of its replay's steps at a word's
    first state."""
    b, t_len, v, s = log_b.shape
    hop = graph._kernel_hop
    dense = F.hop_kind(hop) == "dense"
    nnz = 0 if dense else len(hop.arc_src)
    steps = int(masks[:, 1:].sum())
    entries = sum(replay_counts(torch, F, paths[r], masks[r], s)[0] for r in range(b))
    graph_bytes = (4 * (v * s + v * s * s + v + v * v) if dense
                   else 4 * (v * s + v * s * s + 5 * v + 1) + 12 * nnz)
    # emission rows of each utterance's frame 0 and of its valid steps (a
    # masked frame reads none); every frame's grid written
    emis_bytes = 4 * (b + steps) * v * s
    grid_bytes = 4 * b * t_len * v * s
    hop_ops = 2 * v * v + 2 * v if dense else 5 * v + 2 * nnz
    fwd_ops = steps * (2 * v * s * s + v * s + hop_ops)
    return {"d": bound(graph_bytes + emis_bytes + grid_bytes + b * t_len, fwd_ops),
            "e": bound(4 * ((b + 1) * v * s + 2 * s * steps + 2 * v * entries + v) + 8 * nnz
                       + 5 * b * t_len + 4 * b,
                       2 * b * v * s + steps * 2 * s + entries * (2 if dense else 4) * v + 2 * nnz),
            "f": bound(graph_bytes + emis_bytes + 12 * b * t_len * v + b * t_len, fwd_ops)}


def batch_phase(torch, entry, wrappers, card, launches):
    """The factored graph's batched decodes, one launch a batch (the JAX
    package's vmapped scans): at V = 1000 (dense hop) and V = 5000 (backoff
    hop) on ``entry.parallel_serving``'s 8 ragged segments (two rows planted
    with words), :func:`check_batch` on the batch's own masks and on masks
    that differ at every kind of frame; ``decode_batch_arrays`` with the
    counters reset launches D and E once, bitwise equal to looping
    ``decode_arrays`` on the card and to the batched plain decode on the
    CPU (the same weights and emissions), the planted rows decoding to
    their words; at V = 1000 ``decode_lattice_batch`` launches F once,
    equal to looping ``decode_lattice``; a 64-row V = 5000 batch is cut by
    ``ops.factored.cut_batch`` and launches D and E once a piece, equal to
    the loop. Times the batched D, E and F (CUDA events over queued
    launches) against the B single launches, and ``decode_batch`` against
    looping ``decode`` (host clock, one copy back)."""
    from lnasr_tpu_torch.models import decoder as tdec
    from lnasr_tpu_torch.ops import factored as F

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    n_sm = F.sm_count(dev)
    none = {w.__name__: 0 for w in wrappers}
    out = {}
    for vocab in (1000, BACKOFF_VOCAB):
        serve = entry.parallel_serving(vocab, BATCH_ROWS, device=dev)
        rec = serve.recognizer
        g = rec.graph
        kind = F.hop_kind(g._kernel_hop)
        require(kind == ("dense" if vocab == 1000 else "backoff"),
                f"V={vocab}: the serving graph's hop is {kind}")
        feats, masks, planted = planted_rows(torch, g, rec.lm.ngram, serve.features, serve.masks)
        log_b, pi_g, fin_g = g._grid_inputs(feats)
        b, t_len, v, s = log_b.shape
        hop, hop_t, ia, ei = g._kernel_hop, g.hop_t, g.inner_a, g.exit_idx
        require(F.cut_batch(b, t_len, v, s, hop, n_sm) == [(0, b)]
                and F.cut_batch(b, t_len, v, s, hop, n_sm, lattice=True) == [(0, b)],
                f"V={vocab}: a batch of {b} does not fit one launch")
        grids = check_batch(torch, F, g, log_b, pi_g, fin_g, masks, f"V={vocab} serving batch")
        check_batch(torch, F, g, log_b, pi_g, fin_g, edge_masks(torch, masks),
                    f"V={vocab} serving batch, masks at every kind of frame")
        for hop_mode, loop in ((("rank1", True), ("dense", False)) if vocab == 1000 else ()):
            gk = tdec.FactoredDecodingGraph.build(
                rec.lexicon, rec.am.units, rec.lm.ngram,
                tdec.DecoderConfig(lm_scale=0.5, word_insertion_penalty=-4.0, loop=loop),
                silence_model=rec.am.units[tdec.SILENCE], hop_mode=hop_mode, device=dev)
            lb_k, pi_k, fin_k = gk._grid_inputs(feats)
            check_batch(torch, F, gk, lb_k, pi_k, fin_k, edge_masks(torch, masks),
                        f"V=1000 serving batch, {F.hop_kind(gk._kernel_hop)} hop, masks at every "
                        "kind of frame")

        # the main path: decode_batch_arrays, the counters reset just before
        torch.cuda.synchronize()
        reset_counts(*wrappers)
        paths, scores = g.decode_batch_arrays(feats, masks)
        torch.cuda.synchronize()
        counts = {w.__name__: w.launches for w in wrappers}
        launches[f"V={vocab} batch"] = counts
        require(counts == none | {"factored_forward": 1, "factored_backtrace": 1},
                f"V={vocab} decode_batch_arrays of {b} launched {counts}")
        loop = [g.decode_arrays(feats[r], masks[r]) for r in range(b)]
        # the batched plain decode on the CPU, on the same weights and emissions
        c = lambda x: None if x is None else x.cpu()  # noqa: E731
        hop_c = cpu_hop(torch, hop)
        cpu_p, cpu_s = F.factored_backtrace_plain(
            F.factored_forward_plain(c(pi_g), c(ia), c(ei), hop_c, c(log_b), c(masks)), c(ia),
            c(ei), hop_c, c(fin_g), c(masks))
        require(torch.equal(paths, torch.stack([p for p, _ in loop]))
                and same_bits(torch, [scores], [torch.stack([x for _, x in loop])]),
                f"V={vocab} decode_batch_arrays differs from looping decode_arrays")
        require(torch.equal(paths.cpu(), cpu_p) and same_bits(torch, [scores.cpu()], [cpu_s]),
                f"V={vocab} decode_batch_arrays differs from the CPU's batched plain decode")
        got = g.decode_batch(feats, masks)
        for row, words in planted.items():
            require(got[row][0] == words, f"V={vocab} planted row {row}: {words} decoded as "
                                          f"{got[row][0]}")
        require(all(np.isfinite(x[2]) for x in got), f"V={vocab} decode_batch: a score not finite")
        print(f"main path: FactoredDecodingGraph.decode_batch_arrays at V={vocab} ({kind} hop, "
              f"B={b}, T={t_len}, rows {sorted(planted)} planted): launches {counts}; paths and "
              f"scores bitwise equal to looping decode_arrays and to the batched plain decode on "
              f"the CPU (the same weights and emissions); decode_batch's words "
              f"{[x[0] for x in got]}, the planted rows their words")
        if vocab == 1000:
            torch.cuda.synchronize()
            reset_counts(*wrappers)
            lats = g.decode_lattice_batch(feats, masks)
            counts = {w.__name__: w.launches for w in wrappers}
            launches["V=1000 lattice batch"] = counts
            require(counts == none | {"factored_lattice": 1},
                    f"decode_lattice_batch of {b} launched {counts}")
            for r in range(b):
                solo = g.decode_lattice(feats[r], masks[r])
                require(lats[r].tokens == solo.tokens and
                        [(h.words, h.score) for h in lats[r].nbest(5)]
                        == [(h.words, h.score) for h in solo.nbest(5)],
                        f"decode_lattice_batch row {r} differs from decode_lattice")
            print(f"main path: decode_lattice_batch at V=1000 (B={b}): launches {counts}; tokens "
                  f"and N-best of every row equal to looping decode_lattice "
                  f"({[len(x.tokens) for x in lats]} tokens)")

        # times: the batched launch against its B single launches, queued
        e_args = (grids, ia, ei, hop, fin_g, masks)
        runs = {
            "d": (lambda: F.factored_forward(pi_g, ia, ei, hop, log_b, masks, hop_t=hop_t),
                  lambda: [F.factored_forward(pi_g, ia, ei, hop, log_b[r], masks[r], hop_t=hop_t)
                           for r in range(b)]),
            "e": (lambda: F.factored_backtrace(*e_args, hop_t=hop_t),
                  lambda: [F.factored_backtrace(grids[r], ia, ei, hop, fin_g, masks[r],
                                                hop_t=hop_t) for r in range(b)]),
            "f": (lambda: F.factored_lattice(pi_g, ia, ei, hop, log_b, masks, hop_t=hop_t),
                  lambda: [F.factored_lattice(pi_g, ia, ei, hop, log_b[r], masks[r], hop_t=hop_t)
                           for r in range(b)])}
        times = {}
        for key, (batched, looped) in runs.items():
            times[key] = (burst_ms(batched, launches=6), burst_ms(looped, launches=3),
                          burst_ms(batched, launches=6), burst_ms(looped, launches=3))
        batch_ms = host_ms(lambda: g.decode_batch(feats, masks), reps=5)
        loop_ms = host_ms(lambda: [g.decode(feats[r], masks[r]) for r in range(b)], reps=5)
        bounds = batch_bounds(torch, F, g, log_b, masks, paths)
        out[vocab] = {"b": b, "t": t_len, "times": times, "decode_batch_ms": batch_ms,
                      "decode_loop_ms": loop_ms, "valid": int(masks[:, 1:].sum()),
                      "bounds": bounds}
        for key, name in (("d", "D"), ("e", "E"), ("f", "F")):
            tb = (times[key][0] + times[key][2]) / 2
            tl = (times[key][1] + times[key][3]) / 2
            print(f"timing on {card}: kernel {name} at V={vocab} ({kind} hop), B={b}, T={t_len}: "
                  f"one batched launch {times[key][0]:.4f} / {times[key][2]:.4f} ms, the {b} single "
                  f"launches {times[key][1]:.4f} / {times[key][3]:.4f} ms (CUDA events over queued "
                  f"launches, in turns); {tl / tb:.2f}x; the batch's bound "
                  f"{bounds[key][0]:.5f} ms by {bounds[key][1]}")
        print(f"timing on {card}: decode_batch at V={vocab}, B={b}: {batch_ms:.4f} ms, looping "
              f"decode over the rows {loop_ms:.4f} ms (host clock, each ending in its copies "
              f"back; median of 5); {loop_ms / batch_ms:.2f}x")

    # a batch past one launch's capacity: cut by the stated rule
    serve = entry.parallel_serving(BACKOFF_VOCAB, CUT_ROWS, device=dev)
    g = serve.recognizer.graph
    feats, masks = serve.features, serve.masks
    t_len = feats.shape[1]
    v, s = g.grid_shape
    pieces = F.cut_batch(CUT_ROWS, t_len, v, s, g._kernel_hop, n_sm)
    require(len(pieces) > 1 and all(F.factored_kernel_ok(t_len, v, s, g._kernel_hop, n_sm, j - i)
                                    for i, j in pieces),
            f"the {CUT_ROWS}-row V={v} batch was cut into {pieces}")
    torch.cuda.synchronize()
    reset_counts(*wrappers)
    paths, scores = g.decode_batch_arrays(feats, masks)
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in wrappers}
    launches[f"V={BACKOFF_VOCAB} cut batch"] = counts
    n = len(pieces)
    require(counts == none | {"factored_forward": n, "factored_backtrace": n},
            f"the cut batch launched {counts}, the cut has {n} pieces")
    loop = [g.decode_arrays(feats[r], masks[r]) for r in range(CUT_ROWS)]
    require(torch.equal(paths, torch.stack([p for p, _ in loop]))
            and same_bits(torch, [scores], [torch.stack([x for _, x in loop])]),
            "the cut batch differs from looping decode_arrays")
    print(f"main path: decode_batch_arrays of {CUT_ROWS} rows at V={BACKOFF_VOCAB} (grids "
          f"{4 * CUT_ROWS * t_len * v * s / 1e9:.2f} GB at one launch, budget "
          f"{F.GRID_BUDGET / 1e9:.2f} GB): cut_batch gives {pieces}; launches {counts}; paths and "
          f"scores bitwise equal to looping decode_arrays")
    out["cut"] = pieces
    print(f"batch phase: {time.perf_counter() - t_phase:.1f} s")
    return out


def stream_phase(torch, entry, wrappers, card, launches):
    """Live serving at V = 1000: ``entry.streaming_serving(1000)``'s stream
    in 100 ms chunks on the card (mel frontend, forward and backtrace
    kernels once per segment) against the CPU stream on the same weights
    and audio; a reset replay under torch.profiler for the device's busy
    share; the same audio through ``Recognizer.recognize_segments`` with
    the same detector."""
    from torch.profiler import ProfilerActivity, profile

    srec, audio = entry.streaming_serving(1000, device=DEVICE)
    srec_cpu, _ = entry.streaming_serving(1000, device="cpu")
    audio_s = len(audio) / entry.SERVING_MFCC_CONFIG.sample_rate
    on_path = ("mel_frontend", "factored_forward", "factored_backtrace")
    # one segment decoded first: the kernels' first calls out of the timing
    srec.rec.decode_segment(audio[:16000])
    srec.reset()
    t0 = time.perf_counter()
    segs, lat, peak, totals = feed_stream(torch, srec, audio, entry.STREAM_CHUNK, wrappers,
                                          on_path)
    wall = time.perf_counter() - t0
    launches["V=1000 stream"] = totals
    stats = srec.stats
    require(len(segs) >= 10, f"the stream closed {len(segs)} segments; at least 10 expected")
    require(stats.segments == len(segs) and all(np.isfinite(g.score) for g in segs),
            "the stream's segment count or scores are off")
    require(all(totals[n] == len(segs) for n in on_path),
            f"the stream launched {totals} over {len(segs)} segments")
    segs_cpu, _, peak_cpu, _ = feed_stream(torch, srec_cpu, audio, entry.STREAM_CHUNK)
    err = same_segments(segs, segs_cpu, "V=1000 stream, card vs CPU")
    require(peak == peak_cpu, f"buffer peaks differ: {peak} vs {peak_cpu}")
    print(f"main path: StreamingRecognizer at V=1000 on {audio_s} s in "
          f"{entry.STREAM_CHUNK}-sample chunks -> {len(segs)} segments, "
          f"{sum(len(g.words) for g in segs)} words; launches {totals} (each of {list(on_path)} "
          f"once a segment, checked call by call); equal to the CPU stream (boundaries, words; "
          f"max score rel err {err:.3g})")
    srec.reset()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        replay, _, _, _ = feed_stream(torch, srec, audio, entry.STREAM_CHUNK)
        torch.cuda.synchronize()
        replay_wall = time.perf_counter() - t0
    busy = sum(e.self_device_time_total for e in prof.key_averages()
               if on_device(torch, e)) / 1e6
    same_segments(replay, segs, "V=1000 stream, reset() replay", rel=1e-12)
    print(f"timing on {card}: stream V=1000: per-segment latency p50 {percentile(lat, 50):.4f} "
          f"ms, p99 {percentile(lat, 99):.4f} ms, max {max(lat):.4f} ms (host clock around "
          f"decode_segment); stats.rtf {stats.rtf:.6f} ({stats.decode_seconds:.4f} s of decode "
          f"for {stats.audio_seconds:.3f} s of audio), whole feed {wall:.3f} s = "
          f"{audio_s / wall:.1f} audio-s/s; largest buffer {peak} samples "
          f"({peak / 16000:.3f} s); reset() replay under torch.profiler: equal segments, device "
          f"busy {busy * 1e3:.3f} ms of {replay_wall * 1e3:.1f} ms "
          f"({100 * busy / replay_wall:.2f}%)")
    rec = srec.rec
    rec.vad = type(srec.vad)(mode=0, sample_rate=srec.sample_rate)
    batch = rec.recognize_segments(audio)
    rec.vad = None
    spans = lambda segments: [(round(float(g.start_s), 2), round(float(g.end_s), 2))  # noqa: E731
                              for g in segments]
    print(f"segmentations of the stream: StreamingRecognizer {len(segs)} segments "
          f"{spans(segs)}; Recognizer.recognize_segments (same detector, mode 0) {len(batch)} "
          f"segments {spans(batch)}: spans {'equal' if spans(batch) == spans(segs) else 'differ'}, "
          f"words {'equal' if [g.words for g in batch] == [g.words for g in segs] else 'differ'}")
    return {"segments": len(segs), "p50_ms": percentile(lat, 50),
            "p99_ms": percentile(lat, 99), "rtf": stats.rtf, "max_buffer": peak,
            "busy": busy / replay_wall}


def trigram_ties(torch, log_b, mask, inner_a, hop3, log_pi_w, final3, exit_idx):
    """The ties the trigram recursion meets on these inputs (its plain
    forward replayed): within-word maxima that two sources or more reach,
    hop maxima that two histories or more reach, and hops equal to
    ``within`` at state 0, at finite values on valid frames."""
    h, v, s = hop3.shape[0], hop3.shape[1], inner_a.shape[1]
    ex = exit_idx.long()[None, :, None].expand(h, v, 1)
    grid = torch.full((h, v, s), -np.inf, dtype=log_b.dtype, device=log_b.device)
    grid[h - 1, :, 0] = log_pi_w
    grid = grid + log_b[0]
    counts = np.zeros(3, np.int64)
    for t in range(1, log_b.shape[0]):
        if mask is not None and not bool(mask[t]):
            continue
        cand = grid[:, :, :, None] + inner_a[None]
        within = cand.max(dim=2).values
        hop = torch.gather(grid, 2, ex) + hop3
        entry = hop.max(dim=0).values
        fin_w, fin_h = torch.isfinite(within), torch.isfinite(entry)
        counts += [int(((cand == within[:, :, None]).sum(2) > 1)[fin_w].sum()),
                   int(((hop == entry[None]).sum(0) > 1)[fin_h].sum()),
                   int(((entry == within[:v, :, 0]) & fin_h).sum())]
        within[:v, :, 0] = torch.maximum(within[:v, :, 0], entry)
        grid = within + log_b[t]
    return counts


def check_trigram_case(torch, tri, args, what, route=None, ties=False):
    """Kernel H (forward on ``route``, else the wrapper's own; then the
    backtrace) against its plain versions on ``args``: backpointers, score,
    final state and path bitwise, and a second launch of each bitwise the
    first. With ``ties``, prints the ties the inputs hold. Returns the
    score's absolute difference from the plain version's (0.0: the check
    requires its bits)."""
    bts, score, last = tri._forward(*args, route=route)
    path = tri.trigram_backtrace(bts, last)
    bts2, score2, last2 = tri._forward(*args, route=route)
    path2 = tri.trigram_backtrace(bts2, last2)
    rb, rs, rl = tri.trigram_forward_plain(*args)
    rp = tri.trigram_backtrace_plain(rb, rl)
    torch.cuda.synchronize()
    require(torch.equal(bts, rb) and same_bits(torch, [score], [rs]) and torch.equal(last, rl),
            f"kernel H's forward differs from its plain version on {what}: "
            f"{int((bts != rb).sum())} backpointers, score {float(score)} vs {float(rs)}, "
            f"final state {int(last)} vs {int(rl)}")
    require(torch.equal(path, rp), f"kernel H's backtrace differs from its plain version on "
            f"{what}: {int((path != rp).sum())} path entries")
    require(torch.equal(bts, bts2) and same_bits(torch, [score], [score2])
            and torch.equal(path, path2), f"kernel H: two launches differ on {what}")
    note = ""
    if ties:
        c = trigram_ties(torch, *args)
        note = (f"; ties met: {c[0]} within-word, {c[1]} across histories, {c[2]} hops equal to "
                f"the within-word score at state 0")
    t, v, s = args[0].shape
    route = route or tri.trigram_route(v + 1, v, s, args[0].dtype.itemsize,
                                       tri.sm_count(args[0].device))
    print(f"kernel H vs plain ({what}: T={t}, V={v}, S={s}, {args[0].dtype}, route {route}): "
          f"backpointers, score, final state and path bitwise, two launches bitwise{note}")
    return 0.0 if same_bits(torch, [score], [rs]) else abs(float(score) - float(rs))


def tie_graph(torch, rng, v, s, t_len, dev, dtype):
    """A small trigram graph's tables and emissions on coarse integer grids
    (many ``-inf``s, hop rows of two histories alike, every within-word
    source equal): ties of every kind. ``(log_b, inner_a, hop3, log_pi_w,
    final3, exit_idx)``."""
    h = v + 1
    sizes = rng.integers(1, s + 1, size=v)
    inner = np.full((v, s, s), -np.inf)
    for w, n in enumerate(sizes):
        for j in range(n):
            inner[w, j, j] = 0.0
            if j + 1 < n:
                inner[w, j, j + 1] = 0.0
    hop3 = rng.integers(-2, 1, size=(h, v, v)).astype(np.float64)
    hop3[rng.random((h, v, v)) < 0.2] = -np.inf
    hop3[1] = hop3[0]
    log_b = rng.integers(-2, 1, size=(t_len, v, s)).astype(np.float64)
    log_b[:, np.arange(s)[None, :] >= sizes[:, None]] = -np.inf
    pi = rng.integers(-1, 1, size=v).astype(np.float64)
    fin = rng.integers(-1, 1, size=(h, v)).astype(np.float64)
    on = lambda x: torch.as_tensor(x, dtype=dtype, device=dev)  # noqa: E731
    return (on(log_b), on(inner), on(hop3), on(pi), on(fin),
            torch.as_tensor(sizes - 1, dtype=torch.int32, device=dev))


def trigram_routes(tri, args):
    """The routes of kernel H's forward that take ``args`` (the resident
    route only float32 and within its capacity), in ``tri.ROUTES`` order."""
    t, v, s = args[0].shape
    return [r for r in tri.ROUTES if tri.route_fits(r, v + 1, v, s, args[0].dtype.itemsize,
                                                    tri.sm_count(args[0].device))]


def check_trigram(torch, tri, dev, g, log_b, mask):
    """Kernel H against its plain versions, bitwise (:func:`check_trigram_case`):
    the V = 200 segment's own inputs at float32 and float64, each on every
    route that takes it (:func:`trigram_routes`: float32 the resident,
    ``smem`` and global routes, float64 the last two); its scores rounded
    to integers (ties across histories and within sources, hops equal to
    ``within``) on each route; small graphs of planted ties with masks at
    the start, inside and at the end, and T = 1 and 2; each route forced at
    small V, from one word (two history rows) on. Returns the segment's
    largest score difference (0.0)."""
    tabs = (g.inner_a, g.hop3, g.log_pi_w, g.final3, g._exit_idx32)
    seg = (log_b, mask) + tabs
    seg64 = tuple(x.double() if x.is_floating_point() else x for x in seg)
    require("resident" in trigram_routes(tri, seg), "kernel H's resident route does not take "
            "the V=200 segment at float32")
    err = max(check_trigram_case(torch, tri, a, f"the V=200 segment, {what}", route)
              for what, a in (("float32", seg), ("float64", seg64))
              for route in trigram_routes(tri, a))
    rounded = (log_b.round(), mask, g.inner_a.round(), g.hop3.round(), g.log_pi_w.round(),
               g.final3.round(), g._exit_idx32)
    for route in trigram_routes(tri, rounded):
        check_trigram_case(torch, tri, rounded, "the V=200 segment rounded to integers", route,
                           ties=route == "resident")
    rng = np.random.default_rng(14)
    t_len = 40
    masks = {"no mask": None,
             "masked at the start": torch.arange(t_len, device=dev) >= 3,
             "masked inside": (torch.arange(t_len, device=dev) < 12)
             | (torch.arange(t_len, device=dev) >= 17),
             "masked at the end": torch.arange(t_len, device=dev) < 33}
    for dtype in (torch.float32, torch.float64):
        lb, *tab = tie_graph(torch, rng, 12, 4, t_len, dev, dtype)
        for what, m in masks.items():
            for route in trigram_routes(tri, (lb, m, *tab)):
                check_trigram_case(torch, tri, (lb, m, *tab), f"planted ties, {what}", route,
                                   ties=route == "smem")
        for t in (1, 2):
            for m in (None, torch.zeros(t, dtype=torch.bool, device=dev)):
                for route in trigram_routes(tri, (lb[:t], m, *tab)):
                    check_trigram_case(torch, tri, (lb[:t], m, *tab), f"planted ties, T={t}"
                                       + (", every frame masked" if m is not None else ""), route)
    for v in (1, 5, 40):  # one word to a few: from H = 2 rows on up
        lb, *tab = tie_graph(torch, rng, v, 3, 25, dev, torch.float32)
        args = (lb.float() * 0.37, None, *tab)
        for route in trigram_routes(tri, args):
            check_trigram_case(torch, tri, args, f"V={v}", route)
    return err


def trigram_phase(torch, entry, wrappers, card, launches):
    """The exact trigram graph at V = 200 (an order-3 LM counted from
    ``serving_corpus(200)``): kernel H held against its plain versions
    (:func:`check_trigram`); the bucketed segment decode launches the mel
    frontend, H's forward and H's backtrace once each and nothing else,
    and equals the CPU recognizer; a planted 6-word sequence decodes to
    itself. Times the segment, H's two kernels (CUDA events over
    back-to-back launches queued behind a spinning kernel, and
    torch.profiler) and the plain frame loop on the card."""
    from lnasr_tpu_torch.models.decoder import TrigramDecodingGraph
    from lnasr_tpu_torch.ops import trigram as tri

    rec, seg = entry.recognizer_serving(200, device=DEVICE, graph="trigram", lm_order=3)
    rec_cpu, _ = entry.recognizer_serving(200, device="cpu", graph="trigram", lm_order=3)
    g = rec.graph
    require(isinstance(g, TrigramDecodingGraph) and rec.lm.ngram.order == 3,
            "V=200 did not compose the trigram graph over an order-3 LM")
    padded, n, _ = rec._pad_to_bucket(seg)
    feats, mask = rec.am.mfcc.features_fast(torch.from_numpy(padded).to(DEVICE),
                                            lengths=torch.tensor([n], device=DEVICE))
    log_b = g._grid_log_b(feats)
    h_err = check_trigram(torch, tri, torch.device(DEVICE), g, log_b, mask)
    rec.decode_segment(seg)  # first calls out of the count and the timing
    torch.cuda.synchronize()
    reset_counts(*wrappers)
    by_route = tri.trigram_forward.route_launches
    by_route.update(dict.fromkeys(by_route, 0))
    words, score = rec.decode_segment(seg)
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in wrappers}
    route_counts = dict(by_route)
    launches["V=200 trigram"] = counts
    on_path = ("mel_frontend", "trigram_forward", "trigram_backtrace")
    require(all(counts[n] == 1 for n in on_path)
            and all(c == 0 for n, c in counts.items() if n not in on_path),
            f"the trigram segment decode did not launch the mel frontend, H's forward and H's "
            f"backtrace once each and nothing else: {counts}")
    t, v, s = log_b.shape
    route = tri.trigram_route(v + 1, v, s, log_b.dtype.itemsize, tri.sm_count(log_b.device))
    require(route == "resident" and route_counts == {r: int(r == route) for r in tri.ROUTES},
            f"the trigram segment decode did not take H's resident route once: route {route}, "
            f"launches by route {route_counts}")
    words_c, score_c = rec_cpu.decode_segment(seg)
    rel = abs(score - score_c) / abs(score_c)
    require(words == words_c and rel < 1e-4,
            f"V=200 trigram: card {words} ({score}) vs CPU {words_c} ({score_c})")
    in_lm = set(rec.lm.ngram.vocabulary())
    planted = [w for w in g.words if w in in_lm][3:9]
    obs = planted_features(torch, g, np.random.default_rng(200), planted)
    got, path_g, score_g = g.decode(obs)
    got_c, path_c, score_gc = rec_cpu.graph.decode(obs)
    require(got == planted and got_c == planted,
            f"V=200 trigram: planted {planted} decoded as {got} (card) / {got_c} (CPU)")
    require(abs(score_g - score_gc) <= 1e-4 * abs(score_gc),
            f"V=200 trigram planted scores {score_g} vs {score_gc}")
    seg_s = len(seg) / entry.SERVING_MFCC_CONFIG.sample_rate
    ms = host_ms(lambda: rec.decode_segment(seg), reps=5, warmup=1)
    dev = device_ms(torch, lambda: rec.decode_segment(seg), calls=3)
    print(f"main path: Recognizer(graph='trigram').decode_segment at V=200 (grid {g.grid_shape}, "
          f"hop {tuple(g.hop3.shape)}) on {seg_s} s -> {len(words)} words {words[:8]}, score "
          f"{score}; launches {counts}, H's forward by route {route_counts}; equal to the CPU "
          f"recognizer (score rel err {rel:.3g}); "
          f"planted {planted} -> {got} (paths "
          f"{'equal' if np.array_equal(path_g, path_c) else 'differ'} to the CPU's)")
    print(f"timing on {card}: trigram segment V=200: {ms:.4f} ms per {seg_s} s segment = "
          f"{seg_s / (ms / 1e3):.1f} audio-s/s (host clock, one device->host copy); device time "
          f"{dev:.4f} ms per call (torch.profiler)")
    device_breakdown(torch, lambda: rec.decode_segment(seg), ms, f"{card}, trigram segment V=200",
                     steps=2)

    # kernel H at the segment's own inputs
    args = (log_b, mask, g.inner_a, g.hop3, g.log_pi_w, g.final3, g._exit_idx32)
    bts, _, last = tri.trigram_forward(*args)
    fwd_ms = burst_ms(lambda: tri.trigram_forward(*args), launches=10)
    bt_ms = burst_ms(lambda: tri.trigram_backtrace(bts, last))
    fwd_prof = kernel_device_ms(torch, lambda: tri.trigram_forward(*args), "trigram_forward",
                                calls=5)
    bt_prof = kernel_device_ms(torch, lambda: tri.trigram_backtrace(bts, last),
                               "trigram_backtrace", calls=5)
    wrapper_ms = cuda_ms(lambda: tri.trigram_viterbi(*args), reps=10)
    fwd_wrapper_ms = cuda_ms(lambda: tri.trigram_forward(*args), reps=10)
    bt_wrapper_ms = cuda_ms(lambda: tri.trigram_backtrace(bts, last), reps=10)
    plain_fwd_ms = cuda_ms(lambda: tri.trigram_forward_plain(*args), reps=3, warmup=1)
    rb, _, rl = tri.trigram_forward_plain(*args)
    plain_bt_ms = cuda_ms(lambda: tri.trigram_backtrace_plain(rb, rl), reps=3, warmup=1)
    h = v + 1
    steps = int(mask[1:].sum())
    isz = log_b.dtype.itemsize
    # bytes: hop3, emissions and the small tables in once, T-1 backpointer
    # frames out; operations: each valid step's within-word (H V S^2) and
    # hop (H V^2) adds and maxes
    f_bytes = (isz * (h * v * v + t * v * s + v * s * s + v + h * v) + 4 * v
               + 4 * (t - 1) * h * v * s)
    f_bound = bound(f_bytes, steps * 2 * (h * v * s * s + h * v * v))
    b_bound = bound(4 * (2 * t + 1), 0)
    reread_ms = steps * isz * h * v * v / HBM_BYTES_PER_S * 1e3
    print(f"timing on {card}: kernel H forward {fwd_ms:.4f} ms (CUDA events over 10 launches "
          f"queued behind a spinning kernel; torch.profiler {fwd_prof[0]:.4f} ms, {fwd_prof[1]} "
          f"of 5 launches recorded in window {fwd_prof[2]}), the wrapper call {fwd_wrapper_ms:.4f}"
          f" ms, plain frame loop {plain_fwd_ms:.4f} ms; bound {f_bound[0]:.5f} ms by "
          f"{f_bound[1]} ({f_bytes} bytes, {steps} steps), the row routes' hop3 re-read from "
          f"device memory each step {reread_ms:.4f} ms; kernel H backtrace {bt_ms:.4f} ms (profiler "
          f"{bt_prof[0]:.4f} ms, {bt_prof[1]} of 5), the wrapper call {bt_wrapper_ms:.4f} ms, "
          f"plain gathers {plain_bt_ms:.4f} ms, bound {b_bound[0]:.6f} ms; trigram_viterbi "
          f"{wrapper_ms:.4f} ms (T={t}, H={h}, V={v}, S={s}, route {route})")
    return {"ms": ms, "device_ms": dev, "err": h_err, "route": route,
            "forward": {"ms": fwd_ms, "profiler_ms": fwd_prof[0], "profiler_launches": fwd_prof[1],
                        "wrapper_ms": fwd_wrapper_ms, "plain_ms": plain_fwd_ms, "bound": f_bound,
                        "hop3_reread_ms": reread_ms},
            "backtrace": {"ms": bt_ms, "profiler_ms": bt_prof[0],
                          "profiler_launches": bt_prof[1], "wrapper_ms": bt_wrapper_ms,
                          "plain_ms": plain_bt_ms, "bound": b_bound}}


TRIGRAM_CUT_ROWS = 24  # a V = 200 trigram batch whose backpointers (15.9 GB) pass BTS_BUDGET


def check_trigram_batch(torch, tri, log_b, masks, tabs, what):
    """Kernel H on a batch ``log_b (B, T, V, S)``, ``masks (B, T)``, on
    every route that takes its utterances (:func:`trigram_routes`; the
    route the wrapper picks in the pieces of ``ops.trigram.trigram_cut``,
    a forced one in one launch): one launch of the forward and one of the
    backtrace a piece, backpointers, scores, final states and paths bitwise
    equal to the B single launches on that route and to the batched plain
    versions on the card. Returns ``[(route, pieces)]``."""
    b, t, v, s = log_b.shape
    h, isz = v + 1, log_b.dtype.itemsize
    n_sm = tri.sm_count(log_b.device)
    rb, rs, rl = tri.trigram_forward_plain(log_b, masks, *tabs)
    rp = tri.trigram_backtrace_plain(rb, rl)
    checked = []
    for route in trigram_routes(tri, (log_b[0], None, *tabs)):
        pieces = [(0, b)]
        if route == tri.trigram_route(h, v, s, isz, n_sm):
            pieces = tri.trigram_cut(b, t, h, v, s, isz, n_sm)
        require(all(tri.batch_fits(j - i, t, h, v, s, isz, n_sm, route) for i, j in pieces),
                f"{what}: a batch of {b} does not fit kernel H's {route} route in {pieces}")
        before = (tri.trigram_forward.launches, tri.trigram_backtrace.launches)
        outs = []
        for i, j in pieces:
            bts, score, last = tri._forward(log_b[i:j], masks[i:j], *tabs, route=route)
            outs.append((bts, score, last, tri.trigram_backtrace(bts, last)))
        made = (tri.trigram_forward.launches - before[0],
                tri.trigram_backtrace.launches - before[1])
        require(made == (len(pieces), len(pieces)), f"{what}, {route} route: {len(pieces)} "
                f"pieces launched H's forward and backtrace {made} times")
        bts, score, last, path = (torch.cat(x) if len(x) > 1 else x[0] for x in zip(*outs))
        del outs
        bad = []
        for r in range(b):
            sb, ss, sl = tri._forward(log_b[r], masks[r], *tabs, route=route)
            sp = tri.trigram_backtrace(sb, sl)
            if not (torch.equal(sb, bts[r]) and same_bits(torch, [ss[None]], [score[r:r + 1]])
                    and torch.equal(sl, last[r]) and torch.equal(sp, path[r])):
                bad.append(r)
        torch.cuda.synchronize()
        require(not bad, f"kernel H's batch ({what}, {route} route) differs from its single "
                         f"launches in rows {bad}")
        require(torch.equal(bts, rb) and same_bits(torch, [score], [rs]) and torch.equal(last, rl)
                and torch.equal(path, rp), f"kernel H's batch ({what}, {route} route) differs "
                f"from the batched plain versions: {int((bts != rb).sum())} backpointers, "
                f"scores {score.tolist()} vs {rs.tolist()}")
        checked.append((route, len(pieces)))
        del bts, path
    print(f"kernel H on a batch ({what}: B={b}, T={t}, V={v}, S={s}, {log_b.dtype}, valid frames "
          f"{masks.sum(1).tolist()}): routes and launches {checked}; backpointers, scores, final "
          f"states and paths bitwise equal to {b} single launches on each route and to the "
          f"batched plain versions on the card")
    return checked


def trigram_batch_phase(torch, entry, wrappers, card, launches):
    """The trigram graph's batch, one launch of each of H's kernels a batch
    (the JAX package's vmapped decode), at
    ``entry.parallel_serving(200, 8, graph="trigram", lm_order=3)``'s 8
    ragged bucketed segments, rows 2 and 5 planted with 6 words each:
    :func:`check_trigram_batch` on the batch's masks, on masks that differ
    at every kind of frame and at float64; the batch's features and
    ``decode_batch_arrays``, the counters reset just before, launch the mel
    frontend, H's forward (on its resident route) and H's backtrace once
    each, bitwise equal to looping ``decode_arrays`` and to the batched
    plain decode on the card, the planted rows decoding to their words; a
    24-row batch is cut by ``ops.trigram.trigram_cut`` into 2 launches of
    each, equal to the loop. Times the batched forward and backtrace
    against their 8 single launches (CUDA events over queued launches, in
    turns: batch, loop, loop, batch) and ``decode_batch`` against looping
    ``decode`` (host clock)."""
    from lnasr_tpu_torch.models.decoder import TrigramDecodingGraph
    from lnasr_tpu_torch.ops import trigram as tri

    t_phase = time.perf_counter()
    dev = torch.device(DEVICE)
    n_sm = tri.sm_count(dev)
    none = {w.__name__: 0 for w in wrappers}
    serve = entry.parallel_serving(200, BATCH_ROWS, device=dev, graph="trigram", lm_order=3)
    rec = serve.recognizer
    g = rec.graph
    require(isinstance(g, TrigramDecodingGraph) and rec.lm.ngram.order == 3,
            "parallel_serving(200, graph='trigram', lm_order=3) did not compose the trigram graph")
    feats, masks, planted = planted_rows(torch, g, rec.lm.ngram, serve.features, serve.masks)
    log_b = g._grid_log_b(feats)
    b, t_len, v, s = log_b.shape
    h = v + 1
    tabs = (g.inner_a, g.hop3, g.log_pi_w, g.final3, g._exit_idx32)
    require(tri.trigram_cut(b, t_len, h, v, s, 4, n_sm) == [(0, b)],
            f"the trigram batch of {b} does not fit one launch")
    routes = {"float32": check_trigram_batch(torch, tri, log_b, masks, tabs,
                                             "V=200 trigram batch")}
    routes["edges"] = check_trigram_batch(torch, tri, log_b, edge_masks(torch, masks), tabs,
                                          "V=200 trigram batch, masks at every kind of frame")
    tabs64 = tuple(x.double() if x.is_floating_point() else x for x in tabs)
    routes["float64"] = check_trigram_batch(torch, tri, log_b.double(), masks, tabs64,
                                            "V=200 trigram batch at float64")
    require(routes["float64"][0] == ("smem", 2),
            f"the float64 batch did not take its smem route in two pieces: {routes['float64']}")

    # the main path: the batch's features and decode_batch_arrays, the
    # counters reset just before
    signals, lengths = entry.parallel_serving_signals(BATCH_ROWS, 0)
    signals = torch.as_tensor(signals, device=dev)
    lengths = torch.as_tensor(lengths, device=dev)
    torch.cuda.synchronize()
    reset_counts(*wrappers)
    by_route = tri.trigram_forward.route_launches
    by_route.update(dict.fromkeys(by_route, 0))
    feats_m, masks_m = rec.am.mfcc.features_fast(signals, lengths=lengths)
    feats_m, masks_m, _ = planted_rows(torch, g, rec.lm.ngram, feats_m, masks_m)
    paths, scores = g.decode_batch_arrays(feats_m, masks_m)
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in wrappers}
    route_counts = dict(by_route)
    launches["V=200 trigram batch"] = counts
    on_path = {"mel_frontend": 1, "trigram_forward": 1, "trigram_backtrace": 1}
    require(counts == none | on_path, f"the trigram batch's features and decode_batch_arrays "
            f"launched {counts}, not the mel frontend, H's forward and H's backtrace once each")
    require(route_counts == {r: int(r == "resident") for r in tri.ROUTES},
            f"the trigram batch did not take H's resident route once: {route_counts}")
    require(torch.equal(feats_m, feats) and torch.equal(masks_m, masks),
            "the batch's features differ from entry.parallel_serving's")
    loop = [g.decode_arrays(feats[r], masks[r]) for r in range(b)]
    plain_p, plain_s = tri.trigram_viterbi_plain(log_b, masks, *tabs)
    require(torch.equal(paths, torch.stack([p for p, _ in loop]))
            and same_bits(torch, [scores], [torch.stack([x for _, x in loop])]),
            "the trigram decode_batch_arrays differs from looping decode_arrays")
    require(torch.equal(paths, plain_p) and same_bits(torch, [scores], [plain_s]),
            "the trigram decode_batch_arrays differs from the batched plain decode")
    got = g.decode_batch(feats, masks)
    for row, words in planted.items():
        require(got[row][0] == words, f"trigram batch planted row {row}: {words} decoded as "
                                      f"{got[row][0]}")
    require(all(np.isfinite(x[2]) for x in got), "trigram decode_batch: a score not finite")
    print(f"main path: features_fast + TrigramDecodingGraph.decode_batch_arrays at V=200 (B={b}, "
          f"T={t_len}, valid frames {masks.sum(1).tolist()}, rows {sorted(planted)} planted): "
          f"launches {counts}, H's forward by route {route_counts}; paths and scores bitwise "
          f"equal to looping decode_arrays and to the batched plain decode on the card; "
          f"decode_batch's words {[x[0] for x in got]}, the planted rows their words")

    # a batch past one launch: cut by the stated rule
    signals, lengths = entry.parallel_serving_signals(TRIGRAM_CUT_ROWS, 0)
    f24, m24 = rec.am.mfcc.features_fast(torch.as_tensor(signals, device=dev),
                                         lengths=torch.as_tensor(lengths, device=dev))
    pieces = tri.trigram_cut(TRIGRAM_CUT_ROWS, f24.shape[1], h, v, s, 4, n_sm)
    require(len(pieces) == 2, f"the {TRIGRAM_CUT_ROWS}-row trigram batch was cut into {pieces}")
    torch.cuda.synchronize()
    reset_counts(*wrappers)
    p24, s24 = g.decode_batch_arrays(f24, m24)
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in wrappers}
    launches["V=200 trigram cut batch"] = counts
    require(counts == none | {"trigram_forward": 2, "trigram_backtrace": 2},
            f"the cut trigram batch launched {counts}, the cut has {len(pieces)} pieces")
    loop = [g.decode_arrays(f24[r], m24[r]) for r in range(TRIGRAM_CUT_ROWS)]
    require(torch.equal(p24, torch.stack([p for p, _ in loop]))
            and same_bits(torch, [s24], [torch.stack([x for _, x in loop])]),
            "the cut trigram batch differs from looping decode_arrays")
    bts_gb = 4 * TRIGRAM_CUT_ROWS * (f24.shape[1] - 1) * h * v * s / 1e9
    print(f"main path: decode_batch_arrays of {TRIGRAM_CUT_ROWS} rows at V=200 (backpointers "
          f"{bts_gb:.2f} GB at one launch, budget {tri.BTS_BUDGET / 1e9:.2f} GB): trigram_cut "
          f"gives {pieces}; launches {counts}; paths and scores bitwise equal to looping "
          f"decode_arrays")
    del f24, m24, p24, loop

    # times: one batched launch against its B single launches, in turns
    bts, _, last = tri.trigram_forward(log_b, masks, *tabs)
    singles = [tri.trigram_forward(log_b[r], masks[r], *tabs) for r in range(b)]
    runs = {"forward": (lambda: tri.trigram_forward(log_b, masks, *tabs),
                        lambda: [tri.trigram_forward(log_b[r], masks[r], *tabs)
                                 for r in range(b)], 4),
            "backtrace": (lambda: tri.trigram_backtrace(bts, last),
                          lambda: [tri.trigram_backtrace(x[0], x[2]) for x in singles], 12)}
    times = {}
    for key, (batched, looped, n) in runs.items():
        times[key] = (burst_ms(batched, launches=n), burst_ms(looped, launches=n // 4),
                      burst_ms(looped, launches=n // 4), burst_ms(batched, launches=n))
    del bts, singles
    batch_ms = host_ms(lambda: g.decode_batch(feats, masks), reps=5)
    loop_ms = host_ms(lambda: [g.decode(feats[r], masks[r]) for r in range(b)], reps=5)
    # bounds: hop3 and the small tables read once, each utterance's emission
    # rows of frame 0 and its valid steps, every backpointer frame written;
    # each valid step's within-word and hop adds and maxes. The walk: a
    # pointer a step of each utterance read, its path written
    steps = int(masks[:, 1:].sum())
    f_bytes = (4 * (h * v * v + v * s * s + v + h * v) + 4 * v + 4 * (b + steps) * v * s
               + b * t_len + 4 * b * (t_len - 1) * h * v * s + 8 * b)
    bounds = {"forward": bound(f_bytes, steps * 2 * (h * v * s * s + h * v * v)),
              "backtrace": bound(4 * b * (2 * t_len + 1), 0)}
    for key in ("forward", "backtrace"):
        tb, tl = (times[key][0] + times[key][3]) / 2, (times[key][1] + times[key][2]) / 2
        print(f"timing on {card}: kernel H {key} at V=200, B={b}, T={t_len}, {steps} valid steps: "
              f"one batched launch {times[key][0]:.4f} / {times[key][3]:.4f} ms, the {b} single "
              f"launches {times[key][1]:.4f} / {times[key][2]:.4f} ms (CUDA events over queued "
              f"launches, in turns: batch, loop, loop, batch); {tl / tb:.2f}x; the batch's bound "
              f"{bounds[key][0]:.5f} ms by {bounds[key][1]}")
    print(f"timing on {card}: trigram decode_batch at V=200, B={b}: {batch_ms:.4f} ms, looping "
          f"decode over the rows {loop_ms:.4f} ms (host clock, each ending in its copies back; "
          f"median of 5); {loop_ms / batch_ms:.2f}x")
    print(f"trigram batch phase: {time.perf_counter() - t_phase:.1f} s")
    return {"b": b, "t": t_len, "steps": steps, "times": times, "decode_batch_ms": batch_ms,
            "decode_loop_ms": loop_ms, "bounds": bounds, "cut": pieces, "routes": routes}


# The GMM recursion's operations a frame, each once, as one frame of the
# sequential algorithm does them (adds, subtractions, products, divisions,
# min/max, compares, expf/log2f; moves and selects not counted; the
# kernel's second outcome and its lanes' repeats are not the function's
# work). Per channel: the decision 67 (four Gaussians of
# 10 each, their weights 4, the two log2 shifts 8, the posteriors 9, the
# two sums, the ratio and its local test 6), the minimum tracker 57 (the
# walk's 16 compares and at most 16 increments, the insertion's 16
# compares, the smoothed minimum 9) and the adaptation 102; once a frame,
# the 6-channel sum, the two tests and the hangover, 11
GMM_OPS_PER_FRAME = 6 * (67 + 57 + 102) + 11


def vad_phase(torch, entry, wrappers, card, launches):
    """The device VADs on the stream's audio: LTSD (fixed and adaptive) on
    the card against the CPU; the WebRTC-style torch VAD in modes 0-3, each
    ``process`` call launching kernel I once (its counters reset just
    before), its flags equal to the plain frame loop on the card's own
    features, to the same module on CPU tensors and to the native
    detector; kernel I's final state bitwise the plain loop's, and in mode
    0 the same at float64; then I alone, flags and state bitwise, at the
    edges of its ring (F = 0, 1, a stage of 128 frames and the ring of
    three +-1, and past them) and on runs of frames without power. Times I
    by CUDA events and the plain loop on the card."""
    from lnasr_tpu_torch.config import LTSDConfig
    from lnasr_tpu_torch.vad import VadLtsd, WebRtcVad, WebRtcVadTorch
    from lnasr_tpu_torch.vad import webrtc as tweb

    audio = entry.serving_stream(0)
    audio_s = len(audio) / 16000
    x = audio.astype(np.float64) / 32768.0
    out = {}
    threads = torch.get_num_threads()
    for alpha in (None, 0.4):
        cfg = LTSDConfig(alpha=alpha)
        name = f"ltsd {'adaptive' if alpha else 'fixed'}"
        # float64 on both sides: the JAX package's own LTSD bar
        got = VadLtsd(cfg, dtype=torch.float64, device=DEVICE).detect(x).ltsd.cpu().numpy()
        ref = VadLtsd(cfg, dtype=torch.float64, device="cpu").detect(x).ltsd.numpy()
        require(np.allclose(got, ref, rtol=1e-8, atol=1e-10),
                f"{name}: card vs CPU float64 scores differ by {np.abs(got - ref).max()}")
        vad = VadLtsd(cfg, device=DEVICE)
        vad.detect(x)
        torch.cuda.synchronize()
        reset_counts(*wrappers)
        got32 = vad.detect(x).ltsd.cpu().numpy()
        counts = {w.__name__: w.launches for w in wrappers}
        want = {n: int(alpha is not None and n == "ltsd_noise") for n in counts}
        require(counts == want, f"{name}: detect launched {counts}, expected {want}")
        launches[name] = counts
        ms = host_ms(lambda: vad.detect(x).ltsd.cpu(), reps=5, warmup=1)
        out[name] = ms / audio_s
        print(f"{name} VAD on the stream ({audio_s} s, {len(got)} frames): card equal to CPU in "
              f"float64 (rtol 1e-8, atol 1e-10; max err {np.abs(got - ref).max():.3g}); float32 "
              f"on the card {np.abs(got32 - ref).max():.3g} dB from the float64 scores, "
              f"{int((got32 > cfg.threshold).sum())} vs {int((ref > cfg.threshold).sum())} speech "
              f"frames; launches {counts}; {ms:.4f} ms = {ms / audio_s:.4f} ms per second of "
              f"audio on {card} (host clock, one device->host copy)")
    out["ltsd_noise"] = check_ltsd_noise(torch, audio, card)

    sig = torch.as_tensor(audio, device=DEVICE)
    n_frames = len(audio) // tweb.FRAME_LEN_16K
    feats, total, _ = tweb.extract_features(
        sig[: n_frames * tweb.FRAME_LEN_16K].to(torch.float32),
        tweb.initial_filter_state(torch.float32, DEVICE))

    def same_state(got, ref, what):
        """Kernel I's final GMM state bit for bit the plain loop's; returns
        the largest absolute difference of its values (0.0)."""
        worst = 0.0
        for name in tweb.GmmState._fields:
            a, b = getattr(got, name), getattr(ref, name)
            err = float((a.double() - b.double()).abs().max())
            require(a.dtype == b.dtype and torch.equal(a, b)
                    and (not a.is_floating_point() or same_bits(torch, [a], [b])),
                    f"kernel I {what}: final {name} differs from the plain loop's (max err {err})")
            worst = max(worst, err)
        return worst

    total_launches = {w.__name__: 0 for w in wrappers}
    whole = (audio, feats, total)
    for mode in range(4):
        # mode 0 on the whole stream, modes 1-3 on its first VAD_MODE_SECONDS
        audio, feats, total = whole
        if mode:
            audio = audio[:VAD_MODE_SECONDS * 16000]
            feats, total, _ = tweb.extract_features(
                sig[: len(audio) // tweb.FRAME_LEN_16K * tweb.FRAME_LEN_16K].to(torch.float32),
                tweb.initial_filter_state(torch.float32, DEVICE))
        det = WebRtcVadTorch(mode=mode, device=DEVICE)
        det.process(audio)  # the first call out of the count and the timing
        torch.cuda.synchronize()
        reset_counts(*wrappers)
        flags = det.process(audio)
        counts = {w.__name__: w.launches for w in wrappers}
        require(counts["gmm_flags"] == 1 and all(c == 0 for n, c in counts.items()
                                                 if n != "gmm_flags"),
                f"WebRtcVadTorch mode {mode}: process launched {counts}, not kernel I once")
        total_launches = {n: total_launches[n] + c for n, c in counts.items()}
        ms = host_ms(lambda: det.process(audio), reps=5, warmup=0)
        thr = tweb.MODE_TABLE[mode]
        k_flags, k_state = tweb.gmm_flags(feats, total, thr, final_state=True)
        t0 = time.perf_counter()
        p_flags, p_state = tweb.gmm_flags_plain(feats, total, thr, final_state=True)
        torch.cuda.synchronize()
        plain_ms = (time.perf_counter() - t0) * 1e3
        torch.set_num_threads(1)  # the frame loop's tiny ops run faster on one thread
        try:
            flags_cpu = WebRtcVadTorch(mode=mode, device="cpu").process(audio)
        finally:
            torch.set_num_threads(threads)
        native = WebRtcVad(mode=mode).process(audio)
        require(np.array_equal(flags, k_flags.cpu().numpy()),
                f"WebRtcVadTorch mode {mode}: process and gmm_flags on its features differ")
        require(torch.equal(k_flags, p_flags), f"kernel I mode {mode}: flags differ from the "
                f"plain loop on the card on {int((k_flags != p_flags).sum())} frames")
        require(np.array_equal(flags, flags_cpu), f"WebRtcVadTorch mode {mode}: card != CPU "
                f"on {int((flags != flags_cpu).sum())} frames")
        require(np.array_equal(flags, native), f"WebRtcVadTorch mode {mode}: card != native "
                f"on {int((flags != native).sum())} frames")
        state_err = same_state(k_state, p_state, f"mode {mode}")
        k_ms = cuda_ms(lambda: tweb.gmm_flags(feats, total, thr), reps=5, warmup=1)
        piece_s = len(audio) / 16000
        out[f"webrtc mode {mode}"] = ms / piece_s
        out[f"gmm mode {mode}"] = {"ms": k_ms, "plain_ms": plain_ms, "state_err": state_err,
                                   "seconds": piece_s}
        print(f"WebRtcVadTorch mode {mode} on {piece_s} s of the stream ({len(flags)} frames, "
              f"{int((flags > 0).sum())} flagged): kernel I once a call; flags equal to the plain "
              f"loop on the card, the CPU run and the native detector frame for frame; final "
              f"state bitwise the plain loop's; process {ms:.3f} ms = "
              f"{ms / piece_s:.4f} ms per second of audio on {card} (host clock); kernel I "
              f"{k_ms:.4f} ms ({1e3 * k_ms / len(flags):.3f} us a frame, CUDA events), plain "
              f"loop on the card {plain_ms:.1f} ms")
    audio, feats, total = whole
    launches["webrtc vad"] = total_launches
    thr = tweb.MODE_TABLE[0]
    # the float64 instantiation (webrtc_vad_flags(dtype=torch.float64)) on the
    # float64 filterbank's features
    feats64, total64, _ = tweb.extract_features(
        sig[: n_frames * tweb.FRAME_LEN_16K].to(torch.float64),
        tweb.initial_filter_state(torch.float64, DEVICE))
    k_flags, k_state = tweb.gmm_flags(feats64, total64, thr, final_state=True)
    p_flags, p_state = tweb.gmm_flags_plain(feats64, total64, thr, final_state=True)
    require(k_flags.dtype == torch.int32 and torch.equal(k_flags, p_flags),
            f"kernel I mode 0 float64: flags differ from the plain loop on the card on "
            f"{int((k_flags != p_flags).sum())} frames")
    same_state(k_state, p_state, "mode 0 float64")
    print(f"kernel I mode 0 at float64 on the stream's float64 features ({n_frames} frames, "
          f"{int((k_flags > 0).sum())} flagged): flags equal to the plain loop on the card and "
          f"the final state bitwise its own")
    # the ring's edges (stages of 128 frames, three in the ring): no frame,
    # one, a stage and a ring +-1, and past them; then runs without power
    quiet = total[:1025].clone()
    for start, stop in ((0, 3), (120, 140), (250, 262), (383, 384), (500, 650), (1000, 1025)):
        quiet[start:stop] = 0.0
    cases = [(feats[:n], total[:n], f"F = {n}")
             for n in (0, 1, 127, 128, 129, 384, 385, 511, 512, 513, 1025)]
    cases.append((feats[:1025], quiet, f"F = 1025, {int((quiet <= 10).sum())} frames without "
                  "power in 6 runs"))
    for mode in (0, 3):
        for f_in, t_in, what in cases if mode == 0 else cases[-1:]:
            before = tweb.gmm_flags.launches
            k_flags, k_state = tweb.gmm_flags(f_in, t_in, tweb.MODE_TABLE[mode], final_state=True)
            p_flags, p_state = tweb.gmm_flags_plain(f_in, t_in, tweb.MODE_TABLE[mode],
                                                    final_state=True)
            require(tweb.gmm_flags.launches == before + 1 and torch.equal(k_flags, p_flags),
                    f"kernel I mode {mode}, {what}: flags differ from the plain loop on the card "
                    f"on {int((k_flags != p_flags).sum())} frames")
            same_state(k_state, p_state, f"mode {mode}, {what}")
    print(f"kernel I at the ring's edges ({', '.join(w for _, _, w in cases[:-1])}; mode 0) and "
          f"with {cases[-1][2]} (modes 0 and 3): one launch each, flags equal to the plain loop "
          f"on the card and the final state bitwise its own")
    # I's float divisions take __fdiv_rn's fast path where their operands
    # lie in [2^-50, 2^50): held to __fdiv_rn on random pairs there
    from lnasr_tpu_torch import _build

    lib = _build.load("webrtc_gmm", tweb._GMM_ARGTYPES)
    lib.webrtc_gmm_div_check.argtypes = [ctypes.c_ulonglong, ctypes.c_ulonglong,
                                         ctypes.c_void_p, ctypes.c_void_p]
    pairs, differ = 1 << 34, torch.zeros(1, dtype=torch.int64, device=DEVICE)
    rc = lib.webrtc_gmm_div_check(pairs, 16, differ.data_ptr(),
                                  torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    require(rc == 0 and int(differ) == 0, f"kernel I's fast division differs from __fdiv_rn "
            f"on {int(differ)} of {pairs} pairs (rc {rc})")
    print(f"kernel I's fast float division: equal to __fdiv_rn on all {pairs} random operand pairs "
          "in [2^-50, 2^50)")
    prof = kernel_device_ms(torch, lambda: tweb.gmm_flags(feats, total, thr), "webrtc_gmm",
                            calls=3)
    wrapper_ms = cuda_ms(lambda: tweb.gmm_flags(feats, total, thr), reps=5)
    i_bound = bound(4 * n_frames * (6 + 1 + 1), n_frames * GMM_OPS_PER_FRAME)
    print(f"timing on {card}: kernel I at the stream's {n_frames} frames: profiler "
          f"{prof[0]:.4f} ms ({prof[1]} of 3 launches recorded in window {prof[2]}), the wrapper "
          f"call {wrapper_ms:.4f} ms; bound {i_bound[0]:.6f} ms by {i_bound[1]} (the frames' "
          f"dependency chain is what sets its time)")
    out["gmm"] = {"ms": out["gmm mode 0"]["ms"], "plain_ms": out["gmm mode 0"]["plain_ms"],
                  "profiler_ms": prof[0], "profiler_launches": prof[1], "wrapper_ms": wrapper_ms,
                  "bound": i_bound, "frames": n_frames,
                  "state_err": max(out[f"gmm mode {m}"]["state_err"] for m in range(4))}
    return out


def same_or_nan(torch, got, ref):
    """Float tensors equal bit for bit where ``ref`` is not NaN, NaN where it
    is (a NaN's payload and sign are not compared)."""
    nan = torch.isnan(ref)
    if not torch.equal(nan, torch.isnan(got)):
        return False
    return same_bits(torch, [torch.where(nan, 0.0, got)], [torch.where(nan, 0.0, ref)])


def finite_err(torch, got, ref):
    """Largest ``|got - ref|`` where both are finite (0.0 where none is)."""
    both = torch.isfinite(got) & torch.isfinite(ref)
    return float((got - ref)[both].abs().max()) if bool(both.any()) else 0.0


def parent_ltsd_loop(torch, ltse, noise, config):
    """The adaptive LTSD's frame loop as the port ran it before kernel J
    (~15 torch ops a frame, sums in torch's order): kept to time what J
    replaced, never on a path."""
    alpha = config.alpha
    scores = torch.zeros(ltse.shape[:-1], dtype=ltse.dtype, device=ltse.device)
    for t in range(config.order, ltse.shape[-2] - config.order):
        ltse_t = ltse[..., t, :]
        ratio = (ltse_t * ltse_t / noise).sum(dim=-1)
        score = 10.0 * torch.log10(torch.clamp(ratio / config.win_size, min=1e-30))
        adapted = alpha * noise + (1.0 - alpha) * (ltse_t.sum(dim=-1) / config.win_size)[..., None]
        noise = torch.where((score < config.threshold)[..., None], adapted, noise)
        scores[..., t] = score
    return scores


def alternating_ltse(torch, dtype, t_len=400, f=1025, seed=12):
    """Seeded LTSE ``(t_len, f)`` and noise ``(f,)`` whose frames alternate
    quiet and loud (x100): at :data:`ALTERNATING_THRESHOLD` the adaptive
    LTSD's flag alternates frame by frame (the CPU test's case,
    tests/test_torch_ltsd_kernel.py)."""
    rng = np.random.default_rng(seed)
    x = rng.random((t_len, f)) * 10.0 ** rng.uniform(-2, 1, size=(t_len, f))
    x = x * np.where(np.arange(t_len) % 2 == 1, 100.0, 1.0)[:, None]
    noise = (rng.random(f) + 0.1) ** 2
    return (torch.as_tensor(x, dtype=dtype, device=DEVICE),
            torch.as_tensor(noise, dtype=dtype, device=DEVICE))


ALTERNATING_THRESHOLD = 27.0


def check_ltsd_noise(torch, audio, card):
    """Kernel J (``vad.ltsd.ltsd_noise``: the rows pass and the recursion,
    two kernels a call) bit for bit against its plain loop on the card
    (NaN where it has NaN), one launch a call, at float32 and float64 on
    the stream (at the default threshold, at 15 dB, where most frames
    adapt, at 200 dB, where every frame adapts, at -200 dB, where none
    does, and with windows of 256, 512, 4096, 5954, 10240 and 16382
    samples: 129, 257, 2049, 2978, 5121 and 8192 bins on 1, 2, 13, 19, 31
    and 31 division warps an utterance at float32 (5, 5, 5, 5, 6 and 9 bins
    a lane), 2, 3, 22, 31, 31 and 31 at float64 (3, 3, 3, 4, 6 and 9 bins a
    lane: past 2976 bins at float64 and 4960 at float32 the 31 warps take
    more bins than the rule aims at), against the default's 7 and 11), an
    LTSE whose flag alternates frame by frame, a batch of three 20 s
    pieces of the stream, its first 20 s with 1 s of digital silence in
    front (noise 0: NaN and inf scores; the float recursion runs that
    utterance with the IEEE division) and a 0.6 s signal (no frame in the
    valid band); then J on the stream at float32 (the adaptive
    ``detect``'s dtype) by CUDA events over back-to-back launches and
    torch.profiler, its two kernels apart, beside the plain loop, the loop
    the port ran before J and the chain floor (J at one frequency bin, on
    one warp), with J's bound."""
    from lnasr_tpu_torch.config import LTSDConfig
    from lnasr_tpu_torch.vad import ltsd

    cfg = LTSDConfig(alpha=0.4)
    x = torch.as_tensor(audio.astype(np.float64) / 32768.0, device=DEVICE)
    piece = 20 * 16000
    silent = x[:piece].clone()
    silent[:16000] = 0.0
    adapting = LTSDConfig(alpha=0.4, threshold=15.0)  # most frames adapt the noise
    signals = {"stream": (x, cfg), "stream at 15 dB": (x, adapting),
               "stream at 200 dB": (x, LTSDConfig(alpha=0.4, threshold=200.0)),
               "stream at -200 dB": (x, LTSDConfig(alpha=0.4, threshold=-200.0)),
               "stream, window 256": (x, LTSDConfig(alpha=0.4, win_size=256, step_size=128)),
               "stream, window 512": (x, LTSDConfig(alpha=0.4, win_size=512, step_size=256)),
               "stream, window 4096": (x, LTSDConfig(alpha=0.4, win_size=4096, step_size=2048)),
               **{f"stream, window {w}": (x, LTSDConfig(alpha=0.4, win_size=w, step_size=w // 2))
                  for w in (5954, 10240, 16382)},
               "alternating flag": (None, LTSDConfig(alpha=0.4,
                                                     threshold=ALTERNATING_THRESHOLD)),
               "batch of 3": (torch.stack([x[k * piece:(k + 1) * piece] for k in range(3)]), cfg),
               "1 s of zeros in front": (silent, cfg), "0.6 s": (x[:9600], cfg)}

    def inputs(sig, dtype, c=cfg):
        if sig is None:
            return alternating_ltse(torch, dtype)
        amps = ltsd._amplitudes(sig, c, dtype)
        return ltsd._ltse(amps, c.order), amps[..., :2, :].mean(dim=-2) ** 2

    lines, nan_frames, err = [], 0, 0.0
    for dtype in (torch.float32, torch.float64):
        for what, (sig, c) in signals.items():
            ltse, noise = inputs(sig, dtype, c)
            before = ltsd.ltsd_noise.launches
            got = ltsd.ltsd_noise(ltse, noise, c)
            ref = ltsd.ltsd_noise_plain(ltse, noise, c)
            torch.cuda.synchronize()
            require(ltsd.ltsd_noise.launches == before + 1 and got.dtype == dtype
                    and got.shape == ref.shape and same_or_nan(torch, got, ref),
                    f"kernel J {what} {dtype}: differs from the plain loop on the card on "
                    f"{int((got != ref).sum())} frames")
            nan_frames += int(torch.isnan(got).sum())
            err = max(err, finite_err(torch, got, ref))
            band = ref[..., c.order:ref.shape[-1] - c.order]
            flags = band < c.threshold
            if what == "alternating flag":
                require(bool((flags[1:] != flags[:-1]).all()),
                        f"kernel J's alternating case ({dtype}): the flag does not alternate")
            if what in ("stream at 200 dB", "stream at -200 dB"):  # all adapt, or none
                every = what == "stream at 200 dB"
                require(bool((flags | torch.isnan(band)).all() if every else not flags.any()),
                        f"kernel J {what} ({dtype}): {int(flags.sum())} of {int(flags.numel())} "
                        f"frames adapt")
            if dtype == torch.float32:
                lines.append(f"{what} {tuple(ltse.shape)}, {ltsd.ltsd_warps(ltse.shape[-1])} "
                             f"warps ({ltsd.ltsd_warps(ltse.shape[-1], 8)} at float64): "
                             f"{int(band.numel())} valid frames, "
                             f"{int(torch.isnan(band).sum())} NaN, {int(torch.isinf(band).sum())} "
                             f"inf, {int(flags.sum())} adapted")
    require(nan_frames > 0, "kernel J's checks met no NaN score (the silent start)")
    print("kernel J vs its plain loop on the card, float32 and float64, bit for bit (NaN where "
          "it has NaN), one launch a call: " + "; ".join(lines))

    ltse, noise = inputs(x, torch.float32)
    t_len, f = ltse.shape
    fn = lambda: ltsd.ltsd_noise(ltse, noise, cfg)  # noqa: E731
    ms = burst_ms(fn, launches=10)
    wrapper_ms = cuda_ms(fn, reps=10)
    prof = profiled_device(torch, fn, calls=5)
    one = (ltse[:, :1].contiguous(), noise[:1].contiguous())  # a lane's one bin: the chain
    floor_ms = burst_ms(lambda: ltsd.ltsd_noise(*one, cfg), launches=10)
    # a call's two kernels, apart
    rows = torch.empty((t_len * ltsd.ltsd_row(f, 4),), dtype=torch.float32, device=DEVICE)
    scores = torch.empty(t_len, dtype=torch.float32, device=DEVICE)
    ltsd._rows_pass(ltse, cfg, rows)
    rows_ms = burst_ms(lambda: ltsd._rows_pass(ltse, cfg, rows), launches=10)
    recursion_ms = burst_ms(lambda: ltsd._recursion(rows, noise, cfg, scores), launches=10)
    ref = ltsd.ltsd_noise_plain(ltse, noise, cfg)
    plain_ms = cuda_ms(lambda: ltsd.ltsd_noise_plain(ltse, noise, cfg), reps=2, warmup=0)
    parent = parent_ltsd_loop(torch, ltse, noise, cfg)
    parent_ms = cuda_ms(lambda: parent_ltsd_loop(torch, ltse, noise, cfg), reps=2, warmup=0)
    valid = t_len - 2 * cfg.order
    adapted = int((ref[cfg.order:t_len - cfg.order] < cfg.threshold).sum())
    # the LTSE rows of the valid frames and the noise read once, the scores
    # written; a square, a division and two adds a bin and frame, a multiply
    # and an add a bin on the frames that adapt
    j_bound = bound(4 * (valid * f + f + t_len), 4 * valid * f + 2 * adapted * f)
    close = float((parent - ref)[cfg.order:t_len - cfg.order].abs().max())
    print(f"timing on {card}: kernel J on the stream's {valid} valid frames of {f} bins "
          f"(float32): {ms:.4f} ms (CUDA events, back-to-back launches), profiler "
          f"{prof[0]:.4f} ms ({prof[1]} kernels recorded of 5 calls, two a call, in window "
          f"{prof[2]}; the rows pass {rows_ms:.4f} ms, the recursion {recursion_ms:.4f} ms), the "
          f"wrapper call {wrapper_ms:.4f} ms; chain floor (one bin) {floor_ms:.4f} ms; the plain "
          f"loop on the card {plain_ms:.1f} ms, the loop before J {parent_ms:.1f} ms (CUDA events; "
          f"its scores {close:.3g} dB from the plain loop's: torch's order of sums); bound "
          f"{j_bound[0]:.6f} ms by {j_bound[1]}")
    return {"ms": ms, "wrapper_ms": wrapper_ms, "profiler_ms": prof[0],
            "profiler_launches": prof[1], "floor_ms": floor_ms, "plain_ms": plain_ms,
            "parent_ms": parent_ms, "bound": j_bound, "frames": valid, "bins": f, "err": err,
            "rows_ms": rows_ms, "recursion_ms": recursion_ms}


# kernel K's checks: (N, B, T, kind); every route that takes N, float32 and
# float64. T = 9000 at N = 32 and T = 2000 at N = 1024 keep the backpointers
# off chip and grow the backtrace's chunks past 32 steps; the warp route at
# N = 1-8, 9, 16 and 32, T = 1, 2, 33 (a group and a frame at float32, two
# groups and a frame at float64), 64 and 999, and "first": every frame
# after frame 0 masked in every row
TRELLIS_CASES = [(5, 3, 40, "random"), (5, 3, 40, "ties"), (5, 3, 40, "inf"), (5, 3, 40, "dead"),
                 (1, 3, 17, "random"), (1, 2, 1, "final"), (5, 2, 1, "final"), (8, 2, 2, "inf"),
                 (9, 3, 50, "ties"), (16, 2, 33, "inf"), (32, 2, 9000, "random"),
                 (2, 3, 33, "random"), (3, 2, 2, "ties"), (4, 3, 33, "first"),
                 (6, 2, 1, "random"), (7, 3, 64, "inf"), (8, 3, 999, "random"),
                 (1, 2, 33, "first"), (16, 2, 2, "first"), (32, 2, 33, "first"),
                 (5, 64, 999, "first"),
                 (33, 3, 20, "final"), (33, 3, 20, "inf"), (179, 2, 300, "ties"),
                 (1024, 1, 2000, "random")]


def trellis_inputs(torch, rng, n, b, t, kind, dtype, dev):
    """``(log_pi, log_a, log_b, mask, log_final)`` on ``dev``: ragged masks
    (full, a 1-frame utterance, holes inside); ``ties`` quantized, ``inf``
    an unreachable state, a dead end, ``-inf`` emissions and endings,
    ``dead`` every ending ``-inf``, ``final`` random ending weights,
    ``first`` every frame after frame 0 masked (the CPU test's cases,
    tests/test_torch_viterbi_trellis.py)."""
    log_a = np.log(rng.dirichlet(np.ones(n), size=n))
    log_pi = np.log(rng.dirichlet(np.ones(n)))
    log_b = rng.normal(size=(b, t, n))
    lengths = np.array([t, 1, max(1, t - 3)][:b] + [t] * max(0, b - 3))
    mask = np.arange(t)[None, :] < lengths[:, None]
    if b > 2 and t > 6:
        mask[2, 2:4] = False
    log_final = None
    with np.errstate(divide="ignore"):
        if kind == "ties":
            log_a, log_pi = np.round(log_a), np.zeros(n)
            log_b = np.round(log_b * 2.0) / 2.0
        elif kind == "inf":
            if n > 2:
                log_a[:, 1] = -np.inf
                log_a[2, :] = -np.inf
            log_pi[n // 2] = -np.inf
            log_b[rng.random(log_b.shape) < 0.1] = -np.inf
            log_final = np.where(rng.random(n) < 0.5, -np.inf, rng.normal(size=n))
            log_final[0] = 0.0
        elif kind == "dead":
            log_final = np.full(n, -np.inf)
        elif kind == "final":
            log_final = rng.normal(size=n)
        elif kind == "first":
            mask[:, 1:] = False
    on = lambda v: None if v is None else torch.as_tensor(v, dtype=dtype, device=dev)  # noqa: E731
    return (on(log_pi), on(log_a), on(log_b), torch.as_tensor(mask, device=dev), on(log_final))


def same_trellis(torch, got, ref):
    """Kernel K's four outputs bit for bit the plain loop's."""
    return (same_bits(torch, [got.scores, got.score], [ref.scores, ref.score])
            and got.backptr.dtype == ref.backptr.dtype == torch.int32
            and torch.equal(got.backptr, ref.backptr) and torch.equal(got.path, ref.path))


def check_trellis(torch, tr, dev):
    """Kernel K against ``viterbi_scan_plain`` on the card, all four
    outputs bit for bit, on :data:`TRELLIS_CASES` at float32 and float64,
    on every route that takes N (forced), two launches bitwise."""
    lines = []
    for k, (n, b, t, kind) in enumerate(TRELLIS_CASES):
        routes = ["warp", "block"] if n <= 32 else ["block"]
        for dtype in (torch.float32, torch.float64):
            args = trellis_inputs(torch, np.random.default_rng(90 + k), n, b, t, kind, dtype, dev)
            ref = tr.viterbi_scan_plain(*args)
            for route in routes:
                got = tr._viterbi_launch(*args, route=route)
                again = tr._viterbi_launch(*args, route=route)
                torch.cuda.synchronize()
                require(same_trellis(torch, got, ref) and same_trellis(torch, again, got),
                        f"kernel K N={n} B={b} T={t} {kind} {dtype} {route}: differs from the "
                        f"plain loop (path on {int((got.path != ref.path).sum())} frames, "
                        f"backpointers on {int((got.backptr != ref.backptr).sum())})")
        c, chunk = tr.viterbi_chunks(t, n, routes[0])
        lines.append(f"N={n} B={b} T={t} {kind} ({'/'.join(routes)}; chunks {c}x{chunk}"
                     + (", backpointers off chip" if routes[0] == "warp"
                        and not tr.viterbi_on_chip(t, n, "warp") else "") + ")")
    print("kernel K vs viterbi_scan_plain on the card, float32 and float64, every route forced, "
          "scores, backpointers, path and score bit for bit, two launches bitwise: "
          + "; ".join(lines))


def trellis_phase(torch, entry, wrappers, card, launches):
    """Kernel K, the Viterbi trellis behind every HMM decode:
    :func:`check_trellis`; then ``GMMHMM.decode_batch`` at the flagship's
    width (B = 64 x 10 s of ``entry.training`` features, 5 x 8 x 39
    diagonal, seeded ragged lengths) with the counters reset just before:
    K once and nothing else, its paths the plain loop's on the card's own
    emissions and within 0.999 of the CPU decode's frames; K timed by CUDA
    events over back-to-back launches and torch.profiler, beside the plain
    loop on the card (the port's ``viterbi_scan`` before K), the wrapper
    call, ``decode_batch`` end to end and the chain floor (K at N = 1 on
    the same batch and mask), with K's bound."""
    from lnasr_tpu_torch.ops import trellis as tr

    check_trellis(torch, tr, torch.device(DEVICE))
    model = entry.flagship_model(DEVICE)
    run = entry.training(device=DEVICE)
    feats = run.features
    b, t, _ = feats.shape
    lengths = np.random.default_rng(17).integers(t // 3, t + 1, size=b)
    lengths[0] = t
    mask = torch.as_tensor(np.arange(t)[None, :] < lengths[:, None], device=DEVICE)
    model.decode_batch(feats, mask)
    torch.cuda.synchronize()
    reset_counts(*wrappers)
    by_route = tr.viterbi_scan.route_launches
    by_route.update(dict.fromkeys(by_route, 0))
    paths = model.decode_batch(feats, mask)
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in wrappers}
    route_counts = dict(by_route)
    launches["gmmhmm decode"] = counts
    want = {n: int(n == "viterbi_scan") for n in counts}
    require(counts == want, f"GMMHMM.decode_batch launched {counts}, expected {want}")
    route = [r for r, c in route_counts.items() if c]
    require(len(route) == 1, f"GMMHMM.decode_batch: kernel K's launches by route {route_counts}")
    log_b = model.emissions(feats)
    args = (model.log_pi, model.log_a, log_b, mask)
    ref = tr.viterbi_scan_plain(*args)
    plain_ms = cuda_ms(lambda: tr.viterbi_scan_plain(*args), reps=2, warmup=0)
    got = tr.viterbi_scan(*args)
    require(same_trellis(torch, got, ref) and torch.equal(paths, ref.path),
            f"GMMHMM.decode_batch: kernel K differs from the plain loop on the card on "
            f"{int((got.path != ref.path).sum())} frames")
    err = max(finite_err(torch, got.scores, ref.scores), finite_err(torch, got.score, ref.score))
    model_cpu = entry.flagship_model("cpu")
    paths_c = model_cpu.decode_batch(feats.cpu(), mask.cpu())
    agree = float((paths.cpu() == paths_c).float().mean())
    require(agree >= 0.999, f"GMMHMM.decode_batch: card and CPU paths agree on {agree} of frames")
    tail = all(bool((paths[i, lengths[i]:] == paths[i, lengths[i] - 1]).all()) for i in range(b))
    require(tail, "a masked tail does not repeat the last valid state")
    fn = lambda: tr.viterbi_scan(*args)  # noqa: E731
    ms = burst_ms(fn)
    wrapper_ms = cuda_ms(fn, reps=20)
    prof = profiled_device(torch, fn, calls=10)
    one = (torch.zeros(1, device=DEVICE), torch.zeros((1, 1), device=DEVICE),
           log_b[..., :1].contiguous(), mask)
    floor_ms = burst_ms(lambda: tr.viterbi_scan(*one))
    decode_ms = host_ms(lambda: model.decode_batch(feats, mask).cpu(), reps=10)
    n = log_b.shape[-1]
    steps = int(mask[:, 1:].sum())
    # the emission rows of frame 0 and the valid steps, the mask and the
    # model in (a masked frame needs no emission); trellis, backpointers,
    # path and score out; an add and a compare a (source, target) pair a
    # valid step
    k_bound = bound(4 * (b + steps) * n + b * t + 4 * (n + n * n) + 4 * 2 * b * t * n + 4 * b * t
                    + 4 * b, 2 * n * n * steps)
    print(f"main path: GMMHMM.decode_batch on B={b} x {entry.TRAIN_SECONDS} s (T={t}, N={n}, "
          f"lengths {int(lengths.min())}-{t}): kernel K once on its {route[0]} route, launches "
          f"{counts}; paths bitwise "
          f"the plain loop's on the card, {agree:.6f} of frames on the CPU decode's state")
    print(f"timing on {card}: kernel K at the decode's inputs {ms:.4f} ms (CUDA events, "
          f"back-to-back launches), profiler {prof[0]:.4f} ms ({prof[1]} of 10 launches recorded "
          f"in window {prof[2]}), the wrapper call {wrapper_ms:.4f} ms, chain floor (N = 1) "
          f"{floor_ms:.4f} ms; the plain loop on the card (viterbi_scan before K; CUDA events) "
          f"{plain_ms:.1f} ms; decode_batch end to end {decode_ms:.4f} ms (host clock, one "
          f"device->host copy); bound {k_bound[0]:.6f} ms by {k_bound[1]}")
    return {"ms": ms, "wrapper_ms": wrapper_ms, "profiler_ms": prof[0],
            "profiler_launches": prof[1], "floor_ms": floor_ms, "plain_ms": plain_ms,
            "decode_ms": decode_ms, "bound": k_bound, "agree": agree, "route": route[0],
            "err": err}


# -- kernel P: the streaming pipeline's decoder stage and its walk --------------

PIPE_CHUNK = 111  # divides the flagship utterance's T = 999
STAGE_NS = (1, 5, 8, 9, 32, 33, 257, 1024)  # the three routes and their edges
STAGE_CHUNKS = (1, PIPE_CHUNK, 1000)
STAGE_KINDS = ("random", "ties", "inf")
WALK_NS = (1, 5, 32, 33, 257)  # the map route, rows staged and read through L1
WALK_TS = (1, 2, 999, 100_000)


def stage_inputs(rng, n, chunk, kind):
    """``(alpha, log_pi, log_a, log_b)`` for kernel P as float64 NumPy whose
    values float32 holds exactly (so one float64 plain run is the oracle of
    both dtypes): ``random``; ``ties`` integer-valued with ``-inf``
    transitions, emissions and carried entries (no ``-0.0``); ``inf`` a
    left-to-right model (``-inf`` but on the diagonal and the next state)
    with an all ``-inf`` column, a dead start and ``-inf`` carried
    entries (tests/test_torch_trellis_chunk.py's kinds)."""
    alpha = rng.normal(scale=5.0, size=n) - 50.0
    log_pi = np.log(rng.dirichlet(np.ones(n)))
    log_a = np.log(rng.dirichlet(np.ones(n), size=n))
    log_b = rng.normal(scale=2.0, size=(chunk, n))
    with np.errstate(divide="ignore"):
        if kind == "ties":
            alpha = rng.integers(-6, 1, size=n) + 0.0
            log_pi = rng.integers(-2, 1, size=n) + 0.0
            log_a = rng.integers(-3, 1, size=(n, n)) + 0.0
            log_b = rng.integers(-4, 1, size=(chunk, n)) + 0.0
            log_a[rng.random((n, n)) < 0.3] = -np.inf
            log_b[rng.random((chunk, n)) < 0.1] = -np.inf
            alpha[rng.random(n) < 0.2] = -np.inf
        elif kind == "inf":
            i, j = np.indices((n, n))
            log_a = np.where((j == i) | (j == i + 1), np.log(0.5), -np.inf)
            if n > 2:
                log_a[:, n // 2] = -np.inf
            log_pi[-1] = -np.inf
            alpha[rng.random(n) < 0.3] = -np.inf
    return tuple(x.astype(np.float32).astype(np.float64) for x in (alpha, log_pi, log_a, log_b))


def check_stage(torch, tr, dev):
    """Kernel P against ``trellis_chunk_plain`` on the card, N in
    :data:`STAGE_NS` by chunks of :data:`STAGE_CHUNKS` (each pair one kind
    of :data:`STAGE_KINDS`), the chunk's row 0 at frame 0 and at frame 37,
    float32 and float64, both semirings: the max-plus ``alpha`` and
    pointer rows bit for bit, the log semiring within G's bars (float64
    1e-12 max relative, the ``-inf`` pattern identical; float32 within 2x
    the plain version's RMS distance from float64), its pointers bitwise
    at chunk 1 (later rows follow an ``alpha`` that differs in its last
    bits); with no pointers asked for, ``bt`` untouched and ``alpha`` the
    same bits. The chunked route (the log semiring at N <= 8) is also held
    within 1e-12 of its plain mirror ``trellis_chunk_chunked_plain`` at
    float64. Then the walk bit for bit against ``pointer_walk_plain`` at N
    in :data:`WALK_NS` and T in :data:`WALK_TS` (the map route, its rows in
    shared memory or read through L1, and the chase route forced), ties in
    ``alpha`` and an all ``-inf`` ``alpha``. Returns the largest float64
    log-semiring error."""
    f32, f64 = torch.float32, torch.float64
    worst, lines = 0.0, []
    for k, n in enumerate(STAGE_NS):
        for c, chunk in enumerate(STAGE_CHUNKS):
            kind = STAGE_KINDS[(k + c) % len(STAGE_KINDS)]
            raw = stage_inputs(np.random.default_rng(1000 * k + c), n, chunk, kind)
            errs = []
            for pos in (0, 37):
                for semiring in ("max", "log"):
                    oracle = None
                    for dtype in (f64, f32):
                        alpha, pi, a, lb = (torch.as_tensor(x, dtype=dtype, device=dev)
                                            for x in raw)
                        ref, ref_bt = tr.trellis_chunk_plain(alpha, pos, pi, a, lb, semiring, True)
                        bt = torch.full((chunk, n), -7, dtype=torch.int32, device=dev)
                        got, _ = tr.trellis_chunk(alpha, pos, pi, a, lb, semiring, True, bt)
                        untouched = torch.full_like(bt, -7)
                        bare, _ = tr.trellis_chunk(alpha, pos, pi, a, lb, semiring, False,
                                                   untouched)
                        torch.cuda.synchronize()
                        what = f"kernel P N={n} chunk={chunk} {kind} pos={pos} {semiring} {dtype}"
                        require(same_bits(torch, [bare], [got]) and bool((untouched == -7).all()),
                                f"{what}: without pointers alpha differs or bt was written")
                        if semiring == "max" or chunk == 1:
                            require(torch.equal(bt, ref_bt), f"{what}: pointers differ on "
                                    f"{int((bt != ref_bt).sum())} of {bt.numel()}")
                        if semiring == "max":
                            require(same_bits(torch, [got], [ref]), f"{what}: alpha differs")
                        elif dtype == f64:
                            oracle = ref
                            e = fb_rel(torch, got, ref)[0]
                            require(e <= 1e-12, f"{what}: {e} from the plain version")
                            if tr.trellis_chunk_route(n, semiring) == "chunked":
                                mirror = tr.trellis_chunk_chunked_plain(alpha, pos, pi, a, lb)[0]
                                e_m = fb_rel(torch, got, mirror)[0]
                                require(e_m <= 1e-12, f"{what}: {e_m} from the chunked mirror")
                            worst = max(worst, finite_err(torch, got, ref))
                            errs.append(e)
                        else:
                            d_g, d_p = fb_rel(torch, got, oracle)[1], fb_rel(torch, ref, oracle)[1]
                            require(d_g <= 2 * d_p, f"{what}: RMS {d_g} from float64, the plain "
                                    f"version {d_p}")
            lines.append(f"N={n} chunk={chunk} {kind} (max {tr.trellis_chunk_route(n)}, log "
                         f"{tr.trellis_chunk_route(n, 'log')}): log f64 {max(errs):.3g}")
    print("kernel P vs trellis_chunk_plain on the card, row 0 at frame 0 and 37, float32 and "
          "float64: max-plus alpha and pointers bit for bit, log semiring float64 within 1e-12 "
          "(max rel) and float32 within 2x the plain version's RMS distance from float64, "
          "pointers off leave bt untouched: " + "; ".join(lines))
    cases, routes = 0, set()
    for n in WALK_NS:
        for t in WALK_TS:
            routes.add(f"N={n} T={t} {tr.walk_route(n)} {tr.walk_chunks(t, n)}"
                       f"{' staged' if tr.walk_staged(t, n) else ''}")
            rng = np.random.default_rng(7 * n + t)
            bt = torch.as_tensor(rng.integers(0, n, size=(t, n), dtype=np.int32), device=dev)
            alpha = np.round(rng.normal(size=n))
            alpha[rng.random(n) < 0.3] = -np.inf
            for a in (alpha, np.full(n, -np.inf)):
                a = torch.as_tensor(a, device=dev)
                got, again = tr.pointer_walk(a, bt), tr.pointer_walk(a, bt)
                chase = tr._walk_launch(a, bt, route="chase")
                ref = tr.pointer_walk_plain(a, bt)
                torch.cuda.synchronize()
                require(torch.equal(got, ref) and torch.equal(again, got),
                        f"the walk at N={n} T={t}: differs from the plain walk on "
                        f"{int((got != ref).sum())} frames")
                require(torch.equal(chase, ref), f"the walk's chase route at N={n} T={t}: "
                        f"differs from the plain walk on {int((chase != ref).sum())} frames")
                cases += 1
    print(f"the walk vs pointer_walk_plain on the card, bit for bit, two launches equal: "
          f"{cases} cases, N {WALK_NS} x T {WALK_TS}, ties in alpha and an all -inf alpha, "
          f"the map route and the chase route forced; "
          f"routes (chunks, rows a chunk): " + ", ".join(sorted(routes)))
    return worst


def pipeline_inputs(torch, entry, dev):
    """``(params, log_b)``: the flagship model at float64 and its emissions
    on one 10 s utterance of ``entry.training``'s signals (T = 999, N = 5),
    the decoder stage's inputs in ``parallel_phase``'s pipelines."""
    from lnasr_tpu_torch.models import gmmhmm as tgh

    p = entry.flagship_model(dev, torch.float64).params
    x0 = entry.training(device=dev, batch=1).features[0].double()
    return p, tgh._emissions(p, x0, "diag")[0]


def decoder_stage(torch, fn, p, log_b, semiring="max", want_path=True):
    """``(alpha, bt (T, N))``: the decoder stage over ``log_b (T, N)``, one
    ``fn`` call (``trellis_chunk`` or its plain version) a chunk of
    :data:`PIPE_CHUNK`, as ``parallel.pipeline._pipeline`` makes them."""
    (t, n), chunk = log_b.shape, PIPE_CHUNK
    alpha = torch.full((n,), -torch.inf, dtype=log_b.dtype, device=log_b.device)
    bts = torch.zeros((t // chunk, chunk, n), dtype=torch.int32, device=log_b.device)
    for k in range(t // chunk):
        alpha, _ = fn(alpha, k * chunk, p.log_pi, p.log_a, log_b[k * chunk:(k + 1) * chunk],
                      semiring, want_path, bts[k])
    return alpha, bts.reshape(t, n)


def stage_phase(torch, entry, card):
    """Kernel P and the walk: :func:`check_stage`; then at the pipeline's
    geometry (one 10 s flagship utterance, T = 999, chunk
    :data:`PIPE_CHUNK`, the flagship model, N = 5, float64), the decoder
    stage as ``parallel/pipeline.py`` runs it (one launch a chunk) bit for
    bit the plain frame loop's (the log semiring within 1e-12, its nine
    launches on the chunked route), P timed by CUDA events over
    back-to-back launches (:func:`burst_ms`) on a mid-utterance chunk in
    both semirings, the log semiring's chunked route in turns with the same
    launch forced onto the warp route (the design before the chunked one),
    the wrapper call, the plain version on the card, the chain floors (the
    same launches at N = 1) and P's bounds; the whole stage (9 launches)
    against the plain frame loop by the host clock; the walk over the
    utterance's pointers by events, its plain host loop and its chain floor
    (the walk over a (T, 1) pointer table)."""
    from lnasr_tpu_torch.ops import trellis as tr

    dev = torch.device(DEVICE)
    f64 = torch.float64
    err = check_stage(torch, tr, dev)
    p, log_b = pipeline_inputs(torch, entry, dev)
    t, n = log_b.shape
    chunk = PIPE_CHUNK
    n_chunks = t // chunk

    def stage(fn, semiring="max", want_path=True):
        return decoder_stage(torch, fn, p, log_b, semiring, want_path)

    alpha, bt = stage(tr.trellis_chunk)
    ref_alpha, ref_bt = stage(tr.trellis_chunk_plain)
    by_route = tr.trellis_chunk.route_launches
    by_route.update(dict.fromkeys(by_route, 0))
    log_alpha, _ = stage(tr.trellis_chunk, "log", False)
    log_routes = dict(by_route)
    log_ref, _ = stage(tr.trellis_chunk_plain, "log", False)
    torch.cuda.synchronize()
    require(log_routes["chunked"] == n_chunks and sum(log_routes.values()) == n_chunks,
            f"the log-semiring stage's launches by route {log_routes}: expected {n_chunks} "
            f"on the chunked route")
    require(same_bits(torch, [alpha], [ref_alpha]) and torch.equal(bt, ref_bt),
            "kernel P's decoder stage differs from the plain frame loop at the pipeline's geometry")
    e_log = fb_rel(torch, log_alpha, log_ref)[0]
    require(e_log <= 1e-12, f"kernel P's log-semiring stage: {e_log} from the plain frame loop")
    path = tr.pointer_walk(alpha, bt)
    require(torch.equal(path, tr.pointer_walk_plain(alpha, bt)), "the walk differs at T=999")

    mid_alpha, _ = tr.trellis_chunk(torch.full((n,), -torch.inf, dtype=f64, device=dev), 0,
                                    p.log_pi, p.log_a, log_b[:chunk])
    mid = (mid_alpha, chunk, p.log_pi, p.log_a, log_b[chunk:2 * chunk])
    bt_mid = torch.zeros((chunk, n), dtype=torch.int32, device=dev)
    ms = {s: burst_ms(lambda s=s: tr.trellis_chunk(*mid, s, s == "max", bt_mid))
          for s in ("max", "log")}
    # the log semiring on its chunked route and forced onto the warp route,
    # in turns (chunked, warp, warp, chunked)
    log_mid = tr.trellis_chunk_plain(*mid, "log")[0]
    for route in ("chunked", "warp"):
        e_route = fb_rel(torch, tr._chunk_launch(*mid, "log", False, None, route=route)[0],
                         log_mid)[0]
        require(e_route <= 1e-12, f"kernel P's log semiring on the {route} route, mid chunk: "
                f"{e_route} from the plain version")
    log_turns = {"chunked": [], "warp": []}
    for route in ("chunked", "warp", "warp", "chunked"):
        log_turns[route].append(burst_ms(lambda r=route: tr._chunk_launch(
            *mid, "log", False, None, route=r)))
    wrapper_ms = cuda_ms(lambda: tr.trellis_chunk(*mid, "max", True, bt_mid), reps=20)
    plain_ms = cuda_ms(lambda: tr.trellis_chunk_plain(*mid, "max", True, bt_mid), reps=5, warmup=1)
    one = (mid_alpha[:1].contiguous(), chunk, p.log_pi[:1].contiguous(),
           p.log_a[:1, :1].contiguous(), log_b[chunk:2 * chunk, :1].contiguous())
    bt_one = torch.zeros((chunk, 1), dtype=torch.int32, device=dev)
    floor_ms = burst_ms(lambda: tr.trellis_chunk(*one, "max", True, bt_one))
    log_floor_ms = burst_ms(lambda: tr.trellis_chunk(*one, "log", False, bt_one))
    pieces, piece = tr.stage_pieces(chunk)
    w_chunks, w_piece = tr.walk_chunks(t, n)
    stage_ms = host_ms(lambda: (stage(tr.trellis_chunk), torch.cuda.synchronize()), reps=10)
    stage_plain_ms = host_ms(lambda: (stage(tr.trellis_chunk_plain), torch.cuda.synchronize()),
                             reps=3)
    walk_ms = burst_ms(lambda: tr.pointer_walk(alpha, bt))
    walk_wrapper_ms = cuda_ms(lambda: tr.pointer_walk(alpha, bt), reps=20)
    walk_plain_ms = host_ms(lambda: tr.pointer_walk_plain(alpha, bt), reps=5)
    flat = torch.zeros((t, 1), dtype=torch.int32, device=dev)
    walk_floor_ms = burst_ms(lambda: tr.pointer_walk(alpha[:1].contiguous(), flat))
    # a mid-utterance chunk: alpha, log_a, the chunk's emissions in, alpha and
    # the pointer rows out; a frame's N^2 adds and compares and N emission
    # adds (the log semiring 5 N^2 + 3 N: subtraction, exp and sum more)
    moved = 8 * (n + n * n + chunk * n + n) + 4 * chunk * n
    ops = chunk * (2 * n * n + n)
    p_bound = bound(moved, ops, FP64_FLOPS)
    p_log_bound = bound(moved - 4 * chunk * n, chunk * (5 * n * n + 3 * n), FP64_FLOPS)
    # the walk: alpha and one pointer a frame in, the path out
    w_bound = bound(8 * n + 4 * (t - 1) + 4 * t, n, FP64_FLOPS)
    print(f"kernel P at the pipeline's geometry (T={t} in {n_chunks} chunks of {chunk}, N={n}, "
          f"float64, the flagship model on a 10 s utterance): the decoder stage bit for bit the "
          f"plain frame loop's (alpha, pointers; the log semiring {e_log:.3g}), the walk's path "
          f"the plain walk's")
    print(f"timing on {card}: kernel P on a mid-utterance chunk {ms['max']:.4f} ms max-plus, "
          f"{ms['log']:.4f} ms log semiring (CUDA events, back-to-back launches queued), the "
          f"wrapper call {wrapper_ms:.4f} ms, chain floor (N = 1) {floor_ms:.4f} ms; the plain "
          f"version on the card {plain_ms:.3f} ms (CUDA events); bound {p_bound[0]:.6f} ms by "
          f"{p_bound[1]} ({moved} bytes: {moved / HBM_BYTES_PER_S * 1e3:.7f} ms; {ops} "
          f"operations: {ops / FP64_FLOPS * 1e3:.7f} ms); the stage over the "
          f"utterance ({n_chunks} launches) {stage_ms:.3f} ms vs the plain frame loop "
          f"{stage_plain_ms:.3f} ms (host clock, synchronized)")
    print(f"timing on {card}: kernel P's log semiring on the mid-utterance chunk, chunked route "
          f"({pieces} pieces of {piece} rows: depth L + C = {piece + pieces} steps, not {chunk}) "
          + " / ".join(f"{x:.4f}" for x in log_turns["chunked"]) + " ms, forced onto the warp "
          f"route (a {chunk}-step chain) " + " / ".join(f"{x:.4f}" for x in log_turns["warp"])
          + f" ms (CUDA events, in turns: chunked, warp, warp, chunked); its floor (the same "
          f"launch at N = 1) {log_floor_ms:.4f} ms; bound {p_log_bound[0]:.7f} ms by "
          f"{p_log_bound[1]}; the stage's {n_chunks} log launches by route {log_routes}")
    print(f"timing on {card}: the walk (map route, {w_chunks} chunks of {w_piece} rows: depth "
          f"2 L + C = {2 * w_piece + w_chunks}, not {t - 1}; rows "
          f"{'staged in shared memory' if tr.walk_staged(t, n) else 'read through L1'}) "
          f"{walk_ms:.4f} ms (events, queued; the shuffle walk before it: 0.0384 ms in PERF.md), "
          f"the wrapper call {walk_wrapper_ms:.4f} ms, chain floor (T={t}, N = 1) "
          f"{walk_floor_ms:.4f} ms, the plain host loop after one copy {walk_plain_ms:.3f} ms "
          f"(host clock); walk bound {w_bound[0]:.7f} ms by {w_bound[1]}")
    return {"err": err, "ms": ms["max"], "log_ms": ms["log"], "wrapper_ms": wrapper_ms,
            "plain_ms": plain_ms, "floor_ms": floor_ms, "bound": p_bound,
            "log_bound": p_log_bound, "stage_ms": stage_ms, "stage_plain_ms": stage_plain_ms,
            "walk_ms": walk_ms, "walk_wrapper_ms": walk_wrapper_ms,
            "walk_plain_ms": walk_plain_ms, "walk_floor_ms": walk_floor_ms, "walk_bound": w_bound,
            "log_chunked_ms": log_turns["chunked"], "log_warp_ms": log_turns["warp"],
            "log_floor_ms": log_floor_ms, "log_depth": piece + pieces,
            "walk_depth": 2 * w_piece + w_chunks}


# the segmenter's corpus: space-separated words (tests/test_seg.py's)
SEG_CORPUS = [
    "我们 喜欢 学习 语言 模型",
    "他们 喜欢 学习 数学",
    "我们 学习 中文 分词",
    "语言 模型 帮助 中文 分词",
    "他们 使用 语言 模型",
    "我们 使用 中文",
    "中文 分词 需要 语言 模型",
    "学习 中文 需要 模型",
    "我 在 图书馆 学习",
    "他 喜欢 去 图书馆",
    "隐马尔可夫 模型 很 有用",
    "我 用 隐马尔可夫 模型 分词",
] * 4
SEG_SENTENCES = ["我们喜欢学习中文", "他们使用语言模型", "语言模型帮助分词",
                 "我在图书馆学习隐马尔可夫模型。", "żółw隐马尔可夫"]


def param_dist(torch, got, ref):
    """The largest distance between two parameter sets (NamedTuples of
    the same type): log-probability fields as probabilities (absolute),
    every other field relative to the reference's largest magnitude;
    equal entries (also -inf) count 0, a finite entry against -inf inf."""
    worst = 0.0
    for name, g, r in zip(ref._fields, got, ref):
        g, r = g.detach().double().cpu(), r.detach().double().cpu()
        if name.startswith("log_"):
            d = (torch.exp(g) - torch.exp(r)).abs()
        else:
            d = (g - r).abs() / r[torch.isfinite(r)].abs().max()
        d = torch.where(g == r, torch.zeros_like(d), d)
        worst = max(worst, float(torch.nan_to_num(d, nan=np.inf).max()))
    return worst


def hist_dist(got, ref):
    return max(abs(a - b) / abs(b) for a, b in zip(got, ref))


def host_launches(prof):
    """Kernel launches the host made under ``prof`` (runtime API events)."""
    return sum(e.count for e in prof.key_averages() if "LaunchKernel" in e.key)


@contextlib.contextmanager
def counted_sweeps():
    """Counts E-step sweeps in the block: calls of the GMM-HMM's and the
    discrete HMM's ``_sequence_stats`` (each launches kernel G once on the
    card), wrapped where every trainer reaches them, as module
    attributes."""
    from lnasr_tpu_torch.models import gmmhmm as tgh
    from lnasr_tpu_torch.models import hmm as thmm

    count = [0]
    saved = [(mod, mod._sequence_stats) for mod in (tgh, thmm)]

    def counting(fn):
        def stats(*args, **kw):
            count[0] += 1
            return fn(*args, **kw)
        return stats

    for mod, fn in saved:
        mod._sequence_stats = counting(fn)
    try:
        yield count
    finally:
        for mod, fn in saved:
            mod._sequence_stats = fn


def require_a_and_g(counts, sweeps, what):
    """``counts``: the mel frontend once, kernel G once per sweep (at least
    one), nothing else."""
    require(sweeps > 0 and counts["mel_frontend"] == 1 and counts["forward_backward"] == sweeps
            and all(c == 0 for n, c in counts.items()
                    if n not in ("mel_frontend", "forward_backward")),
            f"{what} did not launch the mel frontend once and kernel G once for each of its "
            f"{sweeps} sweeps, and nothing else: {counts}")


def launches_under(prof, name):
    """Kernel launches the host made inside the profiler range ``name``."""
    found = 0
    for e in prof.events():
        if e.name == name:
            stack = list(e.cpu_children)
            while stack:
                c = stack.pop()
                found += "LaunchKernel" in c.name
                stack.extend(c.cpu_children)
    return found


def training_phase(torch, entry, wrappers, card, launches):
    """Training: the flagship EM sweep at full width (B = 64 x 10 s, 5 x 8 x
    39 diagonal; the mel frontend once, kernel G once a sweep), its float64
    sweeps against the CPU's and its float32 sweeps against a float64
    oracle, its time and split; kernel G against its plain loops and its
    chunked mirror at the sweep's own inputs on the chunked route, timed
    beside the sequential warp route, its bound, depth floor and the warp
    route's chain floor; kill and resume
    bitwise for the GMM-HMM and a 65,536-symbol discrete HMM; a small
    full-covariance sweep; isolated-unit training of the V = 22 inventory
    against the CPU's, a planted decode with the trained units; the
    segmenter against the CPU's."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    from lnasr_tpu_torch.config import GMMHMMConfig
    from lnasr_tpu_torch.models import gmmhmm as tgh
    from lnasr_tpu_torch.models import hmm as thmm
    from lnasr_tpu_torch.models.decoder import SILENCE, DecodingGraph
    from lnasr_tpu_torch.models.recognizer import AcousticModel
    from lnasr_tpu_torch.models.seg import Seg, SegDataSet
    from lnasr_tpu_torch.ops import mel_frontend as mf
    from lnasr_tpu_torch.ops import trellis
    from lnasr_tpu_torch.utils.checkpoints import Checkpointer, em_loop

    f32, f64 = torch.float32, torch.float64

    # -- the training path: features (kernel A once) and one sweep (G once) --
    torch.cuda.synchronize()
    reset_counts(*wrappers)
    with counted_sweeps() as sweeps:
        run = entry.training(device=DEVICE)
        params1, loglik1 = run.step(run.params)
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in wrappers}
    require(sweeps[0] == 1, f"the training path ran {sweeps[0]} E-steps, not one")
    require_a_and_g(counts, sweeps[0], "the training path")
    launches["training"] = counts
    b, t_frames, _ = run.features.shape
    audio_s = b * entry.TRAIN_SECONDS
    require(np.isfinite(float(loglik1)) and all(bool(torch.isfinite(x[x != -np.inf]).all())
                                                for x in params1),
            "the first sweep is not finite")
    print(f"main path: entry.training() on B={b} x {entry.TRAIN_SECONDS} s -> features "
          f"{tuple(run.features.shape)}, one gmmhmm_em_step sweep, loglik {float(loglik1):.6e}; "
          f"launches {counts}")

    # -- 3 sweeps at float64 (card vs CPU) and float32 (vs the oracle) -----
    host = run.features.cpu()

    def sweeps(device, dtype, k=3):
        r = entry.training(device=device, dtype=dtype,
                           features=host if device == "cpu" else run.features)
        p, hist = r.params, []
        for _ in range(k):
            p, ll = r.step(p)
            hist.append(float(ll))
        return p, hist

    threads = torch.get_num_threads()
    p64, h64 = sweeps(DEVICE, f64)
    t0 = time.perf_counter()
    c64, ch64 = sweeps("cpu", f64)
    cpu_s = time.perf_counter() - t0
    p32, h32 = sweeps(DEVICE, f32)
    c32, ch32 = sweeps("cpu", f32)
    e64 = max(param_dist(torch, p64, c64), hist_dist(h64, ch64))
    d_card, d_cpu = (max(param_dist(torch, p, c64), hist_dist(h, ch64))
                     for p, h in ((p32, h32), (c32, ch32)))
    print(f"training sweeps (3, from the flagship start, features of kernel A copied to the host): "
          f"float64 card vs CPU {e64:.3g} (bar 1e-9); float32 from the float64 CPU oracle: card "
          f"{d_card:.3g}, CPU {d_cpu:.3g} (bar: card within 2x the CPU's); logliks {h32} "
          f"(card f32), {ch64} (CPU f64); CPU f64 {cpu_s:.2f} s on {threads} threads")
    require(e64 < 1e-9, f"float64 training sweeps: card and CPU differ by {e64}")
    require(d_card <= 2 * d_cpu, f"float32 training sweeps: the card is {d_card} from the "
            f"float64 oracle, the CPU {d_cpu}")
    require(all(b2 >= a2 - 1e-6 * abs(a2) for a2, b2 in zip(h64, h64[1:])),
            f"the float64 loglik fell: {h64}")

    # -- no host sync inside a sweep (em_loop's float(loglik) is the one) --
    import warnings

    def syncs(fn):
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                fn()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        return [str(w.message)[:120] for w in caught
                if "called a synchronizing" in str(w.message)]

    run.step(run.params)  # warm: the first call may allocate
    found = syncs(lambda: run.step(run.params))
    require(not found, f"the EM sweep synchronized with the host: {found[:3]}")

    # -- one sweep's time, device share, launches and split ---------------
    step_ms = cuda_ms(lambda: run.step(run.params), reps=5, warmup=1)
    torch.cuda.synchronize()
    reset_counts(*wrappers)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run.step(run.params)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    g_per_sweep = trellis.forward_backward.launches
    busy = sum(e.self_device_time_total for e in prof.key_averages() if on_device(torch, e)) / 1e3
    n_launch = host_launches(prof)
    fb_launch = launches_under(prof, "gmmhmm.forward_backward")
    require(g_per_sweep == 1, f"the profiled sweep launched kernel G {g_per_sweep} times")
    # no frame loop left under the range: G and no more (the loops made some
    # 24,000 launches a sweep there; until the chunked route, a transposed
    # copy of log_a too)
    require(fb_launch <= 8, f"{fb_launch} kernel launches under gmmhmm.forward_backward")
    # the sweep's stages: the profiler ranges of models/gmmhmm.py, their host
    # side (wall time of the range, and the device time of the kernels
    # launched inside it)
    stages = {e.key[len("gmmhmm."):]: (e.cpu_time_total / 1e3, e.device_time_total / 1e3)
              for e in prof.key_averages()
              if e.key.startswith("gmmhmm.") and e.device_type == torch.autograd.DeviceType.CPU}
    require(len(stages) == 4, f"the sweep's profile lacks its stage ranges: {sorted(stages)}")
    p0, obs = run.params, run.features
    em_ms = cuda_ms(lambda: tgh._emissions(p0, obs, "diag"), reps=5, warmup=1)
    print(f"timing on {card}: EM sweep (B={b} x {entry.TRAIN_SECONDS} s, T={t_frames}, 5x8x39 "
          f"diag, float32): {step_ms:.4f} ms = {audio_s / (step_ms / 1e3):.1f} audio-s/s (CUDA "
          f"events, median of 5 after 1 warm-up); under torch.profiler: device busy {busy:.4f} ms "
          f"of the profiled sweep's {prof_ms:.4f} ms wall ({100 * busy / prof_ms:.1f}%; of the "
          f"unprofiled events time {100 * busy / step_ms:.1f}%), {n_launch} kernel launches by "
          f"the host; stages (host ms / device ms under the profiler): "
          + ", ".join(f"{k} {h:.4f} / {d:.4f}" for k, (h, d) in stages.items())
          + f"; emissions alone {em_ms:.4f} ms by events; kernel G {g_per_sweep}x, "
          f"{fb_launch} host launches under gmmhmm.forward_backward")
    device_breakdown(torch, lambda: run.step(run.params), step_ms, f"{card}, EM sweep", steps=1)

    # -- kernel G at the sweep's own inputs ---------------------------------
    lb_sweep = tgh._emissions(p0, obs, "diag")[0]
    g32 = (p0.log_pi, p0.log_a, lb_sweep, run.mask)
    g64 = tuple(x.double() for x in g32[:3]) + (run.mask,)
    nb, nt, nn = lb_sweep.shape
    g_route = trellis.fb_route(nn, 4)
    require(g_route == "chunked", f"the sweep's G takes the {g_route} route, not the chunked one")
    got32, ref32, _ = check_fb_at(torch, trellis, g32)
    got64, ref64, g_err64 = check_fb_at(torch, trellis, g64)
    fwd_m, beta_m = trellis.forward_backward_chunked_plain(*g64)
    g_err_m = max(fb_rel(torch, g, r)[0] for g, r in zip(got64, (fwd_m.alpha, fwd_m.loglik,
                                                                  beta_m)))
    require(g_err_m <= 1e-12, f"kernel G at the sweep's inputs is {g_err_m} from its chunked "
            f"plain mirror at float64")
    seq32, _, seq_err64 = check_fb_at(torch, trellis, g32, "warp")
    _, _, seq_err64 = check_fb_at(torch, trellis, g64, "warp")
    d_g = max(fb_rel(torch, g, r)[1] for g, r in zip(got32, ref64))
    d_s = max(fb_rel(torch, g, r)[1] for g, r in zip(seq32, ref64))
    d_p = max(fb_rel(torch, p, r)[1] for p, r in zip(ref32, ref64))
    require(d_g <= 2 * d_p and d_s <= 2 * d_p, f"kernel G at the sweep's float32 inputs: "
            f"chunked {d_g}, sequential {d_s} from the float64 plain result, the float32 plain "
            f"loops {d_p}")
    g_abs = max(float(torch.where(torch.isfinite(r), (g - r).abs(), 0.0).max())
                for g, r in zip(got32, ref32))
    g_wrapper_ms = cuda_ms(lambda: trellis.forward_backward(*g32), reps=50)
    # G's time: CUDA events over 20 back-to-back launches queued behind a
    # spinning kernel (the chunked route is shorter than the host's time to
    # launch it), the chunked route (chosen) and the sequential warp route
    # (forced) in turns; the profiler's figure beside it, with the number of
    # G's launches it recorded
    g_ms, seq_ms, g_ms2, seq_ms2 = (burst_ms(lambda r=r: trellis._launch(*g32, 3, route=r))
                                    for r in ("chunked", "warp", "chunked", "warp"))
    g64_ms = burst_ms(lambda: trellis._launch(*g64, 3))
    g_unqueued_ms = burst_ms(lambda: trellis._launch(*g32, 3), queued=False)
    g_prof = kernel_device_ms(torch, lambda: trellis._launch(*g32, 3), "fb_chunk")
    g_prof_ms = 10 * g_prof[0] / g_prof[1] if g_prof[1] else None  # a launch it recorded
    g_prof_txt = "no" if g_prof_ms is None else f"{g_prof_ms:.4f}"
    g_plain_ms = cuda_ms(lambda: (trellis.forward_scan_plain(*g32),
                                  trellis.backward_scan_plain(*g32[1:])), reps=3, warmup=1)
    # the floors: the same launch at N = 1 (a step of one shuffle, one exp and
    # one log): on the warp route the 998-step chain's, on the chunked route
    # the depth L + C + L's
    one = (torch.zeros(1, device=DEVICE), torch.zeros((1, 1), device=DEVICE),
           lb_sweep[..., :1].contiguous(), run.mask)
    floor_ms = burst_ms(lambda: trellis._launch(*one, 3, route="warp"))
    depth_floor_ms = burst_ms(lambda: trellis._launch(*one, 3, route="chunked"))
    n_chunks, chunk = trellis.fb_chunks(nt)
    depth = 2 * chunk + n_chunks
    steps = int(run.mask[:, 1:].sum())  # valid steps a direction, summed over the batch
    g_bytes = 4 * (nn + nn * nn + 3 * nb * nt * nn + nb) + nb * nt
    # operations: the recursion's own, ~5 N^2 + 2 N a step and direction; the
    # chunked design does N + 1 times that (its chunk products apply the step
    # to N rows), printed beside and not counted in the bound
    g_ops = 2 * steps * (5 * nn * nn + 2 * nn)
    g_bound = bound(g_bytes, g_ops)
    print(f"kernel G at the sweep's inputs (B={nb}, T={nt}, N={nn}, {g_route} route, {n_chunks} "
          f"chunks of {chunk} steps): float64 {g_err64:.3g} from its plain loops (bar 1e-12), "
          f"{g_err_m:.3g} from its chunked plain mirror; float32 RMS {d_g:.3g} from the float64 "
          f"plain result (plain float32 {d_p:.3g}, bar 2x), max abs {g_abs:.3g} from the "
          f"float32 plain loops; two launches bitwise; the sequential warp route (forced) "
          f"float64 {seq_err64:.3g}, float32 RMS {d_s:.3g}")
    print(f"timing on {card}: kernel G {g_ms:.4f} / {g_ms2:.4f} ms a launch on the chunked route "
          f"at float32, the sequential warp route {seq_ms:.4f} / {seq_ms2:.4f} ms (CUDA events "
          f"over 20 back-to-back launches queued behind a spinning kernel, in turns chunked, "
          f"warp, chunked, warp; torch.profiler on the chunked route: {g_prof_txt} ms a "
          f"launch, {g_prof[1]} of 10 launches recorded in window {g_prof[2]}; "
          f"{g64_ms:.4f} ms at float64; {g_unqueued_ms:.4f} ms a launch with nothing queued "
          f"ahead, the host launching as the card runs; the wrapper call {g_wrapper_ms:.4f} ms "
          f"by events; plain "
          f"loops {g_plain_ms:.2f} ms); depth {depth} steps ({chunk} + {n_chunks} + {chunk}), "
          f"depth floor (chunked, N=1) {depth_floor_ms:.4f} ms; the warp route's {nt - 1}-step "
          f"chain floor (N=1) {floor_ms:.4f} ms; bound {g_bound[0]:.5f} ms by {g_bound[1]} "
          f"({g_bytes} bytes, {g_ops} operations; the chunked design's "
          f"{(nn + 1) * g_ops} operations would take {(nn + 1) * g_ops / FP32_FLOPS * 1e3:.5f} "
          f"ms); {g_per_sweep} launch a sweep")
    g = {"err": g_abs, "ms": g_ms, "wrapper_ms": g_wrapper_ms, "plain_ms": g_plain_ms,
         "bound": g_bound, "chain_steps": nt - 1, "floor_ms": floor_ms, "depth": depth,
         "depth_floor_ms": depth_floor_ms, "sequential_ms": seq_ms, "unqueued_ms": g_unqueued_ms,
         "per_sweep": g_per_sweep, "f64_ms": g64_ms, "profiler_ms": g_prof_ms,
         "profiler_launches": g_prof[1], "profiler_window": g_prof[2]}

    # -- kill and resume, bitwise ------------------------------------------
    def kill_and_resume(step, start, what):
        straight, hist = em_loop(step, start, 4, 0.0)
        with tempfile.TemporaryDirectory() as d:
            ckpt = Checkpointer(d, every=1)
            em_loop(step, start, 2, 0.0, checkpointer=ckpt)
            resumed, hist_r = em_loop(step, start, 4, 0.0, checkpointer=ckpt)
        same = all(torch.equal(x, y) for x, y in zip(straight, resumed)) and hist == hist_r
        require(all(np.isfinite(hist)), f"{what}: logliks {hist}")
        require(same, f"{what}: 2 sweeps, a checkpoint and a resume to 4 differ from 4 straight")
        return hist

    hist = kill_and_resume(run.step, run.params, "flagship GMM-HMM")
    # 300 symbols spread over the 65,536 (each seen ~10 times: a symbol seen
    # only at a sequence's last valid frame gets no emission mass under the
    # estimator, and the next sweep's loglik is -inf, in both packages)
    rng = np.random.default_rng(8)
    n_sym, bh, th = 65536, 8, 400
    sym = rng.choice(n_sym, size=300, replace=False)[rng.integers(0, 300, size=(bh, th))]
    sym_mask = np.arange(th)[None, :] < rng.integers(th // 2, th + 1, size=(bh, 1))
    hmm = thmm.HMM(4, n_sym, device=DEVICE).reset("random", torch.Generator().manual_seed(8))
    obs_d, mask_d = (torch.as_tensor(x, device=DEVICE) for x in (sym, sym_mask))
    hist_d = kill_and_resume(lambda p: thmm.em_step(p, obs_d, mask_d), hmm.params,
                             "discrete HMM, 65,536 symbols")
    found = syncs(lambda: thmm.em_step(hmm.params, obs_d, mask_d))
    require(not found, f"the discrete EM sweep synchronized with the host: {found[:3]}")
    p_card, l_card = thmm.em_step(hmm.params, obs_d, mask_d)
    hmm64 = [x.double() for x in hmm.params]
    p_d64, l_d64 = thmm.em_step(thmm.HMMParams(*hmm64), obs_d, mask_d)
    p_c64, l_c64 = thmm.em_step(thmm.HMMParams(*(x.cpu() for x in hmm64)),
                                torch.as_tensor(sym), torch.as_tensor(sym_mask))
    e_disc = max(param_dist(torch, p_d64, p_c64), abs(float(l_d64) - float(l_c64)) / abs(float(l_c64)))
    require(e_disc < 1e-9, f"discrete HMM em_step at float64: card vs CPU {e_disc}")
    # full covariance at a small size, float64, card vs CPU
    rng = np.random.default_rng(9)
    feats_f = rng.normal(size=(4, 60, 8)) + np.linspace(-2, 2, 60)[None, :, None]
    full = tgh.GMMHMM(GMMHMMConfig(n_states=3, n_mix=2, dim=8, cov_type="full"),
                      dtype=f64, device="cpu").init_left_to_right(feats_f,
                                                                 torch.Generator().manual_seed(9))
    mask_f = np.arange(60)[None, :] < np.array([[60], [51], [60], [33]])
    pf_c, lf_c = tgh.gmmhmm_em_step(full.params, torch.as_tensor(feats_f),
                                    torch.as_tensor(mask_f), cov_type="full")
    pf_g, lf_g = tgh.gmmhmm_em_step(tgh.GMMHMMParams(*(x.to(DEVICE) for x in full.params)),
                                    torch.as_tensor(feats_f, device=DEVICE),
                                    torch.as_tensor(mask_f, device=DEVICE), cov_type="full")
    e_full = max(param_dist(torch, pf_g, pf_c), abs(float(lf_g) - float(lf_c)) / abs(float(lf_c)))
    require(e_full < 1e-9, f"full-covariance sweep at float64: card vs CPU {e_full}")
    print(f"kill and resume on the card: 4 sweeps straight == 2 sweeps, a Checkpointer save and a "
          f"resume to 4, bitwise (parameters and history), for the flagship GMM-HMM (logliks "
          f"{hist}) and a discrete HMM of 4 states x {n_sym} symbols on {bh} x {th} masked "
          f"symbols (logliks {hist_d}); neither sweep synchronized with the host (sync debug "
          f"mode); discrete em_step at float64 card vs CPU {e_disc:.3g}; "
          f"full-covariance sweep (4 x 60 frames, 3x2x8) at float64 card vs CPU {e_full:.3g}")

    # -- isolated-unit training of the V = 22 inventory ---------------------
    torch.cuda.synchronize()
    reset_counts(*wrappers)
    with counted_sweeps() as sweeps:
        am64, examples = entry.unit_training(22, device=DEVICE, dtype=f64)
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in wrappers}
    require_a_and_g(counts, sweeps[0], "unit training")
    launches["unit training"] = counts
    # kernel A at the examples' padded batch (its own frames a block at this
    # shape), held against its plain version: the CPU's units below train on
    # the card's features, so only this check covers A's output here
    _, unit_sig, unit_lens = entry.unit_signals(22)
    unit_sig = torch.as_tensor(unit_sig, device=DEVICE)
    cfg_u = entry.SERVING_MFCC_CONFIG
    where = f"unit examples B={unit_sig.shape[0]} with lengths, {a_route(mf, unit_sig, cfg_u)}"
    err, scale, ferr = check_a_shape(torch, mf, unit_sig, cfg_u,
                                     torch.as_tensor(unit_lens, device=DEVICE), where)
    print(f"kernel A vs plain ({where}): mel max err {err:.6g} of energy scale {scale:.6g} "
          f"(bar 2e-6*scale + 1e-4*|ref|), features max err {ferr:.3g} (bar 0.01): ok")
    am_cpu, _ = entry.unit_training(22, device="cpu", dtype=f64, examples=examples)
    e_units = max(param_dist(torch, am64.units[u].params, am_cpu.units[u].params)
                  for u in am_cpu.units)
    require(sorted(am64.units) == sorted(am_cpu.units) and e_units < 1e-8,
            f"unit training at float64: card vs CPU {e_units}")
    t0 = time.perf_counter()
    am32, _ = entry.unit_training(22, device=DEVICE, examples=examples)
    torch.cuda.synchronize()
    unit_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    entry.unit_examples(22, device=DEVICE)
    torch.cuda.synchronize()
    feat_s = time.perf_counter() - t0
    n_frames = sum(len(f) for v in examples.values() for f in v)

    def as32(device):
        units = {u: tgh.GMMHMM(m.config, dtype=f32, device=device).set_params(m.params)
                 for u, m in am64.units.items()}
        return entry.unit_recognizer(AcousticModel(units, entry.SERVING_MFCC_CONFIG,
                                                   device=device))

    rec, rec_cpu = as32(DEVICE), as32("cpu")
    require(isinstance(rec.graph, DecodingGraph) and rec.graph.n_states == 179,
            "the trained V=22 units did not compose the 179-state dense graph")
    planted = ["w0008", "w0019", "w0011", "w0015", "w0013", "w0020"]
    audio = entry.unit_utterance(planted)
    rec.decode_segment(audio)
    torch.cuda.synchronize()
    reset_counts(*wrappers)
    words, score = rec.decode_segment(audio)
    counts = {w.__name__: w.launches for w in wrappers}
    require(counts["mel_frontend"] == 1 and counts["viterbi_dense"] == 1 and
            sum(counts.values()) == 2, f"the planted decode did not launch A and C once: {counts}")
    words_c, score_c = rec_cpu.decode_segment(audio)
    require(words == words_c and abs(score - score_c) <= 1e-4 * abs(score_c),
            f"trained units, planted decode: card {words} ({score}) vs CPU {words_c} ({score_c})")
    # where each decoded word lies, beside the planted spans (0.2 s gaps, 0.4 s words)
    spans = [(w, round(a, 3), round(b, 3)) for w, a, b in rec.decode_segment_aligned(audio)[2]]
    planted_spans = [(w, round(0.2 + 0.6 * k, 3), round(0.6 + 0.6 * k, 3))
                     for k, w in enumerate(planted)]
    print(f"main path: entry.unit_training(22): {len(examples)} units ({SILENCE} 3x4, words 8x2), "
          f"{entry.UNIT_EXAMPLES} examples each, {n_frames} frames; launches {launches['unit training']}"
          f" (one batched features_fast); float64 card vs CPU {e_units:.3g} (bar 1e-8)")
    print(f"timing on {card}: unit training V=22 at float32, 5 sweeps a unit: {unit_s:.3f} s "
          f"(host clock; the examples' features, kernel A once: {feat_s:.3f} s)")
    print(f"planted decode with the trained units (float64-trained, cast to float32), V=22 dense "
          f"graph: {planted} -> card {words}, CPU {words_c} (equal; score rel err "
          f"{abs(score - score_c) / abs(score_c):.3g}); launches {counts}; "
          f"{'all planted words' if words == planted else 'not all planted words'} recovered; "
          f"card word spans (s) {spans}, planted {planted_spans}")

    # -- the segmenter ------------------------------------------------------
    t0 = time.perf_counter()
    torch.cuda.synchronize()
    reset_counts(*wrappers)
    with counted_sweeps() as sweeps:
        seg = Seg(device=DEVICE).train(SegDataSet.mark(line) for line in SEG_CORPUS)
    torch.cuda.synchronize()
    train_counts = {w.__name__: w.launches for w in wrappers}
    # the segmenter trains by counting (HMM.from_counts): no E-step, no kernel
    require(sweeps[0] == 0 and not any(train_counts.values()),
            f"the segmenter's training ran {sweeps[0]} E-steps, launches {train_counts}")
    # each segmentation is one float64 decode: kernel K once a sentence
    reset_counts(*wrappers)
    got = [seg.segment(text) for text in SEG_SENTENCES]
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in wrappers}
    launches["segmenter"] = counts
    want = {n: len(SEG_SENTENCES) * int(n == "viterbi_scan") for n in counts}
    require(counts == want, f"the segmentations launched {counts}, expected {want}")
    seg_s = time.perf_counter() - t0
    seg_cpu = Seg(device="cpu").train(SegDataSet.mark(line) for line in SEG_CORPUS)
    ref = [seg_cpu.segment(text) for text in SEG_SENTENCES]
    require(got == ref, f"segmenter: card {got} vs CPU {ref}")
    require(got[0] == ["我们", "喜欢", "学习", "中文"], f"segmenter: {got[0]}")
    codes = seg.model.emissions(seg._encode(SEG_SENTENCES[-1]))
    k = trellis.viterbi_scan(seg.model.log_pi, seg.model.log_a, codes)
    require(same_trellis(torch, k, trellis.viterbi_scan_plain(seg.model.log_pi, seg.model.log_a,
                                                                codes)),
            "the segmenter's float64 decode: kernel K differs from the plain loop on the card")
    print(f"segmenter on the card: {got} (equal to the CPU's); training and {len(got)} "
          f"segmentations {seg_s:.3f} s; training launches {train_counts}, the segmentations' "
          f"{counts} (kernel K once a sentence, float64, bitwise the plain loop's)")
    return {"sweep_ms": step_ms, "busy": busy / prof_ms, "launches": n_launch, "stages": stages,
            "unit_s": unit_s, "g": g}


PARALLEL_RANKS = 4


def parallel_rank(ckdir):
    """One rank of :func:`parallel_phase`'s world (4 ranks, gloo, one
    card): every check's inputs and results, as NumPy, for the parent to
    hold against the single-process paths. Runs in a spawned process, so
    it imports what it needs and synchronizes the device itself."""
    import torch
    import torch.distributed as dist

    from lnasr_tpu_torch import parallel as P
    from lnasr_tpu_torch import entry
    from lnasr_tpu_torch.config import MeshConfig, TrainConfig
    from lnasr_tpu_torch.models import gmmhmm as tgh
    from lnasr_tpu_torch.models.mfcc import MFCC
    from lnasr_tpu_torch.ops import factored as F
    from lnasr_tpu_torch.ops import mel_frontend as mf
    from lnasr_tpu_torch.ops import trellis
    from lnasr_tpu_torch.ops import trigram as tri
    from lnasr_tpu_torch.ops import viterbi as vt
    from lnasr_tpu_torch.ops import viterbi_dense as vd
    from lnasr_tpu_torch.parallel import distributed as D
    from lnasr_tpu_torch.parallel.mesh import mesh_axis
    from lnasr_tpu_torch.vad import ltsd as tltsd
    from lnasr_tpu_torch.vad import webrtc as tweb

    dev = D.local_device()
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    f32, f64 = torch.float32, torch.float64
    host = lambda x: x.detach().cpu().numpy()  # noqa: E731
    counted = (mf.mel_frontend, vt.viterbi_small, vd.viterbi_dense, F.factored_forward,
               F.factored_backtrace, F.factored_lattice, trellis.forward_backward,
               tri.trigram_forward, tri.trigram_backtrace, tweb.gmm_flags, tltsd.ltsd_noise,
               trellis.viterbi_scan, trellis.trellis_chunk, trellis.pointer_walk)

    def counts():
        return {w.__name__: w.launches for w in counted}

    def wall_ms(fn, reps=3):
        fn()
        sync()
        times = []
        for _ in range(reps):
            t0 = time.perf_counter()
            fn()
            sync()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    t_start = time.perf_counter()
    out = {"rank": dist.get_rank(), "backend": dist.get_backend(), "device": str(dev)}
    dp_mesh = P.make_mesh(MeshConfig(PARALLEL_RANKS, 1, 1))

    # -- data-parallel EM: this rank's 16 utterances, kernel A on its own signals
    sync()
    reset_counts(*counted)
    run = entry.parallel_training(dp_mesh, device=dev, dtype=f64)
    p1, ll1 = run.step(run.params)
    sync()
    out["dp_launches"] = counts()
    out["dp64"] = (float(ll1), [host(x) for x in p1])
    feats_all = D.all_gather(run.features.float(), mesh_axis(dp_mesh, "data")).flatten(0, 1)
    mask_all = torch.ones(feats_all.shape[:2], dtype=torch.bool, device=dev)
    if out["rank"] == 0:
        out["features"] = host(feats_all)
    step32 = P.make_dp_gmmhmm_em_step(dp_mesh, entry.MODEL_CONFIG)
    feats32, p32 = run.features.float(), entry.flagship_model(dev).params
    sweep = lambda: step32(p32, feats32, run.mask)  # noqa: E731
    out["dp32_ms"] = cuda_ms(sweep, reps=3, warmup=1) if on_card else wall_ms(sweep)
    D.STATS.reset()
    sweep()
    sync()
    out["dp32_collectives"] = (D.STATS.calls, D.STATS.bytes, D.STATS.seconds * 1e3)

    # -- model-parallel EM on a (data 2, model 2) mesh, the same batch
    mp_mesh = P.make_mesh(MeshConfig(2, 1, 2))
    mp = entry.parallel_training(mp_mesh, device=dev, dtype=f64, features=feats_all)
    sync()
    reset_counts(*counted)
    pm, llm = mp.step(mp.params)
    sync()
    out["mp_launches"] = counts()
    out["mp64"] = (float(llm), [host(x) for x in P.mp_param_specs().gather(pm, mp_mesh)])
    D.STATS.reset()
    out["mp64_ms"] = wall_ms(lambda: mp.step(mp.params), reps=1)
    out["mp64_collectives"] = (D.STATS.calls / 2, D.STATS.bytes / 2, D.STATS.seconds * 1e3 / 2)

    def mp_train(iters, ck=None):
        model = entry.flagship_model(dev, f64)
        cfg = TrainConfig(max_iters=iters, eps=0.0, checkpoint_every=1 if ck else 0,
                          checkpoint_dir=ck)
        hist = P.train_model_parallel(model, feats_all, mask_all, mp_mesh, config=cfg)
        return hist, model.params

    straight = mp_train(4)
    mp_train(2, ckdir)
    resumed = mp_train(4, ckdir)
    out["mp_resume"] = (straight[0], resumed[0],
                        all(torch.equal(a, b) for a, b in zip(straight[1], resumed[1])))

    # -- sequence parallel: ONE long utterance (the live stream's 62.9 s) on seq = 4
    seq_mesh = P.make_mesh(MeshConfig(1, PARALLEL_RANKS, 1))
    stream = torch.as_tensor(entry.serving_stream().astype(np.float32), device=dev)
    feats_s, _ = MFCC(entry.MFCC_CONFIG, device=dev).features_fast(stream)
    if out["rank"] == 0:
        out["stream_features"] = host(feats_s)
    seq, seq_ms = {}, {}
    for dtype in (f64, f32):
        params = entry.flagship_model(dev, dtype).params
        log_b = tgh._emissions(params, feats_s.to(dtype), "diag")[0]
        lp, la = params.log_pi, params.log_a
        t0 = time.perf_counter()
        alpha, ll = P.forward_seq_parallel(lp, la, log_b, seq_mesh)
        beta = P.backward_seq_parallel(la, log_b, seq_mesh)
        path, score = P.viterbi_seq_parallel(lp, la, log_b, seq_mesh)
        sync()
        seq_ms[str(dtype)] = (time.perf_counter() - t0) * 1e3
        seq[str(dtype)] = dict(alpha=host(alpha), loglik=float(ll), beta=host(beta),
                               path=host(path), score=float(score))
    model = entry.flagship_model(dev, f64)
    t0 = time.perf_counter()
    hist = P.train_seq_parallel(model, feats_s.double(), seq_mesh, iters=1)
    seq_ms["em"] = (time.perf_counter() - t0) * 1e3
    seq["em"] = (hist, [host(x) for x in model.params])
    out["seq"], out["seq_ms"] = seq, seq_ms

    # -- the sharded V = 1000 decode: 8 bucketed segments over data = 4, two planted
    sync()
    reset_counts(*counted)
    serve = entry.parallel_serving(1000, 8, device=dev)
    graph = serve.recognizer.graph
    feats, masks, planted = planted_rows(torch, graph, serve.recognizer.lm.ngram, serve.features,
                                         serve.masks)
    res = P.decode_batch_sharded(graph, feats, masks, dp_mesh)
    sync()
    out["decode_launches"] = counts()
    out["decode"] = res
    out["planted"] = planted
    if out["rank"] == 0:
        out["decode_inputs"] = (host(feats), host(masks))
    out["decode_ms"] = wall_ms(lambda: P.decode_batch_sharded(graph, feats, masks, dp_mesh))

    # -- the streaming pipeline on one 10 s flagship utterance, 2 and 4 stages:
    # kernel P once a chunk on the decoder rank, the walk once a decode
    params = entry.flagship_model(dev, f64).params
    args = (params.log_pi, params.log_a, params.log_w, params.mu, params.cov,
            feats_all[0].double())
    pipe, pipe_ms, meshes = {}, {}, {}
    sync()
    reset_counts(*counted)
    by_route = (trellis.trellis_chunk.route_launches, trellis.pointer_walk.route_launches)
    for routes in by_route:
        routes.update(dict.fromkeys(routes, 0))
    for n_stages in (2, 4):
        mesh = meshes[n_stages] = P.make_stage_mesh(n_stages=n_stages)
        t0 = time.perf_counter()
        path, score = P.streaming_pipeline_decode(*args, mesh, chunk=PIPE_CHUNK)
        sync()
        pipe_ms[n_stages] = (time.perf_counter() - t0) * 1e3
        ll = P.streaming_pipeline_scores(*args, mesh, chunk=PIPE_CHUNK, semiring="log")
        pipe[n_stages] = dict(path=host(path), score=float(score), loglik=float(ll))
    sync()
    out["pipe_launches"] = counts()
    out["pipe_routes"] = [dict(routes) for routes in by_route]
    # the same decodes again, warm (the first call of a rank also loads the
    # kernels' library), in turns with the decoder stage and walk the port
    # ran before kernel P (their plain versions, on the card), then one warm
    # decode's collectives: calls, bytes, host ms
    from lnasr_tpu_torch.parallel import pipeline as pipe_mod

    stages = {"kernel": (trellis.trellis_chunk, trellis.pointer_walk),
              "plain": (trellis.trellis_chunk_plain, trellis.pointer_walk_plain)}
    pipe_warm_ms, pipe_coll = {}, {}
    for k, m in meshes.items():
        decode = lambda m=m: P.streaming_pipeline_decode(*args, m, chunk=PIPE_CHUNK)  # noqa: E731
        pipe_warm_ms[k] = {"kernel": [], "plain": []}
        try:
            for version in ("kernel", "plain", "plain", "kernel"):
                pipe_mod.trellis_chunk, pipe_mod.pointer_walk = stages[version]
                pipe_warm_ms[k][version].append(wall_ms(decode))
        finally:
            pipe_mod.trellis_chunk, pipe_mod.pointer_walk = stages["kernel"]
        D.STATS.reset()
        decode()
        sync()
        pipe_coll[k] = (D.STATS.calls, D.STATS.bytes, D.STATS.seconds * 1e3)
    out["pipe"], out["pipe_ms"], out["pipe_warm_ms"] = pipe, pipe_ms, pipe_warm_ms
    out["pipe_collectives"] = pipe_coll
    out["elapsed_s"] = time.perf_counter() - t_start
    return out


def rel_dist(got, ref):
    """max |got - ref| / max |ref| over the finite entries (equal entries,
    -inf included, count 0)."""
    got, ref = np.asarray(got, np.float64), np.asarray(ref, np.float64)
    d = np.where(got == ref, 0.0, np.abs(got - ref))
    return float(np.nan_to_num(d, nan=np.inf).max() / np.abs(ref[np.isfinite(ref)]).max())


def same_results(a, b) -> bool:
    """Nested results equal, arrays bit for bit."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same_results(a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return len(a) == len(b) and all(same_results(x, y) for x, y in zip(a, b))
    if isinstance(a, np.ndarray):
        return (a.dtype == b.dtype and a.shape == b.shape
                and np.array_equal(a.reshape(-1).view(np.uint8), b.reshape(-1).view(np.uint8)))
    return a == b


def check_parallel_a(torch, entry, ranks, feats_all, feats_s):
    """Kernel A in the parallel phase: held against its plain version
    (:func:`check_a_shape`) at each shape a rank ran it (each rank's 16
    training rows at the training config, the serving batch of 8 padded
    segments with lengths at the serving config, the 62.9 s stream at the
    training config), and the features the ranks used (gathered from them)
    against the plain path's on the same signals: masks equal, features
    within 0.01 (the planted decode rows, which replace A's features, left
    out)."""
    from lnasr_tpu_torch.models.mfcc import mfcc_features
    from lnasr_tpu_torch.ops import mel_frontend as mf

    dev = torch.device(DEVICE)

    def a_at(sig, cfg, lens, got, got_mask, where, rows=None):
        mel_err, scale, ferr = check_a_shape(torch, mf, sig, cfg, lens, where)
        ref = mfcc_features(sig, cfg, lens)
        rows = slice(None) if rows is None else rows
        ref_f, ref_m = ref.features[rows], ref.mask[rows]
        require(torch.equal(got_mask[rows], ref_m), f"the ranks' feature masks ({where})")
        used = float(((got[rows] - ref_f).abs() * ref_m[..., None]).max())
        require(used < 0.01, f"the ranks' features off the plain path's by {used} ({where})")
        return (f"{where}, B={sig.shape[0]} x {sig.shape[1]} ({a_route(mf, sig, cfg)}): mel err "
                f"{mel_err:.4g} of scale {scale:.4g}, features {ferr:.4g}; the ranks' {used:.4g}")

    lines = []
    signals = torch.as_tensor(entry.training_signals(), device=dev)
    per = signals.shape[0] // PARALLEL_RANKS
    ones = torch.ones(feats_all.shape[:2], dtype=torch.bool, device=dev)
    for r in range(PARALLEL_RANKS):
        rows = slice(r * per, (r + 1) * per)
        lines.append(a_at(signals[rows], entry.MFCC_CONFIG, None, feats_all[rows], ones[rows],
                          f"training rows of rank {r}"))
    batch, lengths = entry.parallel_serving_signals(8)
    feats, masks = (torch.as_tensor(x, device=dev) for x in ranks[0]["decode_inputs"])
    kept = [i for i in range(len(batch)) if i not in ranks[0]["planted"]]
    lines.append(a_at(torch.as_tensor(batch, device=dev), entry.SERVING_MFCC_CONFIG,
                      torch.as_tensor(lengths, device=dev), feats, masks,
                      f"serving batch (rows {kept}; every rank)", rows=kept))
    stream = torch.as_tensor(entry.serving_stream().astype(np.float32), device=dev)[None]
    lines.append(a_at(stream, entry.MFCC_CONFIG, None, feats_s[None],
                      torch.ones((1, feats_s.shape[0]), dtype=torch.bool, device=dev),
                      "seq stream (every rank)"))
    print("parallel kernel A vs its plain version at the ranks' shapes: " + "; ".join(lines))


def parallel_phase(torch, entry, wrappers, card, launches, sweep_ms):
    """``parallel/`` on the card: ONE world of 4 ranks spawned on one card
    (gloo: NCCL refuses two ranks on one device), the kernels built in this
    process first so the ranks only load them. Data-parallel EM (the
    flagship batch, 16 utterances a rank, kernel A on each rank's own
    signals), model-parallel EM on (data 2, model 2) with kill and resume,
    sequence parallelism on the 62.9 s stream (forward, backward, Viterbi,
    one EM sweep), the sharded V = 1000 decode (kernels A, D and E once on
    every rank: D and E once for the rank's two rows) and the pipeline (2 and 4 stages), each held
    against the single-process path on the card, and kernel A against its
    plain version at every shape the ranks ran it
    (:func:`check_parallel_a`); then one data-parallel
    sweep on a world of one under NCCL. Several ranks on one card show
    correctness and overhead, not scaling."""
    import tempfile

    import torch.distributed as dist

    from lnasr_tpu_torch import parallel as P
    from lnasr_tpu_torch.models import gmmhmm as tgh
    from lnasr_tpu_torch.ops.trellis import backward_scan, forward_scan, viterbi_scan
    from lnasr_tpu_torch.parallel import distributed as D

    f32, f64 = torch.float32, torch.float64
    shared = f"{PARALLEL_RANKS} ranks share one H100: correctness and overhead, not scaling"
    sync = torch.cuda.synchronize
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        ranks = D.run_ranks(parallel_rank, PARALLEL_RANKS, args=(tmp,), device=DEVICE,
                            timeout=900)
        world_s = time.perf_counter() - t0
    r0 = ranks[0]
    backends = {r["backend"] for r in ranks}
    print(f"parallel phase: backend {sorted(backends)} (chosen by rule: "
          f"{torch.cuda.device_count()} card(s) for {PARALLEL_RANKS} ranks), world "
          f"{PARALLEL_RANKS} on {sorted({r['device'] for r in ranks})}; meshes (data, seq, "
          f"model) = (4, 1, 1), (2, 1, 2), (1, 4, 1) and stage meshes of 2 and 4; spawn and run "
          f"{world_s:.1f} s (ranks' own work {max(r['elapsed_s'] for r in ranks):.1f} s); {shared}")
    require(backends == {D.choose_backend(DEVICE, torch.cuda.device_count(), PARALLEL_RANKS)},
            f"the ranks chose {backends}")
    for key in ("dp64", "mp64", "mp_resume", "seq", "decode", "pipe"):
        require(all(same_results(r[key], r0[key]) for r in ranks[1:]),
                f"the ranks' {key} results differ")
    feats_all = torch.as_tensor(r0["features"], device=DEVICE)
    feats_s = torch.as_tensor(r0["stream_features"], device=DEVICE)
    check_parallel_a(torch, entry, ranks, feats_all, feats_s)

    # -- data- and model-parallel EM against the single-process sweep ------
    run = entry.training(device=DEVICE, dtype=f64, features=feats_all)
    p_ref, ll_ref = run.step(run.params)
    ll_ref = float(ll_ref)
    errs = {}
    for key in ("dp64", "mp64"):
        ll, params = r0[key]
        got = tgh.GMMHMMParams(*(torch.as_tensor(x, device=DEVICE) for x in params))
        errs[key] = max(param_dist(torch, got, p_ref), abs(ll - ll_ref) / abs(ll_ref))
    dp_launch = [r["dp_launches"] for r in ranks]
    mp_launch = [r["mp_launches"] for r in ranks]
    none = {w.__name__: 0 for w in wrappers}
    require(all(c == none | {"mel_frontend": 1, "forward_backward": 1} for c in dp_launch),
            f"parallel_training's launches per rank (features and one DP sweep) {dp_launch}")
    require(all(c == none | {"forward_backward": 1} for c in mp_launch),
            f"one MP sweep's launches per rank {mp_launch}")
    launches["parallel training"] = {n: sum(c[n] for c in dp_launch) for n in none}
    launches["parallel MP sweep"] = {n: sum(c[n] for c in mp_launch) for n in none}
    hist_s, hist_r, bitwise = r0["mp_resume"]
    calls, n_bytes, coll_ms = r0["dp32_collectives"]
    mp_calls, mp_bytes, mp_coll_ms = r0["mp64_collectives"]
    print(f"parallel DP EM (data 4, 16 x 10 s utterances a rank, kernel A once on each rank's "
          f"signals, kernel G once a sweep on every DP and MP rank: {dp_launch[0]}, "
          f"{mp_launch[0]}; B=64, 5x8x39 diag): float64 vs the single-process sweep on the card "
          f"{errs['dp64']:.3g} (bar 1e-9; loglik {r0['dp64'][0]:.10e} vs {ll_ref:.10e}); "
          f"MP EM (data 2, model 2): {errs['mp64']:.3g} (bar 1e-9); MP kill and resume (4 "
          f"sweeps straight vs 2 + resume to 4): {'bitwise' if bitwise else 'DIFFER'}, logliks "
          f"{hist_s}")
    require(errs["dp64"] < 1e-9, f"DP EM differs from the single-process sweep by {errs['dp64']}")
    require(errs["mp64"] < 1e-9, f"MP EM differs from the single-process sweep by {errs['mp64']}")
    require(bitwise and hist_s == hist_r, "MP kill and resume is not bitwise")
    print(f"timing on {card}: DP EM sweep float32, 16 utterances a rank: "
          + ", ".join(f"rank {r['rank']} {r['dp32_ms']:.4f} ms" for r in ranks)
          + f" (CUDA events, median of 3 after 1 warm-up; single-process B=64 sweep "
          f"{sweep_ms:.4f} ms); per sweep {calls} collective call(s), {n_bytes} bytes, "
          f"{coll_ms:.4f} ms of host time in collectives (rank 0); MP float64 sweep "
          f"{r0['mp64_ms']:.4f} ms, {mp_calls:.0f} collective calls, {mp_bytes:.0f} bytes, "
          f"{mp_coll_ms:.4f} ms in collectives; {shared}")

    # -- sequence parallelism against the single-process scans ---------------
    t_len = feats_s.shape[0]
    seq_err = {}
    for dtype in (f64, f32):
        params = entry.flagship_model(DEVICE, dtype).params
        log_b = tgh._emissions(params, feats_s.to(dtype), "diag")[0]
        fwd = forward_scan(params.log_pi, params.log_a, log_b)
        beta = backward_scan(params.log_a, log_b)
        vit = viterbi_scan(params.log_pi, params.log_a, log_b)
        got = r0["seq"][str(dtype)]
        seq_err[dtype] = dict(
            alpha=rel_dist(got["alpha"], fwd.alpha.cpu()),
            loglik=abs(got["loglik"] - float(fwd.loglik)) / abs(float(fwd.loglik)),
            beta=rel_dist(got["beta"], beta.cpu()),
            path=float(np.mean(got["path"] == vit.path.cpu().numpy())),
            score=abs(got["score"] - float(vit.score)) / abs(float(vit.score)))
    e64 = seq_err[f64]
    model = entry.flagship_model(DEVICE, f64)  # its floor resolved, as the ranks' model's
    mask = torch.ones((1, t_len), dtype=torch.bool, device=DEVICE)
    p_ref, ll_ref = model._em(model.params, feats_s.double()[None], mask)
    hist, em_params = r0["seq"]["em"]
    got = tgh.GMMHMMParams(*(torch.as_tensor(x, device=DEVICE) for x in em_params))
    em_err = max(param_dist(torch, got, p_ref), abs(hist[0] - float(ll_ref)) / abs(float(ll_ref)))
    print(f"parallel seq (seq 4, ONE utterance: the stream's {t_len} frames, 5x8x39): float64 "
          f"alpha {e64['alpha']:.3g}, loglik {e64['loglik']:.3g}, beta {e64['beta']:.3g} (bar "
          f"1e-10, max |err| / max |ref|); Viterbi path {'equal' if e64['path'] == 1.0 else 'DIFFERS'}, "
          f"score {e64['score']:.3g} (bar 1e-12); EM sweep {em_err:.3g} (bar 1e-9); float32: "
          f"{100 * seq_err[f32]['path']:.4f}% of frames on the single-process path's state, "
          f"alpha {seq_err[f32]['alpha']:.3g}, score {seq_err[f32]['score']:.3g}")
    require(e64["alpha"] < 1e-10 and e64["beta"] < 1e-10 and e64["loglik"] < 1e-10,
            f"seq-parallel forward/backward differ from the scans: {e64}")
    require(e64["path"] == 1.0 and e64["score"] < 1e-12, f"seq-parallel Viterbi: {e64}")
    require(em_err < 1e-9, f"seq-parallel EM differs from the single-process sweep by {em_err}")
    print(f"timing on {card}: seq forward + backward + Viterbi on {t_len} frames: float64 "
          f"{r0['seq_ms'][str(f64)]:.2f} ms, float32 {r0['seq_ms'][str(f32)]:.2f} ms; "
          f"the EM sweep {r0['seq_ms']['em']:.2f} ms (host clock, rank 0); {shared}")

    # -- the sharded decode against decode_batch, bitwise --------------------
    rec, _ = entry.recognizer_serving(1000, device=DEVICE)
    feats, masks = (torch.as_tensor(x, device=DEVICE) for x in r0["decode_inputs"])
    ref = rec.graph.decode_batch(feats, masks)
    sync()
    t0 = time.perf_counter()
    rec.graph.decode_batch(feats, masks)
    sync()
    single_ms = (time.perf_counter() - t0) * 1e3
    got = r0["decode"]
    equal = len(got) == len(ref) and all(
        gw == rw and np.array_equal(gp, rp) and gp.dtype == rp.dtype and gs == rs
        for (gw, gp, gs), (rw, rp, rs) in zip(got, ref))
    per_rank = [r["decode_launches"] for r in ranks]
    total = {w.__name__: sum(c[w.__name__] for c in per_rank) for w in wrappers}
    launches["parallel"] = total
    print(f"main path: parallel.decode_batch_sharded at V=1000 (entry.parallel_serving: 8 "
          f"bucketed segments of the stream, rows {sorted(r0['planted'])} planted with "
          f"{list(r0['planted'].values())}) over data 4: words {[w for w, _, _ in got]}; "
          f"{'bitwise equal' if equal else 'NOT EQUAL'} to the single-process decode_batch "
          f"(words, int32 paths, scores); launches per rank {per_rank}, total {total}")
    require(equal, "the sharded decode differs from decode_batch")
    for row, words in r0["planted"].items():
        require(got[row][0] == words, f"planted row {row}: {words} decoded as {got[row][0]}")
    expect = {w.__name__: 0 for w in wrappers} | {"mel_frontend": 1, "factored_forward": 1,
                                                  "factored_backtrace": 1}
    require(all(c == expect for c in per_rank), f"the sharded decode's launches per rank: {per_rank}")
    print(f"timing on {card}: sharded decode of 8 segments: "
          + ", ".join(f"rank {r['rank']} {r['decode_ms']:.3f} ms" for r in ranks)
          + f" (host clock, median of 3); single-process decode_batch {single_ms:.3f} ms; {shared}")

    # -- the pipeline against the single-process scans -----------------------
    x0 = feats_all[0].double()
    p = entry.flagship_model(DEVICE, f64).params
    log_b = tgh._emissions(p, x0, "diag")[0]
    vit = viterbi_scan(p.log_pi, p.log_a, log_b)
    fwd = forward_scan(p.log_pi, p.log_a, log_b)
    for n_stages, got in r0["pipe"].items():
        same = np.array_equal(got["path"], vit.path.cpu().numpy())
        e_score = abs(got["score"] - float(vit.score)) / abs(float(vit.score))
        e_ll = abs(got["loglik"] - float(fwd.loglik)) / abs(float(fwd.loglik))
        print(f"parallel pipeline, {n_stages} stages, chunk {PIPE_CHUNK} of T={x0.shape[0]}: "
              f"path {'equal' if same else 'DIFFERS'} to viterbi_scan, score {e_score:.3g}, "
              f"log-semiring loglik {e_ll:.3g} vs forward_scan (bars 1e-10); decode "
              f"{r0['pipe_ms'][n_stages]:.2f} ms first call on {card}; warm, in turns (kernel, "
              f"plain, plain, kernel; the plain decoder stage and walk on the card: the port "
              f"before kernel P), host clock, median of 3 each: "
              + "; ".join(f"rank {r['rank']} kernel " + " / ".join(
                  f"{x:.2f}" for x in r["pipe_warm_ms"][n_stages]["kernel"]) + " ms, plain "
                  + " / ".join(f"{x:.2f}" for x in r["pipe_warm_ms"][n_stages]["plain"])
                  + " ms, collectives of one warm decode {:.0f} calls, {:.0f} bytes, {:.2f} ms"
                  .format(*r["pipe_collectives"][n_stages]) for r in ranks)
              + f" ({shared})")
        require(same and e_score < 1e-10 and e_ll < 1e-10,
                f"the {n_stages}-stage pipeline: path equal {same}, {e_score}, {e_ll}")
    # kernel P on the decoder ranks (rank 1 of 2 stages, rank 3 of 4): 9
    # chunks for the decode and 9 for the log-semiring scores; the walk on
    # every rank once a decode
    pipe_launch = [r["pipe_launches"] for r in ranks]
    n_chunks = x0.shape[0] // PIPE_CHUNK
    want = [none | {"trellis_chunk": 2 * n_chunks if r["rank"] in (1, 3) else 0,
                    "pointer_walk": 2} for r in ranks]
    launches["parallel pipeline"] = {n: sum(c[n] for c in pipe_launch) for n in none}
    mine = ("trellis_chunk", "pointer_walk")
    others = sum(v for c in pipe_launch for k, v in c.items() if k not in mine)
    print("main path: the 2- and 4-stage pipelines' launches per rank (trellis_chunk, "
          "pointer_walk): " + ", ".join(f"rank {r['rank']} ({c[mine[0]]}, {c[mine[1]]})"
                                        for r, c in zip(ranks, pipe_launch))
          + f"; every other kernel {others}")
    require(pipe_launch == want, f"the pipelines' launches per rank {pipe_launch}, expected {want}")
    # by route: the decode's max-plus chunks on the warp route, the scores'
    # log-semiring chunks on the chunked one, every walk on the map route
    pipe_routes = [r["pipe_routes"] for r in ranks]
    want_routes = [[{"warp": n_chunks, "block": 0, "chunked": n_chunks} if r["rank"] in (1, 3)
                    else {"warp": 0, "block": 0, "chunked": 0}, {"maps": 2, "chase": 0}]
                   for r in ranks]
    pipe_by_route = {
        name: {k: sum(r[i][k] for r in pipe_routes) for k in pipe_routes[0][i]}
        for i, name in enumerate(mine)}
    print("main path: the pipelines' launches per rank by route (trellis_chunk; pointer_walk): "
          + ", ".join(f"rank {r['rank']} ({c[0]}; {c[1]})" for r, c in zip(ranks, pipe_routes)))
    require(pipe_routes == want_routes,
            f"the pipelines' launches by route {pipe_routes}, expected {want_routes}")

    # -- a world of one under NCCL (the backend rule's other branch) ----------
    with tempfile.TemporaryDirectory() as tmp:
        backend = D.initialize("file://" + os.path.join(tmp, "rendezvous"), 1, 0, device=DEVICE)
        try:
            expect = D.choose_backend(DEVICE, torch.cuda.device_count(), 1)
            run1 = entry.parallel_training(P.make_mesh(), device=DEVICE, dtype=f64,
                                           batch=16, features=feats_all[:16])
            p1, ll1 = run1.step(run1.params)
            ref = entry.training(device=DEVICE, dtype=f64, features=feats_all[:16])
            p_ref, ll_ref = ref.step(ref.params)
            e1 = max(param_dist(torch, p1, p_ref), abs(float(ll1) - float(ll_ref))
                     / abs(float(ll_ref)))
            probe = torch.arange(4.0, device=DEVICE)
            dist.all_reduce(probe)
            sync()
        finally:
            dist.destroy_process_group()
    print(f"parallel world of one: backend {backend} (rule: {expect}), mesh (1, 1, 1), one DP "
          f"sweep of 16 utterances vs the single-process sweep {e1:.3g} (bar 1e-9); "
          f"all_reduce on the card {probe.tolist()}")
    require(backend == expect and e1 < 1e-9 and probe.tolist() == [0.0, 1.0, 2.0, 3.0],
            f"the world of one: backend {backend}, sweep {e1}, all_reduce {probe.tolist()}")
    return {"world_s": world_s, "dp32_ms": [r["dp32_ms"] for r in ranks],
            "pipe_by_route": pipe_by_route}


# -- the command line, harnesses and examples -------------------------------------

CLI_WORD_F0 = {"low": 220.0, "mid": 560.0, "high": 1400.0}  # tests/test_cli.py's words
CLI_CORPUS = "low mid high\nhigh mid low\nlow high\nmid mid low\n"
CLI_TRUTH = ["high", "low", "mid"]
CLI_SCORE = r"(#\d+ )(-?[\d.]+)"


def cli_word_audio(word, rng, dur=0.3):
    """A tone-burst word of ``tests/test_cli.py``: three harmonics of the
    word's pitch under a Hann window, int16 at 16 kHz."""
    n = int(SR * dur)
    t = np.arange(n) / SR
    f0 = CLI_WORD_F0[word] * (1.0 + 0.01 * rng.normal())
    sig = sum(np.sin(2 * np.pi * k * f0 * t + rng.uniform(0, 2 * np.pi)) / k for k in range(1, 4))
    x = (sig * np.hanning(n) * 0.3 + rng.normal(0, 0.01, n)) * 12000
    return np.clip(x, -32768, 32767).astype(np.int16)


def cli_gap(rng, dur):
    return rng.normal(0, 60.0, int(SR * dur)).astype(np.int16)


# The module attributes through which the decoders and the MFCC pipeline
# reach kernels A, C, D, E, F and H (each wrapper is imported by name there).
KERNEL_SITES = (("lnasr_tpu_torch.models.mfcc", "mel_frontend"),
                ("lnasr_tpu_torch.models.decoder", "viterbi_dense"),
                ("lnasr_tpu_torch.models.decoder", "factored_forward"),
                ("lnasr_tpu_torch.models.decoder", "factored_backtrace"),
                ("lnasr_tpu_torch.models.decoder", "factored_lattice"),
                ("lnasr_tpu_torch.models.decoder", "trigram_viterbi"))
# the wrappers whose launches a recorded site makes, by counter name
SITE_OF = {"trigram_forward": "trigram_viterbi", "trigram_backtrace": "trigram_viterbi"}


def shape_key(torch, x):
    """What sets a kernel call's shapes: tensors by shape and dtype, a hop's
    fields likewise, configs by value."""
    if torch.is_tensor(x):
        return tuple(x.shape), x.dtype
    if isinstance(x, tuple):
        return (type(x).__name__,) + tuple(shape_key(torch, y) for y in x)
    return x if x is None or isinstance(x, (int, float, str)) or dataclasses.is_dataclass(x) \
        else type(x).__name__


@contextlib.contextmanager
def recorded_calls(torch, calls):
    """Within the block, each wrapper of :data:`KERNEL_SITES` is called
    through a recorder that keeps, in ``calls``, the first call at each
    distinct set of input shapes: ``(name, args, kwargs, output)``. The
    wrapper itself runs and counts its launch as before."""
    saved = []
    for mod_name, attr in KERNEL_SITES:
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)

        def recorder(*args, _fn=fn, **kw):
            out = _fn(*args, **kw)
            key = (_fn.__name__, shape_key(torch, args),
                   tuple((k, shape_key(torch, v)) for k, v in sorted(kw.items())))
            calls.setdefault(key, (_fn.__name__, args, kw, out))
            return out

        saved.append((mod, attr, fn))
        setattr(mod, attr, recorder)
    try:
        yield calls
    finally:
        for mod, attr, fn in saved:
            setattr(mod, attr, fn)


def check_recorded(torch, mf, F, vd, calls, what, want):
    """Each call kept by :func:`recorded_calls` against its kernel's plain
    version on the same inputs: A within its bars (:func:`check_a_shape`),
    C, E and H (path and score) bitwise, D's grids bitwise at feasible
    states, F's records bitwise (``-inf`` included). ``want`` names the
    wrappers that must have been checked at least once (H's two by their
    site, :data:`SITE_OF`)."""
    checked = {}
    for name, args, kw, out in calls.values():
        if name == "mel_frontend":
            sig, cfg = args
            check_a_shape(torch, mf, sig, cfg, kw.get("lengths"), what, got=out)
            shape = tuple(sig.shape)
        elif name == "viterbi_dense":
            ref = vd.viterbi_dense_plain(*args, **kw)
            require(all(torch.equal(a, b) for a, b in zip(out, ref)),
                    f"kernel C differs from its plain version on {what}'s inputs: "
                    f"{int((out[0] != ref[0]).sum())} path entries, scores {out[1]} vs {ref[1]}")
            shape = tuple(args[2].shape)
        elif name == "factored_forward":
            ref = F.factored_forward_plain(*args)
            feasible = torch.isfinite(ref)
            require(bool(feasible.any()) and torch.equal(out[feasible], ref[feasible]),
                    f"kernel D grids differ from its plain version at feasible states on "
                    f"{what}'s inputs")
            shape = tuple(args[4].shape)
        elif name == "factored_backtrace":
            ref = F.factored_backtrace_plain(*args)
            require(all(torch.equal(a, b) for a, b in zip(out, ref)),
                    f"kernel E differs from its plain version on {what}'s inputs: "
                    f"{int((out[0] != ref[0]).sum())} path entries, scores {out[1]} vs {ref[1]}")
            shape = tuple(args[0].shape)
        elif name == "trigram_viterbi":
            from lnasr_tpu_torch.ops.trigram import trigram_viterbi_plain

            ref = trigram_viterbi_plain(*args)
            require(torch.equal(out[0], ref[0]) and same_bits(torch, [out[1]], [ref[1]]),
                    f"kernel H differs from its plain version on {what}'s inputs: "
                    f"{int((out[0] != ref[0]).sum())} path entries, scores {out[1]} vs {ref[1]}")
            shape = tuple(args[0].shape)
        else:
            ref = F.factored_lattice_plain(*args)
            bits = lambda x: x.view(torch.int32) if x.is_floating_point() else x  # noqa: E731
            require(all(torch.equal(bits(a), bits(b)) for a, b in zip(out, ref)),
                    f"kernel F records differ from its plain version on {what}'s inputs")
            shape = tuple(args[4].shape)
        checked.setdefault(name, []).append(shape)
    torch.cuda.synchronize()
    want = {SITE_OF.get(n, n) for n in want}
    require(want <= set(checked),
            f"{what}: no call of {sorted(want - set(checked))} was held against its plain "
            "version")
    print(f"{what}: each kernel call at each distinct shape held against its plain version "
          "on the path's own inputs (A within its bars, C, E, F and H bitwise, D bitwise at "
          "feasible states): " + "; ".join(f"{n} at {v}" for n, v in sorted(checked.items())))


def counted_run(torch, wrappers, fn, calls=None):
    """``(fn(), launches, host seconds)`` with the counters of ``wrappers``
    reset just before the call and read just after; with ``calls``, the
    kernels' calls recorded into it (:func:`recorded_calls`)."""
    torch.cuda.synchronize()
    reset_counts(*wrappers)
    t0 = time.perf_counter()
    with contextlib.nullcontext() if calls is None else recorded_calls(torch, calls):
        res = fn()
    torch.cuda.synchronize()
    return res, {w.__name__: w.launches for w in wrappers}, time.perf_counter() - t0


def captured(fn, argv):
    """``(fn(argv), what it printed on stdout, what on stderr)``."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = fn(argv)
    return rc, out.getvalue(), err.getvalue()


def cli_phase(torch, entry, wrappers, card, launches):
    """The command line on the card (``lnasr_tpu_torch.cli``), each path with
    the launch counters reset just before it and read just after:

    - ``mfcc`` on a seeded ``.pcm`` (kernel A once), within the feature bar
      of a ``--device cpu`` run;
    - ``lm-train`` -> ``lm-ppl`` and ``vad`` (webrtc, amrwb): the lines the
      port's objects print when driven directly on the CPU;
    - ``train-am`` and ``recognize`` through ``build_parser()`` and the
      cores, the models in memory (the card's machine may lack h5py; the
      file flow runs too where it has it): ``train-am --f64`` on the card
      against the CPU (1e-8), ``recognize`` with the CPU-trained float32
      model on the card against the CPU in five forms (default graph: A,
      C; ``--graph factored``: A, D, E; ``--nbest 3 --confidence``: A, F;
      ``--bucket-frames 16``: A, C; ``--graph trigram`` with an order-3
      LM: A, H's forward and backtrace);
    - ``cli bench`` (the headline harness at its defaults: A, B, D, E, F),
      the training harness at ``--trials 2`` and the decoder harness at
      ``--frames 500``: valid JSON, no row with an error, kernel C's paths
      bitwise those of the scan;
    - ``examples/multihost_train`` with no flags: a world of one on the
      card (NCCL by the backend rule), three sweeps.

    Each kernel path runs inside :func:`recorded_calls`, and
    :func:`check_recorded` then holds its calls against the kernels' plain
    versions on the same inputs; ``cli bench``'s V = 22 factored graph also
    goes through :func:`check_factored` and :func:`check_lattice`."""
    import importlib.util
    import re
    import tempfile

    import torch.distributed as dist

    from lnasr_tpu_torch import cli
    from lnasr_tpu_torch.models import decoder as tdec
    from lnasr_tpu_torch.ops import factored as F
    from lnasr_tpu_torch.ops import mel_frontend as mf
    from lnasr_tpu_torch.ops import viterbi_dense as vd
    from lnasr_tpu_torch.bench import decoder as bench_decoder
    from lnasr_tpu_torch.bench import train as bench_train
    from lnasr_tpu_torch.examples import multihost_train
    from lnasr_tpu_torch.models.gmmhmm import GMMHMM
    from lnasr_tpu_torch.models.lexicon import Lexicon
    from lnasr_tpu_torch.models.ngram import NGramCounter, NGramModel, NGramModelARPA, Tokenizer
    from lnasr_tpu_torch.models.recognizer import AcousticModel, LanguageModel, segment_speech
    from lnasr_tpu_torch.utils.audio import write_pcm
    from lnasr_tpu_torch.vad.native import AmrWbVad, WebRtcVad

    names = [w.__name__ for w in wrappers]

    def counted(fn, calls=None):
        return counted_run(torch, wrappers, fn, calls)

    def expect(counts, want, what):
        full = {n: 0 for n in names} | want
        require(counts == full, f"{what}: launches {counts}, expected {full}")

    def run_cli(argv):
        return captured(cli.main, argv)

    def json_lines(text):
        return [json.loads(x) for x in text.splitlines() if x.startswith("{")]

    phase_t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        path = lambda name: os.path.join(tmp, name)  # noqa: E731

        # -- mfcc ------------------------------------------------------------
        speech = entry.serving_segment(seed=3)[: 2 * SR].astype(np.int16)
        write_pcm(path("speech.pcm"), speech)
        calls = {}
        (rc, out, _), counts, mfcc_s = counted(
            lambda: run_cli(["mfcc", path("speech.pcm"), path("card.npy")]), calls)
        launches["cli mfcc"] = counts
        rc_c, out_c, _ = run_cli(["mfcc", path("speech.pcm"), path("cpu.npy"), "--device", "cpu"])
        got, ref = np.load(path("card.npy")), np.load(path("cpu.npy"))
        err = float(np.abs(got - ref).max())
        print(f"cli mfcc on {card}: {out.strip()!r} in {mfcc_s:.3f} s (host clock, the command "
              f"whole); features {got.shape} within {err:.3g} of --device cpu (bar 0.01); "
              f"launches {counts}")
        require(rc == rc_c == 0 and got.shape == ref.shape == (199, 39) and err < 0.01,
                f"cli mfcc: rc {rc}/{rc_c}, shapes {got.shape}/{ref.shape}, error {err}")
        require(out_c == out.replace(path("card.npy"), path("cpu.npy")),
                f"cli mfcc printed {out!r} on the card, {out_c!r} on the CPU")
        expect(counts, {"mel_frontend": 1}, "cli mfcc")
        check_recorded(torch, mf, F, vd, calls, "cli mfcc", ["mel_frontend"])

        # -- lm-train -> lm-ppl, vad: host code, as the port's objects print ----
        with open(path("corpus.txt"), "w", encoding="utf-8") as fp:
            fp.write(CLI_CORPUS)
        tokens = [Tokenizer.get_tokens(x) for x in CLI_CORPUS.splitlines()]
        sent = "low mid high mid"
        for order in (2, 3):
            lm_path = path(f"words{order}.lm")
            rc, out, _ = run_cli(["lm-train", path("corpus.txt"), lm_path, "--order", str(order)])
            model = NGramModel(NGramCounter(order, tokens))
            NGramModelARPA().save(model, path(f"direct{order}.lm"))
            with open(lm_path) as a, open(path(f"direct{order}.lm")) as b:
                same_file = a.read() == b.read()
            rc_p, out_p, _ = run_cli(["lm-ppl", lm_path, sent])
            toks = Tokenizer.get_tokens(sent)
            want = f"logprob={model.calc_prob(toks):.4f} ppl={model.calc_ppl(toks):.3f}\n"
            print(f"cli lm-train --order {order} -> lm-ppl: {out_p.strip()!r}; ARPA file "
                  f"{'equal' if same_file else 'DIFFERENT'} to NGramModelARPA().save of the "
                  "same counts")
            require(rc == rc_p == 0 and same_file and out_p == want
                    and out == f"{order}-gram LM over 4 sentences -> {lm_path}\n",
                    f"cli lm-train/lm-ppl --order {order}: {out!r} {out_p!r}, want {want!r}")
        stream = entry.serving_stream()[: 8 * SR]
        write_pcm(path("stream.pcm"), stream)
        for detector in ("webrtc", "amrwb"):
            rc, out, _ = run_cli(["vad", path("stream.pcm"), "--detector", detector])
            vad = WebRtcVad(mode=0) if detector == "webrtc" else AmrWbVad()
            flags = vad.process(stream)
            flags = flags[0] if detector == "amrwb" else flags
            want = "".join(f"speech\t{a / SR:.2f}\t{b / SR:.2f}\n"
                           for a, b in segment_speech(flags, vad.FRAME_LEN))
            print(f"cli vad --detector {detector}: {out.count(chr(10))} speech spans, "
                  f"{'equal' if out == want else 'DIFFERENT'} to the detector driven directly")
            require(rc == 0 and out == want and want, f"cli vad {detector}: {out!r} vs {want!r}")

        # -- train-am and recognize through build_parser() and the cores ----------
        rng = np.random.default_rng(3)
        manifest, audio_of = [], {}
        for w in CLI_WORD_F0:
            for k in range(4):
                audio_of[f"{w}{k}"] = (w, cli_word_audio(w, rng))
        for k in range(3):
            audio_of[f"sil{k}"] = ("<sil>", cli_gap(rng, 0.4))
        for name, (unit, audio) in audio_of.items():
            write_pcm(path(f"{name}.pcm"), audio)
            manifest.append(f"{unit}\t{path(name + '.pcm')}")
        with open(path("train.manifest"), "w") as fp:
            fp.write("\n".join(manifest) + "\n")
        parts = [cli_gap(rng, 0.2)]
        for w in CLI_TRUTH:
            parts += [cli_word_audio(w, rng), cli_gap(rng, 0.2)]
        utterance = np.concatenate(parts)
        write_pcm(path("utt.pcm"), utterance)

        def train_am(extra):
            args = cli.build_parser().parse_args(
                ["train-am", path("train.manifest"), path("am"), "--states", "3", "--mix", "2",
                 "--iters", "5"] + extra)
            am = cli.new_acoustic_model(args)
            examples = {}
            with contextlib.redirect_stdout(io.StringIO()):
                for unit, audio in audio_of.values():
                    examples.setdefault(unit, []).append(cli.unit_features(am, audio))
                return cli.train_am_units(examples, args, am), args

        with counted_sweeps() as sweeps:
            (am64, args64), counts, train_s = counted(lambda: train_am(["--f64"]))
        launches["cli train-am"] = counts
        am64_cpu, args64_cpu = train_am(["--f64", "--device", "cpu"])
        dist64 = max(param_dist(torch, am64.units[u].params, am64_cpu.units[u].params)
                     for u in am64_cpu.units)
        print(f"cli train-am --f64 (build_parser + train_am_units, 4 units, 5 sweeps) on {card}: "
              f"{train_s:.3f} s (host clock); units {sorted(am64.units)}, parameters within "
              f"{dist64:.3g} of --device cpu (bar 1e-8); launches {counts} (the plain MFCC "
              f"pipeline; kernel G once in each of {sweeps[0]} sweeps)")
        require(sorted(am64.units) == sorted(am64_cpu.units) == ["<sil>", "high", "low", "mid"]
                and dist64 < 1e-8, f"cli train-am --f64: card vs CPU {dist64}")
        require(cli.am_config(args64) == cli.am_config(args64_cpu), "am_config.json differs")
        require(sweeps[0] > 0, "cli train-am ran no EM sweep")
        expect(counts, {"forward_backward": sweeps[0]}, "cli train-am")

        am_cpu, _ = train_am(["--device", "cpu"])
        am_card = AcousticModel(
            {u: GMMHMM(m.config, device=DEVICE).set_params(m.params)
             for u, m in am_cpu.units.items()}, am_cpu.mfcc.config, device=DEVICE)
        lexicon = Lexicon.whole_word(list(CLI_WORD_F0))
        lm = LanguageModel(path("words2.lm"))
        base = ["recognize", path("utt.pcm"), "--am", "in-memory", "--lex", "in-memory",
                "--lm", path("words2.lm"), "--lm-scale", "0.5", "--word-penalty", "-40.0",
                "--ref", " ".join(CLI_TRUTH)]
        forms = {
            "cli recognize": ([], {"mel_frontend": 1, "viterbi_dense": 1}),
            "cli recognize factored": (["--graph", "factored"],
                                       {"mel_frontend": 1, "factored_forward": 1,
                                        "factored_backtrace": 1}),
            "cli recognize nbest": (["--nbest", "3", "--confidence"],
                                    {"mel_frontend": 1, "factored_lattice": 1}),
            "cli recognize bucketed": (["--bucket-frames", "16"],
                                       {"mel_frontend": 1, "viterbi_dense": 1}),
            # the exact trigram graph over the order-3 LM
            "cli recognize trigram": (["--graph", "trigram", "--lm", path("words3.lm")],
                                      {"mel_frontend": 1, "trigram_forward": 1,
                                       "trigram_backtrace": 1}),
        }
        lm3 = LanguageModel(path("words3.lm"))
        require(lm3.ngram.order == 3, f"words3.lm is of order {lm3.ngram.order}")
        for key, (extra, want) in forms.items():
            args = cli.build_parser().parse_args(base + extra)
            args_cpu = cli.build_parser().parse_args(base + extra + ["--device", "cpu"])
            lm_form = lm3 if "trigram" in extra else lm
            calls = {}
            (hyp, lines), counts, rec_s = counted(
                lambda: cli.recognize_with(am_card, lexicon, lm_form, utterance, args), calls)
            launches[key] = counts
            hyp_c, lines_c = cli.recognize_with(am_cpu, lexicon, lm_form, utterance, args_cpu)
            text, text_c = (re.sub(CLI_SCORE, r"\1S", "\n".join(x)) for x in (lines, lines_c))
            scores, scores_c = ([float(s) for _, s in re.findall(CLI_SCORE, "\n".join(x))]
                                for x in (lines, lines_c))
            s_err = max([abs(a - b) / abs(b) for a, b in zip(scores, scores_c)] or [0.0])
            print(f"{key} ({' '.join(extra) or 'default graph'}) on {card}: {hyp!r} in "
                  f"{rec_s:.3f} s (host clock, graph build included); {lines[-1]!r}; stderr lines "
                  f"{'equal' if text == text_c else 'DIFFERENT'} to --device cpu, N-best scores "
                  f"within {s_err:.3g} relative (bar 1e-6); launches {counts}")
            require(hyp == hyp_c == " ".join(CLI_TRUTH), f"{key}: {hyp!r} vs the CPU's {hyp_c!r}")
            # the card's and the CPU's emissions differ in float32 rounding, so
            # the scores (sums over ~100 frames at |score| ~ 2e4, where a float32
            # ulp is ~0.002) may differ by a few ulps; the kernels themselves are
            # held bitwise on the card's own inputs just below
            require(text == text_c and len(scores) == len(scores_c) and s_err < 1e-6,
                    f"{key}: stderr {lines} vs the CPU's {lines_c}")
            require(lines[-1].startswith("WER 0.000"), f"{key}: {lines[-1]!r}")
            expect(counts, want, key)
            check_recorded(torch, mf, F, vd, calls, key, list(want))

        if importlib.util.find_spec("h5py") is None:
            print("cli train-am -> recognize: ran through build_parser() and the cores with the "
                  "models in memory; the file flow (train-am OUT/ -> recognize --am OUT/) needs "
                  "h5py, which this machine lacks (the CPU tests run it)")
        else:
            rc, _, _ = run_cli(["train-am", path("train.manifest"), path("am"), "--states", "3",
                                "--mix", "2", "--iters", "5", "--device", "cpu"])
            with open(path("words.lex"), "w") as fp:
                fp.write("".join(f"{w} {w}\n" for w in CLI_WORD_F0))
            argv = base[:2] + ["--am", path("am"), "--lex", path("words.lex")] + base[6:]
            rc2, out, err = run_cli(argv)
            print(f"cli train-am OUT/ -> recognize --am OUT/ (h5py present, the file flow): "
                  f"{out.strip()!r}; {err.strip().splitlines()[-1]!r}")
            require(rc == rc2 == 0 and out.split() == CLI_TRUTH, f"the file flow: {out!r}")

        # -- the bench harnesses -----------------------------------------------
        calls = {}
        (res, counts, bench_s) = counted(lambda: run_cli(["bench"]), calls)
        launches["cli bench"] = counts
        rc, out, _ = res
        head = json_lines(out)
        require(rc == 0 and len(head) == 1, f"cli bench: rc {rc}, output {out!r}")
        head = head[0]
        print(f"cli bench (bench/headline at its defaults) on {card}: {bench_s:.1f} s; flagship "
              f"step {head['value']} audio-s/s (spread {head['spread']['min']}-"
              f"{head['spread']['max']}), serving {head['serving']['value']}; stages "
              + ", ".join(f"{k} {v['seconds_per_call'] * 1e3:.4f} ms "
                          f"({v.get('pct_of_bound', np.nan):.1f}% of its "
                          f"{v.get('bound_by', '(no peaks)')} bound)"
                          for k, v in head["stages"].items())
              + "; segments " + ", ".join(
                  f"V={r['vocab']} decode {r['decode_segment']['seconds_per_call'] * 1e3:.4f} ms, "
                  f"records {r['lattice_records']['seconds_per_call'] * 1e3:.4f} ms"
                  for k, r in head["recognizer_serving"].items() if k != "note")
              + f"; device {head['device']!r}; launches {counts}")
        require(all(counts[n] > 0 for n in ("mel_frontend", "viterbi_small", "factored_forward",
                                            "factored_backtrace", "factored_lattice"))
                and counts["viterbi_dense"] == 0, f"cli bench: launches {counts}")
        require(head["value"] > 0 and head["device"] == card and "error" not in out,
                f"cli bench: {head}")
        print(json.dumps({"cli_bench": head}))
        # kernel B (the flagship step) is held at this shape in section 3 of
        # main; the rest at every shape the harness gave them
        check_recorded(torch, mf, F, vd, calls, "cli bench",
                       ["mel_frontend", "factored_forward", "factored_backtrace",
                        "factored_lattice"])
        rec22, seg22 = entry.recognizer_serving(22, device=DEVICE, graph="factored")
        padded, n_valid, _ = rec22._pad_to_bucket(seg22)
        feats22, mask22 = rec22.am.mfcc.features_fast(
            torch.from_numpy(padded).to(DEVICE), lengths=torch.tensor([n_valid], device=DEVICE))
        g22 = rec22.graph
        require(isinstance(g22, tdec.FactoredDecodingGraph),
                "cli bench's V=22 row did not compose the factored graph")
        lb22, pi22, fin22 = g22._grid_inputs(feats22)
        what = "cli bench's V=22 factored graph, its serving segment"
        check_factored(torch, F, tdec, DEVICE, g22, lb22, pi22, fin22, mask22, what)
        check_lattice(torch, F, g22, lb22, pi22, mask22, what)

        calls = {}
        (res, counts, train_s) = counted(lambda: captured(bench_train.main, ["--trials", "2"]),
                                         calls)
        launches["bench/train"] = counts
        rc, out, _ = res
        tr = json_lines(out)
        require(rc == 0 and len(tr) == 1 and tr[0]["loglik_finite"] and "error" not in out,
                f"bench/train: rc {rc}, {out!r}")
        tr = tr[0]
        print(f"bench/train --trials 2 on {card}: {train_s:.1f} s; one EM sweep "
              f"{tr['seconds_per_sweep'] * 1e3:.4f} ms = {tr['value']} audio-s/s; emissions "
              f"{tr['stages']['emissions']['seconds_per_call'] * 1e3:.4f} ms "
              f"({tr['stages']['emissions'].get('pct_of_bound', np.nan):.1f}% of its "
              f"{tr['stages']['emissions'].get('bound_by', '(no peaks)')} bound); fwd+bwd "
              f"{tr['stages']['fwd_bwd_scans']['us_per_step']} us a step; launches {counts}")
        print(json.dumps({"bench_train": tr}))
        check_recorded(torch, mf, F, vd, calls, "bench/train", ["mel_frontend"])
        calls = {}
        (res, counts, dec_s) = counted(
            lambda: captured(bench_decoder.main, ["--frames", "500"]), calls)
        launches["bench/decoder"] = counts
        rc, out, _ = res
        rows = json_lines(out)
        require(rc == 0 and len(rows) == 5 and not any("error" in json.dumps(r) for r in rows),
                f"bench/decoder: rc {rc}, {out!r}")
        by_row = {r["row"]: r for r in rows}
        dense = by_row["dense_kernel"]
        require(dense["paths_bit_identical"] and by_row["factored_1k"]["paths_equal_scan"]
                and by_row["lattice_1k"]["records_equal_scan"]
                and all(by_row[k]["realizations"]["rank1"]["paths_equal_scan"]
                        for k in ("large_vocab_5k", "large_vocab_10k")),
                f"bench/decoder: a kernel route differs from its scan: {rows}")
        # kernel C's dense_kernel row calls the wrapper directly (bitwise
        # against the scan above); D, E and F at every shape the rows gave them
        check_recorded(torch, mf, F, vd, calls, "bench/decoder",
                       ["factored_forward", "factored_backtrace", "factored_lattice"])
        print(f"bench/decoder --frames 500 on {card}: {dec_s:.1f} s; factored_1k "
              f"{by_row['factored_1k']['decode_seconds'] * 1e3:.4f} ms (scan "
              f"{by_row['factored_1k']['scan_decode_seconds'] * 1e3:.1f} ms), lattice_1k "
              f"{by_row['lattice_1k']['records_seconds'] * 1e3:.4f} ms (scan "
              f"{by_row['lattice_1k']['scan_seconds'] * 1e3:.1f} ms), dense_kernel N=512 "
              f"{dense['kernel_seconds'] * 1e3:.4f} ms, {dense['value']}x the scan, paths "
              f"bitwise equal; large vocabularies "
              + ", ".join(f"{k}: " + ", ".join(f"{n} {x['seconds'] * 1e3:.1f} ms"
                                               for n, x in by_row[k]["realizations"].items()
                                               if "seconds" in x)
                          for k in ("large_vocab_5k", "large_vocab_10k"))
              + f"; launches {counts}")
        for r in rows:
            print(json.dumps({"bench_decoder": r}))

    # -- examples/multihost_train with no flags: a world of one on the card ------
    (res, counts, mh_s) = counted(lambda: captured(multihost_train.main, ["--iters", "3"]))
    launches["examples/multihost_train"] = counts
    rc, out, _ = res
    lls = [float(x) for x in re.findall(r"iter \d+: loglik (-?[\d.]+)", out)]
    backend = re.findall(r"process 0/1: (\w+) on (\S+)", out)
    print(f"examples/multihost_train (no flags) on {card}: {mh_s:.1f} s; {backend}, logliks {lls}")
    require(rc == 0 and backend == [("nccl", "cuda:0")] and len(lls) == 3 and lls == sorted(lls)
            and not dist.is_initialized(), f"multihost_train: {out!r}")
    print(f"cli phase: {time.perf_counter() - phase_t0:.1f} s on {card}")


def first_difference(got, ref):
    """Where two hypotheses (word lists) first differ: ``(index, got word,
    ref word)``, a missing word as ``None``."""
    for i in range(max(len(got), len(ref))):
        a = got[i] if i < len(got) else None
        b = ref[i] if i < len(ref) else None
        if a != b:
            return i, a, b
    return None


def recording_phase(torch, entry, wrappers, card, launches):
    """The recording harnesses on the card, on the seeded stand-in for the
    reference's two speech recordings (``entry.recording_pair``: 12.6 s and
    1.36 s) written as raw PCM into a temporary directory, each with the
    launch counters reset just before it and read just after, and every
    kernel call of both held against its plain version at each distinct
    shape (:func:`recorded_calls`, :func:`check_recorded`):

    - ``bench/stream.py`` (``run``) for 1 minute of stream: the training
      batch and each segment through the mel frontend, each segment's
      decode through the dense-graph Viterbi; ``rtf`` < 0.5 and the buffer
      under 30 s, the harness's own exit rule;
    - the core of ``examples/real_audio_demo.py`` (what ``bench/wer.py``
      runs, with the acoustic model in memory) at the full protocol, 20
      utterances under 6 conditions: mel frontend and dense-graph Viterbi
      a segment, the lattice kernel for the trigram-rescored N-best call;
      its CLI check must match;
    - the demo's units trained in float64 on the card and on the CPU
      (1e-8, the bar of ``cli_phase``'s ``train-am --f64``);
    - the card's float32 model copied to the CPU decodes the protocol
      there: every clean and 10 dB hypothesis must equal the card's, word
      for word (float32 training on the card and the CPU differs by
      rounding, so the decode is held, not the training)."""
    import tempfile

    from lnasr_tpu_torch.bench import stream as bench_stream
    from lnasr_tpu_torch.examples import real_audio_demo as demo
    from lnasr_tpu_torch.models.gmmhmm import GMMHMM
    from lnasr_tpu_torch.models.recognizer import AcousticModel
    from lnasr_tpu_torch.ops import factored as F
    from lnasr_tpu_torch.ops import mel_frontend as mf
    from lnasr_tpu_torch.ops import viterbi_dense as vd
    from lnasr_tpu_torch.utils.audio import read_pcm, write_pcm

    def dense_path(counts, want, what, sweeps):
        require(all(counts[n] > 0 for n in want)
                and all(counts[n] == 0 for n in counts if n not in want),
                f"{what}: launches {counts}; expected {want} and nothing else (the synthetic "
                "vocabulary composes the dense graph; its units train on the card)")
        require(counts["forward_backward"] == sweeps,
                f"{what}: kernel G launched {counts['forward_backward']} times in {sweeps} sweeps")

    phase_t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_recordings_") as tmp:
        paths = [os.path.join(tmp, name) for name in ("data-vad.raw", "data.raw")]
        for path, audio in zip(paths, entry.recording_pair()):
            write_pcm(path, audio)
        recordings = [read_pcm(p) for p in paths]
        words, gaps = demo.recording_words(recordings)
        _, stream_words, _ = bench_stream.stream_inventory(recordings[0])
        demo_states = demo.STATES * len(words) + 3
        stream_states = 6 * len(stream_words) + 3
        print(f"recordings: the stand-in pair {[len(r) / SR for r in recordings]} s written to "
              f"{tmp}; the demo's vocabulary {len(words)} words after the hygiene filter "
              f"({len(gaps)} noise-floor chunks), {demo_states} composed states; the stream "
              f"harness's {len(stream_words)} words, {stream_states} composed states")
        require(len(words) >= 15 and max(demo_states, stream_states) <= 256,
                f"the stand-in gives {len(words)} words ({demo_states} states)")

        # -- bench/stream.py, 1 minute of stream -----------------------------------
        log, calls = io.StringIO(), {}
        with counted_sweeps() as sweeps:
            out, counts, stream_s = counted_run(
                torch, wrappers,
                lambda: bench_stream.run(paths[0], minutes=1.0, device=DEVICE, log=log), calls)
        launches["stream harness"] = counts
        lat, dec = out["latency_ms"], out["decomposition_ms"]
        print(" | ".join(line.strip() for line in log.getvalue().splitlines()))
        print(f"stream harness (bench/stream.py, 1 minute) on {card}: {stream_s:.1f} s; "
              f"{out['segments']} segments of {out['audio_seconds']} s, latency p50 "
              f"{lat['p50']} ms, p95 {lat['p95']}, p99 {lat['p99']}, max {lat['max']}, mean "
              f"{lat['mean']} (host clock around decode_segment; the kernels' recorder sits in "
              f"the calls); rtf {out['rtf']}, wall_rtf {out['wall_rtf']}; largest buffer "
              f"{out['max_buffer_samples']} samples ({out['max_buffer_seconds']} s); dispatch "
              f"p50 {dec['dispatch']['p50']} ms, host and fetch p50 "
              f"{dec['host_and_fetch']['p50']} ms; device time by bucket count (CUDA events, "
              f"median of {bench_stream.TIMING_TRIALS} x {bench_stream.TIMING_REPS} calls) "
              f"{dec['device_by_bucket_count']} ms; launches {counts}")
        print(json.dumps({"stream_harness": out}))
        require(out["rtf"] < 0.5 and out["max_buffer_samples"] < 30 * SR,
                f"stream harness: rtf {out['rtf']}, buffer {out['max_buffer_samples']}")
        require(out["segments"] >= 20 and out["units"] == len(stream_words) + 1,
                f"stream harness: {out['segments']} segments, {out['units']} units")
        dense_path(counts, ("mel_frontend", "viterbi_dense", "forward_backward"), "stream harness",
                   sweeps[0])
        check_recorded(torch, mf, F, vd, calls, "stream harness",
                       ["mel_frontend", "viterbi_dense"])

        # -- the demo's core (bench/wer.py's protocol), units trained on the card ---
        inputs = demo.protocol_inputs(words, gaps)
        calls, train_s = {}, []

        def wer_harness():
            t0 = time.perf_counter()
            am = demo.train_units(inputs, DEVICE)
            torch.cuda.synchronize()
            train_s.append(time.perf_counter() - t0)
            return demo.protocol(words, gaps, device=DEVICE, fixtures=paths, am=am)

        with contextlib.redirect_stdout(io.StringIO()) as demo_out, counted_sweeps() as sweeps:
            run, counts, wer_s = counted_run(torch, wrappers, wer_harness, calls)
        launches["wer harness"] = counts
        rep = run.report
        print(" | ".join(line.strip() for line in demo_out.getvalue().splitlines()))
        print(f"wer harness (the demo's core, protocol v{rep['protocol_version']}) on {card}: "
              f"{wer_s:.1f} s, of which unit training {train_s[0]:.1f} s ({len(run.am.units)} "
              f"units, {demo.ITERS} sweeps, {len(inputs.training)} clips); WER "
              + ", ".join(f"{c} {v['wer']}" for c, v in rep["conditions"].items())
              + f" over {rep['n_ref_words']} reference words, {rep['n_test_utts']} utterances; "
              f"cli_check {rep['cli_check']['match']} ({rep['cli_check']['hyp']!r}); CLI "
              f"defaults {rep['cli_default_check']['hyp']!r} (WER "
              f"{rep['cli_default_check']['wer']}); N-best {run.nbest_lines}; launches {counts}")
        print(json.dumps({"wer_harness": {k: v for k, v in rep.items() if k != "per_utt"}}))
        require(rep["cli_check"]["match"], f"wer harness: the CLI check differs: {rep['cli_check']}")
        require(rep["n_test_utts"] == 20 and len(rep["conditions"]) == 6
                and all(0.0 <= v["wer"] <= 1.0 for v in rep["conditions"].values())
                and run.nbest_lines, f"wer harness: {rep}")
        dense_path(counts, ("mel_frontend", "viterbi_dense", "factored_lattice",
                            "forward_backward"), "wer harness", sweeps[0])
        check_recorded(torch, mf, F, vd, calls, "wer harness",
                       ["mel_frontend", "viterbi_dense", "factored_lattice"])

        # -- float64 units, card against CPU -----------------------------------
        t0 = time.perf_counter()
        am64 = demo.train_units(inputs, DEVICE, f64=True)
        torch.cuda.synchronize()
        t64 = time.perf_counter() - t0
        t0 = time.perf_counter()
        am64_cpu = demo.train_units(inputs, "cpu", f64=True)
        t64_cpu = time.perf_counter() - t0
        dist64 = max(param_dist(torch, am64.units[u].params, am64_cpu.units[u].params)
                     for u in am64_cpu.units)
        print(f"wer harness units in float64: card {t64:.1f} s, CPU {t64_cpu:.1f} s; parameters "
              f"within {dist64:.3g} (bar 1e-8)")
        require(sorted(am64.units) == sorted(am64_cpu.units) and dist64 < 1e-8,
                f"wer harness float64 units, card vs CPU: {dist64}")

        # -- the card's float32 model decoded on the CPU ---------------------------
        am_cpu = AcousticModel({u: GMMHMM(m.config, device="cpu").set_params(m.params)
                                for u, m in run.am.units.items()}, run.am.mfcc.config,
                               device="cpu")
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            run_cpu = demo.protocol(words, gaps, device="cpu", fixtures=paths, am=am_cpu)
        cpu_s = time.perf_counter() - t0
        agree = {}
        for cond, hyps in run.hypotheses.items():
            ref = run_cpu.hypotheses[cond]
            agree[cond] = sum(a == b for a, b in zip(hyps, ref))
            if cond in ("clean", "snr10"):
                for u, (a, b) in enumerate(zip(hyps, ref)):
                    require(a == b, f"wer harness, {cond} utterance {u}: the card decodes {a!r}, "
                            f"the CPU {b!r} (first difference at word "
                            f"{first_difference(a.split(), b.split())})")
        print(f"wer harness: the card's float32 model on the CPU ({cpu_s:.1f} s): hypotheses equal "
              f"to the card's in " + ", ".join(f"{c} {n}/{len(run.hypotheses[c])}"
                                               for c, n in agree.items())
              + f" (clean and snr10 required); CPU WER "
              + ", ".join(f"{c} {v['wer']}" for c, v in run_cpu.report["conditions"].items())
              + f"; CPU N-best {run_cpu.nbest_lines}")
    print(f"recording phase: {time.perf_counter() - phase_t0:.1f} s on {card}")


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lnasr_tpu_torch import _build, entry
    from lnasr_tpu_torch.models import decoder as tdec
    from lnasr_tpu_torch.models.lexicon import Lexicon
    from lnasr_tpu_torch.models.ngram import NGramCounter, NGramModel
    from lnasr_tpu_torch.models.mfcc import mfcc_features_fused
    from lnasr_tpu_torch.ops import factored as F
    from lnasr_tpu_torch.ops import mel_frontend as mf
    from lnasr_tpu_torch.ops import trellis
    from lnasr_tpu_torch.ops import trigram as tri
    from lnasr_tpu_torch.ops import viterbi as vt
    from lnasr_tpu_torch.ops import viterbi_dense as vd
    from lnasr_tpu_torch.ops.framing import hamming_window, num_frames, split_frames
    from lnasr_tpu_torch.vad import ltsd as tltsd
    from lnasr_tpu_torch.vad import webrtc as tweb
    from lnasr_tpu_torch.ops.spectral import mel_filterbank

    dev = torch.device(DEVICE)
    card = card_line()
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda} | "
          f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # -- 1. build -----------------------------------------------------------
    t0 = time.perf_counter()
    built = _build.build_all()
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(built)} kernels (parallel nvcc)")
    for name, (secs, log) in built.items():
        info = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        print(f"  {name}: done at {secs:.1f} s; " + " | ".join(info))
    t0 = time.perf_counter()
    vad_lib = _build.build_native_vad()
    print(f"native VAD build: {time.perf_counter() - t0:.1f} s (g++ of the port's copy of "
          f"{', '.join(_build.NATIVE_VAD_SOURCES)}) -> {os.path.relpath(vad_lib)}")

    cfg = entry.MFCC_CONFIG
    x = make_signals(torch, entry, dev)
    t_frames = num_frames(S, cfg.frame_len, cfg.frame_step)

    # -- 2, 3. kernels A and B vs their plain versions ------------------------
    mel_err = check_mel_frontend(torch, mf, cfg, x, dev)
    check_viterbi_small(torch, vt, vd, dev, t_frames)
    # -- 3b. kernel G vs its plain loops (the flagship sweep's own shape in 12)
    check_forward_backward(torch, trellis, dev)

    # -- 4. the recognizers of the slice, on the card and on the CPU ----------
    recs = {v: entry.recognizer_serving(v, device=dev) for v in (1000, 22)}
    recs_cpu = {v: entry.recognizer_serving(v, device="cpu")[0] for v in (1000, 22)}
    seg = recs[22][1]
    seg_s = len(seg) / entry.SERVING_MFCC_CONFIG.sample_rate

    def segment_inputs(rec):
        """The bucketed segment's features and frame mask on the card, as
        ``Recognizer.decode_segment`` computes them."""
        padded, n, _ = rec._pad_to_bucket(seg)
        return rec.am.mfcc.features_fast(torch.from_numpy(padded).to(dev),
                                         lengths=torch.tensor([n], device=dev))

    g1000, g22 = recs[1000][0].graph, recs[22][0].graph
    require(isinstance(g1000, tdec.FactoredDecodingGraph) and g1000.hop_t is not None,
            "V=1000 did not compose the factored graph with a dense hop")
    require(isinstance(g22, tdec.DecodingGraph) and g22.n_states == 179,
            "V=22 did not compose the 179-state dense graph")
    feats22, mask22 = segment_inputs(recs[22][0])
    feats1000, mask1000 = segment_inputs(recs[1000][0])
    seg_frames = feats22.shape[0]
    print(f"slice geometry: segment {len(seg)} samples ({seg_s} s) -> T={seg_frames} frames, "
          f"{int(mask22.sum())} valid; V=1000: factored grid {g1000.grid_shape} with a dense "
          f"hop; V=22: dense graph of {g22.n_states} states")

    # -- 5. kernel C vs its plain version (bitwise) ---------------------------
    log_b22 = tdec._emissions(feats22, g22.log_w, g22.mu, g22.cov, g22.cov_type)
    c_args = (g22.log_pi, g22.log_a, log_b22, mask22, g22.log_final)
    path_k, score_k = vd.viterbi_dense(*c_args)
    path_p, score_p = vd.viterbi_dense_plain(*c_args)
    torch.cuda.synchronize()
    require(torch.equal(path_k, path_p) and torch.equal(score_k, score_p),
            "kernel C differs from the plain scan on the V=22 segment's inputs")
    c_err = float((score_k - score_p).abs())
    print(f"kernel C vs plain (the V=22 segment: T={seg_frames}, N={g22.n_states}, bucket mask, "
          "log_final): bitwise equal")
    # random dense graphs: source lists in registers (33, 64), whole columns
    # from shared memory (179) and through L2 (256, 1000)
    for k, n in enumerate((33, 64, 179, 256, 1000)):
        check_dense_viterbi(torch, vd, dev, np.random.default_rng(30 + k), n, seg_frames)
    check_dense_lists(torch, vd, dev, g22, seg_frames)

    # -- 6. kernels D, E and F vs their plain versions (bitwise) --------------
    log_b1000, pi1000, final1000 = g1000._grid_inputs(feats1000)
    d_err = check_factored(torch, F, tdec, dev, g1000, log_b1000, pi1000, final1000, mask1000,
                           "the V=1000 segment, dense hop")
    check_repeats(torch, F.factored_forward, F.factored_forward_plain, g1000, log_b1000, pi1000,
                  mask1000, 60)
    require(F.lattice_kernel_ok(*g1000.grid_shape, g1000._kernel_hop, F.sm_count(dev)),
            "the V=1000 graph is not lattice-kernel-eligible")
    f_err = check_lattice(torch, F, g1000, log_b1000, pi1000, mask1000,
                          "the V=1000 segment, dense hop")
    check_repeats(torch, F.factored_lattice, F.factored_lattice_plain, g1000, log_b1000, pi1000,
                  mask1000, 60)
    rng = np.random.default_rng(5)
    rec1000 = recs[1000][0]
    lm = rec1000.lm.ngram
    # 21 planted words at the segment's geometry, three of them between
    # close word pairs: a path with many word changes (and N-best
    # alternatives, section 7), with the bucket's mask and with frames also
    # masked at the edges of kernel E's windows
    alt_feats, alt_n, alt_pairs = ambiguous_features(
        g1000, set(lm.vocabulary()), seg_frames, np.random.default_rng(7))
    alt_mask = torch.arange(seg_frames, device=dev) < alt_n
    alt_obs = torch.as_tensor(alt_feats, device=dev)
    lb_alt, pi_alt, fin_alt = g1000._grid_inputs(alt_obs)
    alt_path, _ = F.factored_backtrace(
        F.factored_forward(pi_alt, g1000.inner_a, g1000.exit_idx, g1000._kernel_hop, lb_alt,
                           alt_mask, hop_t=g1000.hop_t),
        g1000.inner_a, g1000.exit_idx, g1000._kernel_hop, fin_alt, alt_mask, hop_t=g1000.hop_t)
    edge_mask = window_edge_mask(torch, F, alt_path, alt_mask, g1000.grid_shape[1])
    bucket = torch.arange(seg_frames, device=dev) < seg_frames - 41
    t_grid = (seg_frames,) + g1000.grid_shape
    rand_b = torch.as_tensor(rng.normal(scale=6.0, size=t_grid).astype(np.float32), device=dev)
    rand_b = torch.where(g1000.pad_mask, rand_b, torch.tensor(-np.inf, device=dev))
    for hop_mode, loop in (("dense", True), ("rank1", True), ("dense", False)):
        g = tdec.FactoredDecodingGraph.build(
            rec1000.lexicon, rec1000.am.units, lm,
            tdec.DecoderConfig(lm_scale=0.5, word_insertion_penalty=-4.0, loop=loop),
            silence_model=rec1000.am.units[tdec.SILENCE], hop_mode=hop_mode, device=dev)
        kind = F.hop_kind(g._kernel_hop)
        require(g.has_kernel and F.factored_kernel_ok(seg_frames, *g.grid_shape, g._kernel_hop,
                                                      F.sm_count(dev)),
                f"the {kind} hop graph is not kernel-eligible")
        require(kind != "rank1" or g._kernel_hop.sil_idx >= 0,
                "the rank-1 graph has no silence word")
        _, pi_g, fin_g = g._grid_inputs(feats1000[:1])
        for lb, what in ((rand_b, "random emissions"), (torch.round(rand_b), "integer ties")):
            d_err = max(d_err, check_factored(torch, F, tdec, dev, g, lb, pi_g, fin_g, bucket,
                                              f"{kind} hop, {what}, bucket mask"))
            f_err = max(f_err, check_lattice(torch, F, g, lb, pi_g, bucket,
                                             f"{kind} hop, {what}, bucket mask"))
        lb_p, pi_p, fin_p = g._grid_inputs(alt_obs)
        for m, what in ((alt_mask, "bucket mask"), (edge_mask, "masks at E's window edges")):
            d_err = max(d_err, check_factored(torch, F, tdec, dev, g, lb_p, pi_p, fin_p, m,
                                              f"{kind} hop, 21 planted words, {what}"))
    # the largest forward blocks the capacity rule admits (edge-free hops,
    # whose rows leave shared memory room for 1024-thread blocks)
    n_sm = F.sm_count(dev)
    for s_max, hop in ((24, "rank1"), (24, None), (8, "rank1")):
        g, wpb = near_limit_graph(torch, F, dev, rng, n_sm, s_max, hop)
        vw = g.grid_shape[0]
        require(F.factored_kernel_ok(64, vw, s_max, g._kernel_hop, n_sm),
                f"the near-limit graph V={vw}, S={s_max} is not kernel-eligible")
        lb = torch.as_tensor(rng.normal(scale=6.0, size=(64, vw, s_max)).astype(np.float32),
                             device=dev)
        pi_g = torch.as_tensor(rng.normal(size=(vw, s_max)).astype(np.float32), device=dev)
        fin_g = torch.as_tensor(rng.normal(size=(vw, s_max)).astype(np.float32), device=dev)
        d_err = max(d_err, check_factored(
            torch, F, tdec, dev, g, lb, pi_g, fin_g, torch.arange(64, device=dev) < 57,
            f"{F.hop_kind(g._kernel_hop)} hop, {wpb * s_max} threads per forward block"))
        require(F.lattice_kernel_ok(vw, s_max, g._kernel_hop, n_sm),
                f"the near-limit graph V={vw}, S={s_max} is not lattice-kernel-eligible")
        f_err = max(f_err, check_lattice(
            torch, F, g, lb, pi_g, torch.arange(64, device=dev) < 57,
            f"{F.hop_kind(g._kernel_hop)} hop, {wpb * s_max} threads per block"))
    # mixed word lengths at a small V
    mixed_units = {}
    for i in range(40):
        n = 2 + i % 5
        with np.errstate(divide="ignore"):
            l2r = np.log(np.where(np.eye(n) + np.eye(n, k=1) > 0, 0.5, 0.0))
        mixed_units[f"m{i:02d}"] = entry._serving_unit(
            n, 1, l2r, rng.normal(scale=8.0, size=(n, 1, 39)), 4.0, dev, torch.float32)
    for hop_mode, loop in (("dense", True), ("rank1", True), ("dense", False)):
        g = tdec.FactoredDecodingGraph.build(
            Lexicon.whole_word(sorted(mixed_units)), mixed_units, None,
            tdec.DecoderConfig(loop=loop), hop_mode=hop_mode, device=dev)
        obs = torch.as_tensor(rng.normal(scale=8.0, size=(200, 39)).astype(np.float32),
                              device=dev)
        lb, pi_g, fin_g = g._grid_inputs(obs)
        mask = torch.arange(200, device=dev) < 170
        d_err = max(d_err, check_factored(torch, F, tdec, dev, g, lb, pi_g, fin_g, mask,
                                          f"mixed word lengths 2-6, {F.hop_kind(g._kernel_hop)}"
                                          " hop, bucket mask"))
        f_err = max(f_err, check_lattice(torch, F, g, lb, pi_g, mask,
                                         f"mixed word lengths 2-6, {F.hop_kind(g._kernel_hop)} "
                                         "hop, bucket mask"))
    # decode_batch: one forward and one backtrace launch for the batch
    masks = torch.stack([mask, torch.arange(200, device=dev) < 140])
    before = F.factored_forward.launches, F.factored_backtrace.launches
    batch = g.decode_batch(torch.stack([obs, obs]), masks)
    require((F.factored_forward.launches - before[0], F.factored_backtrace.launches - before[1])
            == (1, 1), "decode_batch of 2 utterances did not launch D and E once each")
    lb2, pi_g, fin_g = g._grid_inputs(torch.stack([obs, obs]))
    for b, (_, path_b, score_b) in enumerate(batch):
        path_p, score_p = F.factored_backtrace_plain(
            F.factored_forward_plain(pi_g, g.inner_a, g.exit_idx, g._kernel_hop, lb2[b], masks[b]),
            g.inner_a, g.exit_idx, g._kernel_hop, fin_g, masks[b])
        require(np.array_equal(path_b, path_p.cpu().numpy()) and score_b == float(score_p),
                f"decode_batch utterance {b} differs from the plain forward and replay")
    print("decode_batch (B=2, mixed word lengths, loop-free, masks of 170 and 140 frames): D and "
          "E once each, paths and scores bitwise those of the plain versions")
    # exact ties: uniform emissions, identical hops, stay == advance (the
    # graph of tests/test_factored_pallas.py's tie test: 7 words x 3 states)
    v_t, s_t, t_t = 7, 3, 23
    inner = np.full((v_t, s_t, s_t), -np.inf, np.float32)
    for j in range(s_t):
        inner[:, j, j] = np.log(0.5)
        if j + 1 < s_t:
            inner[:, j, j + 1] = np.log(0.5)
    pi_t = np.full((v_t, s_t), -np.inf, np.float32)
    pi_t[:, 0] = 0.0
    on = lambda x: torch.as_tensor(x, device=dev)  # noqa: E731
    for hop in (on(np.zeros((v_t, v_t), np.float32)),
                F.Rank1Hop(on(np.zeros(v_t, np.float32)), on(np.zeros(v_t, np.float32)),
                           on(np.full(v_t, -np.inf, np.float32)), -1)):
        g = types.SimpleNamespace(inner_a=on(inner), exit_idx=on(np.full(v_t, s_t - 1, np.int32)),
                                  _kernel_hop=hop, hop_t=None)
        f_err = max(f_err, check_lattice(torch, F, g, on(np.zeros((t_t, v_t, s_t), np.float32)),
                                         on(pi_t), None, f"exact ties, {F.hop_kind(hop)} hop"))

    # -- 7. the main paths ---------------------------------------------------
    flag_model = entry.flagship_model(device=dev)
    step = entry.flagship(device=dev, params=flag_model.params)
    torch.cuda.synchronize()
    wrappers = (mf.mel_frontend, vt.viterbi_small, vd.viterbi_dense, F.factored_forward,
                F.factored_backtrace, F.factored_lattice, trellis.forward_backward,
                tri.trigram_forward, tri.trigram_backtrace, tweb.gmm_flags, tltsd.ltsd_noise,
                trellis.viterbi_scan, trellis.trellis_chunk, trellis.pointer_walk)
    reset_counts(*wrappers)
    paths, scores = step(x)
    torch.cuda.synchronize()
    launches = {"flagship": {w.__name__: w.launches for w in wrappers}}
    print(f"main path: flagship step on B={B} x {SECONDS} s -> paths {tuple(paths.shape)} "
          f"{paths.dtype}, scores {tuple(scores.shape)}; launches {launches['flagship']}")
    require(launches["flagship"]["mel_frontend"] > 0 and launches["flagship"]["viterbi_small"] > 0,
            f"a kernel of the main path never ran: {launches['flagship']}")
    require(paths.shape == (B, t_frames) and paths.dtype == torch.int32, "bad path shape/dtype")
    require(scores.shape == (B,) and bool(torch.isfinite(scores).all()), "scores not finite")
    require(int(paths.min()) >= 0 and int(paths.max()) < 5, "path states out of range")

    # the same step on the plain CPU path, same weights and input
    step_cpu = entry.flagship(device="cpu", params=flag_model.params)
    paths_c, scores_c = step_cpu(x.cpu())
    agree = float((paths.cpu() == paths_c).float().mean())
    rel = float(((scores.cpu() - scores_c).abs() / scores_c.abs()).max())
    print(f"main path vs plain CPU step: {agree:.6f} of frames on the same state, "
          f"max score rel err {rel:.3g}")
    require(agree >= 0.999, f"GPU and CPU paths agree on only {agree} of frames")
    require(rel < 1e-4, f"GPU and CPU scores differ by {rel} relative")

    # the recognizer's bucketed segment decode, V = 1000 then V = 22
    path_kernels = {1000: (mf.mel_frontend, F.factored_forward, F.factored_backtrace),
                    22: (mf.mel_frontend, vd.viterbi_dense)}
    for v, on_path in path_kernels.items():
        rec = recs[v][0]
        names = [w.__name__ for w in on_path]
        torch.cuda.synchronize()
        reset_counts(*wrappers)
        words, score = rec.decode_segment(seg)
        counts = {w.__name__: w.launches for w in wrappers}
        launches[f"V={v}"] = counts
        print(f"main path: Recognizer.decode_segment at V={v} ({type(rec.graph).__name__}) on "
              f"{seg_s} s -> {len(words)} words {words[:8]}, score {score}; launches {counts}")
        require(all(counts[n] == 1 for n in names),
                f"the V={v} segment decode did not launch each of {names} once: {counts}")
        require(all(counts[n] == 0 for n in counts if n not in names),
                f"the V={v} segment decode launched a kernel off its path: {counts}")
        require(np.isfinite(score), f"V={v} segment score is not finite")
        words_c, score_c = recs_cpu[v].decode_segment(seg)
        rel = abs(score - score_c) / abs(score_c)
        print(f"main path V={v} vs the port's CPU recognizer on the same weights and audio: words "
              f"{'equal' if words == words_c else 'DIFFER'}, score rel err {rel:.3g}")
        require(words == words_c, f"V={v}: GPU words {words} != CPU words {words_c}")
        require(rel < 1e-4, f"V={v}: GPU and CPU scores differ by {rel} relative")
        # a planted word sequence: the graph decode must recover it, as on the CPU
        g = rec.graph
        in_lm = set(rec.lm.ngram.vocabulary())  # words the LM never saw are unreachable
        planted = [w for w in g.words if w in in_lm][3:9]
        obs = planted_features(torch, g, np.random.default_rng(v), planted)
        got, path_g, score_g = g.decode(obs)
        got_c, path_gc, score_gc = recs_cpu[v].graph.decode(obs)
        print(f"V={v} graph decode of {len(obs)} frames planted along {planted}: {got}; CPU "
              f"{got_c}, paths {'equal' if np.array_equal(path_g, path_gc) else 'DIFFER'}")
        require(got == planted and got_c == planted,
                f"V={v}: planted words {planted} decoded as {got} (GPU) / {got_c} (CPU)")
        require(abs(score_g - score_gc) <= 1e-4 * abs(score_gc),
                f"V={v}: planted decode scores {score_g} vs {score_gc}")
        if v == 1000:
            check_planted_lattice(torch, F, entry, NGramCounter, NGramModel, rec,
                                  recs_cpu[v].graph, obs, planted, score_g)

    # the recognizer's bucketed N-best segment decode at V = 1000
    rec = recs[1000][0]
    nb_path = ("mel_frontend", "factored_lattice")
    torch.cuda.synchronize()
    reset_counts(*wrappers)
    hyps = rec.decode_segment_nbest(seg, n=5, with_confidence=True)
    counts = {w.__name__: w.launches for w in wrappers}
    launches["V=1000 nbest"] = counts
    print(f"main path: Recognizer.decode_segment_nbest(n=5, with_confidence=True) at V=1000 on "
          f"{seg_s} s -> {len(hyps)} hypotheses {[(h.words[:6], h.score) for h in hyps]}; "
          f"launches {counts}")
    require(all(counts[n] == 1 for n in nb_path) and
            all(counts[n] == 0 for n in counts if n not in nb_path),
            f"the N-best segment decode did not launch exactly mel_frontend and factored_lattice "
            f"once each: {counts}")
    require(len(hyps) >= 1 and all(np.isfinite(h.score) for h in hyps),
            "the N-best segment decode gave no finite hypothesis")
    hyps_c = recs_cpu[1000].decode_segment_nbest(seg, n=5, with_confidence=True)
    rel = max(abs(a.score - b.score) / abs(b.score) for a, b in zip(hyps, hyps_c))
    print(f"main path V=1000 N-best vs the port's CPU recognizer on the same weights and audio: "
          f"{len(hyps)} vs {len(hyps_c)} hypotheses, word lists "
          f"{'equal' if [h.words for h in hyps] == [h.words for h in hyps_c] else 'DIFFER'}, "
          f"max score rel err {rel:.3g}, confidences {[h.confidence for h in hyps][:2]}")
    require([h.words for h in hyps] == [h.words for h in hyps_c],
            f"N-best word lists differ: {[h.words for h in hyps]} vs {[h.words for h in hyps_c]}")
    require(rel < 1e-4, f"N-best scores differ by {rel} relative")
    # the segment decodes to silence, so its list has one hypothesis: the
    # same steps on planted frames at the segment's geometry, with three
    # word sites each between two close words, give a list with alternatives
    alt_recs = host_records(tdec, g1000, alt_obs, alt_mask, alt_n)
    alt = lattice_nbest(g1000, alt_recs)[0]
    g_cpu = recs_cpu[1000].graph
    alt_c = lattice_nbest(g_cpu, host_records(tdec, g_cpu, alt_obs.cpu(), alt_mask.cpu(),
                                              alt_n))[0]
    rel = max(abs(a.score - b.score) / abs(b.score) for a, b in zip(alt, alt_c))
    # confidences are posteriors of float32 path scores near 6e4 nats, whose
    # ulp is 0.004 nats: the card's and the CPU's emissions may differ by a
    # few ulps along a path, which moves a posterior by under 0.02
    conf_err = max(float(np.max(np.abs(np.subtract(a.confidence, b.confidence))))
                   for a, b in zip(alt, alt_c))
    print(f"N-best with alternatives (V=1000, {alt_n} planted frames of {seg_frames}, word sites "
          f"between {alt_pairs}): {len(alt)} hypotheses {[(len(h.words), h.score) for h in alt]}, "
          f"least confidence of each {[round(min(h.confidence), 4) for h in alt]}; "
          f"vs the CPU graph: word lists "
          f"{'equal' if [h.words for h in alt] == [h.words for h in alt_c] else 'DIFFER'}, max "
          f"score rel err {rel:.3g}, max confidence err {conf_err:.3g}")
    require(len({tuple(h.words) for h in alt}) >= 3,
            f"the planted N-best list has fewer than 3 surface hypotheses: {len(alt)}")
    require([h.words for h in alt] == [h.words for h in alt_c],
            f"planted N-best word lists differ: {[h.words for h in alt]} vs "
            f"{[h.words for h in alt_c]}")
    require(rel < 1e-4, f"planted N-best scores differ by {rel} relative")
    require(conf_err < 0.02, f"planted N-best confidences differ by {conf_err}")

    # -- 8. timing ----------------------------------------------------------
    y = mf.preemphasize(x, cfg)
    a_ms = cuda_ms(lambda: mf._launch(y, cfg), reps=50)
    a_wrap_ms = cuda_ms(lambda: mf.mel_frontend(x, cfg), reps=50)
    a_plain_ms = cuda_ms(lambda: mf.mel_frontend_plain(y, cfg), reps=20)
    half = cfg.fft_n // 2
    bins = half + 1
    nnz = int(np.count_nonzero(mel_filterbank(cfg.n_mels, cfg.fft_n, cfg.sample_rate)))
    frames = B * t_frames
    a_ops = frames * (5 * half * int(np.log2(half)) + cfg.frame_len + 14 * bins + 2 * nnz + bins)
    a_bytes = 4 * (B * S + frames * (cfg.n_mels + 1))
    a_bound, a_by = bound(a_bytes, a_ops)
    # the yardstick: the same function as a chain of library calls (cuFFT
    # through torch.fft, then cuBLAS); not one call, so library_ms stays null
    window = torch.as_tensor(hamming_window(cfg.frame_len), dtype=torch.float32, device=dev)
    fbank_t = torch.as_tensor(mel_filterbank(cfg.n_mels, cfg.fft_n, cfg.sample_rate).T,
                              dtype=torch.float32, device=dev).contiguous()

    def cufft_chain():
        spec = torch.fft.rfft(split_frames(y, cfg.frame_len, cfg.frame_step) * window, cfg.fft_n)
        power = (spec.real * spec.real + spec.imag * spec.imag) / cfg.fft_n
        return power @ fbank_t, power.sum(-1)

    chain_mel = cufft_chain()[0]
    chain_err = float((chain_mel - mf._launch(y, cfg)[0]).abs().max())
    chain_ms = cuda_ms(cufft_chain, reps=50)
    chain_dev_ms = device_ms(torch, cufft_chain)

    log_b = flag_model.emissions(mfcc_features_fused(x, cfg)[0])
    lp, la = flag_model.log_pi, flag_model.log_a
    n = la.shape[0]
    b_ms = cuda_ms(lambda: vt.viterbi_small(lp, la, log_b), reps=50)
    b_plain_ms = cuda_ms(lambda: vt.viterbi_plain(lp, la, log_b), reps=3, warmup=1)
    b_bytes = 4 * (n + n * n + B * t_frames * n + B * t_frames + B)
    b_ops = B * (t_frames - 1) * (2 * n * n + n)
    b_bound, b_by = bound(b_bytes, b_ops)

    step_ms = cuda_ms(lambda: step(x), reps=20)
    print(f"timing on {card}: the cuFFT chain for kernel A's function (split_frames -> "
          f"torch.fft.rfft -> |X|^2/n -> @ fbank.T and .sum(-1)): {chain_ms:.4f} ms by events, "
          f"{chain_dev_ms:.4f} ms of device time; its mel differs from kernel A's by at most "
          f"{chain_err:.6g}")
    print(f"timing on {card}: kernel A {a_ms:.4f} ms (wrapper with pre-emphasis {a_wrap_ms:.4f} ms, "
          f"plain {a_plain_ms:.4f} ms, bound {a_bound:.4f} ms by {a_by}); kernel B {b_ms:.4f} ms "
          f"(plain {b_plain_ms:.4f} ms, bound {b_bound:.5f} ms by {b_by}); step {step_ms:.4f} ms = "
          f"{B * SECONDS / (step_ms / 1e3):.1f} audio-s/s at B={B} x {SECONDS} s")
    device_breakdown(torch, lambda: step(x), step_ms, card)

    # kernels C, D, E at the segment decodes' own inputs; the work counted
    # is what these inputs need (valid frames only)
    steps = int(mask22[1:].sum())
    nc = g22.n_states
    c_ms = cuda_ms(lambda: vd.viterbi_dense(*c_args), reps=50)
    # what bounds C: the same frames on the graph's self-loops alone (lists
    # of i = 0 and j, one lane each, no shuffle), the frame loop's floor
    diag = torch.where(torch.eye(g22.n_states, dtype=torch.bool, device=dev), g22.log_a,
                       torch.tensor(-np.inf, device=dev))
    c_floor_ms = cuda_ms(lambda: vd.viterbi_dense(g22.log_pi, diag, *c_args[2:]), reps=50)
    c_plain_ms = cuda_ms(lambda: vd.viterbi_dense_plain(*c_args), reps=5, warmup=1)
    # C on random dense graphs (viterbi_batched's N > 32): whole columns, of
    # log_a in shared memory at N = 179 and through L2 at N = 256
    c_dense_ms = {}
    for n in (179, 256):
        rng = np.random.default_rng(40 + n)
        dense_args = [torch.as_tensor(x, device=dev) for x in model(rng, n, "random")]
        dense_args.append(torch.as_tensor(rng.normal(scale=3.0, size=(seg_frames, n))
                                          .astype(np.float32), device=dev))
        c_dense_ms[n] = cuda_ms(lambda: vd.viterbi_dense(*dense_args, mask22), reps=30)
    c_bytes = 4 * (3 * nc + nc * nc + seg_frames * nc + seg_frames + 1) + seg_frames
    c_bound, c_by = bound(c_bytes, steps * (2 * nc * nc + nc))

    hop, hop_t = g1000._kernel_hop, g1000.hop_t
    ia, ei = g1000.inner_a, g1000.exit_idx
    vw, sw = g1000.grid_shape
    d_args = (pi1000, ia, ei, hop, log_b1000, mask1000)
    grids = F.factored_forward(*d_args, hop_t=hop_t)
    e_args = (grids, ia, ei, hop, final1000, mask1000)
    d_ms = cuda_ms(lambda: F.factored_forward(*d_args, hop_t=hop_t), reps=30)
    # what bounds D: the same frames with no hop (no exchange at all) and
    # with a rank-1 hop (the blocks' partials exchanged, no V x V work)
    r1 = F.Rank1Hop(*(torch.as_tensor(np.random.default_rng(k).normal(size=vw)
                                      .astype(np.float32), device=dev) for k in range(3)), 0)
    d_none_ms = cuda_ms(lambda: F.factored_forward(pi1000, ia, ei, None, log_b1000, mask1000),
                        reps=30)
    d_rank1_ms = cuda_ms(lambda: F.factored_forward(pi1000, ia, ei, r1, log_b1000, mask1000),
                         reps=30)
    d_plain_ms = cuda_ms(lambda: F.factored_forward_plain(*d_args), reps=3, warmup=1)
    e_ms = cuda_ms(lambda: F.factored_backtrace(*e_args, hop_t=hop_t), reps=30)
    e_plain_ms = cuda_ms(lambda: F.factored_backtrace_plain(*e_args), reps=3, warmup=1)
    steps = int(mask1000[1:].sum())
    graph_bytes = 4 * (vw * sw + vw * sw * sw + vw + vw * vw)
    # emission rows of frame 0 and of the valid steps (a masked frame reads
    # none); every frame's grid written
    emis_bytes = 4 * (1 + steps) * vw * sw
    grid_bytes = 4 * seg_frames * vw * sw
    d_bound, d_by = bound(graph_bytes + emis_bytes + grid_bytes + seg_frames,
                          steps * (2 * vw * vw + 2 * vw * sw * sw + 2 * vw + vw * sw))
    path_e, _ = F.factored_backtrace(*e_args, hop_t=hop_t)
    entries, e_hops, e_windows = replay_counts(torch, F, path_e, mask1000, sw)
    # E on the planted path of 21 words (many word changes, more windows)
    e_alt_args = (F.factored_forward(pi_alt, ia, ei, hop, lb_alt, alt_mask, hop_t=hop_t), ia, ei,
                  hop, fin_alt, alt_mask)
    e_alt_ms = cuda_ms(lambda: F.factored_backtrace(*e_alt_args, hop_t=hop_t), reps=30)
    alt_counts = replay_counts(torch, F, F.factored_backtrace(*e_alt_args, hop_t=hop_t)[0],
                               alt_mask, sw)
    # E touches grid[T-1] and final once, one S-row of grid[t-1] and one
    # inner_a column per valid step, and V exit scores and V hop entries
    # only where the path sits at a word's first state
    e_bound, e_by = bound(4 * (2 * vw * sw + 2 * sw * steps + 2 * vw * entries + vw)
                          + 5 * seg_frames + 4,
                          2 * vw * sw + steps * 2 * sw + entries * 2 * vw)

    seg_ms = {v: host_ms(lambda v=v: recs[v][0].decode_segment(seg), reps=10) for v in recs}
    print(f"timing on {card}: kernel C {c_ms:.4f} ms (plain {c_plain_ms:.4f} ms, bound "
          f"{c_bound:.5f} ms by {c_by}) at T={seg_frames}, N={nc}; kernel D {d_ms:.4f} ms (plain "
          f"{d_plain_ms:.4f} ms, bound {d_bound:.5f} ms by {d_by}) and kernel E {e_ms:.4f} ms "
          f"(plain {e_plain_ms:.4f} ms, bound {e_bound:.5f} ms by {e_by}) at T={seg_frames}, "
          f"V={vw}, S={sw}")
    print(f"timing on {card}: kernel C on the graph's self-loops alone (the frame loop's "
          f"floor) {c_floor_ms:.4f} ms, so the lists of the V=22 graph add "
          f"{1e3 * (c_ms - c_floor_ms) / int(mask22[1:].sum()):.3f} us a frame; on random dense "
          f"graphs (whole columns) N=179 {c_dense_ms[179]:.4f} ms, N=256 {c_dense_ms[256]:.4f} ms")
    print(f"timing on {card}: kernel E's walk on the segment: {entries} valid steps at a word's "
          f"first state, {e_hops} word changes, {len(e_windows)} windows of up to "
          f"{F.BACKTRACE_WINDOW} frames; on the planted path of 21 words {e_alt_ms:.4f} ms "
          f"({alt_counts[0]} steps at a first state, {alt_counts[1]} word changes, "
          f"{len(alt_counts[2])} windows)")
    print(f"timing on {card}: kernel D's frames without the dense hop: no hop (no exchange) "
          f"{d_none_ms:.4f} ms, rank-1 hop (the partials' exchange) {d_rank1_ms:.4f} ms, so the "
          f"exchange and the dense reduction take {1e3 * (d_ms - d_none_ms) / steps:.3f} us a "
          f"frame")
    for v, ms in seg_ms.items():
        print(f"timing on {card}: segment decode V={v}: {ms:.4f} ms per {seg_s} s segment = "
              f"{seg_s / (ms / 1e3):.1f} audio-s/s (host clock, one device->host copy)")
    for v in (1000, 22):
        device_breakdown(torch, lambda v=v: recs[v][0].decode_segment(seg), seg_ms[v],
                         f"{card}, segment decode V={v}")

    # kernel F at the N-best segment's own inputs: D's work (the same
    # trellis), bytes of the graph and emissions in and the (T, V) records out
    f_args = (pi1000, ia, ei, hop, log_b1000, mask1000)
    f_ms = cuda_ms(lambda: F.factored_lattice(*f_args, hop_t=hop_t), reps=30)
    f_plain_ms = cuda_ms(lambda: F.factored_lattice_plain(*f_args), reps=3, warmup=1)
    f_bound, f_by = bound(graph_bytes + emis_bytes + 12 * seg_frames * vw + seg_frames,
                          steps * (2 * vw * vw + 2 * vw * sw * sw + 2 * vw + vw * sw))
    rec1000 = recs[1000][0]
    nbest = lambda: rec1000.decode_segment_nbest(seg, n=5, with_confidence=True)  # noqa: E731
    nb_ms = host_ms(nbest, reps=10)
    nb_dev_ms = host_ms(lambda: rec1000._segment_records(seg), reps=10)
    host_recs = rec1000._segment_records(seg)
    nb_host_ms = host_ms(lambda: lattice_nbest(g1000, host_recs), reps=10)
    # the same two parts on the planted frames with alternatives
    alt_dev_ms = host_ms(lambda: host_records(tdec, g1000, alt_obs, alt_mask, alt_n), reps=10)
    alt_host_ms = host_ms(lambda: lattice_nbest(g1000, alt_recs), reps=10)
    print(f"timing on {card}: kernel F {f_ms:.4f} ms (plain {f_plain_ms:.4f} ms, bound "
          f"{f_bound:.5f} ms by {f_by}) at T={seg_frames}, V={vw}, S={sw}; N-best segment V=1000 "
          f"(n=5, with confidences): {nb_ms:.4f} ms per {seg_s} s segment = "
          f"{seg_s / (nb_ms / 1e3):.1f} audio-s/s (host clock), of which the device part up to "
          f"the records' one device->host copy {nb_dev_ms:.4f} ms and the host lattice work "
          f"(from_records + nbest + posteriors + confidences, "
          f"{lattice_nbest(g1000, host_recs)[1]} tokens, {len(hyps)} hypotheses) "
          f"{nb_host_ms:.4f} ms")
    print(f"timing on {card}: N-best with alternatives ({alt_n} planted frames of {seg_frames}): "
          f"the records and their one device->host copy {alt_dev_ms:.4f} ms, the host "
          f"lattice work ({lattice_nbest(g1000, alt_recs)[1]} tokens, {len(alt)} hypotheses) "
          f"{alt_host_ms:.4f} ms")
    device_breakdown(torch, nbest, nb_ms, f"{card}, N-best segment V=1000")

    # each kernel's device time per wrapper call (A: its launch alone, as
    # timed above); the event times above also count the host's time
    # between a wrapper's launches, which a short kernel no longer hides
    calls = {"mel_frontend": lambda: mf._launch(y, cfg),
             "viterbi": lambda: vt.viterbi_small(lp, la, log_b),
             "viterbi_dense": lambda: vd.viterbi_dense(*c_args),
             "factored_forward": lambda: F.factored_forward(*d_args, hop_t=hop_t),
             "factored_backtrace": lambda: F.factored_backtrace(*e_args, hop_t=hop_t),
             "factored_lattice": lambda: F.factored_lattice(*f_args, hop_t=hop_t)}
    dev_ms = {name: device_ms(torch, fn) for name, fn in calls.items()}
    e_alt_dev_ms = device_ms(torch, lambda: F.factored_backtrace(*e_alt_args, hop_t=hop_t))
    print(f"timing on {card}: device time per call (torch.profiler, 10 calls): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in dev_ms.items())
          + f"; kernel E on the planted path of 21 words {e_alt_dev_ms:.4f} ms")

    # -- 8b. the exact backoff search at V = 5000: D, E, F with the CSR hop ---
    bo = backoff_phase(torch, entry, wrappers, card, launches)

    # -- 8c. the batched decodes: D, E and F once a batch ----------------------
    bat = batch_phase(torch, entry, wrappers, card, launches)

    # -- 9, 10, 11. live serving: the stream, the trigram graph, device VADs --
    stream_phase(torch, entry, wrappers, card, launches)
    trig = trigram_phase(torch, entry, wrappers, card, launches)
    tbat = trigram_batch_phase(torch, entry, wrappers, card, launches)
    vads = vad_phase(torch, entry, wrappers, card, launches)
    trel = trellis_phase(torch, entry, wrappers, card, launches)
    stg = stage_phase(torch, entry, card)

    # -- 12. training -------------------------------------------------------
    train = training_phase(torch, entry, wrappers, card, launches)

    # -- 13. parallel/: 4 ranks on the card -----------------------------------
    par = parallel_phase(torch, entry, wrappers, card, launches, train["sweep_ms"])

    # -- 14. the command line, the bench harnesses and the examples --------------
    cli_phase(torch, entry, wrappers, card, launches)

    # -- 15. the recording harnesses: bench/stream.py, bench/wer.py's protocol --
    recording_phase(torch, entry, wrappers, card, launches)

    def kernel_row(name, counter, own_path, replaces, err, wrapper_ms, plain_ms, bnd):
        """One kernel's entry: ``launches`` on its own slice's main path and
        ``launches_by_path`` on every main path run here that counted it;
        ``ms`` its device time per call, ``wrapper_ms`` the CUDA-event time
        of the call. No single PyTorch call computes any of these kernels'
        functions. Kernel G's row takes its ``ms`` from CUDA events over
        back-to-back launches on the chunked route (``profiler_ms`` beside
        it: the device time of a launch torch.profiler recorded, and
        ``profiler_launches`` how many of 10 it recorded, ``profiler_window``
        in which profiled window) and adds the
        sequential warp route's time, the chunked route's depth and depth
        floor, the warp route's chain floor (each floor the same launch at
        N = 1) and its launches per EM sweep."""
        return {"name": name, "route": "cuda", "source": f"lnasr_tpu_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": launches[own_path][counter],
                "launches_by_path": {p: c[counter] for p, c in launches.items() if counter in c},
                "max_abs_err": err, "ms": dev_ms.get(name), "wrapper_ms": wrapper_ms,
                "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None}

    kernels = [
        kernel_row("mel_frontend", "mel_frontend", "flagship", "lnasr_tpu/ops/mfcc_pallas.py:429",
                   mel_err, a_ms, a_plain_ms, (a_bound, a_by)),
        kernel_row("viterbi", "viterbi_small", "flagship", "lnasr_tpu/ops/trellis_pallas.py:129",
                   0.0, b_ms, b_plain_ms, (b_bound, b_by)),
        kernel_row("viterbi_dense", "viterbi_dense", "V=22", "lnasr_tpu/ops/trellis_pallas.py:299",
                   c_err, c_ms, c_plain_ms, (c_bound, c_by)),
        kernel_row("factored_forward", "factored_forward", "V=1000",
                   "lnasr_tpu/ops/factored_pallas.py:240", d_err, d_ms, d_plain_ms,
                   (d_bound, d_by)),
        kernel_row("factored_backtrace", "factored_backtrace", "V=1000",
                   "lnasr_tpu/ops/factored_pallas.py:399", 0.0, e_ms, e_plain_ms, (e_bound, e_by)),
        kernel_row("factored_lattice", "factored_lattice", "V=1000 nbest",
                   "lnasr_tpu/ops/factored_pallas.py:661", f_err, f_ms, f_plain_ms,
                   (f_bound, f_by)),
    ]
    g = train["g"]
    g_row = kernel_row("forward_backward", "forward_backward", "training",
                       "lnasr_tpu/ops/trellis.py:37 forward_scan + :58 backward_scan (lax.scan "
                       "under jax.jit, no Pallas)", g["err"], g["wrapper_ms"], g["plain_ms"],
                       g["bound"])
    g_row |= {"ms": g["ms"], "profiler_ms": g["profiler_ms"],
              "profiler_launches": g["profiler_launches"],
              "profiler_window": g["profiler_window"], "route_taken": "chunked",
              "sequential_ms": g["sequential_ms"], "depth": g["depth"],
              "depth_floor_ms": g["depth_floor_ms"], "chain_steps": g["chain_steps"],
              "chain_floor_ms": g["floor_ms"], "launches_per_sweep": g["per_sweep"]}
    kernels.append(g_row)
    # kernel H's rows: ``ms`` by CUDA events over back-to-back launches
    # queued behind a spinning kernel (the profiler's figure beside)
    for part, bnd_key in (("forward", "trigram_forward"), ("backtrace", "trigram_backtrace")):
        r = trig[part]
        row = kernel_row(bnd_key, bnd_key, "V=200 trigram",
                         "lnasr_tpu/models/decoder.py:1554 (step :1510-1545, lax.scan under "
                         "jax.jit :1579, final argmax :1556-1563)" if part == "forward" else
                         "lnasr_tpu/models/decoder.py:1571 (the reverse lax.scan :1567-1571, "
                         "under jax.jit :1579)", trig["err"], r["wrapper_ms"], r["plain_ms"],
                         r["bound"])
        row |= {"ms": r["ms"], "profiler_ms": r["profiler_ms"],
                "profiler_launches": r["profiler_launches"],
                # the batch (trigram_batch_phase): one launch of the batch
                # against its single launches, two turns each
                "batch": {"V=200": {"b": tbat["b"],
                                    "ms": (tbat["times"][part][0] + tbat["times"][part][3]) / 2,
                                    "loop_ms": (tbat["times"][part][1]
                                                + tbat["times"][part][2]) / 2,
                                    "bound_ms": tbat["bounds"][part][0],
                                    "bound_by": tbat["bounds"][part][1]},
                          "cut": tbat["cut"]}}
        if part == "forward":
            row |= {"route_taken": trig["route"], "hop3_reread_ms": r["hop3_reread_ms"]}
        kernels.append(row)
    gm = vads["gmm"]
    i_row = kernel_row("webrtc_gmm", "gmm_flags", "webrtc vad",
                       "lnasr_tpu/vad/webrtc.py:393 (lax.scan of gmm_step :274 under jax.jit "
                       ":407; aging walk fori_loop :226-243)", gm["state_err"], gm["wrapper_ms"],
                       gm["plain_ms"], gm["bound"])
    i_row |= {"ms": gm["ms"], "profiler_ms": gm["profiler_ms"],
              "profiler_launches": gm["profiler_launches"], "frames": gm["frames"]}
    kernels.append(i_row)
    # kernels J and K: ``ms`` by CUDA events over back-to-back launches queued
    # behind a spinning kernel, the profiler's figure beside; ``loop_ms`` the
    # frame loop each replaced, on the card
    jn = vads["ltsd_noise"]
    j_row = kernel_row("ltsd_noise", "ltsd_noise", "ltsd adaptive",
                       "lnasr_tpu/vad/ltsd.py:101 (step :89-99, lax.scan under jax.jit :119; "
                       "vmapped by detect_batch :125-128)", jn["err"], jn["wrapper_ms"],
                       jn["plain_ms"], jn["bound"])
    j_row |= {"ms": jn["ms"], "profiler_ms": jn["profiler_ms"],
              "profiler_launches": jn["profiler_launches"], "loop_ms": jn["parent_ms"],
              "chain_floor_ms": jn["floor_ms"], "frames": jn["frames"], "bins": jn["bins"],
              "rows_ms": jn["rows_ms"], "recursion_ms": jn["recursion_ms"]}
    kernels.append(j_row)
    k_row = kernel_row("viterbi_trellis", "viterbi_scan", "gmmhmm decode",
                       "lnasr_tpu/ops/trellis.py:92 viterbi_scan (forward lax.scan :126, "
                       "backtrace lax.scan :138; under jax.jit in models/hmm.py:228-247 and "
                       "models/gmmhmm.py:345-353)", trel["err"], trel["wrapper_ms"],
                       trel["plain_ms"], trel["bound"])
    k_row |= {"ms": trel["ms"], "profiler_ms": trel["profiler_ms"],
              "profiler_launches": trel["profiler_launches"], "route_taken": trel["route"],
              "loop_ms": trel["plain_ms"], "chain_floor_ms": trel["floor_ms"],
              "decode_ms": trel["decode_ms"]}
    kernels.append(k_row)
    # kernel P and the walk (the streaming pipeline's decoder stage): ``ms``
    # by CUDA events over back-to-back launches queued behind a spinning
    # kernel, on a mid-utterance chunk of the pipeline's geometry
    p_row = kernel_row("trellis_chunk", "trellis_chunk", "parallel pipeline",
                       "lnasr_tpu/parallel/pipeline.py:119-131 trellis_step (lax.scan over an "
                       "arrived chunk :151 inside the tick scan :164, in the jitted shard_map "
                       ":172)", stg["err"], stg["wrapper_ms"], stg["plain_ms"], stg["bound"])
    pipe_routes = par["pipe_by_route"]  # the pipelines' launches by route, all ranks
    p_row |= {"ms": stg["ms"], "log_ms": stg["log_ms"], "log_bound_ms": stg["log_bound"][0],
              "log_route": "chunked", "log_chunked_ms": stg["log_chunked_ms"],
              "log_warp_ms": stg["log_warp_ms"], "log_chain_floor_ms": stg["log_floor_ms"],
              "log_depth": stg["log_depth"], "route_launches": pipe_routes.get("trellis_chunk"),
              "chain_floor_ms": stg["floor_ms"], "chunk": PIPE_CHUNK,
              "stage_ms": stg["stage_ms"], "stage_plain_ms": stg["stage_plain_ms"]}
    kernels.append(p_row)
    w_row = kernel_row("pointer_walk", "pointer_walk", "parallel pipeline",
                       "lnasr_tpu/parallel/pipeline.py:231-238 (the walk's reverse lax.scan)",
                       0.0, stg["walk_wrapper_ms"], stg["walk_plain_ms"], stg["walk_bound"])
    w_row |= {"source": "lnasr_tpu_torch/csrc/trellis_chunk.cu", "ms": stg["walk_ms"],
              "chain_floor_ms": stg["walk_floor_ms"], "depth": stg["walk_depth"],
              "route_launches": pipe_routes.get("pointer_walk")}
    kernels.append(w_row)
    # the backoff kind of D, E and F (the exact backoff search's scans
    # replaced): ``ms`` the device time per call at the V = 5000 segment,
    # the scan each replaces (``scan_ms``, on the card) and the bench graphs'
    # times beside
    seg5k = bo["V=5000 segment"]
    for name, key, path, replaces in (
            ("factored_forward", "d", "V=5000 backoff",
             "lnasr_tpu/models/decoder.py:709 factored_trellis_scan's forward with HopFactors "
             "(_hop_entry :115-151; jax.jit :1044, vmapped :1125)"),
            ("factored_backtrace", "e", "V=5000 backoff",
             "lnasr_tpu/models/decoder.py:709 factored_trellis_scan's backpointers and reverse "
             "scan with HopFactors (:732-761; jax.jit :1044, vmapped :1125)"),
            ("factored_lattice", "f", "V=5000 backoff nbest",
             "lnasr_tpu/models/decoder.py:765 factored_lattice_scan with HopFactors "
             "(jax.jit :1162)")):
        scan_key = "lattice_scan_ms" if key == "f" else "scan_ms"
        kernels.append({
            "name": f"{name}[backoff]", "route": "cuda",
            "source": f"lnasr_tpu_torch/csrc/{name}.cu", "replaces": replaces,
            "launches": launches[path][name],
            "launches_by_path": {p: c[name] for p, c in launches.items()
                                 if p.startswith("V=5000 backoff")},
            "max_abs_err": 0.0, "ms": seg5k[f"{key}_dev_ms"], "wrapper_ms": seg5k[f"{key}_ms"],
            "plain_ms": seg5k[f"{key}_plain_ms"], "bound_ms": seg5k[f"{key}_bound"][0],
            "bound_by": seg5k[f"{key}_bound"][1], "library_ms": None,
            "scan_ms": seg5k[scan_key], "map": seg5k["map"],
            "bench_ms": {n: {"ms": bo[n][f"{key}_ms"], "bound_ms": bo[n][f"{key}_bound"][0],
                             "scan_ms": bo[n][scan_key], "map": bo[n]["map"]}
                         for n in bo if n.startswith("bench")}})
    # the batched launches (batch_phase): one launch of a batch against its
    # single launches, by CUDA events over queued launches (two turns each)
    for row in kernels:
        key = {"factored_forward": "d", "factored_backtrace": "e",
               "factored_lattice": "f"}.get(row["name"])
        if key:
            row["batch"] = {f"V={v}": {"b": r["b"], "ms": (r["times"][key][0] + r["times"][key][2]) / 2,
                                       "loop_ms": (r["times"][key][1] + r["times"][key][3]) / 2,
                                       "bound_ms": r["bounds"][key][0],
                                       "bound_by": r["bounds"][key][1]}
                            for v, r in bat.items() if v != "cut"}
            row["batch"]["cut"] = bat["cut"]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
