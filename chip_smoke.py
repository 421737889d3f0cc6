#!/usr/bin/env python3
"""Drive the PyTorch port of lnasr_tpu on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``lnasr_tpu_torch/csrc`` (one
``nvcc`` per source, all at once) and holds each kernel against its plain
PyTorch version at the serving shapes (the Viterbi kernels bitwise: the
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
- live serving at V = 1000, ``entry.streaming_serving(1000)``: a ~60 s
  stream in 100 ms chunks through ``StreamingRecognizer`` (the native
  VAD, built with ``g++``, closes segments; each segment launches the mel
  frontend, forward and backtrace kernels once), against the CPU stream,
  with a ``reset()`` replay and ``Recognizer.recognize_segments``;
- the exact trigram graph at V = 200, ``entry.recognizer_serving(200,
  graph="trigram", lm_order=3)``: its segment decode launches the mel
  frontend once (the decode itself is a frame loop of torch ops);
- the device VADs on the stream's audio (LTSD fixed and adaptive, the
  WebRTC-style torch VAD in modes 0-3) against their CPU runs and the
  native detector;
- training, ``entry.training()``: B=64 utterances of 10 s -> MFCC (mel
  frontend once) -> Baum-Welch sweeps of the flagship GMM-HMM (torch
  frame loops and GEMMs, no kernel of the port), float64 against the CPU
  and float32 against a float64 oracle, timed and split; kill and resume
  bitwise (the GMM-HMM and a 65,536-symbol discrete HMM);
  ``entry.unit_training(22)`` (mel frontend once) against the CPU, with a
  planted decode by the trained units (mel frontend, dense-graph
  Viterbi); the word segmenter against the CPU;
- ``parallel/`` on one world of 4 ranks spawned on the card (gloo; the
  kernels built here first): data-parallel EM on the flagship batch (16
  utterances a rank, the mel frontend once on each rank's signals) and
  mixture-sharded EM against the single-process sweep, kill and resume
  bitwise; the time-sharded forward, backward, Viterbi and EM on the
  stream's features against the scans; ``parallel.decode_batch_sharded``
  at V = 1000 (8 segments, two planted; the mel frontend once, the
  forward and backtrace kernels twice on every rank) bitwise equal to
  ``decode_batch``; the 2- and 4-stage pipelines; then one sweep on a
  world of one under NCCL. Several ranks on one card show correctness
  and overhead, not scaling;
- the command line (``lnasr_tpu_torch.cli``), ``cli_phase``: ``mfcc``
  (mel frontend once) against ``--device cpu``; ``lm-train``, ``lm-ppl``
  and ``vad`` against the port's objects; ``train-am --f64`` and
  ``recognize`` through ``build_parser()`` and the cores with the models in
  memory, card against CPU, ``recognize`` in four forms (default graph:
  mel frontend and dense-graph Viterbi; ``--graph factored``: mel
  frontend, forward and backtrace; ``--nbest 3 --confidence``: mel
  frontend and lattice; ``--bucket-frames 16``); ``cli bench`` (the
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
S = SECONDS * SR
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate
FP32_FLOPS = 67e12  # H100 SXM fp32 peak outside the tensor cores


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


def device_ms(torch, fn, calls=10):
    """Device milliseconds per call of ``fn``: the device time of the
    kernels and memsets it launches (torch.profiler over ``calls`` calls
    after one warm-up), without the host time between them that CUDA events
    around a short wrapper call also catch."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in prof.key_averages()
               if on_device(torch, e)) / 1e3 / calls


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


def bound(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOPS * 1e3
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
    return mel_err


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
    (kernel F once per utterance) equals looping ``decode_lattice``."""
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
    require(F.factored_lattice.launches - before == 2,
            "decode_lattice_batch of 2 utterances did not launch kernel F twice")
    for b in range(2):
        solo = g.decode_lattice(feats[b], masks[b])
        require(batch[b].tokens == solo.tokens and
                [(h.words, h.score) for h in batch[b].nbest(5)]
                == [(h.words, h.score) for h in solo.nbest(5)],
                f"decode_lattice_batch utterance {b} differs from decode_lattice")
    print(f"decode_lattice_batch (B=2, masks of {len(obs)} and {len(obs) - cut} frames): kernel F "
          "twice, tokens and N-best equal to looping decode_lattice")

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


def trigram_phase(torch, entry, wrappers, card, launches):
    """The exact trigram graph at V = 200 (an order-3 LM counted from
    ``serving_corpus(200)``): the bucketed segment decode launches the mel
    frontend once and no other kernel, and equals the CPU recognizer; a
    planted 6-word sequence decodes to itself."""
    from lnasr_tpu_torch.models.decoder import TrigramDecodingGraph

    rec, seg = entry.recognizer_serving(200, device=DEVICE, graph="trigram", lm_order=3)
    rec_cpu, _ = entry.recognizer_serving(200, device="cpu", graph="trigram", lm_order=3)
    g = rec.graph
    require(isinstance(g, TrigramDecodingGraph) and rec.lm.ngram.order == 3,
            "V=200 did not compose the trigram graph over an order-3 LM")
    rec.decode_segment(seg)  # first calls out of the count and the timing
    torch.cuda.synchronize()
    reset_counts(*wrappers)
    words, score = rec.decode_segment(seg)
    counts = {w.__name__: w.launches for w in wrappers}
    launches["V=200 trigram"] = counts
    require(counts["mel_frontend"] == 1 and all(c == 0 for n, c in counts.items()
                                                if n != "mel_frontend"),
            f"the trigram segment decode did not launch the mel frontend once and nothing "
            f"else: {counts}")
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
          f"{score}; launches {counts}; equal to the CPU recognizer (score rel err {rel:.3g}); "
          f"planted {planted} -> {got} (paths "
          f"{'equal' if np.array_equal(path_g, path_c) else 'differ'} to the CPU's)")
    print(f"timing on {card}: trigram segment V=200: {ms:.4f} ms per {seg_s} s segment = "
          f"{seg_s / (ms / 1e3):.1f} audio-s/s (host clock, one device->host copy); device time "
          f"{dev:.4f} ms per call (torch.profiler)")
    device_breakdown(torch, lambda: rec.decode_segment(seg), ms, f"{card}, trigram segment V=200",
                     steps=2)
    return {"ms": ms, "device_ms": dev}


def vad_phase(torch, entry, card):
    """The device VADs on the stream's audio: LTSD (fixed and adaptive) and
    the WebRTC-style torch VAD in modes 0-3, each on the card against the
    same module on CPU tensors; WebRTC's flags against the native
    detector's."""
    from lnasr_tpu_torch.config import LTSDConfig
    from lnasr_tpu_torch.vad import VadLtsd, WebRtcVad, WebRtcVadTorch

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
        got32 = vad.detect(x).ltsd.cpu().numpy()
        ms = host_ms(lambda: vad.detect(x).ltsd.cpu(), reps=5, warmup=1)
        out[name] = ms / audio_s
        print(f"{name} VAD on the stream ({audio_s} s, {len(got)} frames): card equal to CPU in "
              f"float64 (rtol 1e-8, atol 1e-10; max err {np.abs(got - ref).max():.3g}); float32 "
              f"on the card {np.abs(got32 - ref).max():.3g} dB from the float64 scores, "
              f"{int((got32 > cfg.threshold).sum())} vs {int((ref > cfg.threshold).sum())} speech "
              f"frames; {ms:.4f} ms = {ms / audio_s:.4f} ms per second of audio on {card}")
    for mode in range(4):
        t0 = time.perf_counter()
        flags = WebRtcVadTorch(mode=mode, device=DEVICE).process(audio)
        ms = (time.perf_counter() - t0) * 1e3
        torch.set_num_threads(1)  # the frame loop's tiny ops run faster on one thread
        try:
            flags_cpu = WebRtcVadTorch(mode=mode, device="cpu").process(audio)
        finally:
            torch.set_num_threads(threads)
        native = WebRtcVad(mode=mode).process(audio)
        require(np.array_equal(flags, flags_cpu), f"WebRtcVadTorch mode {mode}: card != CPU "
                f"on {int((flags != flags_cpu).sum())} frames")
        require(np.array_equal(flags, native), f"WebRtcVadTorch mode {mode}: card != native "
                f"on {int((flags != native).sum())} frames")
        out[f"webrtc mode {mode}"] = ms / audio_s
        print(f"WebRtcVadTorch mode {mode} on the stream ({len(flags)} frames, "
              f"{int((flags > 0).sum())} flagged): equal to the CPU run and to the native "
              f"detector frame for frame; {ms:.1f} ms = {ms / audio_s:.3f} ms per second of "
              f"audio on {card} (host clock; the GMM's frame loop)")
    return out


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


def training_phase(torch, entry, wrappers, card, launches):
    """Training: the flagship EM sweep at full width (B = 64 x 10 s, 5 x 8 x
    39 diagonal), its float64 sweeps against the CPU's and its float32
    sweeps against a float64 oracle, its time and split; kill and resume
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
    from lnasr_tpu_torch.utils.checkpoints import Checkpointer, em_loop

    f32, f64 = torch.float32, torch.float64

    def only_a(counts, what):
        require(counts["mel_frontend"] == 1 and all(c == 0 for n, c in counts.items()
                                                    if n != "mel_frontend"),
                f"{what} did not launch the mel frontend once and nothing else: {counts}")

    # -- the training path: features (kernel A once) and one sweep ----------
    torch.cuda.synchronize()
    reset_counts(*wrappers)
    run = entry.training(device=DEVICE)
    params1, loglik1 = run.step(run.params)
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in wrappers}
    only_a(counts, "the training path")
    launches["training"] = {"mel_frontend": counts["mel_frontend"]}
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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run.step(run.params)
        torch.cuda.synchronize()
        prof_ms = (time.perf_counter() - t0) * 1e3
    busy = sum(e.self_device_time_total for e in prof.key_averages() if on_device(torch, e)) / 1e3
    n_launch = host_launches(prof)
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
          + f"; emissions alone {em_ms:.4f} ms by events")
    device_breakdown(torch, lambda: run.step(run.params), step_ms, f"{card}, EM sweep", steps=1)

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
    am64, examples = entry.unit_training(22, device=DEVICE, dtype=f64)
    torch.cuda.synchronize()
    counts = {w.__name__: w.launches for w in wrappers}
    only_a(counts, "unit training")
    launches["unit training"] = {"mel_frontend": counts["mel_frontend"]}
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
    seg = Seg(device=DEVICE).train(SegDataSet.mark(line) for line in SEG_CORPUS)
    got = [seg.segment(text) for text in SEG_SENTENCES]
    seg_s = time.perf_counter() - t0
    seg_cpu = Seg(device="cpu").train(SegDataSet.mark(line) for line in SEG_CORPUS)
    ref = [seg_cpu.segment(text) for text in SEG_SENTENCES]
    require(got == ref, f"segmenter: card {got} vs CPU {ref}")
    require(got[0] == ["我们", "喜欢", "学习", "中文"], f"segmenter: {got[0]}")
    print(f"segmenter on the card: {got} (equal to the CPU's); training and {len(got)} "
          f"segmentations {seg_s:.3f} s")
    return {"sweep_ms": step_ms, "busy": busy / prof_ms, "launches": n_launch, "stages": stages,
            "unit_s": unit_s}


PARALLEL_RANKS = 4
PIPE_CHUNK = 111  # divides the flagship utterance's T = 999


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
    from lnasr_tpu_torch.ops import viterbi as vt
    from lnasr_tpu_torch.ops import viterbi_dense as vd
    from lnasr_tpu_torch.parallel import distributed as D
    from lnasr_tpu_torch.parallel.mesh import mesh_axis

    dev = D.local_device()
    on_card = dev.type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    f32, f64 = torch.float32, torch.float64
    host = lambda x: x.detach().cpu().numpy()  # noqa: E731
    counted = (mf.mel_frontend, vt.viterbi_small, vd.viterbi_dense, F.factored_forward,
               F.factored_backtrace, F.factored_lattice)

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
    pm, llm = mp.step(mp.params)
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
    feats, masks = serve.features.clone(), serve.masks.clone()
    in_lm = [w for w in graph.words if w in set(serve.recognizer.lm.ngram.vocabulary())]
    planted = {2: in_lm[3:9], 5: in_lm[20:26]}
    for row, words in planted.items():
        obs = torch.as_tensor(planted_features(torch, graph, np.random.default_rng(300 + row),
                                               words), device=dev)
        feats[row] = 0.0
        feats[row, :len(obs)] = obs
        masks[row] = torch.arange(feats.shape[1], device=dev) < len(obs)
    res = P.decode_batch_sharded(graph, feats, masks, dp_mesh)
    sync()
    out["decode_launches"] = counts()
    out["decode"] = res
    out["planted"] = planted
    if out["rank"] == 0:
        out["decode_inputs"] = (host(feats), host(masks))
    out["decode_ms"] = wall_ms(lambda: P.decode_batch_sharded(graph, feats, masks, dp_mesh))

    # -- the streaming pipeline on one 10 s flagship utterance, 2 and 4 stages
    params = entry.flagship_model(dev, f64).params
    args = (params.log_pi, params.log_a, params.log_w, params.mu, params.cov,
            feats_all[0].double())
    pipe, pipe_ms = {}, {}
    for n_stages in (2, 4):
        mesh = P.make_stage_mesh(n_stages=n_stages)
        t0 = time.perf_counter()
        path, score = P.streaming_pipeline_decode(*args, mesh, chunk=PIPE_CHUNK)
        sync()
        pipe_ms[n_stages] = (time.perf_counter() - t0) * 1e3
        ll = P.streaming_pipeline_scores(*args, mesh, chunk=PIPE_CHUNK, semiring="log")
        pipe[n_stages] = dict(path=host(path), score=float(score), loglik=float(ll))
    out["pipe"], out["pipe_ms"] = pipe, pipe_ms
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
    one EM sweep), the sharded V = 1000 decode (kernels A once, D and E
    twice on every rank) and the pipeline (2 and 4 stages), each held
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
    a_once = {w.__name__: int(w.__name__ == "mel_frontend") for w in wrappers}
    require(all(c == a_once for c in dp_launch), f"parallel_training's launches per rank {dp_launch}")
    launches["parallel training"] = {"mel_frontend": sum(c["mel_frontend"] for c in dp_launch)}
    hist_s, hist_r, bitwise = r0["mp_resume"]
    calls, n_bytes, coll_ms = r0["dp32_collectives"]
    mp_calls, mp_bytes, mp_coll_ms = r0["mp64_collectives"]
    print(f"parallel DP EM (data 4, 16 x 10 s utterances a rank, kernel A once on each rank's "
          f"signals; B=64, 5x8x39 diag): float64 vs the single-process sweep on the card "
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
    expect = {w.__name__: 0 for w in wrappers} | {"mel_frontend": 1, "factored_forward": 2,
                                                  "factored_backtrace": 2}
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
              f"{r0['pipe_ms'][n_stages]:.2f} ms on {card} (host clock; {shared})")
        require(same and e_score < 1e-10 and e_ll < 1e-10,
                f"the {n_stages}-stage pipeline: path equal {same}, {e_score}, {e_ll}")

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
    return {"world_s": world_s, "dp32_ms": [r["dp32_ms"] for r in ranks]}


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
# reach kernels A, C, D, E and F (each wrapper is imported by name there).
KERNEL_SITES = (("lnasr_tpu_torch.models.mfcc", "mel_frontend"),
                ("lnasr_tpu_torch.models.decoder", "viterbi_dense"),
                ("lnasr_tpu_torch.models.decoder", "factored_forward"),
                ("lnasr_tpu_torch.models.decoder", "factored_backtrace"),
                ("lnasr_tpu_torch.models.decoder", "factored_lattice"))


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
    C and E (path and score) bitwise, D's grids bitwise at feasible states,
    F's records bitwise (``-inf`` included). ``want`` names the wrappers
    that must have been checked at least once."""
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
        else:
            ref = F.factored_lattice_plain(*args)
            bits = lambda x: x.view(torch.int32) if x.is_floating_point() else x  # noqa: E731
            require(all(torch.equal(bits(a), bits(b)) for a, b in zip(out, ref)),
                    f"kernel F records differ from its plain version on {what}'s inputs")
            shape = tuple(args[4].shape)
        checked.setdefault(name, []).append(shape)
    torch.cuda.synchronize()
    require(set(want) <= set(checked),
            f"{what}: no call of {sorted(set(want) - set(checked))} was held against its plain "
            "version")
    print(f"{what}: each kernel call at each distinct shape held against its plain version "
          "on the path's own inputs (A within its bars, C, E and F bitwise, D bitwise at "
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
      model on the card against the CPU in four forms (default graph: A,
      C; ``--graph factored``: A, D, E; ``--nbest 3 --confidence``: A, F;
      ``--bucket-frames 16``: A, C);
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

        (am64, args64), counts, train_s = counted(lambda: train_am(["--f64"]))
        launches["cli train-am"] = counts
        am64_cpu, args64_cpu = train_am(["--f64", "--device", "cpu"])
        dist64 = max(param_dist(torch, am64.units[u].params, am64_cpu.units[u].params)
                     for u in am64_cpu.units)
        print(f"cli train-am --f64 (build_parser + train_am_units, 4 units, 5 sweeps) on {card}: "
              f"{train_s:.3f} s (host clock); units {sorted(am64.units)}, parameters within "
              f"{dist64:.3g} of --device cpu (bar 1e-8); launches {counts} (the plain MFCC "
              "pipeline and torch EM)")
        require(sorted(am64.units) == sorted(am64_cpu.units) == ["<sil>", "high", "low", "mid"]
                and dist64 < 1e-8, f"cli train-am --f64: card vs CPU {dist64}")
        require(cli.am_config(args64) == cli.am_config(args64_cpu), "am_config.json differs")
        expect(counts, {}, "cli train-am")

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
        }
        for key, (extra, want) in forms.items():
            args = cli.build_parser().parse_args(base + extra)
            args_cpu = cli.build_parser().parse_args(base + extra + ["--device", "cpu"])
            calls = {}
            (hyp, lines), counts, rec_s = counted(
                lambda: cli.recognize_with(am_card, lexicon, lm, utterance, args), calls)
            launches[key] = counts
            hyp_c, lines_c = cli.recognize_with(am_cpu, lexicon, lm, utterance, args_cpu)
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

    def dense_path(counts, want, what):
        require(all(counts[n] > 0 for n in want)
                and all(counts[n] == 0 for n in counts if n not in want),
                f"{what}: launches {counts}; expected {want} and nothing else (the synthetic "
                "vocabulary composes the dense graph)")

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
        dense_path(counts, ("mel_frontend", "viterbi_dense"), "stream harness")
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

        with contextlib.redirect_stdout(io.StringIO()) as demo_out:
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
        dense_path(counts, ("mel_frontend", "viterbi_dense", "factored_lattice"), "wer harness")
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
    from lnasr_tpu_torch.ops import viterbi as vt
    from lnasr_tpu_torch.ops import viterbi_dense as vd
    from lnasr_tpu_torch.ops.framing import hamming_window, num_frames, split_frames
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
    # decode_batch: one forward and one backtrace launch per utterance
    masks = torch.stack([mask, torch.arange(200, device=dev) < 140])
    before = F.factored_forward.launches, F.factored_backtrace.launches
    batch = g.decode_batch(torch.stack([obs, obs]), masks)
    require((F.factored_forward.launches - before[0], F.factored_backtrace.launches - before[1])
            == (2, 2), "decode_batch of 2 utterances did not launch D and E twice each")
    lb2, pi_g, fin_g = g._grid_inputs(torch.stack([obs, obs]))
    for b, (_, path_b, score_b) in enumerate(batch):
        path_p, score_p = F.factored_backtrace_plain(
            F.factored_forward_plain(pi_g, g.inner_a, g.exit_idx, g._kernel_hop, lb2[b], masks[b]),
            g.inner_a, g.exit_idx, g._kernel_hop, fin_g, masks[b])
        require(np.array_equal(path_b, path_p.cpu().numpy()) and score_b == float(score_p),
                f"decode_batch utterance {b} differs from the plain forward and replay")
    print("decode_batch (B=2, mixed word lengths, loop-free, masks of 170 and 140 frames): D and "
          "E twice each, paths and scores bitwise those of the plain versions")
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
                F.factored_backtrace, F.factored_lattice)
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
    # with a rank-1 hop (the exchange and a V-long block max, no V x V work)
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
    grid_bytes = 4 * seg_frames * vw * sw
    d_bound, d_by = bound(graph_bytes + 2 * grid_bytes + seg_frames,
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
          f"{d_none_ms:.4f} ms, rank-1 hop (exchange + block max) {d_rank1_ms:.4f} ms, so the "
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
    f_bound, f_by = bound(graph_bytes + grid_bytes + 12 * seg_frames * vw + seg_frames,
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

    # -- 9, 10, 11. live serving: the stream, the trigram graph, device VADs --
    stream_phase(torch, entry, wrappers, card, launches)
    trigram_phase(torch, entry, wrappers, card, launches)
    vad_phase(torch, entry, card)

    # -- 12. training -------------------------------------------------------
    train = training_phase(torch, entry, wrappers, card, launches)

    # -- 13. parallel/: 4 ranks on the card -----------------------------------
    parallel_phase(torch, entry, wrappers, card, launches, train["sweep_ms"])

    # -- 14. the command line, the bench harnesses and the examples --------------
    cli_phase(torch, entry, wrappers, card, launches)

    # -- 15. the recording harnesses: bench/stream.py, bench/wer.py's protocol --
    recording_phase(torch, entry, wrappers, card, launches)

    def kernel_row(name, counter, own_path, replaces, err, wrapper_ms, plain_ms, bnd):
        """One kernel's entry: ``launches`` on its own slice's main path and
        ``launches_by_path`` on every main path run here that counted it
        (the training paths count the mel frontend only); ``ms`` its device
        time per call, ``wrapper_ms`` the CUDA-event time of the call. No
        single PyTorch call computes any of these kernels' functions."""
        return {"name": name, "route": "cuda", "source": f"lnasr_tpu_torch/csrc/{name}.cu",
                "replaces": replaces, "launches": launches[own_path][counter],
                "launches_by_path": {p: c[counter] for p, c in launches.items() if counter in c},
                "max_abs_err": err, "ms": dev_ms[name], "wrapper_ms": wrapper_ms,
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
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
