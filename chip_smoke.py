#!/usr/bin/env python3
"""Drive the PyTorch port of lnasr_tpu on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the hand-written CUDA kernels from ``lnasr_tpu_torch/csrc`` (one
``nvcc`` per source, all at once), holds each kernel against its plain
PyTorch version at the serving shapes, runs the flagship serving step
(B=64 utterances of 10 s -> MFCC -> GMM emissions -> Viterbi) through the
port's entry point with the kernels' launch counters reset just before,
checks its output against the plain CPU path, and times each kernel, its
plain version and the whole step with CUDA events (medians after warm-up).

Ends with a ``{"kernels": [...]}`` line, the card's name and power limit,
and ``{"ok": true, "device": {...}}`` as the last line. Any failed check
exits non-zero before those lines are printed. Needs a CUDA device and the
repository around it; without either it fails.
"""

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

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


def device_breakdown(torch, fn, step_ms, card, steps=5):
    """Print device time per step by kernel (torch.profiler over ``steps``
    calls) and the device's busy share of the event-timed step."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            fn()
        torch.cuda.synchronize()
    rows = sorted(((e.self_device_time_total / 1e3 / steps, e.count // steps, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA), reverse=True)
    busy = sum(r[0] for r in rows)
    print(f"step breakdown on {card} (torch.profiler, {steps} steps): device busy {busy:.4f} ms "
          f"of {step_ms:.4f} ms per step ({100 * busy / step_ms:.1f}%), {len(rows)} kernel kinds")
    for ms, count, name in rows[:10]:
        print(f"  {ms:.4f} ms  x{count}  {name[:90]}")


def bound(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def make_signals(torch, device):
    """Seeded speech-like noise: amplitude-modulated, never digital silence."""
    rng = np.random.default_rng(0)
    t = np.arange(S) / SR
    rate = rng.uniform(1.0, 4.0, size=(B, 1))
    env = 0.05 + np.clip(np.sin(2 * np.pi * rate * t[None, :]), 0.0, None) ** 2
    x = rng.normal(scale=3000.0, size=(B, S)) * env
    return torch.as_tensor(x.astype(np.float32), device=device)


def main():
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this needs a CUDA GPU",
              file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from lnasr_tpu_torch import _build, entry
    from lnasr_tpu_torch.models.mfcc import cepstral_epilogue, mfcc_features, mfcc_features_fused
    from lnasr_tpu_torch.ops import mel_frontend as mf
    from lnasr_tpu_torch.ops import viterbi as vt
    from lnasr_tpu_torch.ops.framing import num_frames
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

    cfg = entry.MFCC_CONFIG
    x = make_signals(torch, dev)
    t_frames = num_frames(S, cfg.frame_len, cfg.frame_step)

    # -- 2. kernel A vs its plain version -----------------------------------
    lengths = torch.as_tensor(np.random.default_rng(1).integers(S // 2, S + 1, size=B), device=dev)
    lengths[0] = S
    mel_err = 0.0
    for lens in (None, lengths):
        mel_k, en_k = mf.mel_frontend(x, cfg, lengths=lens)
        y = mf.preemphasize(x, cfg, lens)
        mel_p, en_p = mf.mel_frontend_plain(y, cfg)
        torch.cuda.synchronize()
        scale = float(en_p.max())
        for got, ref, what in ((mel_k, mel_p, "mel"), (en_k, en_p, "energy")):
            require(got.shape == ref.shape, f"kernel A {what} shape {tuple(got.shape)}")
            err = (got - ref).abs()
            bar = 2e-6 * scale + 1e-4 * ref.abs()
            require(bool((err <= bar).all()),
                    f"kernel A {what} off the bar: max err {float(err.max())}, scale {scale}")
            if what == "mel":
                mel_err = max(mel_err, float(err.max()))
        feats_k, mask_k = mfcc_features_fused(x, cfg, lengths=lens)
        ref = mfcc_features(x, cfg, lens)
        require(torch.equal(mask_k, ref.mask), "kernel A feature masks differ")
        ferr = float(((feats_k - ref.features).abs() * ref.mask[..., None]).max())
        require(ferr < 0.01, f"kernel A features off by {ferr}")
        print(f"kernel A vs plain ({'variable lengths' if lens is not None else 'full length'}): "
              f"mel max err {float((mel_k - mel_p).abs().max()):.6g} of energy scale {scale:.6g} "
              f"(bar 2e-6*scale + 1e-4*|ref|), features max err {ferr:.3g} (bar 0.01): ok")
    # which side is nearer the truth: both fp32 paths against the plain chain in float64
    mel64, en64 = mf.mel_frontend_plain(mf.preemphasize(x, cfg).double(), cfg)
    all_frames = torch.ones(mel64.shape[:2], dtype=torch.bool, device=dev)
    f64 = cepstral_epilogue(mel64, en64, all_frames, cfg, torch.float64, False)[1]
    k_err = float((mfcc_features_fused(x, cfg)[0].double() - f64).abs().max())
    p_err = float((mfcc_features(x, cfg).features.double() - f64).abs().max())
    print(f"features vs a float64 oracle: kernel path max err {k_err:.3g}, "
          f"plain fp32 path max err {p_err:.3g}")
    # other geometries the kernel takes: any n_mels, other frame lengths and FFT sizes
    for other in (dataclasses.replace(cfg, frame_t=20e-3, n_mels=26),
                  dataclasses.replace(cfg, fft_n=1024, n_mels=80)):
        mel_k, en_k = mf.mel_frontend(x[:4, :SR], other)
        mel_p, en_p = mf.mel_frontend_plain(mf.preemphasize(x[:4, :SR], other), other)
        scale = float(en_p.max())
        ok = all(bool(((g - r).abs() <= 2e-6 * scale + 1e-4 * r.abs()).all())
                 for g, r in ((mel_k, mel_p), (en_k, en_p)))
        require(ok, f"kernel A off the bar at frame_len={other.frame_len}, fft_n={other.fft_n}, "
                    f"n_mels={other.n_mels}")
        print(f"kernel A vs plain (frame_len {other.frame_len}, fft_n {other.fft_n}, "
              f"n_mels {other.n_mels}): within the mel bar")

    # -- 3. kernel B vs its plain version (bitwise) --------------------------
    def model(rng, n, kind):
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

    rng = np.random.default_rng(2)
    for n, b, kind in ((5, B, "random"), (32, 16, "random"), (5, B, "ties"), (5, B, "left_to_right")):
        log_pi, log_a = model(rng, n, kind)
        lb = rng.normal(scale=3.0, size=(b, t_frames, n)).astype(np.float32)
        if kind == "ties":
            lb = np.round(lb)
        args = [torch.as_tensor(v, device=dev) for v in (log_pi, log_a, lb)]
        path_k, score_k = vt.viterbi_small(*args)
        path_p, score_p = vt.viterbi_plain(*args)
        path_c, score_c = vt.viterbi_plain(*[a.cpu() for a in args])
        torch.cuda.synchronize()
        require(torch.equal(path_k, path_p) and torch.equal(score_k, score_p),
                f"kernel B differs from the plain scan on the card ({kind}, N={n}): "
                f"{int((path_k != path_p).sum())} path entries")
        require(torch.equal(path_k.cpu(), path_c) and torch.equal(score_k.cpu(), score_c),
                f"kernel B differs from the plain scan on the CPU ({kind}, N={n})")
        print(f"kernel B vs plain ({kind}, B={b}, T={t_frames}, N={n}): paths and scores bitwise equal")
    try:
        big = torch.zeros((1, 4, 33), device=dev)
        vt.viterbi_batched(torch.zeros(33, device=dev), torch.zeros((33, 33), device=dev), big)
        raised = False
    except NotImplementedError:
        raised = True
    require(raised, "viterbi_batched took N=33 on CUDA without the dense-graph kernel")
    print("viterbi_batched N=33 on CUDA: NotImplementedError (dense kernel not ported yet)")

    # -- 4. the main path ---------------------------------------------------
    flag_model = entry.flagship_model(device=dev)
    step = entry.flagship(device=dev, params=flag_model.params)
    torch.cuda.synchronize()
    mf.mel_frontend.launches = 0
    vt.viterbi_small.launches = 0
    paths, scores = step(x)
    torch.cuda.synchronize()
    launches = {"mel_frontend": mf.mel_frontend.launches, "viterbi": vt.viterbi_small.launches}
    print(f"main path: flagship step on B={B} x {SECONDS} s -> paths {tuple(paths.shape)} "
          f"{paths.dtype}, scores {tuple(scores.shape)}; launches {launches}")
    require(all(v > 0 for v in launches.values()), f"a kernel of the main path never ran: {launches}")
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

    # -- 5. timing ----------------------------------------------------------
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

    log_b = flag_model.emissions(mfcc_features_fused(x, cfg)[0])
    lp, la = flag_model.log_pi, flag_model.log_a
    n = la.shape[0]
    b_ms = cuda_ms(lambda: vt.viterbi_small(lp, la, log_b), reps=50)
    b_plain_ms = cuda_ms(lambda: vt.viterbi_plain(lp, la, log_b), reps=3, warmup=1)
    b_bytes = 4 * (n + n * n + B * t_frames * n + B * t_frames + B)
    b_ops = B * (t_frames - 1) * (2 * n * n + n)
    b_bound, b_by = bound(b_bytes, b_ops)

    step_ms = cuda_ms(lambda: step(x), reps=20)
    print(f"timing on {card}: kernel A {a_ms:.4f} ms (wrapper with pre-emphasis {a_wrap_ms:.4f} ms, "
          f"plain {a_plain_ms:.4f} ms, bound {a_bound:.4f} ms by {a_by}); kernel B {b_ms:.4f} ms "
          f"(plain {b_plain_ms:.4f} ms, bound {b_bound:.5f} ms by {b_by}); step {step_ms:.4f} ms = "
          f"{B * SECONDS / (step_ms / 1e3):.1f} audio-s/s at B={B} x {SECONDS} s")
    device_breakdown(torch, lambda: step(x), step_ms, card)

    kernels = [
        {"name": "mel_frontend", "route": "cuda", "source": "lnasr_tpu_torch/csrc/mel_frontend.cu",
         "replaces": "lnasr_tpu/ops/mfcc_pallas.py:429", "launches": launches["mel_frontend"],
         "max_abs_err": mel_err, "ms": a_ms, "plain_ms": a_plain_ms, "bound_ms": a_bound,
         "bound_by": a_by, "library_ms": None},
        {"name": "viterbi", "route": "cuda", "source": "lnasr_tpu_torch/csrc/viterbi.cu",
         "replaces": "lnasr_tpu/ops/trellis_pallas.py:129", "launches": launches["viterbi"],
         "max_abs_err": 0.0, "ms": b_ms, "plain_ms": b_plain_ms, "bound_ms": b_bound,
         "bound_by": b_by, "library_ms": None},
    ]
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
