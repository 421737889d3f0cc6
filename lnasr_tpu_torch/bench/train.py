"""Training-throughput benchmark: one Baum-Welch EM sweep's audio-seconds
per second on the flagship topology, the port of the JAX package's
``bench_train.py``.

    python -m lnasr_tpu_torch.bench.train [--device cuda] [--trials 5] [--out FILE]

Times one full ``gmmhmm_em_step`` sweep (emissions, the forward-backward
recursion, posterior statistics, M-step) at ``entry.training()``'s
geometry: B = 64 utterances of 10 s, 5 states x 8 mixtures x 39 dims,
diagonal covariance, float32, the parameters carried from sweep to sweep
as a training loop carries them. Beside it:

- the emission stage alone, with its GEMM's operations and bytes against
  the card's peaks;
- the forward + backward recursions at T and T/2 frames, through
  ``forward_backward`` as the sweep runs them (on the card one launch of
  kernel G for both directions), whose difference gives the cost of one
  step (the recursion's latency);
- the E-step statistics (emissions + recursions + posterior moments), so
  the posterior reductions are the statistics less the recursions and the
  emissions, and the M-step the sweep less the statistics.

Timing: CUDA events, the median of ``--trials`` after a warm-up (the host
clock on the CPU). The JSON line goes to stdout, and to ``--out`` only
when that is given.
"""

from __future__ import annotations

import argparse
import json
import sys
from statistics import median

import torch

from lnasr_tpu_torch.bench import (
    BATCH,
    DIM,
    N_MIX,
    N_STATES,
    UTT_SECONDS,
    describe_device,
    device_peaks,
    rounded,
    speed_of_light,
    time_calls,
)

DEFAULT_TRIALS = 5
EMISSION_REPS = 20  # the emission GEMM alone is short: calls a trial times


def measurements(device, trials: int) -> dict:
    from lnasr_tpu_torch import entry
    from lnasr_tpu_torch.models import gmmhmm as G
    from lnasr_tpu_torch.ops.trellis import forward_backward

    run = entry.training(device=device, batch=BATCH, seconds=UTT_SECONDS)
    feats, mask = run.features, run.mask
    p0 = run.params
    t_frames = int(feats.shape[1])
    carried = [p0]

    def sweep():
        carried[0] = run.step(carried[0])[0]

    em_samples = time_calls(sweep, device, trials)

    def emissions():
        return G._emissions(p0, feats, "diag")

    emis_samples = time_calls(emissions, device, trials, reps=EMISSION_REPS)
    log_b = emissions()[0]

    def scans_at(t_sub):
        lb, mk = log_b[:, :t_sub], mask[:, :t_sub]

        return lambda: forward_backward(p0.log_pi, p0.log_a, lb, mk)

    scans_full = time_calls(scans_at(t_frames), device, trials)
    scans_half = time_calls(scans_at(t_frames // 2), device, trials)
    stats_samples = time_calls(
        lambda: G._combine_stats(G._sequence_stats(p0, feats, mask, "diag")), device, trials)

    peaks = device_peaks(device)
    bt = BATCH * t_frames
    k = N_STATES * N_MIX
    # the E-step emission GEMM (B T, 2 D + 1) x (2 D + 1, N M) and the
    # per-state logsumexp; features in, (B, T, N) state and (B, T, N, M)
    # component log-likelihoods out (the E-step consumes both)
    emis_s = median(emis_samples)
    emis = speed_of_light(bt * (2 * (2 * DIM + 1) * k + 4 * k),
                          bt * (DIM * 4 + N_STATES * 4 + k * 4), emis_s, peaks)
    emis |= {"audio_s_per_s": BATCH * UTT_SECONDS / emis_s,
             "trials_s": [round(s, 7) for s in emis_samples]}

    t_full, t_half = median(scans_full), median(scans_half)
    slope = max(t_full - t_half, 1e-12) / (t_frames - t_frames // 2)
    scans = {
        "seconds_per_call": round(t_full, 7),
        "seconds_at_half_T": round(t_half, 7),
        "us_per_step": round(slope * 1e6, 3),
        "intercept_s": round(t_full - slope * t_frames, 7),
        "trials_s": [round(s, 7) for s in scans_full],
        # per step the forward and backward recursions move 2 B N^2
        # logsumexp candidates (~4 operations each): nanoseconds of the
        # card's fp32 rate, so the measured step is the loop's latency
        "ops_floor_us_per_step": (round(2 * 4 * BATCH * N_STATES ** 2 / peaks[0] * 1e6, 6)
                                  if peaks else None),
    }
    t_stats = median(stats_samples)
    em_s = median(em_samples)
    posterior_s = max(t_stats - t_full - emis_s, 0.0)
    # the two moment GEMMs over (b, t) into (N, M, D), and the xi/gamma
    # and component-posterior fields
    post_flops = 2 * 2 * bt * k * DIM + 8 * bt * k
    post_bytes = bt * (k * 4 * 3 + DIM * 4) + 2 * k * DIM * 4
    post = {"seconds_derived": round(posterior_s, 7),
            "derived_as": "statistics - recursions - emissions (each timed)",
            "stats_seconds_per_call": round(t_stats, 7)}
    if posterior_s > 0:
        post |= speed_of_light(post_flops, post_bytes, posterior_s, peaks)
    return {
        "device": describe_device(device),
        "sweep_throughputs": sorted(BATCH * UTT_SECONDS / s for s in em_samples),
        "sweep_trials_s": [round(s, 7) for s in em_samples],
        "emissions": emis,
        "stages_extra": {
            "fwd_bwd_scans": scans,
            "posterior_reductions": rounded(post, 7),
            "m_step": {"seconds_derived": round(max(em_s - t_stats, 0.0), 7),
                       "derived_as": "the whole sweep - statistics"},
        },
        "t_frames": t_frames,
        "loglik_finite": bool(torch.isfinite(run.step(carried[0])[1])),
    }


def main(argv=None) -> int:
    from lnasr_tpu_torch._device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--trials", type=int, default=DEFAULT_TRIALS)
    ap.add_argument("--out", default=None, help="also write the JSON line to this file")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    meas = measurements(device, args.trials)
    ths = meas["sweep_throughputs"]
    value = median(ths)
    out = {
        "metric": "EM training sweep audio-seconds/s per card "
                  "(full Baum-Welch: emissions + fwd/bwd + stats + M-step)",
        "value": round(value, 2),
        "unit": "audio-seconds/s",
        "topology": {"batch": BATCH, "utt_seconds": UTT_SECONDS, "n_states": N_STATES,
                     "n_mix": N_MIX, "dim": DIM, "t_frames": meas["t_frames"],
                     "cov_type": "diag", "dtype": "float32"},
        "spread": {"median": round(value, 2), "min": round(ths[0], 2),
                   "max": round(ths[-1], 2), "trials": [round(t, 2) for t in ths]},
        "seconds_per_sweep": round(median(meas["sweep_trials_s"]), 7),
        "loglik_finite": meas["loglik_finite"],
        "stages": {"emissions": rounded(meas["emissions"], 7), **meas["stages_extra"]},
        "note": "the fwd/bwd recursions are one chain of dependent steps a direction (one "
                "kernel launch on the card, frame loops of torch ops on the CPU): their "
                "per-step cost (the T-slope) is the chain's latency, not the card's arithmetic",
        "device": meas["device"],
        "timing": (f"{'CUDA events' if device.type == 'cuda' else 'host clock'}, median of "
                   f"{args.trials} trials after a warm-up"),
    }
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fp:
            fp.write(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
