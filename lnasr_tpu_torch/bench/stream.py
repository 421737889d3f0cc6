"""Streaming-latency harness: per-segment decode latency, real-time factor
and the retained buffer of ``StreamingRecognizer`` on a looped recording.

    python -m lnasr_tpu_torch.bench.stream --recording F.raw \\
        [--minutes 5] [--device cpu] [--out FILE]

The port of the JAX package's ``bench_stream.py``. The recording (raw
16 kHz 16-bit PCM) is an argument, with no default path.

1. :func:`build_recognizer`: VAD-segment the recording into a word
   inventory (each speech segment of at least 0.2 s is a word, the audio
   after the last segment the silence), make 4 augmented copies of each
   word and 3 of the silence, take them through the frontend as ONE padded
   batch (the mel frontend kernel once on CUDA), train 6-state x 2-mixture
   word units and a 3 x 4 ``<sil>`` (5 sweeps, padded to the longest
   example) and build a shape-bucketed recognizer (``bucket_frames`` 128).
2. :func:`run`: warm up (one decode per bucket count 1-5 and a whole pass
   of the recording), time the bucketed segment decode
   (``Recognizer._segment_arrays``: features, then the graph's decode on
   the device) per bucket count, then feed ``--minutes`` of the recording,
   looped and freshly augmented each pass, in 100 ms chunks.
3. Report p50/p95/p99/max/mean segment latency, ``rtf`` (decode time over
   audio time), ``wall_rtf`` (the feed's wall time over audio time), the
   largest retained buffer, and the latency split into the decode's
   dispatch (the host time of ``_segment_arrays``) and the rest (padding,
   the one copy back, the words), beside the device time per bucket
   count (CUDA events on the card, the host clock on the CPU).

Exit code 0 only when the stream keeps up (``rtf`` < 0.5) and the buffer
stays under 30 s. Writes a file only with ``--out``. On CUDA each segment
launches the mel frontend kernel and the dense-graph Viterbi kernel (a
vocabulary of up to 42 words composes at most 256 states; above that the
factored forward and backtrace kernels).
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np

SR = 16000
CHUNK = 1600  # 100 ms feed granularity
# the device-time loop: trials of TIMING_REPS calls each, per bucket count
TIMING_TRIALS, TIMING_REPS = 5, 20


def stream_inventory(audio: np.ndarray):
    """``(segments, words, gaps)`` of the recording: the native WebRTC VAD
    (mode 0) segments it (gaps of 12 frames close a segment, 8 frames
    make one, 2 frames of padding); each segment of at least 0.2 s is a
    word; the audio after the last segment is the one gap (the first
    second when nothing is speech)."""
    from lnasr_tpu_torch.models.recognizer import segment_speech
    from lnasr_tpu_torch.vad.native import WebRtcVad

    vad = WebRtcVad(mode=0)
    flags = vad.process(audio)
    segs = segment_speech(flags, vad.FRAME_LEN, min_gap_frames=12, min_len_frames=8,
                          pad_frames=2)
    words = [audio[a:b] for a, b in segs if (b - a) / SR >= 0.2]
    gaps = [audio[segs[-1][1]:]] if segs else [audio[:SR]]
    return segs, words, gaps


def augmenter(rng):
    """The harness's augmentation on ``rng``: gain 0.8-1.2 and white noise
    at 18-30 dB below the scaled signal."""

    def augment(x):
        y = x.astype(np.float64) * rng.uniform(0.8, 1.2)
        rms = np.sqrt(np.mean(y**2)) / (10.0 ** (rng.uniform(18, 30) / 20.0))
        y = y + rng.normal(0.0, rms, len(y))
        return np.clip(y, -32768, 32767).astype(np.int16)

    return augment


def training_batch(words, gaps, augment):
    """``(labels, batch (n, S) float32, lengths)``: 4 augmented copies of
    each word (``w{i}``), then 3 rounds of the gaps (``<sil>``), zero-padded
    into one batch."""
    clips, labels = [], []
    for i, w in enumerate(words):
        for _ in range(4):
            clips.append(augment(w))
            labels.append(f"w{i}")
    for g in gaps * 3:
        clips.append(augment(g))
        labels.append("<sil>")
    lengths = np.array([len(c) for c in clips])
    batch = np.zeros((len(clips), int(lengths.max())), np.float32)
    for i, c in enumerate(clips):
        batch[i, : len(c)] = c
    return labels, batch, lengths


def build_recognizer(recording: str, device="cuda"):
    """``(recognizer, audio, augment)`` for the recording at ``recording``
    on ``device`` (see the module docstring); ``augment`` carries on the
    generator of seed 0 that drew the training copies."""
    import torch

    from lnasr_tpu_torch._device import resolve_device
    from lnasr_tpu_torch.config import GMMHMMConfig, MFCCConfig
    from lnasr_tpu_torch.models.lexicon import Lexicon
    from lnasr_tpu_torch.models.recognizer import AcousticModel, Recognizer, train_unit_models
    from lnasr_tpu_torch.ops.framing import num_frames
    from lnasr_tpu_torch.utils.audio import read_pcm

    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    audio = read_pcm(recording)
    _, words, gaps = stream_inventory(audio)
    augment = augmenter(rng)

    mfcc_cfg = MFCCConfig(energy_floor=1e-10, mean_norm=False)
    am = AcousticModel(mfcc_config=mfcc_cfg, dtype=torch.float32, device=dev)
    labels, batch, lengths = training_batch(words, gaps, augment)
    feats, _ = am.features_batch(torch.from_numpy(batch).to(dev),
                                 torch.as_tensor(lengths, device=dev))
    feats = feats.cpu().numpy()
    examples = {}
    for i, lab in enumerate(labels):
        t = num_frames(int(lengths[i]), mfcc_cfg.frame_len, mfcc_cfg.frame_step)
        examples.setdefault(lab, []).append(feats[i, :t])
    cfg = GMMHMMConfig(n_states=6, n_mix=2, dim=mfcc_cfg.feature_dim)
    sil_cfg = GMMHMMConfig(n_states=3, n_mix=4, dim=mfcc_cfg.feature_dim)
    t_pad = max(e.shape[0] for exs in examples.values() for e in exs)
    am.units = train_unit_models(examples, cfg, iters=5, unit_configs={"<sil>": sil_cfg},
                                 pad_to=t_pad, device=dev)
    lex = Lexicon({f"w{i}": [f"w{i}"] for i in range(len(words))})
    return Recognizer(am, lex, bucket_frames=128), audio, augment


def _pct(values, q):
    return values[min(len(values) - 1, int(q / 100.0 * len(values)))]


def run(recording: str, minutes: float = 5.0, device="cuda", log=sys.stderr) -> dict:
    """Build the recognizer and stream ``minutes`` of the recording through
    it on ``device``; returns the harness's JSON record."""
    import torch

    from lnasr_tpu_torch.bench import describe_device, time_calls
    from lnasr_tpu_torch.models.recognizer import StreamingRecognizer

    t0 = time.perf_counter()
    rec, audio, augment = build_recognizer(recording, device)
    print(f"# recognizer built in {time.perf_counter() - t0:.1f}s ({len(rec.am.units)} units, "
          f"{rec.graph.n_states if hasattr(rec.graph, 'n_states') else '-'} composed states)",
          file=log)

    latencies, dispatches, buckets = [], [], []
    bucket_samples = rec.bucket_frames * rec.am.mfcc.config.frame_step
    inner = rec._segment_arrays

    def timed(sig, length):
        # the host time of the dispatch only: the one copy back, where the
        # path waits for the device, lands in the rest of the latency
        t = time.perf_counter()
        out = inner(sig, length)
        dispatches.append(time.perf_counter() - t)
        buckets.append(int(sig.shape[0]) // bucket_samples)
        return out

    rec._segment_arrays = timed

    class InstrumentedStream(StreamingRecognizer):
        def _cut_segment(self, start_f, end_f):
            seg = super()._cut_segment(start_f, end_f)
            if seg is not None:
                latencies.append(self.stats.last_latency_s)
            return seg

    stream = InstrumentedStream(rec)
    # warm-up: every plausible bucket count, then a whole pass of the stream
    for k in range(1, 6):
        rec.decode_segment(np.zeros(k * bucket_samples - CHUNK, np.int16))
    for off in range(0, len(audio) - CHUNK, CHUNK):
        stream.process(audio[off: off + CHUNK])
    stream.flush()
    print(f"# warm-up: {len(latencies)} segments", file=log)

    device_ms = {}
    for k in range(1, 6):
        sig = torch.zeros(k * bucket_samples, dtype=torch.float32, device=rec.device)
        n_valid = torch.tensor([k * bucket_samples - CHUNK], device=rec.device)
        times = time_calls(lambda: inner(sig, n_valid), rec.device, TIMING_TRIALS,
                           reps=TIMING_REPS)
        device_ms[k] = round(statistics.median(times) * 1e3, 4)
    print(f"# device time per bucket count: {device_ms} ms", file=log)

    stream.reset()
    latencies.clear()
    dispatches.clear()
    buckets.clear()
    max_buffer = 0
    need_s = minutes * 60.0
    wall0 = time.perf_counter()
    while stream.stats.audio_seconds < need_s:
        loop_audio = augment(audio)  # fresh per pass: no two segments are bit-identical
        for off in range(0, len(loop_audio) - CHUNK, CHUNK):
            stream.process(loop_audio[off: off + CHUNK])
            max_buffer = max(max_buffer, stream.stats.buffer_samples)
    stream.flush()
    wall = time.perf_counter() - wall0

    st = stream.stats
    lat = sorted(latencies)
    out = {
        "metric": "streaming per-segment decode latency (looped recording)",
        "value": round(_pct(lat, 50) * 1000, 3),
        "unit": "ms (p50)",
        "segments": st.segments,
        "audio_seconds": round(st.audio_seconds, 1),
        "latency_ms": {
            "p50": round(_pct(lat, 50) * 1000, 3),
            "p95": round(_pct(lat, 95) * 1000, 3),
            "p99": round(_pct(lat, 99) * 1000, 3),
            "max": round(lat[-1] * 1000, 3),
            "mean": round(statistics.mean(lat) * 1000, 3),
        },
        "rtf": round(st.rtf, 5),
        "wall_rtf": round(wall / st.audio_seconds, 5),
        "max_buffer_samples": int(max_buffer),
        "max_buffer_seconds": round(max_buffer / SR, 3),
        "bucket_frames": rec.bucket_frames,
        "chunk_ms": CHUNK * 1000 // SR,
        "units": len(rec.am.units),
        "device": describe_device(rec.device),
    }
    if dispatches and len(dispatches) == len(latencies):
        disp = sorted(dispatches)
        rest = sorted(lt - d for lt, d in zip(latencies, dispatches))
        beyond = sorted(lt - d - device_ms.get(k, 0.0) / 1e3
                        for lt, d, k in zip(latencies, dispatches, buckets))

        def p(v, q):
            return round(_pct(v, q) * 1000, 3)

        out["decomposition_ms"] = {
            "dispatch": {"p50": p(disp, 50), "p95": p(disp, 95), "p99": p(disp, 99)},
            "host_and_fetch": {"p50": p(rest, 50), "p95": p(rest, 95)},
            "device_by_bucket_count": device_ms,
            "wait_beyond_device": {"p50": p(beyond, 50), "p95": p(beyond, 95)},
            "note": "latency = dispatch (the host time of Recognizer._segment_arrays: "
                    "features and the graph's decode launched) + host_and_fetch (padding, "
                    "the one copy of the path back, the words). device_by_bucket_count is "
                    "the time of one bucketed decode by CUDA events (the host clock on the "
                    "CPU); wait_beyond_device = host_and_fetch minus the matching device "
                    "time.",
        }
    return out


def main(argv=None) -> int:
    from lnasr_tpu_torch.cli import DEVICES

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--recording", required=True, metavar="PATH",
                    help="the speech recording, raw 16 kHz 16-bit PCM")
    ap.add_argument("--minutes", type=float, default=5.0)
    ap.add_argument("--device", choices=DEVICES, default="cuda")
    ap.add_argument("--out", default=None, help="also write the JSON line here")
    args = ap.parse_args(argv)

    out = run(args.recording, args.minutes, args.device)
    line = json.dumps(out)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fp:
            fp.write(line + "\n")
    print(line)
    # the stream must keep up (RTF << 1) and memory must stay bounded
    return 0 if out["rtf"] < 0.5 and out["max_buffer_samples"] < 30 * SR else 1


if __name__ == "__main__":
    sys.exit(main())
