"""Decoder benchmarks, the port of the JAX package's ``bench_decoder.py``.

    python -m lnasr_tpu_torch.bench.decoder [--device cuda] [--vocab 1000] \\
        [--frames 2000] [--n 512] [--t 500] [--out FILE]

Five rows, each printed as one JSON line as it completes:

1. ``factored_1k``: a ``--vocab`` word whole-word graph (3 states a word,
   a dense word hop) decoded through the graph's own route (on CUDA the
   factored forward and backtrace kernels) and through
   ``factored_trellis_scan``, in audio-seconds per second (10 ms frames);
2. ``lattice_1k``: the lattice-recording pass of N-best serving (on CUDA
   the lattice kernel) against ``factored_lattice_scan``;
3. ``dense_kernel``: the dense-graph Viterbi (on CUDA its kernel) against
   the port's ``viterbi_scan`` (on CUDA the trellis kernel's block route,
   the counterpart of the JAX package's jitted scan) at N = ``--n``,
   T = ``--t``: the paths must be bitwise equal, and the row's value is
   the speed-up;
4. ``large_vocab_5k`` and ``large_vocab_10k``: a corpus-trained bigram
   over 5,000 and 10,000 words, three realizations of the same search:
   the backoff-factored hop (rank-1 plus sparse seen bigrams, the exact
   search; on CUDA the factored kernels with its arcs in CSR, beside
   ``factored_trellis_scan``'s time), the rank-1 hop (sparse arcs pruned;
   on CUDA the factored kernels) and, at 5k, the dense (V, V) hop through
   the scan. The backoff and rank-1 routes' paths and scores must be
   bitwise those of ``factored_trellis_scan`` on the same inputs
   (``paths_equal_scan``).

Times are medians after a warm-up: CUDA events on the card, the host
clock on the CPU. An exception in a row is recorded in that row's JSON
(``"error"``) and the run exits 1; an error never becomes a number.
``--out`` also writes the rows as one JSON list.
"""

from __future__ import annotations

import argparse
import json
import sys
import types
from statistics import median

import numpy as np
import torch

from lnasr_tpu_torch.bench import (
    describe_device,
    device_peaks,
    rounded,
    speed_of_light,
    time_calls,
)

FRAME_SECONDS = 0.010
LARGE_VOCABS = (5000, 10000)  # the rows large_vocab_5k (with the dense hop) and _10k
LM_SENTENCES = 8000  # the corpus the large-vocabulary bigram is counted from


def _timed(fn, device, trials: int = 3) -> float:
    return median(time_calls(fn, device, trials))


def _units(vocab: int, rng, dim: int = 8, n_states: int = 3, width: int = 4, cov=0.05):
    """Whole-word left-to-right units ``w{i:0width}``: distinct means, state
    offsets of 0.5, NumPy stand-ins with the GMM-HMM surface."""
    from lnasr_tpu_torch.config import GMMHMMConfig

    cfg = GMMHMMConfig(n_states=n_states, n_mix=1, dim=dim)
    means = rng.normal(scale=30.0, size=(vocab, dim))
    with np.errstate(divide="ignore"):
        log_a = np.log(np.where(np.eye(n_states) + np.eye(n_states, k=1) > 0,
                                0.5, 0.0)).astype(np.float32)
    return {
        f"w{i:0{width}d}": types.SimpleNamespace(
            n=n_states, config=cfg, log_a=log_a,
            log_w=np.zeros((n_states, 1), np.float32),
            mu=(means[i][None, None, :]
                + np.arange(n_states)[:, None, None] * 0.5).astype(np.float32),
            cov=np.full((n_states, 1, dim), cov, np.float32),
        )
        for i in range(vocab)
    }


def _graph(vocab, device, rng, lm=None, hop_mode="auto", width=4, **kw):
    from lnasr_tpu_torch.models.decoder import DecoderConfig, FactoredDecodingGraph
    from lnasr_tpu_torch.models.lexicon import Lexicon

    units = _units(vocab, rng, width=width)
    return FactoredDecodingGraph.build(Lexicon.whole_word(sorted(units)), units, lm,
                                       DecoderConfig(loop=True, lm_scale=1.0), hop_mode=hop_mode,
                                       dtype=torch.float32, device=device, **kw)


def _frames(rng, n_frames, device, dim=8):
    return torch.as_tensor(rng.normal(scale=30.0, size=(n_frames, dim)).astype(np.float32),
                           device=device)


def _route(device) -> str:
    return "cuda kernels" if torch.device(device).type == "cuda" else "plain (cpu)"


def _forward_work(vocab: int, s: int, n_frames: int):
    """Operations and bytes of one forward over a (V, S) grid with a dense
    hop: the hop's add and max, the within-word max-plus, the exits and
    the emission add a frame; the graph and emissions in, the grids out."""
    ops = n_frames * (2 * vocab * vocab + 2 * vocab * s * s + 2 * vocab + vocab * s)
    n_bytes = 4 * (vocab * vocab + vocab * s * s + n_frames * vocab * s * 2)
    return ops, n_bytes


def bench_factored_decode(vocab: int, n_frames: int, device) -> dict:
    from lnasr_tpu_torch.models.decoder import factored_trellis_scan

    rng = np.random.default_rng(0)
    graph = _graph(vocab, device, rng)
    frames = _frames(rng, n_frames, device)
    graph.decode(frames)  # sanity: the full decode with words once
    args = graph._grid_inputs(frames)
    t_route = _timed(lambda: graph._decode_grid(*args, None), device)
    path_r, score_r = graph._decode_grid(*args, None)
    scan = lambda: factored_trellis_scan(args[0], graph.inner_a, graph.hop, args[1],  # noqa: E731
                                         args[2], graph.exit_idx)
    t_scan = _timed(scan, device, trials=1)
    path_s, score_s = scan()
    v, s = graph.grid_shape
    return {
        "metric": f"composed-graph decode throughput ({vocab}-word lexicon, "
                  f"{graph.n_states} states)",
        "value": round(n_frames * FRAME_SECONDS / t_route, 2),
        "unit": "audio-seconds/s",
        "frames": n_frames,
        "route": _route(device),
        "decode_seconds": round(t_route, 6),
        "scan_decode_seconds": round(t_scan, 6),
        "paths_equal_scan": bool(torch.equal(path_r.cpu(), path_s.cpu())
                                 and float(score_r) == float(score_s)),
        "bound": rounded(speed_of_light(*_forward_work(v, s, n_frames), t_route,
                                        device_peaks(device))),
        "device": describe_device(device),
    }


def bench_lattice(vocab: int, n_frames: int, device) -> dict:
    """Lattice-recording pass (N-best serving): the graph's route against
    the scan, records equal."""
    from lnasr_tpu_torch.ops.factored import factored_lattice_scan

    rng = np.random.default_rng(0)
    graph = _graph(vocab, device, rng)
    frames = _frames(rng, n_frames, device)
    graph.decode_lattice(frames, beam=20.0)  # end-to-end sanity
    log_b, pi_grid, _ = graph._grid_inputs(frames)
    t_route = _timed(lambda: graph._lattice_grid(log_b, pi_grid, None), device)
    scan = lambda: factored_lattice_scan(log_b, graph.inner_a, graph.hop, pi_grid,  # noqa: E731
                                         graph.exit_idx)[:3]
    t_scan = _timed(scan, device, trials=1)
    got, ref = graph._lattice_grid(log_b, pi_grid, None), scan()
    v, s = graph.grid_shape
    ops, n_bytes = _forward_work(v, s, n_frames)
    return {
        "metric": f"lattice-recording pass for N-best serving ({vocab}-word lexicon)",
        "value": round(n_frames * FRAME_SECONDS / t_route, 2),
        "unit": "audio-seconds/s",
        "frames": n_frames,
        "route": _route(device),
        "records_seconds": round(t_route, 6),
        "scan_seconds": round(t_scan, 6),
        "records_equal_scan": all(torch.equal(a.cpu(), b.cpu()) for a, b in zip(got, ref)),
        "bound": rounded(speed_of_light(ops, n_bytes - 4 * n_frames * v * s + 12 * n_frames * v,
                                        t_route, device_peaks(device))),
        "device": describe_device(device),
    }


def bench_dense_kernel(n: int, t_len: int, device) -> dict:
    from lnasr_tpu_torch.ops.trellis import viterbi_scan
    from lnasr_tpu_torch.ops.viterbi_dense import viterbi_dense

    rng = np.random.default_rng(1)
    as_t = lambda x: torch.as_tensor(x.astype(np.float32), device=device)  # noqa: E731
    log_a = as_t(np.log(rng.dirichlet(np.ones(n), size=n)))
    log_pi = as_t(np.log(rng.dirichlet(np.ones(n))))
    log_b = as_t(rng.normal(size=(t_len, n)))
    res = viterbi_scan(log_pi, log_a, log_b)
    t_scan = _timed(lambda: viterbi_scan(log_pi, log_a, log_b), device, trials=1)
    path, score = viterbi_dense(log_pi, log_a, log_b)
    t_kern = _timed(lambda: viterbi_dense(log_pi, log_a, log_b), device, trials=5)
    identical = bool(torch.equal(path.cpu(), res.path.cpu())
                     and float(score) == float(res.score))
    return {
        "metric": f"dense-graph Viterbi vs viterbi_scan (N={n}, T={t_len})",
        "value": round(t_scan / t_kern, 2),
        "unit": "x speedup over scan",
        "route": "cuda kernel" if torch.device(device).type == "cuda" else "plain (cpu)",
        "scan_seconds": round(t_scan, 6),
        "kernel_seconds": round(t_kern, 6),
        "paths_bit_identical": identical,
        # an add and a max per (frame, target, source); the graph and the
        # emissions in, the path out
        "bound": rounded(speed_of_light(2.0 * t_len * n * n, 4 * (n * n + t_len * n + t_len),
                                        t_kern, device_peaks(device))),
        "device": describe_device(device),
    }


def bench_large_vocab(vocab: int, n_frames: int, device, max_in_degree: int = 256,
                      with_dense: bool = True) -> dict:
    """The large-vocabulary regime, three realizations of the same search at
    ``vocab`` words, LM-weighted with a corpus-trained bigram: ``backoff``
    (exact Katz search over rank-1 + sparse seen bigrams: on CUDA the
    factored kernels, beside the scan), ``rank1`` (word-loop pruning: the
    sparse arcs dropped; on CUDA the factored kernels) and ``dense`` (the
    (V, V) matrix through the scan: V^2 floats a frame, the number that
    shows why the factors exist)."""
    from lnasr_tpu_torch.bench.corpus import make_corpus
    from lnasr_tpu_torch.config import NGramConfig
    from lnasr_tpu_torch.models.decoder import factored_trellis_scan
    from lnasr_tpu_torch.models.ngram import NGramCounter, NGramModel

    rng = np.random.default_rng(0)
    sents = make_corpus(LM_SENTENCES, vocab, np.random.default_rng(1))
    lm = NGramModel(NGramCounter(2, sents), NGramConfig(order=2))
    audio_s = n_frames * FRAME_SECONDS
    rows = {}

    def guarded(name, fn):
        # one faulting realization must not discard the others' rows
        try:
            rows[name] = fn()
        except Exception as e:  # noqa: BLE001 - recorded in the row
            rows[name] = {"error": f"{type(e).__name__}: {e}"}

    g_bo = _graph(vocab, device, rng, lm, hop_mode="backoff", width=5,
                  hop_max_in_degree=max_in_degree)
    frames = _frames(rng, n_frames, device)
    k = int(g_bo.hop.pred.shape[1])

    def run_backoff():
        args = g_bo._grid_inputs(frames)
        t = _timed(lambda: g_bo._decode_grid(*args, None), device)
        path_r, score_r = g_bo._decode_grid(*args, None)
        scan = lambda: factored_trellis_scan(args[0], g_bo.inner_a, g_bo.hop, args[1],  # noqa: E731
                                             args[2], g_bo.exit_idx)
        t_scan = _timed(scan, device, trials=1)
        path_s, score_s = scan()
        v, s = g_bo.grid_shape
        nnz = len(g_bo._kernel_hop.arc_src)
        ops = n_frames * (2 * v * s * s + 10 * v + 2 * nnz)
        return {"seconds": round(t, 4), "audio_s_per_s": round(audio_s / t, 1),
                "route": _route(device), "k_max_in_degree": k, "arcs": nnz,
                "clamped_arcs": g_bo.hop_clamped,
                "scan_seconds": round(t_scan, 4),
                "paths_equal_scan": bool(torch.equal(path_r.cpu(), path_s.cpu())
                                         and float(score_r) == float(score_s)),
                "bound": rounded(speed_of_light(
                    ops, 4 * (v * s * s + 2 * n_frames * v * s) + 12 * nnz, t,
                    device_peaks(device))),
                "measured_us_per_step": round(t / n_frames * 1e6, 2)}

    guarded("backoff", run_backoff)
    g_r1 = _graph(vocab, device, np.random.default_rng(0), lm, hop_mode="rank1", width=5)

    def run_rank1():
        args = g_r1._grid_inputs(frames)
        t = _timed(lambda: g_r1._decode_grid(*args, None), device)
        path_r, score_r = g_r1._decode_grid(*args, None)
        path_s, score_s = factored_trellis_scan(args[0], g_r1.inner_a, g_r1.hop, args[1],
                                                args[2], g_r1.exit_idx)
        v, s = g_r1.grid_shape
        ops = n_frames * (2 * v * s * s + 10 * v)
        return {"seconds": round(t, 4), "audio_s_per_s": round(audio_s / t, 1),
                "route": _route(device), "pruned_arcs": g_r1.hop_pruned_edges,
                "paths_equal_scan": bool(torch.equal(path_r.cpu(), path_s.cpu())
                                         and float(score_r) == float(score_s)),
                "bound": rounded(speed_of_light(ops, 4 * (v * s * s + 2 * n_frames * v * s), t,
                                                device_peaks(device))),
                "measured_us_per_step": round(t / n_frames * 1e6, 2)}

    guarded("rank1", run_rank1)

    def run_hyps():
        w_bo, _, _ = g_bo.decode(frames)
        w_r1, _, _ = g_r1.decode(frames)
        return {"backoff": len(w_bo), "rank1": len(w_r1)}

    guarded("hyp_lengths", run_hyps)

    if with_dense:
        def run_dense():
            g_d = _graph(vocab, device, np.random.default_rng(0), lm, hop_mode="dense", width=5)
            args = g_d._grid_inputs(frames)
            t = _timed(lambda: factored_trellis_scan(args[0], g_d.inner_a, g_d.hop, args[1],
                                                     args[2], g_d.exit_idx), device, trials=1)
            v = g_d.grid_shape[0]
            return {"seconds": round(t, 4), "audio_s_per_s": round(audio_s / t, 1),
                    "route": "scan",
                    "bound": rounded(speed_of_light(2.0 * n_frames * v * v, 4.0 * n_frames * v * v,
                                                    t, device_peaks(device))),
                    "note": "the scan reads the (V, V) hop every frame"}

        guarded("dense_scan", run_dense)

    return {
        "metric": f"large-vocabulary decode ({vocab} words, LM-weighted)",
        "value": rows["backoff"].get("audio_s_per_s"),
        "unit": "audio-seconds/s (exact backoff search)",
        "frames": n_frames,
        "device": describe_device(device),
        "realizations": rows,
    }


def main(argv=None) -> int:
    from lnasr_tpu_torch._device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--vocab", type=int, default=1000)
    ap.add_argument("--frames", type=int, default=2000)
    ap.add_argument("--n", type=int, default=512)
    ap.add_argument("--t", type=int, default=500)
    ap.add_argument("--out", default=None, help="also write the rows to this file")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    benches = [
        ("factored_1k", lambda: bench_factored_decode(args.vocab, args.frames, device)),
        ("lattice_1k", lambda: bench_lattice(args.vocab, args.frames, device)),
        ("dense_kernel", lambda: bench_dense_kernel(args.n, args.t, device)),
        ("large_vocab_5k", lambda: bench_large_vocab(LARGE_VOCABS[0], args.t, device)),
        ("large_vocab_10k",
         lambda: bench_large_vocab(LARGE_VOCABS[1], args.t, device, with_dense=False)),
    ]
    rows = []
    failed = False
    for name, fn in benches:
        # print as each row completes; a failed row is recorded, not dropped
        try:
            r = {"row": name} | fn()
        except Exception as e:  # noqa: BLE001 - recorded in the row
            r = {"row": name, "metric": name, "error": f"{type(e).__name__}: {e}"}
            failed = True
        failed = failed or any("error" in x for x in r.get("realizations", {}).values())
        rows.append(r)
        print(json.dumps(r), flush=True)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fp:
            json.dump(rows, fp, indent=2)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
