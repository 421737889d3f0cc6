"""Scaling benchmark of the multi-rank paths, the port of the JAX package's
``bench_scaling.py``.

    python -m lnasr_tpu_torch.bench.scaling [--devices 1,2,4,8] [--batch 8] \\
        [--t 200] [--steps 5] [--device cpu] [--out FILE]

For each rank count n a world of n ranks is spawned
(``parallel.distributed.run_ranks``; gloo CPU ranks by default, CUDA ranks
with ``--device cuda``, NCCL only when every rank has a card), and every
rank runs:

- data-parallel EM on the 5 x 8 x 39 diagonal GMM-HMM with a FIXED
  per-rank batch (weak scaling: the ideal step time is constant), with the
  collective payload counted exactly from the summed statistics (the
  ``psum`` buffer: O(N^2 + N M D) values, independent of batch size and
  sequence length) and as the collectives moved it;
- model-parallel EM, the same model with its mixture axis over n ranks
  and a fixed batch (strong scaling), where n divides the mixture count;
- the sharded batch decode (``parallel.make_dp_decode_step``) of a
  100-word factored graph, a fixed number of segments a rank.

Ranks that share the host's cores, or one card, measure the sharding and
collective overhead, not the hardware's scaling; the output says which.
JSON lines go to stdout, the whole report to ``--out`` only when given.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import types

import numpy as np
import torch

from lnasr_tpu_torch.bench import DIM, N_MIX, N_STATES, synchronize

DECODE_VOCAB = 100


def _timed_steps(fn, steps: int, dev):
    """(wall seconds, process CPU seconds) per call of ``fn`` after one
    warm-up call."""
    fn()
    synchronize(dev)
    c0, t0 = time.process_time(), time.perf_counter()
    for _ in range(steps):
        fn()
    synchronize(dev)
    return (time.perf_counter() - t0) / steps, (time.process_time() - c0) / steps


def _payload_bytes(stats: dict) -> int:
    return sum(v.numel() * v.element_size() for v in stats.values())


def _decode_graph(dev):
    from lnasr_tpu_torch.config import GMMHMMConfig
    from lnasr_tpu_torch.models.decoder import DecoderConfig, FactoredDecodingGraph
    from lnasr_tpu_torch.models.lexicon import Lexicon

    rng = np.random.default_rng(2)
    v, dim, n_states = DECODE_VOCAB, 8, 3
    cfg = GMMHMMConfig(n_states=n_states, n_mix=1, dim=dim)
    means = rng.normal(scale=20.0, size=(v, dim))
    with np.errstate(divide="ignore"):
        log_a = np.log(np.where(np.eye(n_states) + np.eye(n_states, k=1) > 0,
                                0.5, 0.0)).astype(np.float32)
    units = {
        f"w{i:03d}": types.SimpleNamespace(
            n=n_states, config=cfg, log_a=log_a, log_w=np.zeros((n_states, 1), np.float32),
            mu=(means[i][None, None, :]
                + rng.normal(scale=0.3, size=(n_states, 1, dim))).astype(np.float32),
            cov=np.full((n_states, 1, dim), 0.1, np.float32))
        for i in range(v)
    }
    return FactoredDecodingGraph.build(Lexicon.whole_word(sorted(units)), units, None,
                                       DecoderConfig(loop=True), dtype=torch.float32, device=dev)


def scaling_rank(per_rank_batch: int, t_frames: int, steps: int) -> dict:
    """One rank's measurements (run under ``run_ranks``): every rank builds
    the same global inputs from the same seeds and takes its rows."""
    import torch.distributed as dist

    from lnasr_tpu_torch import parallel as P
    from lnasr_tpu_torch.config import GMMHMMConfig, MeshConfig
    from lnasr_tpu_torch.models.gmmhmm import GMMHMM
    from lnasr_tpu_torch.parallel import distributed as D
    from lnasr_tpu_torch.parallel.mesh import local_rows, mesh_axis
    from lnasr_tpu_torch.parallel.training import _gmm_linear_stats

    n = dist.get_world_size()
    dev = D.local_device()
    cfg = GMMHMMConfig(n_states=N_STATES, n_mix=N_MIX, dim=DIM)
    out = {"rank": dist.get_rank(), "backend": dist.get_backend(), "device": str(dev)}

    # data-parallel EM, weak scaling
    mesh = P.make_mesh(P.mesh_shape_for(n, data=n))
    data = mesh_axis(mesh, "data")
    rng = np.random.default_rng(0)
    obs = torch.as_tensor(rng.normal(size=(n * per_rank_batch, t_frames, DIM))
                          .astype(np.float32))
    model = GMMHMM(cfg, device=dev).init_from_data(obs.reshape(-1, DIM),
                                                   torch.Generator().manual_seed(0))
    local = local_rows(obs, data).to(dev)
    mask = torch.ones(local.shape[:2], dtype=torch.bool, device=dev)
    step = P.make_dp_gmmhmm_em_step(mesh, cfg)
    carried = [model.params]

    def dp():
        carried[0], loglik = step(carried[0], local, mask)
        out["dp_loglik"] = float(loglik)

    D.STATS.reset()
    out["dp_step_s"], out["dp_cpu_s"] = _timed_steps(dp, steps, dev)
    out["dp_collective_bytes_per_step"] = D.STATS.bytes // (steps + 1)
    out["dp_collectives_per_step"] = D.STATS.calls / (steps + 1)
    out["psum_payload_bytes"] = _payload_bytes(
        _gmm_linear_stats(model.params, local, mask, cfg.cov_type))

    # model-parallel EM, strong scaling over the mixture axis
    if N_MIX % n == 0:
        mp_mesh = P.make_mesh(MeshConfig(1, 1, n))
        mp_obs = torch.as_tensor(np.random.default_rng(1).normal(
            size=(per_rank_batch, t_frames, DIM)).astype(np.float32))
        mp_model = GMMHMM(cfg, device=dev).init_from_data(mp_obs.reshape(-1, DIM),
                                                          torch.Generator().manual_seed(0))
        mp_params = [P.mp_param_specs().local(mp_model.params, mp_mesh)]
        mp_step = P.make_mp_gmmhmm_em_step(mp_mesh, cfg)
        mp_obs = mp_obs.to(dev)
        mp_mask = torch.ones(mp_obs.shape[:2], dtype=torch.bool, device=dev)

        def mp():
            mp_params[0] = mp_step(mp_params[0], mp_obs, mp_mask)[0]

        D.STATS.reset()
        out["mp_step_s"], _ = _timed_steps(mp, steps, dev)
        out["mp_collectives_per_step"] = D.STATS.calls / (steps + 1)
        out["mp_collective_bytes_per_step"] = D.STATS.bytes // (steps + 1)

    # the sharded batch decode, weak scaling
    graph = _decode_graph(dev)
    feats = torch.as_tensor(np.random.default_rng(3).normal(
        scale=20.0, size=(n * per_rank_batch, t_frames, 8)).astype(np.float32))
    d_step = P.make_dp_decode_step(mesh, graph)
    d_obs = local_rows(feats, data).to(dev)
    d_mask = torch.ones(d_obs.shape[:2], dtype=torch.bool, device=dev)
    out["decode_step_s"], out["decode_cpu_s"] = _timed_steps(lambda: d_step(d_obs, d_mask),
                                                             steps, dev)
    return out


def run(device_counts, per_rank_batch: int, t_frames: int, steps: int, device: str):
    from lnasr_tpu_torch.bench import scaling  # the rank function by its importable name
    from lnasr_tpu_torch.parallel.distributed import run_ranks

    cores = os.cpu_count() or 1
    cards = torch.cuda.device_count() if device == "cuda" else 0
    rows, mp_rows, decode_rows = [], [], []
    t1 = cpu1 = mp_t1 = mp_n1 = d_t1 = d_cpu1 = None
    for n in device_counts:
        ranks = run_ranks(scaling.scaling_rank, n, args=(per_rank_batch, t_frames, steps),
                          device=device)
        slowest = max(ranks, key=lambda r: r["dp_step_s"])
        dt, cpu_dt = slowest["dp_step_s"], max(r["dp_cpu_s"] for r in ranks)
        if t1 is None:
            t1, cpu1 = dt, cpu_dt
        # the host ceiling: n ranks share `cores` cores (or one card), so
        # the ideal weak-scaling step is the n ranks' compute spread over
        # the cores: t_ideal(n) = max(t(1), n cpu(1) / cores)
        t_ideal = max(t1, n * cpu1 / cores)
        payload = ranks[0]["psum_payload_bytes"]
        rows.append({
            "devices": n, "backend": ranks[0]["backend"], "rank_device": ranks[0]["device"],
            "per_device_batch": per_rank_batch, "frames": t_frames,
            "step_seconds": round(dt, 6), "cpu_seconds_per_step": round(cpu_dt, 6),
            "utterances_per_s": round(n * per_rank_batch / dt, 2),
            "weak_scaling_efficiency": round(t1 / dt, 3),
            "host_ceiling_step_seconds": round(t_ideal, 6),
            "ceiling_relative_efficiency": round(min(1.0, t_ideal / dt), 3),
            "speedup_vs_serial": round(n * t1 / dt, 3),
            "psum_payload_bytes_per_device": payload,
            "collective_bytes_per_step": ranks[0]["dp_collective_bytes_per_step"],
            # ring all-reduce moves 2(n-1)/n of the payload per device
            "ring_allreduce_bytes_per_device": int(2 * (n - 1) / n * payload),
            "losses_equal_across_ranks": len({r["dp_loglik"] for r in ranks}) == 1,
        })
        print(json.dumps(rows[-1]), flush=True)
        if "mp_step_s" in ranks[0]:
            mp_dt = max(r["mp_step_s"] for r in ranks)
            if mp_t1 is None:
                mp_t1, mp_n1 = mp_dt, n
            mp_rows.append({
                "model_axis": n, "components_per_device": N_MIX // n,
                "step_seconds": round(mp_dt, 6),
                # strong scaling: total work fixed, ideal t(n) = t(n1) n1 / n
                "strong_scaling_efficiency": round(mp_n1 * mp_t1 / (n * mp_dt), 3),
                "collectives_per_step": ranks[0]["mp_collectives_per_step"],
                "collective_bytes_per_step": ranks[0]["mp_collective_bytes_per_step"],
                "model_collective_floats_per_seq": t_frames * N_STATES,
            })
            print(json.dumps(mp_rows[-1]), flush=True)
        d_dt = max(r["decode_step_s"] for r in ranks)
        d_cpu = max(r["decode_cpu_s"] for r in ranks)
        if d_t1 is None:
            d_t1, d_cpu1 = d_dt, d_cpu
        d_ideal = max(d_t1, n * d_cpu1 / cores)
        decode_rows.append({
            "devices": n, "per_device_batch": per_rank_batch, "vocab": DECODE_VOCAB,
            "step_seconds": round(d_dt, 6), "cpu_seconds_per_step": round(d_cpu, 6),
            "segments_per_s": round(n * per_rank_batch / d_dt, 2),
            "weak_scaling_efficiency": round(d_t1 / d_dt, 3),
            "host_ceiling_step_seconds": round(d_ideal, 6),
            "ceiling_relative_efficiency": round(min(1.0, d_ideal / d_dt), 3),
        })
        print(json.dumps(decode_rows[-1]), flush=True)

    max_n = max(device_counts)
    shared = (f"{max_n} ranks share {max(cards, 1)} card(s)" if device == "cuda"
              else f"{max_n} ranks share {cores} host cores")
    note = (f"{shared}: where ranks share a card or the host's cores this measures the "
            "sharding and collective overhead, not hardware scaling; the collective payload "
            "is independent of batch and sequence length")
    if mp_rows:
        mp_rows.append({"note": "strong scaling of the 5x8x39 model's 8 components is "
                                "collective-bound by construction (little compute to shard); "
                                "the rows give the mixture-sharded step's overhead"})
    decode_rows.append({"note": note})
    summary = {
        "metric": f"dp-em weak-scaling efficiency ({'card' if device == 'cuda' else 'cpu'} ranks)",
        "value": rows[-1]["weak_scaling_efficiency"],
        "unit": f"t(1)/t({max_n}) at fixed per-rank batch",
        "devices": list(device_counts),
        "utterances_per_s": [r["utterances_per_s"] for r in rows],
        "psum_payload_bytes_per_device": rows[-1]["psum_payload_bytes_per_device"],
        "overhead_not_scaling": device != "cuda" or max_n > cards,
        "note": note,
    }
    print(json.dumps(summary), flush=True)
    return rows, summary, mp_rows, decode_rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", default="1,2,4,8", help="rank counts, comma-separated")
    ap.add_argument("--batch", type=int, default=8, help="utterances per rank")
    ap.add_argument("--t", type=int, default=200, help="frames per utterance")
    ap.add_argument("--steps", type=int, default=5, help="timed steps")
    ap.add_argument("--device", choices=["cpu", "cuda"], default="cpu",
                    help="gloo CPU ranks (default) or CUDA ranks")
    ap.add_argument("--out", default=None, help="also write the report to this file")
    args = ap.parse_args(argv)
    counts = [int(x) for x in args.devices.split(",")]
    rows, summary, mp_rows, decode_rows = run(counts, args.batch, args.t, args.steps,
                                              args.device)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as fp:
            json.dump({"rows": rows, "summary": summary, "model_parallel_rows": mp_rows,
                       "dp_decode_rows": decode_rows}, fp, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
