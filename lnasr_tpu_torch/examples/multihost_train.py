"""Multi-process data-parallel Baum-Welch launcher on ``torch.distributed``.

Run the SAME command on every host, one process per rank:

    python -m lnasr_tpu_torch.examples.multihost_train \\
        --coordinator HOST0:8765 --num-processes 2 --process-id $I

``--coordinator HOST:PORT`` becomes the rendezvous ``tcp://HOST:PORT``,
``--num-processes`` the world size and ``--process-id`` the rank. With no
flags it runs a world of one on the card (NCCL, by the backend rule of
``parallel.distributed.initialize``); ``--fake-devices N`` runs N gloo
ranks on the CPU through ``parallel.distributed.run_ranks``, the
single-machine demo. The port of the JAX package's
``examples/multihost_train.py``.

Flow — the production shape of the data-parallel training path:

1. ``parallel.distributed.initialize`` joins the processes into one world
   (NCCL when every rank has a card of its own, gloo otherwise);
2. each process builds ONLY its ``process_local_slice`` of the global
   batch (hosts never load each other's audio; here the rows are
   synthesized deterministically from their global index);
3. rank 0's initial parameters are broadcast, so every rank starts from
   the same model, and ``make_dp_gmmhmm_em_step`` runs with parameters
   replicated and the statistics summed across the ``data`` axis. The
   log-likelihood must not fall from one sweep to the next.
"""

from __future__ import annotations

import argparse
import socket
import sys
from typing import List

import numpy as np
import torch


def _rows(lo: int, hi: int, frames: int, dim: int) -> np.ndarray:
    """Rows ``[lo, hi)`` of the global batch, each from its own seed (so a
    process synthesizes only its rows)."""
    t = np.sin(np.arange(frames))[:, None]
    return np.stack([np.random.default_rng([0, i]).normal(size=(frames, dim)) + t
                     for i in range(lo, hi)]).astype(np.float32)


def _say(line: str) -> None:
    """Print ``line`` in one write: the ranks share the launcher's output,
    and ``print`` writes the text and the newline separately (two writes
    where the stream is unbuffered, as under ``PYTHONUNBUFFERED``), so
    another rank's line could land between them."""
    sys.stdout.write(line + "\n")
    sys.stdout.flush()


def train(global_batch: int, frames: int, iters: int) -> List[float]:
    """The data-parallel EM loop on the world this process joined; returns
    the log-likelihood history (equal on every rank)."""
    import torch.distributed as dist

    from lnasr_tpu_torch.config import GMMHMMConfig
    from lnasr_tpu_torch.models.gmmhmm import GMMHMM
    from lnasr_tpu_torch.parallel import make_dp_gmmhmm_em_step, make_mesh, mesh_shape_for
    from lnasr_tpu_torch.parallel.distributed import local_device, process_local_slice

    world, rank = dist.get_world_size(), dist.get_rank()
    dev = local_device()
    _say(f"process {rank}/{world}: {dist.get_backend()} on {dev}")
    cfg = GMMHMMConfig(n_states=5, n_mix=4, dim=13)
    mesh = make_mesh(mesh_shape_for(world, data=world))
    lo, hi = process_local_slice(global_batch)
    local = torch.as_tensor(_rows(lo, hi, frames, cfg.dim), device=dev)
    mask = torch.ones(local.shape[:2], dtype=torch.bool, device=dev)

    model = GMMHMM(cfg, device=dev).init_from_data(local.reshape(-1, cfg.dim),
                                                   torch.Generator().manual_seed(0))
    params = model.params
    for x in params:  # every rank starts from rank 0's model
        dist.broadcast(x, src=0)
    step = make_dp_gmmhmm_em_step(mesh, cfg)
    history: List[float] = []
    for it in range(iters):
        params, loglik = step(params, local, mask)
        loglik = float(loglik)
        if rank == 0:
            _say(f"iter {it}: loglik {loglik:.2f}")
        if not np.isfinite(loglik):
            raise RuntimeError(f"iteration {it}: loglik {loglik} is not finite")
        if history and loglik < history[-1] - max(1e-3, 1e-6 * abs(history[-1])):
            raise RuntimeError(f"EM regressed: {history[-1]} -> {loglik}")
        history.append(loglik)
    model.set_params(params)
    if rank == 0:
        _say("done: multi-process DP EM converging")
    return history


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--coordinator", default=None, help="HOST:PORT of process 0")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument("--fake-devices", type=int, default=0,
                    help="run this many gloo ranks on the CPU (a single-machine demo)")
    ap.add_argument("--global-batch", type=int, default=32)
    ap.add_argument("--frames", type=int, default=200)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where each rank runs (--fake-devices always runs on the CPU)")
    args = ap.parse_args(argv)

    import torch.distributed as dist

    from lnasr_tpu_torch.examples import multihost_train  # train by its importable name
    from lnasr_tpu_torch.parallel.distributed import initialize, run_ranks

    if args.fake_devices:
        histories = run_ranks(multihost_train.train, args.fake_devices,
                              args=(args.global_batch, args.frames, args.iters), device="cpu")
        if any(h != histories[0] for h in histories):
            raise RuntimeError(f"the ranks' logliks differ: {histories}")
        return 0
    if args.coordinator:
        init = f"tcp://{args.coordinator}"
        world, rank = args.num_processes, args.process_id
        if world is None or rank is None:
            ap.error("--coordinator needs --num-processes and --process-id")
    else:
        init, world, rank = f"tcp://localhost:{_free_port()}", 1, 0
    initialize(init, world, rank, device=args.device)
    try:
        train(args.global_batch, args.frames, args.iters)
    finally:
        dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())
