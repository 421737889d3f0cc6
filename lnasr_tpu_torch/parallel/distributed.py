"""Process groups, the rank launcher and the collectives of ``parallel/``.

The JAX package runs one controller over a device mesh; this package
runs one process per rank (SPMD) on ``torch.distributed``:

- :func:`initialize` joins the calling process to a world and picks the
  backend by rule: NCCL when every rank has a card of its own, gloo on
  the CPU and when several ranks share one card (NCCL refuses two ranks
  on one device). A rank asked for CUDA on a machine without it raises
  (:func:`~lnasr_tpu_torch._device.resolve_device`); nothing moves to the
  CPU quietly.
- :func:`run_ranks` spawns a world (``spawn`` start method: CUDA cannot
  be forked), runs one function on every rank and returns each rank's
  result; a rank's exception is raised again in the caller with its rank.
- :func:`psum`, :func:`pmax`, :func:`all_gather` and :func:`ppermute`
  are the four collectives the JAX code uses, over one named axis of a
  mesh (:class:`Axis`). All four are ``all_reduce`` calls, the one
  collective every backend takes on both CPU and CUDA tensors (gloo
  moves other collectives of CUDA tensors through the host, or has
  none). ``all_gather`` and ``ppermute`` sum a zero-filled ``(S, ...)``
  buffer in which each rank writes only its own slot, with the values'
  bits reinterpreted as integers of their width: an integer sum with
  zeros is exact for every bit pattern (``-inf``, ``-0.0`` and int32
  paths included), so a gathered tensor is bitwise each rank's. The
  payloads are one ``(N, N)`` product, one ``(chunk, N)`` block or one
  batch of paths, so the S-fold volume costs little.

:data:`STATS` counts the collectives' calls, bytes and host seconds.
"""

from __future__ import annotations

import dataclasses
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List, NamedTuple, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from lnasr_tpu_torch._device import resolve_device

_device: Optional[torch.device] = None  # this process's device, set by initialize()


def choose_backend(device_type: str, n_cards: int, world_size: int) -> str:
    """The backend rule: NCCL when the ranks are on CUDA and every rank
    has a card of its own, gloo otherwise."""
    return "nccl" if device_type == "cuda" and n_cards >= world_size else "gloo"


def initialize(init_method: str, world_size: int, rank: int, device="cuda",
               backend: Optional[str] = None) -> str:
    """Join this process to a world of ``world_size`` ranks as ``rank``
    (``init_method`` as ``torch.distributed.init_process_group`` takes it,
    e.g. ``file:///path`` or ``tcp://localhost:<port>``) and return the
    backend. ``backend=None`` picks it by :func:`choose_backend`;
    ``"nccl"`` without a card for every rank raises. On CUDA, rank r uses
    card ``r % device_count()``. Idempotent: a second call returns the
    backend of the world already joined."""
    global _device
    if dist.is_initialized():
        return dist.get_backend()
    dev = resolve_device(device)
    n_cards = torch.cuda.device_count() if dev.type == "cuda" else 0
    rule = choose_backend(dev.type, n_cards, world_size)
    if backend is None:
        backend = rule
    elif backend == "nccl" and rule != "nccl":
        raise ValueError(f"backend 'nccl' needs a CUDA card for each of the {world_size} "
                         f"ranks; {n_cards} found on {dev.type}")
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % n_cards)
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, init_method=init_method, world_size=world_size, rank=rank)
    _device = dev
    return backend


def local_device() -> torch.device:
    """This rank's device, as :func:`initialize` set it. Raises in a process
    that joined no world through :func:`initialize`: the device is not
    guessed."""
    if _device is None:
        raise RuntimeError("no device for this rank: join the world through "
                           "parallel.distributed.initialize (or run under run_ranks)")
    return _device


def process_local_slice(global_batch: int) -> Tuple[int, int]:
    """Host data loading: the ``[start, stop)`` rows of a global batch this
    rank reads (the whole batch outside a world)."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if global_batch % world:
        raise ValueError(f"global batch {global_batch} not divisible by {world} processes")
    per = global_batch // world
    return per * rank, per * (rank + 1)


# -- the launcher ---------------------------------------------------------------


class RankError(RuntimeError):
    """A rank of a :func:`run_ranks` world failed; ``rank`` says which."""

    def __init__(self, rank: int, message: str):
        super().__init__(f"rank {rank}: {message}")
        self.rank = rank


def _rank_main(rank, world_size, init_method, device, backend, fn, args, results):
    try:
        torch.set_num_threads(1)  # the ranks share the host's cores
        initialize(init_method, world_size, rank, device=device, backend=backend)
        # no rank runs fn, and may tear the group down, before every rank has
        # joined: a gloo rank still connecting would see its peer's sockets
        # close ("Connection closed by peer") and fail its own initialize
        dist.barrier()
        results.put((rank, True, fn(*args)))
    except BaseException:  # reported to the parent, which raises it
        results.put((rank, False, traceback.format_exc()))
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn: Callable, world_size: int, args: Sequence = (), device="cuda",
              backend: Optional[str] = None, timeout: float = 900.0) -> List[Any]:
    """Spawn ``world_size`` ranks on ``device``, each of which
    :func:`initialize` s (``file://`` rendezvous in a temporary directory)
    and returns ``fn(*args)``; returns the results in rank order.
    ``device="cuda"`` without a card raises here, before any rank starts.
    ``fn`` and ``args`` are pickled, so ``fn`` must be importable (a
    module-level function of a package or of the ``__main__`` script), and
    so must each result. A rank that raises or dies, or that gave its
    result and then exited with a nonzero code, makes this raise
    :class:`RankError` with its rank (and traceback), after the other ranks
    are stopped. A rank that exited with code 0 has put its result, which
    is waited for until ``timeout`` however late it reaches this process."""
    resolve_device(device)
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory() as tmp:
        init = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(r, world_size, init, device, backend, fn, args, results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        done = {}
        deadline = time.monotonic() + timeout
        try:
            while len(done) < world_size:
                try:
                    rank, ok, payload = results.get(timeout=0.5)
                except queue.Empty:
                    # a rank puts its result and then exits: one that exited
                    # with code 0 has put it (the queue's feeder thread is
                    # flushed at exit), so it is waited for until the deadline;
                    # one that exited nonzero may have died before its put
                    failed = [r for r, p in enumerate(procs)
                              if r not in done and p.exitcode not in (None, 0)]
                    if failed:
                        try:
                            rank, ok, payload = results.get(timeout=1.0)
                        except queue.Empty:
                            raise RankError(failed[0], f"exited with code "
                                            f"{procs[failed[0]].exitcode} and no result") from None
                    elif time.monotonic() > deadline:
                        raise RankError(min(set(range(world_size)) - set(done)),
                                        f"no result within {timeout} s")
                    else:
                        continue
                if not ok:
                    raise RankError(rank, "raised\n" + payload)
                done[rank] = payload
            for p in procs:
                p.join(timeout=60)
            for r, p in enumerate(procs):
                if p.exitcode not in (0, None):  # None: still running, stopped below
                    raise RankError(r, f"exited with code {p.exitcode} after its result")
        finally:
            for p in procs:
                if p.is_alive():
                    p.terminate()
                    p.join()
    return [done[r] for r in range(world_size)]


# -- collectives over one mesh axis -----------------------------------------------


class Axis(NamedTuple):
    """One named axis of a mesh as this rank sees it: the process group of
    the ranks that differ from it only along this axis (``None`` when the
    axis has size 1), the axis size and this rank's coordinate."""

    name: str
    group: Optional[Any]
    size: int
    index: int


@dataclasses.dataclass
class CollectiveStats:
    """Calls, bytes (of the all_reduce buffers) and host seconds of the
    collectives of this process since the last :meth:`reset`."""

    calls: int = 0
    bytes: int = 0
    seconds: float = 0.0

    def reset(self) -> None:
        self.calls, self.bytes, self.seconds = 0, 0, 0.0


STATS = CollectiveStats()

_AS_INT = {torch.float64: torch.int64, torch.float32: torch.int32, torch.int64: torch.int64,
           torch.int32: torch.int32, torch.bool: torch.uint8}


def _all_reduce(buf: torch.Tensor, op, axis: Axis) -> torch.Tensor:
    t0 = time.perf_counter()
    dist.all_reduce(buf, op=op, group=axis.group)
    STATS.seconds += time.perf_counter() - t0
    STATS.calls += 1
    STATS.bytes += buf.numel() * buf.element_size()
    return buf


def psum(x, axis: Axis):
    """Sum over the axis: a tensor, or a dict of tensors of one dtype
    summed as one flat buffer (one collective)."""
    if axis.size == 1:
        return x
    if not isinstance(x, dict):
        return _all_reduce(x.clone(), dist.ReduceOp.SUM, axis)
    keys = list(x)
    flat = _all_reduce(torch.cat([x[k].reshape(-1) for k in keys]), dist.ReduceOp.SUM, axis)
    out, start = {}, 0
    for k in keys:
        n = x[k].numel()
        out[k] = flat[start:start + n].reshape(x[k].shape)
        start += n
    return out


def pmax(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """Elementwise maximum over the axis."""
    if axis.size == 1:
        return x
    return _all_reduce(x.clone(), dist.ReduceOp.MAX, axis)


def all_gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """``(S, *x.shape)``: every rank's ``x`` in axis order, bitwise."""
    if axis.size == 1:
        return x[None]
    as_int = _AS_INT[x.dtype]
    buf = torch.zeros((axis.size, *x.shape), dtype=as_int, device=x.device)
    buf[axis.index] = x.view(as_int) if x.dtype != torch.bool else x.to(as_int)
    _all_reduce(buf, dist.ReduceOp.SUM, axis)
    return buf.view(x.dtype) if x.dtype != torch.bool else buf.bool()


def ppermute(x: torch.Tensor, axis: Axis, perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """Send ``x`` along the ``(source, destination)`` pairs of ``perm``
    (axis coordinates); a rank that no pair names as destination gets
    zeros, as with ``jax.lax.ppermute``."""
    src = {d: s for s, d in perm}.get(axis.index)
    gathered = all_gather(x, axis)
    return gathered[src] if src is not None else torch.zeros_like(x)
