"""Training-state checkpoints and the EM loop.

The port of the JAX package's ``utils/checkpoints.py``: parameters plus
the EM iteration counter and loglik history, written atomically to a flat
NumPy ``.npz``, with periodic saves and deterministic resume.

The file layout is the JAX package's, so checkpoints cross-load both
ways: ``__meta__`` holds JSON bytes (``iteration``, ``history``,
``treedef``, ``n_leaves``, ``done``) and ``leaf_i`` the i-th parameter in
the NamedTuple's field order. ``treedef`` is a description for readers
(this package writes its own); loading checks only ``n_leaves``, as the
JAX package does. :class:`RankCheckpointer` is the same file for an EM
loop that every rank of a ``torch.distributed`` world runs (one rank
writes; mixture-sharded parameters are gathered first).
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Any, List, NamedTuple, Optional, Tuple

import numpy as np
import torch


def _atomic_write(path: str, write_fn) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        write_fn(tmp)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


class TrainState:
    """Parameters, iteration and loglik history.

    ``done`` marks a run that finished (converged): resuming a done
    checkpoint is a no-op, so an interrupted and resumed run ends bitwise
    identical to an uninterrupted one even when the EM loop stopped
    early."""

    def __init__(self, params, iteration: int = 0,
                 history: Optional[List[float]] = None, done: bool = False):
        self.params = params
        self.iteration = iteration
        self.history = list(history or [])
        self.done = bool(done)


def save_train_state(path: str, state: TrainState) -> None:
    """Atomic ``.npz`` checkpoint of a :class:`TrainState` whose ``params``
    is a NamedTuple of tensors (``HMMParams``, ``GMMHMMParams``,
    ``GMMParams``)."""
    params: NamedTuple = state.params
    leaves = [np.asarray(torch.as_tensor(x).detach().cpu()) for x in params]
    meta = {
        "iteration": state.iteration,
        "history": state.history,
        "treedef": f"{type(params).__name__}({', '.join(params._fields)})",
        "n_leaves": len(leaves),
        "done": state.done,
    }

    def write(tmp):
        np.savez(
            tmp,
            __meta__=np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8),
            **{f"leaf_{i}": leaf for i, leaf in enumerate(leaves)},
        )
        # np.savez appends .npz when missing; normalize
        if not tmp.endswith(".npz") and os.path.exists(tmp + ".npz"):
            os.replace(tmp + ".npz", tmp)

    _atomic_write(path, write)


def load_train_state(path: str, like_params) -> TrainState:
    """Load a checkpoint into the structure of ``like_params``: the same
    NamedTuple type, each leaf on its template's device and in its dtype."""
    with np.load(path) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        leaves = [data[f"leaf_{i}"] for i in range(meta["n_leaves"])]
    if len(like_params) != len(leaves):
        raise ValueError(f"checkpoint has {len(leaves)} leaves, template has "
                         f"{len(like_params)}")
    params = type(like_params)(*(
        torch.as_tensor(leaf, dtype=like.dtype, device=like.device)
        for leaf, like in zip(leaves, like_params)))
    return TrainState(params, meta["iteration"], meta["history"], meta.get("done", False))


class Checkpointer:
    """Periodic training checkpoints with resume.

    Usage in an EM loop::

        ckpt = Checkpointer(dir, every=5)
        start, params, history = ckpt.restore(params)
        for it in range(start, iters):
            params, loglik = step(params, ...)
            history.append(loglik)
            ckpt.maybe_save(it + 1, params, history)
    """

    FILENAME = "train_state.npz"

    def __init__(self, directory: str, every: int = 1):
        self.directory = directory
        self.every = max(1, every)

    @property
    def path(self) -> str:
        return os.path.join(self.directory, self.FILENAME)

    def restore(self, like_params) -> Tuple[int, Any, List[float]]:
        state = self.restore_state(like_params)
        return state.iteration, state.params, state.history

    def restore_state(self, like_params) -> TrainState:
        if os.path.exists(self.path):
            return load_train_state(self.path, like_params)
        return TrainState(like_params)

    def maybe_save(self, iteration: int, params, history: List[float],
                   done: bool = False) -> bool:
        if done or iteration % self.every == 0:
            save_train_state(self.path, TrainState(params, iteration, history, done))
            return True
        return False


class RankCheckpointer(Checkpointer):
    """A :class:`Checkpointer` for an EM loop that every rank of a
    ``torch.distributed`` world runs in step (``parallel/``'s trainers).

    A save gathers the full parameters on every rank (``gather``, a
    collective; the identity for replicated parameters), world rank 0
    alone writes the file, and every rank waits at a barrier, so no rank
    reads a file being replaced. A restore waits at a barrier, reads the
    full parameters on every rank and keeps this rank's part (``local``).
    The file is the single-process layout, so ``GMMHMM.load``-style
    readers and :class:`Checkpointer` read it, and kill and resume stay
    bitwise (the gather and the slice move bits, not values)."""

    def __init__(self, directory: str, every: int = 1, gather=None, local=None):
        super().__init__(directory, every)
        self.gather = gather
        self.local = local

    def restore_state(self, like_params) -> TrainState:
        import torch.distributed as dist

        dist.barrier()
        if not os.path.exists(self.path):
            return TrainState(like_params)
        state = load_train_state(self.path, like_params)
        if self.local is not None:
            state.params = self.local(state.params)
        return state

    def maybe_save(self, iteration: int, params, history: List[float],
                   done: bool = False) -> bool:
        import torch.distributed as dist

        if not (done or iteration % self.every == 0):
            return False
        full = self.gather(params) if self.gather is not None else params
        if dist.get_rank() == 0:
            save_train_state(self.path, TrainState(full, iteration, history, done))
        dist.barrier()
        return True


def checkpointer_from_config(config) -> Optional[Checkpointer]:
    """A :class:`Checkpointer` when a
    :class:`~lnasr_tpu_torch.config.TrainConfig` enables one
    (``checkpoint_every > 0`` and ``checkpoint_dir`` set), else ``None``."""
    if config is None or not config.checkpoint_dir or config.checkpoint_every <= 0:
        return None
    return Checkpointer(config.checkpoint_dir, every=config.checkpoint_every)


def rank_checkpointer_from_config(config, gather=None, local=None
                                  ) -> Optional[RankCheckpointer]:
    """:func:`checkpointer_from_config`'s checkpointer as a
    :class:`RankCheckpointer` with ``gather`` and ``local``."""
    ckpt = checkpointer_from_config(config)
    return None if ckpt is None else RankCheckpointer(ckpt.directory, ckpt.every, gather, local)


def em_loop(
    step_fn,
    params,
    iters: int,
    eps: float,
    verbose: bool = False,
    checkpointer: Optional[Checkpointer] = None,
    fmt: str = "Iter: {it:3}, L(lambda|O) = {loglik:.6e}",
):
    """The EM loop behind every trainer: runs ``step_fn`` (params ->
    (params, loglik)) until |delta loglik| < eps or ``iters`` sweeps, with
    periodic atomic saves and deterministic resume when a checkpointer is
    given. ``float(loglik)`` is the loop's one wait on the device a sweep.
    An interrupted run resumed from its checkpoint ends with bitwise the
    parameters of an uninterrupted one: the step is deterministic, the
    ``.npz`` round trip keeps the bits, and a converged run is marked
    ``done``, so re-running it is a no-op. Returns ``(params, history)``."""
    start, history = 0, []
    if checkpointer is not None:
        state = checkpointer.restore_state(params)
        if state.done:
            return state.params, state.history
        start, params, history = state.iteration, state.params, state.history
    prev = history[-1] if history else None
    for it in range(start, iters):
        params, loglik = step_fn(params)
        loglik = float(loglik)
        history.append(loglik)
        if verbose:
            print(fmt.format(it=it, loglik=loglik))
        converged = prev is not None and abs(loglik - prev) < eps
        if checkpointer is not None:
            # ``done`` marks convergence only: a run that used up its budget
            # resumes with a larger ``iters`` and continues
            checkpointer.maybe_save(it + 1, params, history, done=converged)
        if converged:
            break
        prev = loglik
    return params, history
