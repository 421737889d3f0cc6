"""Batched small-N Viterbi: ``log_b (B, T, N)`` -> ``(path (B, T) int32,
score (B,))``.

Counterpart of the JAX package's ``ops/trellis_pallas.py:viterbi_pallas``
and its dispatcher ``viterbi_batched``. For CUDA tensors
:func:`viterbi_small` launches the hand-written kernel of
``csrc/viterbi.cu`` (one warp per utterance, lane j = state j, a tree
argmax a step, backpointers in shared memory where
:func:`viterbi_smem_ok` says they fit, and a backtrace by composed chunk
maps in the same kernel); for CPU tensors it runs :func:`viterbi_plain`,
the scan it is held to bitwise.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from lnasr_tpu_torch import _build
from lnasr_tpu_torch.ops.trellis import viterbi_scan_plain
from lnasr_tpu_torch.ops.viterbi_dense import viterbi_dense

N_MAX = 32  # one warp per utterance, one lane per state
BACKTRACE_CHUNK = 32  # frames a chunk map of the kernel's backtrace covers
BP_SMEM_BYTES = 48 * 1024  # most int8 backpointers an utterance keeps on chip

_P = ctypes.c_void_p
_I = ctypes.c_int
# log_pi, log_a, log_b, B, T, N, on_chip, backpointer scratch, path, score,
# stream
_ARGTYPES = [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P]


def viterbi_smem_ok(t: int, n: int) -> bool:
    """Whether the kernel keeps an utterance's ``T x N`` int8 backpointers
    in shared memory (else in a device-memory scratch buffer)."""
    return t * n <= BP_SMEM_BYTES


def viterbi_plain(log_pi: torch.Tensor, log_a: torch.Tensor,
                  log_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: :func:`viterbi_scan_plain` without mask
    or final weights."""
    res = viterbi_scan_plain(log_pi, log_a, log_b)
    return res.path, res.score


def _launch(log_pi, log_a, log_b):
    b, t, n = log_b.shape
    dev = log_b.device
    for name, x in (("log_pi", log_pi), ("log_a", log_a), ("log_b", log_b)):
        if x.device != dev or x.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {dev}, got {x.dtype} on {x.device}")
    path = torch.empty((b, t), dtype=torch.int32, device=dev)
    score = torch.empty((b,), dtype=torch.float32, device=dev)
    if b == 0 or t == 0:
        return path, score
    on_chip = viterbi_smem_ok(t, n)
    bp = None if on_chip else torch.empty((b, t, n), dtype=torch.int8, device=dev)
    log_pi, log_a = log_pi.contiguous(), log_a.contiguous()
    lib = _build.load("viterbi", _ARGTYPES)
    with torch.cuda.device(dev):  # launch on the tensors' card
        rc = lib.viterbi_launch(
            log_pi.data_ptr(), log_a.data_ptr(), log_b.data_ptr(), b, t, n, int(on_chip),
            None if bp is None else bp.data_ptr(), path.data_ptr(), score.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, "viterbi", rc)
    viterbi_small.launches += 1
    return path, score


def viterbi_small(log_pi: torch.Tensor, log_a: torch.Tensor,
                  log_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Viterbi for N <= 32: the CUDA kernel for CUDA tensors (fp32
    only), the plain scan for CPU tensors; the two are bitwise equal on the
    same fp32 inputs."""
    if log_b.dim() != 3:
        raise ValueError(f"log_b must be (B, T, N), got shape {tuple(log_b.shape)}")
    n = log_b.shape[-1]
    if n > N_MAX or log_a.shape != (n, n) or log_pi.shape != (n,):
        raise ValueError(f"viterbi_small takes N <= {N_MAX} with log_a (N, N) and "
                         f"log_pi (N,); got N={n}, log_a {tuple(log_a.shape)}")
    if log_b.device.type == "cpu":
        return viterbi_plain(log_pi, log_a, log_b)
    if log_b.device.type != "cuda":
        raise ValueError(f"viterbi_small runs on cpu or cuda tensors, got {log_b.device}")
    return _launch(log_pi, log_a, log_b.contiguous())


viterbi_small.launches = 0  # kernel launches; plain CPU calls do not count


def viterbi_batched(log_pi: torch.Tensor, log_a: torch.Tensor,
                    log_b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Viterbi dispatch: the small-N kernel for N <= 32, the
    dense-graph kernel (:func:`~lnasr_tpu_torch.ops.viterbi_dense.
    viterbi_dense`, the port of ``viterbi_pallas_dense``) above that; on
    CPU tensors both run their plain scans."""
    n = log_b.shape[-1]
    if n <= N_MAX:
        return viterbi_small(log_pi, log_a, log_b)
    return viterbi_dense(log_pi, log_a, log_b)
