"""Dense-graph Viterbi for N > 32 states: ``log_b (T, N)`` or ``(B, T, N)``
-> ``(path int32, score)``, with an optional frame mask and termination
weights.

Counterpart of the JAX package's ``ops/trellis_pallas.py:
viterbi_pallas_dense`` (one utterance, no mask), widened to a batch and a
mask so that the recognizer's bucketed decodes and ``viterbi_batched`` for
N > 32 both run it. For CUDA tensors :func:`viterbi_dense` launches the
hand-written kernel of ``csrc/viterbi_dense.cu`` (one block per utterance;
per-target lists of the finite sources, or whole columns of ``log_a``,
split across the lanes of a warp (:func:`route`); int16 first-index
backpointers; backtrace in the same kernel); for CPU
tensors it runs :func:`viterbi_dense_plain`, the scan it is held to
bitwise.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from lnasr_tpu_torch import _build
from lnasr_tpu_torch.ops.trellis import viterbi_scan_plain

SMEM_LIMIT = 232448  # bytes of shared memory one block can use on sm_90
MAX_THREADS = 1024
N_LIMIT = 32767  # int16 backpointers
BP_BUDGET = 2 * 1024**3  # bytes of backpointer scratch one call may take
# csrc/viterbi_dense.cu's constants
_CHUNK = 32  # backtrace frames staged in shared memory
_RING = 8  # emission frames in the cp.async ring
_MASK_CHUNK = 1024  # mask frames staged at a time
KREG = 8  # list entries a lane keeps in registers

_P = ctypes.c_void_p
_I = ctypes.c_int
# log_pi, log_a, log_b, mask, log_final, B, T, N, bp, path, score, stream
_ARGTYPES = [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P, _P]


def _a16(x: int) -> int:
    return (x + 15) & ~15


def threads_for(n: int) -> int:
    """Threads of one block: eight lanes a state, at most 1024."""
    return min(MAX_THREADS, (8 * n + 31) // 32 * 32)


def _layout(n: int) -> Tuple[int, int, int]:
    """``(pool bytes, bytes a staged log_a may take, total bytes)`` of one
    block's shared memory (``csrc/viterbi_dense.cu:layout``): ``v``
    double-buffered, then the forward's emission ring, staged mask, list
    offsets, lane descriptors and the pool that holds the source lists,
    all sharing their space with the backtrace's staged backpointer
    frames. A staged ``log_a`` (no lists, so no descriptors) starts at the
    descriptors."""
    nth = threads_for(n)
    d = -(-n // nth) * nth
    u = _a16(8 * n)
    dj = u + _a16(_RING * n * 4) + _MASK_CHUNK + _a16(4 * (n + 1))
    pool = dj + 3 * _a16(4 * d)
    cap = SMEM_LIMIT - 1024
    avail = (cap - pool) & ~15 if cap > pool else 0
    pool_bytes = min(_a16(6 * n * n), avail)
    return pool_bytes, pool - dj + pool_bytes, u + max(pool - u + pool_bytes, _a16(_CHUNK * n * 2))


def smem_bytes(n: int) -> int:
    """Shared memory of one block (:func:`_layout`)."""
    return _layout(n)[2]


def lists_fit(n: int, entries: int) -> bool:
    """Whether source lists of ``entries`` (index, value) pairs fit the
    pool; otherwise the kernel walks whole columns of ``log_a``."""
    return 6 * entries <= _layout(n)[0]


def route(lengths) -> str:
    """The frame loop kernel C picks, from its source lists' ``lengths``
    (one a target: i = 0 and the finite sources i >= 1), as the prologue of
    ``csrc/viterbi_dense.cu`` does: ``"registers"`` (every lane <= KREG
    entries, one round of the block), ``"lists"`` (lists in shared memory,
    where ``log_a`` does not fit there or they hold under a third of it)
    or ``"columns"``."""
    n, total = len(lengths), sum(lengths)
    if not lists_fit(n, total):
        return "columns"
    per = KREG
    while True:
        groups = [min(32, 1 << max(0, (-(-ln // per) - 1).bit_length())) for ln in lengths]
        if sum(groups) <= threads_for(n) or per >= n:
            break
        per *= 2
    if sum(groups) <= threads_for(n) and max(-(-ln // g) for ln, g in zip(lengths, groups)) <= KREG:
        return "registers"
    return "lists" if not a_in_smem(n) or 3 * total <= n * n else "columns"


def a_in_smem(n: int) -> bool:
    """Whether ``log_a`` fits in shared memory (N <= 234) for the columns
    route; above that the kernel reads it through L1/L2."""
    return 4 * n * n <= _layout(n)[1]


def viterbi_dense_ok(t_len: int, n: int, batch: int = 1) -> bool:
    """The kernel's H100 capacity rule (it replaces the TPU's VMEM budget
    ``viterbi_dense_vmem_ok``): a block's 227 KB of shared memory must
    hold ``v`` and the backtrace's staged frames (72 N bytes, so
    N <= 3,214; the forward's regions share that space), backpointers are
    int16 (N <= 32,767), and the (B, T, N) int16 backpointer scratch stays
    within 2 GiB of the 80 GB of HBM."""
    return (1 <= n <= N_LIMIT and smem_bytes(n) + 1024 <= SMEM_LIMIT
            and batch * t_len * n * 2 <= BP_BUDGET)


def viterbi_dense_plain(log_pi: torch.Tensor, log_a: torch.Tensor, log_b: torch.Tensor,
                        mask: Optional[torch.Tensor] = None,
                        log_final: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's plain version: :func:`viterbi_scan_plain` with ``mask``
    and ``log_final``."""
    res = viterbi_scan_plain(log_pi, log_a, log_b, mask=mask, log_final=log_final)
    return res.path, res.score


def _launch(log_pi, log_a, log_b, mask, log_final):
    b, t, n = log_b.shape
    dev = log_b.device
    if log_b.dtype != torch.float32:
        raise ValueError(f"the dense Viterbi kernel takes float32, got {log_b.dtype}")
    if not viterbi_dense_ok(t, n, b):
        raise ValueError(f"N={n}, T={t}, B={b} is past the dense kernel's capacity")
    named = [("log_pi", log_pi, (n,)), ("log_a", log_a, (n, n))]
    if log_final is not None:
        named.append(("log_final", log_final, (n,)))
    for name, x, shape in named:
        if x.device != dev or x.dtype != torch.float32 or tuple(x.shape) != shape:
            raise ValueError(f"{name} must be float32 {shape} on {dev}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    if mask is not None:
        if mask.shape != (b, t) or mask.device != dev:
            raise ValueError(f"mask must be ({b}, {t}) on {dev}, got {tuple(mask.shape)}")
        mask = mask.to(torch.bool).contiguous()
    path = torch.empty((b, t), dtype=torch.int32, device=dev)
    score = torch.empty((b,), dtype=torch.float32, device=dev)
    if b == 0 or t == 0:
        return path, score
    bp = torch.empty((b, t, n), dtype=torch.int16, device=dev)
    log_pi, log_a = log_pi.contiguous(), log_a.contiguous()
    log_final = None if log_final is None else log_final.contiguous()
    lib = _build.load("viterbi_dense", _ARGTYPES)
    with torch.cuda.device(dev):
        rc = lib.viterbi_dense_launch(
            log_pi.data_ptr(), log_a.data_ptr(), log_b.data_ptr(),
            None if mask is None else mask.data_ptr(),
            None if log_final is None else log_final.data_ptr(),
            b, t, n, bp.data_ptr(), path.data_ptr(), score.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    _build.check(lib, "viterbi_dense", rc)
    viterbi_dense.launches += 1
    return path, score


def viterbi_dense(log_pi: torch.Tensor, log_a: torch.Tensor, log_b: torch.Tensor,
                  mask: Optional[torch.Tensor] = None,
                  log_final: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Viterbi over a dense graph: ``log_b (T, N)`` -> ``(path (T,),
    score ())``, or batched ``(B, T, N)`` -> ``((B, T), (B,))``; ``mask``
    is ``(T,)``/``(B, T)``. The CUDA kernel for CUDA tensors (float32, within
    :func:`viterbi_dense_ok`; it raises otherwise), the plain scan for CPU
    tensors; the two are bitwise equal on the same float32 inputs."""
    single = log_b.dim() == 2
    if log_b.device.type == "cpu":
        return viterbi_dense_plain(log_pi, log_a, log_b, mask, log_final)
    if log_b.device.type != "cuda":
        raise ValueError(f"viterbi_dense runs on cpu or cuda tensors, got {log_b.device}")
    if log_b.dim() not in (2, 3):
        raise ValueError(f"log_b must be (T, N) or (B, T, N), got {tuple(log_b.shape)}")
    lb = log_b[None] if single else log_b
    m = None if mask is None else (mask[None] if single else mask)
    path, score = _launch(log_pi, log_a, lb.contiguous(), m, log_final)
    return (path[0], score[0]) if single else (path, score)


viterbi_dense.launches = 0  # kernel launches; plain CPU calls do not count
