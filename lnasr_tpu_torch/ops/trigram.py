"""The exact trigram decode's Viterbi recursion: kernel H and its plain version.

The history-expanded word graph of ``models/decoder.py:
TrigramDecodingGraph`` has states ``(h, w, s)``: history word h (V words,
then the sentence-begin row h = V), current word w, local state s. Its
decode is a max-plus recursion over the ``(H, V, S)`` grid with
first-index argmax backpointers, then a walk back along them. The JAX
package runs both as one jitted ``lax.scan`` each (one device program,
no Pallas kernel); here:

- :func:`trigram_forward`: for CUDA tensors one launch of the
  hand-written kernel of ``csrc/trigram_forward.cu`` (kernel H's forward:
  every frame on the whole card, blocks exchanging exit scores through
  tagged words, the final argmax at its end), on one of three routes
  (:func:`trigram_route`): ``"resident"`` (float32: blocks own ranges of
  copies and keep their ``hop3`` columns on chip for the whole launch),
  ``"smem"`` and ``"global"`` (blocks own history rows and stream
  ``hop3`` every frame); for CPU tensors :func:`trigram_forward_plain`,
  the frame loop it is held to bitwise.
- :func:`trigram_backtrace`: for CUDA tensors one launch of
  ``csrc/trigram_backtrace.cu`` (one thread walks the backpointers); for
  CPU tensors :func:`trigram_backtrace_plain`, a gather a frame.
- :func:`trigram_viterbi`: both, ``(path, score)``.

Each takes one utterance (``log_b (T, V, S)``, ``mask (T,)``) or a batch
(``(B, T, V, S)``, ``(B, T)``), as the JAX package vmaps its decode: one
launch of each kernel for the batch, every row bitwise its single decode.
:func:`trigram_cut` cuts a batch past one launch's capacity into pieces.
On a CUDA tensor a wrapper launches its kernel or raises; there is no
path back to the frame loop, and no batch is looped row by row. Each
counts its launches in ``.launches``.
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import List, NamedTuple, Optional, Tuple

import torch

from lnasr_tpu_torch import _build
from lnasr_tpu_torch.ops.factored import even_pieces, sm_count

_P = ctypes.c_void_p
_I = ctypes.c_int
# log_b, mask, inner_a, hop3, log_pi_w, final3, exit_idx, B, T, H, V, S,
# is_double, route, n_sm, bts, score, last, xch, rows, part_v, part_i, done,
# stream
_FWD_ARGTYPES = [_P] * 7 + [_I] * 8 + [_P] * 9
# bts, last, B, T, n_states, path, stream
_BT_ARGTYPES = [_P, _P, _I, _I, ctypes.c_longlong, _P, _P]
ROUTES = ("smem", "global", "resident")  # the forward kernel's ``route`` codes, in order
SMEM_LIMIT = 232448  # bytes of shared memory one block can use on sm_90
SMEM_STATIC = 1024  # the forward kernel's static shared arrays, at most
# the resident route (csrc/trigram_forward.cu: R_THREADS, R_KR, R_SMAX,
# R_ASTRIDE, R_GSTRIDE)
RESIDENT_THREADS = 384  # a block: one thread for each of its copies
RESIDENT_KR = 80  # hop sources a thread keeps in registers
RESIDENT_SMAX = 8  # local states a word has at most on this route
RESIDENT_ASTRIDE = RESIDENT_SMAX * RESIDENT_SMAX + 1  # floats of a word's inner transitions
RESIDENT_GSTRIDE = RESIDENT_SMAX + 1  # floats of a copy's states
# a batch (csrc/trigram_forward.cu: MAX_BATCH): utterances one launch takes,
# each thread keeping every utterance's publication count in a local array
MAX_BATCH = 32
# bytes of (B, T-1, H, V, S) int32 backpointers one launch may store: about
# a tenth of an H100's 80 GB, so that a launch's backpointers leave room for
# the caller's tensors and the next piece's; the serving batch of 8 at V =
# 200 and T = 511 (5.30 GB) is one launch, 24 such rows two launches of 12
BTS_BUDGET = 8 * 1024**3


class ResidentLayout(NamedTuple):
    """The resident route's partition of the H*V copies ``h*V + w`` (the
    same shared-memory carve in every block): ``blocks`` = min(SMs, H),
    block b owning copies ``[copy_lo(b), copy_lo(b + 1))``, those of rows h
    < V its hop copies; the most hop copies (``nhp``), copies (``ncp``)
    and exit columns read (``ncol``) of a block; ``hsp``: a column's
    sources in shared memory (those from ``RESIDENT_KR`` on, padded to 4
    mod 8 floats, or 0)."""
    blocks: int
    nhp: int
    ncp: int
    ncol: int
    hsp: int


def _pad4(x: int) -> int:
    return -(-x // 4) * 4


def copy_lo(b: int, blocks: int, h: int, v: int) -> int:
    """The first copy of block ``b`` of the resident route."""
    return h * v * b // blocks


@functools.lru_cache(maxsize=None)
def resident_layout(h: int, v: int, n_sm: int) -> ResidentLayout:
    """The resident route's partition (``csrc/trigram_forward.cu:
    resident_layout``). ``blocks`` <= H keeps every block's range at least
    V copies long, so that every exit column holds a word of every block.
    Cached: the route rule asks for it several times a launch, and its loop
    over the blocks took ~0.2 ms of the host's time each."""
    blocks = min(n_sm, h)
    nhp = ncp = ncol = 0
    for b in range(blocks):
        lo, hi = copy_lo(b, blocks, h, v), copy_lo(b + 1, blocks, h, v)
        n_hop = min(hi, v * v) - lo
        nhp = max(nhp, n_hop)
        ncp = max(ncp, hi - lo)
        ncol = max(ncol, (lo + n_hop - 1) // v - lo // v + 1 if n_hop > 0 else 1)
    rest = _pad4(h - RESIDENT_KR)
    hsp = 0 if h <= RESIDENT_KR else rest + (4 if rest % 8 == 0 else 0)
    return ResidentLayout(blocks, nhp, ncp, ncol, hsp)


def resident_bytes(h: int, v: int, n_sm: int) -> int:
    """Dynamic shared memory of a resident-route block (``csrc/
    trigram_forward.cu:resident_smem_bytes``): the exit states, the inner
    transitions, its copies' states, the exit columns it reads (two
    buffers) and the part of its hop columns past the registers'
    ``RESIDENT_KR`` sources."""
    lay = resident_layout(h, v, n_sm)
    return 4 * (_pad4(v) + _pad4(v * RESIDENT_ASTRIDE) + _pad4(lay.ncp * RESIDENT_GSTRIDE)
                + 2 * lay.ncol * (RESIDENT_KR + lay.hsp) + lay.nhp * lay.hsp)


def rows_per_block(h: int, n_sm: int) -> int:
    """History rows a block of the ``smem`` and ``global`` routes owns:
    ``ceil(H / SMs)``."""
    return -(-h // n_sm)


def forward_smem_bytes(h: int, v: int, s: int, itemsize: int, n_sm: int, route: str,
                       batch: int = 1) -> int:
    """Dynamic shared memory of a forward block over ``batch`` utterances
    (``csrc/trigram_forward.cu:smem_bytes``, and :func:`resident_bytes` on
    the resident route, whose batch keeps its states in device memory): on
    the row routes the exit columns of its rows and state 0's sources, and
    on the ``"smem"`` route each utterance's rows of two frames."""
    if route == "resident":
        return resident_bytes(h, v, n_sm)
    rpb = rows_per_block(h, n_sm)
    head = rpb * h * itemsize + (rpb + 1) * v * 4
    if route == "global":
        return head
    return -(-head // 16) * 16 + 2 * batch * rpb * v * s * itemsize


def route_fits(route: str, h: int, v: int, s: int, itemsize: int, n_sm: int) -> bool:
    """Whether the forward kernel takes ``route`` for an ``(H, V, S)`` grid
    at ``itemsize`` on ``n_sm`` SMs: its shared memory fits a block, and on
    the resident route besides float32, S <= ``RESIDENT_SMAX`` and at most
    ``RESIDENT_THREADS`` copies a block (one a thread)."""
    if route == "resident":
        if itemsize != 4 or s > RESIDENT_SMAX:
            return False
        if resident_layout(h, v, n_sm).ncp > RESIDENT_THREADS:
            return False
    return forward_smem_bytes(h, v, s, itemsize, n_sm, route) + SMEM_STATIC <= SMEM_LIMIT


def trigram_route(h: int, v: int, s: int, itemsize: int, n_sm: int) -> str:
    """The forward kernel's route for an ``(H, V, S)`` grid, by capacity:
    at float32 ``"resident"`` (``hop3`` on chip for the whole launch) where
    it fits (:func:`route_fits`: V <= 203 at S <= 8 on 132 SMs), else
    ``"global"``; at float64, whose ``hop3`` no card holds on chip,
    ``"smem"`` (a block's rows of two frames in shared memory) while they
    fit, else ``"global"`` (the rows in a device-memory scratch, through
    L2). On an H100 at the V = 200 segment (``kernel_timing.py --kernels
    H``) the resident route took 2.39 ms at float32 against 11.68-11.74 on
    the global route and 11.86-11.87 with the rows in shared memory, which
    took 18.39-18.45 ms at float64 against 19.27 on the global route:
    each dtype takes its fastest route that fits. Raises, with the
    numbers, past what even the global route holds: ``ceil(H / SMs)``
    exit columns of H values in one block's shared memory."""
    for route in ("resident", "global") if itemsize == 4 else ("smem", "global"):
        if route_fits(route, h, v, s, itemsize, n_sm):
            return route
    need = forward_smem_bytes(h, v, s, itemsize, n_sm, "global") + SMEM_STATIC
    raise ValueError(
        f"the trigram forward kernel holds each block's {rows_per_block(h, n_sm)} exit columns "
        f"of H={h} values in shared memory: {need} bytes > {SMEM_LIMIT} at {n_sm} SMs")


def batch_fits(batch: int, t_len: int, h: int, v: int, s: int, itemsize: int, n_sm: int,
               route: str) -> bool:
    """Whether one launch on ``route`` takes ``batch`` utterances of ``T``
    frames: at most :data:`MAX_BATCH`, their backpointers within
    :data:`BTS_BUDGET`, and on the ``"smem"`` route their rows of two
    frames in a block's shared memory (the other routes keep a batch's
    state in device memory). One utterance always fits: what a single
    decode takes is the route's own rule (:func:`route_fits`)."""
    if batch <= 1:
        return True
    if batch > MAX_BATCH or 4 * batch * max(t_len - 1, 0) * h * v * s > BTS_BUDGET:
        return False
    return route != "smem" or (forward_smem_bytes(h, v, s, itemsize, n_sm, route, batch)
                               + SMEM_STATIC <= SMEM_LIMIT)


def trigram_cut(batch: int, t_len: int, h: int, v: int, s: int, itemsize: int,
                n_sm: int) -> List[Tuple[int, int]]:
    """The launches of a batch of ``batch`` utterances of ``T`` frames, as
    ``(start, stop)`` row ranges in order (``ops/factored.py:cut_batch``'s
    shape): as few as :func:`batch_fits` allows on the route that one
    utterance takes (:func:`trigram_route`, so every piece takes it), the
    rows spread over them as evenly as they go, the first pieces the
    larger. Nothing for an empty batch. Never refuses: past every route's
    capacity each utterance is a piece of its own, whose launch raises as a
    single decode's does."""
    if batch < 1:
        return []
    try:
        route = trigram_route(h, v, s, itemsize, n_sm)
    except ValueError:
        route = None

    return even_pieces(batch, MAX_BATCH, lambda b: b == 1 or (
        route is not None and batch_fits(b, t_len, h, v, s, itemsize, n_sm, route)))


# -- the plain versions ---------------------------------------------------------


def trigram_forward_plain(log_b, mask, inner_a, hop3, log_pi_w, final3, exit_idx):
    """Kernel H's forward as a frame loop over grid emissions ``log_b (T,
    V, S)`` with ``mask (T,)`` or None: ``(bts (T-1, H, V, S) int32
    backpointers in (h*V + w)*S + s ids, score (), last () int32)``; or
    over a batch's ``(B, T, V, S)`` with ``(B, T)`` masks: ``(bts (B, T-1,
    H, V, S), score (B,), last (B,))``, the batch stepped as one tensor
    with each row's adds and maxima those of its single call, so that every
    row is bitwise its single decode. Ties go as in the JAX package's scan:
    the first within-word source, the first history on a hop, a hop only
    when strictly better at local state 0; the <s> history row is never
    re-entered; masked frames keep the grid and point to themselves; the
    final argmax takes the first of the flattened (H, V, S) states."""
    if log_b.dim() == 3:
        bts, score, last = trigram_forward_plain(
            log_b[None], None if mask is None else mask[None], inner_a, hop3, log_pi_w, final3,
            exit_idx)
        return bts[0], score[0], last[0]
    h_hist, v_words, s_max = hop3.shape[0], hop3.shape[1], inner_a.shape[1]
    exit_idx = exit_idx.long()
    b_n, t_len = log_b.shape[:2]
    dev = log_b.device
    n_states = h_hist * v_words * s_max
    copy_self = torch.arange(n_states, device=dev).reshape(h_hist, v_words, s_max)
    copy_base = copy_self[:, :, :1]  # (H, V, 1) id of each copy's state 0
    # the hop into copy (u, w) comes from copy (hsrc, u) at u's exit state
    hop_src_base = (torch.arange(v_words, device=dev) * s_max + exit_idx)[:, None]
    exit_sel = exit_idx[None, None, :, None].expand(b_n, h_hist, v_words, 1)
    inner_a = inner_a[None, None]
    hop3 = hop3[None]

    vgrid = torch.full((b_n, h_hist, v_words, s_max), -math.inf, dtype=log_b.dtype, device=dev)
    vgrid[:, h_hist - 1, :, 0] = log_pi_w.to(log_b.dtype)
    vgrid = vgrid + log_b[:, 0, None]
    bts = torch.empty((b_n, max(t_len - 1, 0), h_hist, v_words, s_max), dtype=torch.int32,
                      device=dev)
    for t in range(1, t_len):
        within, wsrc = torch.max(vgrid[..., None] + inner_a, dim=3)
        bt = wsrc + copy_base
        exit_v = torch.gather(vgrid, 3, exit_sel)  # (B, H, V, 1)
        entry, hsrc = torch.max(exit_v + hop3, dim=1)  # (B, V, V): [b, u, w]
        w0 = within[:, :v_words, :, 0]
        hop_wins = entry > w0
        within[:, :v_words, :, 0] = torch.maximum(w0, entry)
        bt[:, :v_words, :, 0] = torch.where(
            hop_wins, torch.add(hop_src_base, hsrc, alpha=v_words * s_max),
            bt[:, :v_words, :, 0])
        new_v = within + log_b[:, t, None]
        if mask is None:
            vgrid = new_v
            bts[:, t - 1] = bt
        else:
            valid = mask[:, t, None, None, None]
            vgrid = torch.where(valid, new_v, vgrid)
            bts[:, t - 1] = torch.where(valid, bt, copy_self)

    final_grid = torch.where(
        torch.arange(s_max, device=dev)[None, None, :] == exit_idx[None, :, None],
        final3[:, :, None].to(vgrid.dtype),
        torch.tensor(-math.inf, dtype=vgrid.dtype, device=dev))
    score, last = torch.max((vgrid + final_grid).reshape(b_n, n_states), dim=1)
    return bts, score, last.to(torch.int32)


def trigram_backtrace_plain(bts: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """Kernel H's backtrace as a frame loop: the ``(T,)`` int32 state path
    from ``last ()`` back through ``bts (T-1, H, V, S)``, or a batch's
    ``(B, T)`` paths from ``last (B,)`` through ``(B, T-1, H, V, S)``, a
    gather a step, so that the walk never waits on the host."""
    if bts.dim() == 4:
        return trigram_backtrace_plain(bts[None], last.reshape(1))[0]
    b_n, t_len = bts.shape[0], bts.shape[1] + 1
    bts_flat = bts.flatten(2)  # (B, T-1, H*V*S); reshape(.., 0, -1) is refused at T = 1
    states = [last.reshape(b_n, 1).to(torch.int32)]
    for t in range(t_len - 2, -1, -1):
        states.append(torch.gather(bts_flat[:, t], 1, states[-1].long()))
    return torch.cat(states[::-1], dim=1)


def trigram_viterbi_plain(log_b, mask, inner_a, hop3, log_pi_w, final3, exit_idx):
    """:func:`trigram_forward_plain` then :func:`trigram_backtrace_plain`:
    ``(path (T,) int32 in (h*V + w)*S + s ids, score ())``, or a batch's
    ``(paths (B, T), scores (B,))``."""
    bts, score, last = trigram_forward_plain(log_b, mask, inner_a, hop3, log_pi_w, final3,
                                             exit_idx)
    return trigram_backtrace_plain(bts, last), score


# -- the kernels -----------------------------------------------------------------


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cpu":
        return False
    if x.device.type != "cuda":
        raise ValueError(f"the trigram decode runs on cpu or cuda tensors, got {x.device}")
    return True


def _dense(x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """``x`` in ``dtype`` and contiguous, copied only where it is not."""
    return x if x.dtype == dtype and x.is_contiguous() else x.to(dtype).contiguous()


def trigram_forward(log_b, mask, inner_a, hop3, log_pi_w, final3, exit_idx):
    """``(bts, score, last)`` of :func:`trigram_forward_plain`, for one
    utterance or a batch. CUDA tensors launch kernel H's forward once
    (float32 or float64, the graph's tensors cast to ``log_b``'s dtype, on
    :func:`trigram_route`'s route, a batch within :func:`batch_fits`; an
    empty batch launches nothing), anything it does not take raises; CPU
    tensors run the plain frame loop. Every check reads shapes, dtypes and
    devices only: nothing waits on the card."""
    return _forward(log_b, mask, inner_a, hop3, log_pi_w, final3, exit_idx)


def _forward(log_b, mask, inner_a, hop3, log_pi_w, final3, exit_idx,
             route: Optional[str] = None):
    """:func:`trigram_forward`, with ``route`` overriding
    :func:`trigram_route` (``chip_smoke.py`` and ``kernel_timing.py`` hold
    and time each route on the card)."""
    if not _on_cuda(log_b):
        return trigram_forward_plain(log_b, mask, inner_a, hop3, log_pi_w, final3, exit_idx)
    dev = log_b.device
    if log_b.dim() not in (3, 4):
        raise ValueError(f"log_b must be (T, V, S) or (B, T, V, S), got shape "
                         f"{tuple(log_b.shape)}")
    single = log_b.dim() == 3
    b, t, v, s = (1, *log_b.shape) if single else tuple(log_b.shape)
    h = v + 1
    want = {"inner_a": (inner_a, (v, s, s)), "hop3": (hop3, (h, v, v)),
            "log_pi_w": (log_pi_w, (v,)), "final3": (final3, (h, v)),
            "exit_idx": (exit_idx, (v,))}
    if mask is not None:
        want["mask"] = (mask, (t,) if single else (b, t))
    for name, (x, shape) in want.items():
        if tuple(x.shape) != shape:
            raise ValueError(f"the trigram forward kernel takes {name} {shape} for log_b "
                             f"{tuple(log_b.shape)}, got {tuple(x.shape)}")
        if x.device != dev:
            raise ValueError(f"{name} is on {x.device}, log_b on {dev}")
    dtype = log_b.dtype
    if dtype not in (torch.float32, torch.float64) or t < 1:
        raise ValueError(f"the trigram forward kernel takes float32 or float64 and T >= 1, got "
                         f"{dtype}, T={t}")
    n_sm = sm_count(dev)
    route = trigram_route(h, v, s, dtype.itemsize, n_sm) if route is None else route
    if route not in ROUTES or not route_fits(route, h, v, s, dtype.itemsize, n_sm):
        raise ValueError(f"no route {route!r} of the trigram forward kernel at H={h}, V={v}, "
                         f"S={s}, {dtype}")
    if not batch_fits(b, t, h, v, s, dtype.itemsize, n_sm, route):
        raise ValueError(f"a batch of {b} utterances of T={t} is past one launch of the trigram "
                         f"forward kernel on its {route!r} route: cut it (trigram_cut)")
    bts = torch.empty((b, t - 1, h, v, s), dtype=torch.int32, device=dev)
    score = torch.empty((b,), dtype=dtype, device=dev)
    last = torch.empty((b,), dtype=torch.int32, device=dev)
    if b == 0:
        return bts, score, last
    blocks = (resident_layout(h, v, n_sm).blocks if route == "resident"
              else -(-h // rows_per_block(h, n_sm)))
    xch = torch.empty((b, 2, v, h, 2 if dtype == torch.float64 else 1), dtype=torch.int64,
                      device=dev)
    rows = None  # device-memory state: the global route's rows, a resident batch's copies
    if route == "global":
        rows = torch.empty((b, 2, h, v, s), dtype=dtype, device=dev)
    elif route == "resident" and b > 1:
        rows = torch.empty((b, RESIDENT_SMAX, h * v), dtype=dtype, device=dev)
    part_v = torch.empty((b, blocks), dtype=dtype, device=dev)
    part_i = torch.empty((b, blocks), dtype=torch.int32, device=dev)
    done = torch.empty(1, dtype=torch.int32, device=dev)
    ins = [_dense(log_b, dtype), None if mask is None else _dense(mask, torch.bool),
           _dense(inner_a, dtype), _dense(hop3, dtype), _dense(log_pi_w, dtype),
           _dense(final3, dtype), _dense(exit_idx, torch.int32)]
    ptr = lambda x: None if x is None else x.data_ptr()  # noqa: E731
    lib = _build.load("trigram_forward", _FWD_ARGTYPES)
    with torch.cuda.device(dev):  # launch on the tensors' card
        rc = lib.trigram_forward_launch(
            *(ptr(x) for x in ins), b, t, h, v, s, int(dtype == torch.float64),
            ROUTES.index(route), n_sm, bts.data_ptr(), score.data_ptr(), last.data_ptr(),
            xch.data_ptr(), ptr(rows), part_v.data_ptr(), part_i.data_ptr(), done.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "trigram_forward", rc)
    trigram_forward.launches += 1
    trigram_forward.route_launches[route] += 1
    return (bts[0], score[0], last[0]) if single else (bts, score, last)


trigram_forward.launches = 0  # kernel H forward launches; plain CPU calls do not count
trigram_forward.route_launches = dict.fromkeys(ROUTES, 0)  # the same, by route


def trigram_backtrace(bts: torch.Tensor, last: torch.Tensor) -> torch.Tensor:
    """The state path of :func:`trigram_backtrace_plain`: ``(T,)`` from
    ``bts (T-1, H, V, S)`` and ``last ()``, or a batch's ``(B, T)`` from
    ``(B, T-1, H, V, S)`` and ``(B,)``. CUDA tensors launch kernel H's
    backtrace once (a thread walks each utterance; an empty batch launches
    nothing), CPU tensors run the plain gathers."""
    if not _on_cuda(bts):
        return trigram_backtrace_plain(bts, last)
    dev = bts.device
    single = bts.dim() == 4
    b = 1 if single else bts.shape[0]
    if bts.dim() not in (4, 5) or bts.dtype != torch.int32 or last.dtype != torch.int32 \
            or last.numel() != b or last.device != dev:
        raise ValueError(f"the trigram backtrace kernel takes int32 bts (T-1, H, V, S) and an "
                         f"int32 last state, or a batch's (B, T-1, H, V, S) and (B,), on one "
                         f"device, got {bts.dtype} {tuple(bts.shape)}, {last.dtype} "
                         f"{tuple(last.shape)} on {last.device}")
    t = bts.shape[-4] + 1
    n_states = math.prod(bts.shape[-3:])
    path = torch.empty((b, t), dtype=torch.int32, device=dev)
    if b == 0:
        return path
    bts = bts.contiguous()
    lib = _build.load("trigram_backtrace", _BT_ARGTYPES)
    with torch.cuda.device(dev):
        rc = lib.trigram_backtrace_launch(bts.data_ptr(), last.contiguous().data_ptr(), b, t,
                                          n_states, path.data_ptr(),
                                          torch.cuda.current_stream(dev).cuda_stream)
    _build.check(lib, "trigram_backtrace", rc)
    trigram_backtrace.launches += 1
    return path[0] if single else path


trigram_backtrace.launches = 0  # kernel H backtrace launches; plain CPU calls do not count


def trigram_viterbi(log_b, mask, inner_a, hop3, log_pi_w, final3, exit_idx
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The trigram decode of grid emissions ``log_b (T, V, S)`` with
    ``mask (T,)`` or None, or of a batch's ``(B, T, V, S)`` with ``(B, T)``
    masks, over ``inner_a (V, S, S)``, ``hop3 (H, V, V)``, ``log_pi_w
    (V,)``, ``final3 (H, V)`` and ``exit_idx (V,)``: ``(path (T,) int32 in
    (h*V + w)*S + s ids, score ())``, or ``(paths (B, T), scores (B,))``.
    On CUDA tensors kernel H's forward and backtrace, one launch each for
    the utterance or the batch (within :func:`batch_fits`); on CPU tensors
    :func:`trigram_viterbi_plain`."""
    bts, score, last = trigram_forward(log_b, mask, inner_a, hop3, log_pi_w, final3, exit_idx)
    return trigram_backtrace(bts, last), score
