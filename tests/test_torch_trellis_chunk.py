"""Kernel P (``csrc/trellis_chunk.cu``: the streaming pipeline's decoder
stage, one launch an arrived chunk, and the walk, one launch a decode) on
the CPU, where it cannot run: its plain versions against the JAX package,
its caller in ``parallel/pipeline.py``, and its wrappers' host side.

- ``ops.trellis.trellis_chunk_plain`` chained over chunks of 1, 7, 16 and
  T (T = 64, N = 1, 4 and 33, float32 and float64; random models,
  integer-valued models and emissions with ``-inf`` entries (planted ties),
  left-to-right models): in the max-plus semiring each chunk's final
  ``alpha`` is bitwise the JAX ``viterbi_scan``'s trellis row and the
  pointer rows 1... its backpointers (row 0 is ``arange(N)``); in the log
  semiring each chunk's ``alpha`` is within 1e-12 relative of the JAX
  ``forward_scan``'s at float64.
- ``ops.trellis.trellis_chunk_chunked_plain`` (the chunked route's
  mirror: pieces, their operator products, ``alpha`` through them) and a
  NumPy model of the kernel's chunked route chained over chunks of 1, 7,
  16 and T (N = 1, 4, 5 and 8, the route's edges; random, planted-tie and
  left-to-right models): within 1e-12 relative of the JAX
  ``forward_scan`` at float64, ``-inf`` where it has ``-inf``; their
  pointers (the replay) the plain frame loop's at chunk 1.
- ``pointer_walk_plain`` gives the JAX ``viterbi_scan`` path, and the JAX
  ``streaming_pipeline_decode`` path on a 2-device CPU mesh, for T = 1, 2
  and 64; a NumPy model of the walk's chunk-map backtrace gives the JAX
  path (prefixes of one masked T = 999 scan) and the plain walk's at
  T = 1, 2, 31, 32, 33, 64 and 999 with ties in ``alpha``.
- ``parallel.pipeline._pipeline`` on a stand-in stage mesh (the decoder
  rank of two stages, and an emission rank, no world): one
  ``trellis_chunk`` call an arrived chunk, at frames 0, chunk, 2 chunk...,
  equal to the plain chain; ``streaming_pipeline_decode`` one
  ``pointer_walk`` call; no kernel launch counted on the CPU.
- The wrappers' host side on CPU tensors, with ``_build.load`` replaced
  by a NumPy model of both C entries that reads the calls' pointers (the
  row routes' steps; the chunked route's pieces, products and replay; the
  walk's chunk maps): the route rule and the launches counted by route,
  promotion, the caller's ``bt`` slice written in place, ``want_path=False``
  writing none; CUDA stand-ins refused past N = 1024, off float32/float64
  and on a route that cannot take the case, before anything is built; the
  C signatures against the wrappers' ``argtypes``.
"""

import ctypes
import functools
import math
import pathlib
import re
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lnasr_tpu import parallel as JP
from lnasr_tpu.ops.gaussian import gmm_emissions_diag as j_emissions
from lnasr_tpu.ops.trellis import forward_scan as j_forward_scan
from lnasr_tpu.ops.trellis import viterbi_scan as j_viterbi_scan
from lnasr_tpu_torch import _build
from lnasr_tpu_torch.ops import trellis as ttr
from lnasr_tpu_torch.parallel import distributed as D
from lnasr_tpu_torch.parallel import pipeline as tpipe
from tests.test_torch_parallel import _pipe

SOURCE = pathlib.Path(ttr.__file__).parent.parent / "csrc" / "trellis_chunk.cu"
T_LEN = 64

# one jitted scan each, shared by every case (a compile a shape and dtype)
_J_VITERBI = jax.jit(j_viterbi_scan)
_J_FORWARD = jax.jit(j_forward_scan)


def _model(n, t, kind, dtype, seed):
    """``(log_pi, log_a, log_b)`` as NumPy in ``dtype``: ``random``
    (Dirichlet rows, normal emissions), ``ties`` (integers, so equal
    candidates abound, with ``-inf`` transitions, starts and emissions;
    no ``-0.0``, whose order against ``+0.0`` no contract fixes) or ``ltr``
    (left-to-right: ``-inf`` below the diagonal and past the next state)."""
    rng = np.random.default_rng(seed)
    log_pi = np.log(rng.dirichlet(np.ones(n)))
    log_a = np.log(rng.dirichlet(np.ones(n), size=n))
    log_b = rng.normal(scale=2.0, size=(t, n))
    if kind == "ties":
        log_pi = rng.integers(-2, 1, size=n) + 0.0
        log_a = rng.integers(-3, 1, size=(n, n)) + 0.0
        log_b = rng.integers(-4, 1, size=(t, n)) + 0.0
        log_a[rng.random((n, n)) < 0.3] = -np.inf
        log_b[rng.random((t, n)) < 0.1] = -np.inf
        if n > 1:
            log_pi[n - 1] = -np.inf
    elif kind == "ltr":
        i, j = np.indices((n, n))
        log_a = np.where((j == i) | (j == i + 1), np.log(0.5), -np.inf)
        log_a[n - 1, n - 1] = 0.0
        log_pi = np.where(np.arange(n) == 0, 0.0, -np.inf)
    return tuple(x.astype(dtype) for x in (log_pi, log_a, log_b))


def _chunks(t, chunk):
    return [(s, min(s + chunk, t)) for s in range(0, t, chunk)]


def _chain(log_pi, log_a, log_b, chunk, semiring, want_path=True):
    """``trellis_chunk_plain`` over consecutive chunks: each chunk's end
    frame with its ``alpha``, and the pointer rows of the whole utterance."""
    pi, a, lb = (torch.as_tensor(np.array(x)) for x in (log_pi, log_a, log_b))
    alpha = torch.full((lb.shape[1],), -torch.inf, dtype=lb.dtype)
    ends, rows = [], []
    for s, e in _chunks(lb.shape[0], chunk):
        alpha, bt = ttr.trellis_chunk_plain(alpha, s, pi, a, lb[s:e], semiring, want_path)
        ends.append((e - 1, alpha.numpy()))
        rows.append(bt.numpy())
    return ends, np.concatenate(rows)


@functools.lru_cache(maxsize=None)
def _jax_refs(n, kind, dtype, seed):
    """The JAX ``viterbi_scan`` and ``forward_scan`` of one case, as NumPy."""
    args = [jnp.asarray(x) for x in _model(n, T_LEN, kind, dtype, seed)]
    vit = _J_VITERBI(*args)
    fwd = _J_FORWARD(*args)
    return (np.asarray(vit.scores), np.asarray(vit.backptr), np.asarray(vit.path),
            np.asarray(fwd.alpha))


def _bits(x):
    return np.ascontiguousarray(x).view(np.uint8)


CASES = [(n, kind) for n in (1, 4, 33) for kind in ("random", "ties", "ltr")]


@pytest.mark.parametrize("chunk", [1, 7, 16, T_LEN])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,kind", CASES)
def test_max_chunks_bitwise_vs_jax_viterbi(n, kind, dtype, chunk):
    seed = 100 * n + len(kind)
    scores, backptr, _, _ = _jax_refs(n, kind, dtype, seed)
    ends, bt = _chain(*_model(n, T_LEN, kind, dtype, seed), chunk, "max")
    for end, alpha in ends:
        assert alpha.dtype == scores.dtype
        np.testing.assert_array_equal(_bits(alpha), _bits(scores[end]), err_msg=f"frame {end}")
    assert bt.dtype == np.int32
    np.testing.assert_array_equal(bt[0], np.arange(n))
    np.testing.assert_array_equal(bt[1:], backptr[1:])
    if kind == "ties" and n > 1:  # ties were planted, and the first index taken
        log_a = _model(n, T_LEN, kind, dtype, seed)[1]
        cand = scores[:-1, :, None] + log_a  # cand[t - 1, i, j]
        best = cand.max(axis=1, keepdims=True)
        tied = ((cand == best).sum(axis=1) > 1) & np.isfinite(best[:, 0])
        assert tied.sum() > 10
        first = (cand == best).argmax(axis=1)
        np.testing.assert_array_equal(bt[1:][tied], first[tied])


@pytest.mark.parametrize("chunk", [1, 7, 16, T_LEN])
@pytest.mark.parametrize("n,kind", CASES)
def test_log_chunks_vs_jax_forward(n, kind, chunk):
    """Float64 within 1e-12 relative of the JAX forward, ``-inf`` where it
    has ``-inf``; no pointers asked for: none written."""
    seed = 100 * n + len(kind)
    alphas = _jax_refs(n, kind, np.float64, seed)[3]
    ends, bt = _chain(*_model(n, T_LEN, kind, np.float64, seed), chunk, "log", want_path=False)
    for end, alpha in ends:
        np.testing.assert_array_equal(np.isneginf(alpha), np.isneginf(alphas[end]))
        np.testing.assert_allclose(alpha, alphas[end], rtol=1e-12, atol=0, err_msg=f"frame {end}")
    assert not bt.any()


CHUNKED_CASES = [(n, kind) for n in (1, 4, 5, 8) for kind in ("random", "ties", "ltr")]


@pytest.mark.parametrize("chunk", [1, 7, 16, T_LEN])
@pytest.mark.parametrize("n,kind", CHUNKED_CASES)
def test_chunked_route_vs_jax_forward(n, kind, chunk):
    """The chunked route's plain mirror and the NumPy model of the kernel,
    chained over chunks, within 1e-12 relative of the JAX forward at
    float64 with its ``-inf`` pattern; no pointers asked for: none written.
    At chunk 1 the replay's pointers are the plain frame loop's."""
    seed = 100 * n + len(kind)
    alphas = _jax_refs(n, kind, np.float64, seed)[3]
    log_pi, log_a, log_b = _model(n, T_LEN, kind, np.float64, seed)
    pi, a, lb = (torch.as_tensor(x) for x in (log_pi, log_a, log_b))
    mirror = torch.full((n,), -torch.inf, dtype=torch.float64)
    model = mirror.numpy().copy()
    for s, e in _chunks(T_LEN, chunk):
        mirror, bt = ttr.trellis_chunk_chunked_plain(mirror, s, pi, a, lb[s:e])
        assert not bt.any()
        model, rows = stage_model(model, s, log_pi, log_a, log_b[s:e], 1, chunk == 1, "chunked",
                                  ttr.stage_pieces(e - s - (s == 0))[1])
        for got in (mirror.numpy(), model):
            np.testing.assert_array_equal(np.isneginf(got), np.isneginf(alphas[e - 1]))
            np.testing.assert_allclose(got, alphas[e - 1], rtol=1e-12, atol=0,
                                       err_msg=f"frame {e - 1}")
        if chunk == 1:
            prev = torch.as_tensor(alphas[s - 1].copy()) if s else mirror
            want = ttr.trellis_chunk_plain(prev, s, pi, a, lb[s:e], "log", True)[1]
            got = ttr.trellis_chunk_chunked_plain(prev, s, pi, a, lb[s:e], True)[1]
            np.testing.assert_array_equal(got.numpy(), want.numpy())
            np.testing.assert_array_equal(stage_model(alphas[s - 1] if s else model, s, log_pi,
                                                      log_a, log_b[s:e], 1, True, "chunked",
                                                      1)[1], want.numpy())


@pytest.mark.parametrize("t", [1, 2, T_LEN])
def test_walk_vs_jax_viterbi(t):
    for n, kind in CASES:
        args = _model(n, t, kind, np.float64, 7 * n + t)
        ref = _J_VITERBI(*(jnp.asarray(x) for x in args))
        ends, bt = _chain(*args, 16, "max")
        path = ttr.pointer_walk_plain(torch.as_tensor(ends[-1][1]), torch.as_tensor(bt))
        assert path.dtype == torch.int32 and path.shape == (t,)
        np.testing.assert_array_equal(path.numpy(), np.asarray(ref.path), err_msg=f"{n} {kind}")


@pytest.mark.parametrize("t,chunk", [(1, 1), (2, 1), (T_LEN, 16)])
def test_walk_vs_jax_pipeline(t, chunk):
    """The decoder stage's chain and walk on the JAX emissions give the JAX
    2-stage pipeline's path and score."""
    log_pi, log_a, log_w, mu, var, feats = _pipe(60 + t, t)
    log_b = np.asarray(j_emissions(jnp.asarray(feats), jnp.asarray(log_w), jnp.asarray(mu),
                                   jnp.asarray(var))[0])
    ref_path, ref_score = JP.streaming_pipeline_decode(
        *(jnp.asarray(x) for x in (log_pi, log_a, log_w, mu, var, feats)),
        JP.make_stage_mesh(jax.devices()[:2]), chunk=chunk)
    ends, bt = _chain(log_pi, log_a, log_b, chunk, "max")
    alpha = torch.as_tensor(ends[-1][1])
    path = ttr.pointer_walk_plain(alpha, torch.as_tensor(bt))
    np.testing.assert_array_equal(path.numpy(), np.asarray(ref_path))
    np.testing.assert_allclose(float(alpha.max()), float(ref_score), rtol=1e-10)


@functools.lru_cache(maxsize=None)
def _jax_masked_999(n):
    """One JAX ``viterbi_scan`` at T = 999 (planted ties) and its masked
    prefixes' paths: with frames T... masked, the scan keeps ``v`` and
    points every state to itself, so ``path[:T]`` is the T-frame path and
    ``backptr[:T]`` its pointers, all from one compile a shape."""
    args = [jnp.asarray(x) for x in _model(n, 999, "ties", np.float64, 50 + n)]
    out = {}
    for t in (1, 2, 31, 32, 33, 64, 999):
        mask = jnp.asarray(np.arange(999) < t)
        ref = _J_VITERBI(*args, mask)
        out[t] = (np.asarray(ref.scores)[t - 1], np.asarray(ref.backptr)[:t].astype(np.int32),
                  np.asarray(ref.path)[:t])
    return out


@pytest.mark.parametrize("t", [1, 2, 31, 32, 33, 64, 999])
@pytest.mark.parametrize("n", [5, 33])
def test_walk_model_vs_jax_viterbi(n, t):
    """The chunk-map walk on the JAX scan's own pointers and final row gives
    the JAX path, bit for bit, and so does the plain walk; ties in the
    final row are planted (integer scores)."""
    v, backptr, ref = _jax_masked_999(n)[t]
    backptr = backptr.copy()
    backptr[0] = 0
    if t == 999:
        assert (v == v.max()).sum() > 1  # the first of the tied states is taken
    np.testing.assert_array_equal(walk_model(v, backptr), ref)
    np.testing.assert_array_equal(
        ttr.pointer_walk_plain(torch.as_tensor(v.copy()), torch.as_tensor(backptr)).numpy(), ref)


# -- the caller: _pipeline on a stand-in stage mesh, no world ------------------------


class _StageMesh:
    """What ``_pipeline`` reads of a 2-stage mesh, as rank ``idx`` sees it."""

    def __init__(self, idx):
        self.idx = idx

    def get_coordinate(self):
        return [self.idx]

    def size(self, dim):
        return 2

    def get_group(self, name):
        return None


def _stand_in_world(monkeypatch, idx, log_b, chunk):
    """Rank ``idx`` of a 2-stage pipeline: the ring delivers to the decoder
    (rank 1) chunk k's complete emissions at the end of tick k, as the
    emission stage sends them; the closing collectives see a world of one."""
    ticks = []

    def ppermute(x, axis, perm):
        k = len(ticks)
        ticks.append(x)
        if idx == 1 and k * chunk < log_b.shape[0]:
            return log_b[k * chunk:(k + 1) * chunk]
        return torch.zeros_like(x)

    monkeypatch.setattr(tpipe, "ppermute", ppermute)
    monkeypatch.setattr(tpipe, "_world", lambda: D.Axis("world", None, 1, 0))
    return ticks


def _pipe_tensors(seed, t):
    log_pi, log_a, log_w, mu, var, feats = (torch.as_tensor(x) for x in _pipe(seed, t))
    log_b = tpipe.gmm_emissions_diag(feats, log_w, mu, var)[0]
    return (log_pi, log_a, log_w, mu, var, feats), log_b


@pytest.mark.parametrize("semiring,want_path", [("max", True), ("log", False)])
def test_decoder_stage_one_call_a_chunk(monkeypatch, semiring, want_path):
    args, log_b = _pipe_tensors(5, T_LEN)
    chunk = 16
    calls = []

    def counting(alpha, pos, *rest):
        calls.append((pos, rest[2].shape))
        return ttr.trellis_chunk(alpha, pos, *rest)

    monkeypatch.setattr(tpipe, "trellis_chunk", counting)
    launches = ttr.trellis_chunk.launches
    ticks = _stand_in_world(monkeypatch, 1, log_b, chunk)
    alpha, bt = tpipe._pipeline(*args, _StageMesh(1), chunk, semiring, want_path)
    assert calls == [(s, (chunk, 4)) for s in range(0, T_LEN, chunk)]
    assert len(ticks) == T_LEN // chunk + 1
    assert ttr.trellis_chunk.launches == launches  # CPU tensors: the plain loop
    ends, rows = _chain(args[0], args[1], log_b, chunk, semiring, want_path)
    np.testing.assert_array_equal(_bits(alpha.numpy()), _bits(ends[-1][1]))
    np.testing.assert_array_equal(bt.numpy(), rows)

    calls.clear()
    _stand_in_world(monkeypatch, 0, log_b, chunk)  # the emission stage decodes nothing
    alpha0, bt0 = tpipe._pipeline(*args, _StageMesh(0), chunk, semiring, want_path)
    assert calls == [] and bool(torch.isneginf(alpha0).all()) and not bt0.any()


def test_decode_walks_once(monkeypatch):
    args, log_b = _pipe_tensors(6, T_LEN)
    walks = []

    def counting(alpha, bt):
        walks.append(bt.shape)
        return ttr.pointer_walk(alpha, bt)

    monkeypatch.setattr(tpipe, "pointer_walk", counting)
    launches = ttr.pointer_walk.launches
    _stand_in_world(monkeypatch, 1, log_b, 16)
    path, score = tpipe.streaming_pipeline_decode(*args, _StageMesh(1), chunk=16)
    assert walks == [(T_LEN, 4)] and ttr.pointer_walk.launches == launches
    ref = _J_VITERBI(*(jnp.asarray(x.numpy()) for x in (args[0], args[1], log_b)))
    np.testing.assert_array_equal(path.numpy(), np.asarray(ref.path))
    assert path.dtype == torch.int32
    np.testing.assert_allclose(float(score), float(ref.score), rtol=1e-10)


# -- the wrappers' host side against a model of the kernels --------------------------


def _pair_sum(e, lo, hi):
    """The kernel's ``pair_sum``: ``e[lo..hi)`` summed over axis 0 in a fixed
    pairwise order."""
    if hi - lo == 1:
        return e[lo]
    mid = lo + (hi - lo + 1) // 2
    return _pair_sum(e, lo, mid) + _pair_sum(e, mid, hi)


def _lse64(x, axis):
    """The kernel's ``lse64`` over ``axis`` in float64: the maximum as the
    shift (0 where it is ``-inf``, then the result is ``-inf``), the exps
    summed in ``pair_sum``'s order."""
    x = np.moveaxis(np.asarray(x, np.float64), axis, 0)
    m = x.max(axis=0)
    shift = np.where(np.isneginf(m), 0.0, m)
    with np.errstate(divide="ignore"):
        total = np.log(_pair_sum(np.exp(x - shift), 0, x.shape[0]))
    return np.where(np.isneginf(m), m, shift + total)


def stage_model(alpha, pos0, pi, a, lb, log_semiring, want_path, route="warp", piece=0):
    """What ``trellis_chunk_launch`` computes on ``route``. The row routes
    (``warp``, ``block``), row by row in the working type: row r is frame
    pos0 + r; frame 0 is ``pi + lb[0]`` with the pointers ``arange(N)``;
    every other row forms the candidates with one rounding, keeps the first
    maximal index, and in the log semiring adds ``log(sum exp(c - shift))``
    to the shift (0 where the maximum is ``-inf``), the sum in float64. The
    chunked route (the log semiring), in float64: the stepped rows (rows
    1... where row 0 is frame 0, whose ``alpha`` is ``pi + lb[0]`` in the
    working type) cut into pieces of ``piece`` rows, each piece's product
    from the identity, lane (row, col)'s step ``lse_i(P[row, i] + a[i,
    col]) + lb[r, col]``; ``alpha`` through the products; with pointers,
    each piece replayed from the ``alpha`` entering it, the candidates
    formed in the working type from it rounded to that type."""
    chunk, n = lb.shape
    dt = lb.dtype
    bt = np.zeros((chunk, n), np.int32)
    if route == "chunked":
        first = 1 if pos0 == 0 else 0
        v = (pi + lb[0]).astype(dt).astype(np.float64) if first else alpha.astype(np.float64)
        a64, b64 = a.astype(np.float64), lb.astype(np.float64)
        if first:
            bt[0] = np.arange(n)
        starts = list(range(first, chunk, piece)) or [first]
        for s in starts:  # phase 2 through phase 1's product of each piece
            prod = np.where(np.eye(n, dtype=bool), 0.0, -np.inf)
            for r in range(s, min(s + piece, chunk)):
                prod = _lse64(prod[:, :, None] + a64[None], axis=1) + b64[r][None, :]
            state = v
            v = _lse64(v[:, None] + prod, axis=0)
            for r in range(s, min(s + piece, chunk)):  # phase 3: the replay
                bt[r] = np.argmax(state.astype(dt)[:, None] + a, axis=0)
                state = _lse64(state[:, None] + a64, axis=0) + b64[r]
        return v.astype(dt), (bt if want_path else None)
    v = alpha.copy()
    for r in range(chunk):
        if pos0 + r == 0:
            v = pi + lb[r]
            bt[r] = np.arange(n)
            continue
        c = v[:, None] + a
        best, arg = c.max(axis=0), c.argmax(axis=0)
        if log_semiring:
            shift = np.where(np.isneginf(best), 0.0, best).astype(lb.dtype)
            with np.errstate(invalid="ignore", divide="ignore"):
                total = np.exp((c - shift).astype(np.float64)).sum(axis=0)
                lse = (shift + np.log(total).astype(lb.dtype)).astype(lb.dtype)
            best = np.where(np.isneginf(best), best, lse)
        v = best + lb[r]
        bt[r] = arg
    return v, (bt if want_path else None)


def walk_model(alpha, bt, route="maps"):
    """What ``pointer_walk_launch`` does: the first argmax of ``alpha`` by
    32 lanes (lane l scans l, l + 32, ... with a strict >, then a (value,
    index) butterfly keeping the lower index); on the map route the chunks
    of :func:`ops.trellis.walk_chunks`: (a) chunk c walked from each end
    state e down to its start, ``maps[c, e]``; (b) the chunks' end states
    composed from the last chunk down; (c) each chunk walked again from its
    end state, writing its part of the path. On the chase route one
    thread's walk through memory."""
    t, n = bt.shape
    best = [(alpha[lane], lane) if lane < n else (-np.inf, 1 << 30) for lane in range(32)]
    for lane in range(32):
        for i in range(lane + 32, n, 32):
            if alpha[i] > best[lane][0]:
                best[lane] = (alpha[i], i)
    for off in (16, 8, 4, 2, 1):
        nxt = list(best)
        for lane in range(32):
            (bv, bi), (ov, oi) = best[lane], best[lane ^ off]
            if ov > bv or (ov == bv and oi < bi):
                nxt[lane] = (ov, oi)
        best = nxt
    last = best[0][1]
    path = np.full(t, -1, np.int32)
    path[t - 1] = last
    if route == "chase":
        s = last
        for q in range(t - 2, -1, -1):
            s = bt[q + 1, s]
            path[q] = s
        return path
    n_chunks, piece = ttr.walk_chunks(t, n)
    spans = [(min((c + 1) * piece, t - 1), c * piece + 1) for c in range(n_chunks)]
    maps = np.zeros((n_chunks, n), np.int16)
    for c, (top, low) in enumerate(spans):  # (a)
        for e in range(n):
            s = e
            for q in range(top, low - 1, -1):
                s = bt[q, s]
            maps[c, e] = s
    ends = np.zeros(n_chunks, np.int16)
    if n_chunks:  # (b)
        e = last
        ends[-1] = e
        for c in range(n_chunks - 1, 0, -1):
            e = maps[c, e]
            ends[c - 1] = e
    for c, (top, low) in enumerate(spans):  # (c)
        s = ends[c]
        for q in range(top, low - 1, -1):
            s = bt[q, s]
            path[q - 1] = s
    return path


class _Entry:
    """A C entry of the model library: ctypes' ``argtypes`` and ``restype``
    can be set on it, as on the real one."""

    def __init__(self, fn):
        self.fn = fn

    def __call__(self, *args):
        return self.fn(*args)


class _ModelLibrary:
    """Stands in for the built ``trellis_chunk`` library: reads the C calls'
    pointers (CPU tensors' addresses) and writes the models' results where
    the kernels would."""

    def __init__(self):
        self.calls = []
        self.trellis_chunk_launch = _Entry(self._chunk)
        self.pointer_walk_launch = _Entry(self._walk)

    @staticmethod
    def _view(ptr, dtype, shape):
        count = int(np.prod(shape))
        buf = (ctypes.c_char * (count * np.dtype(dtype).itemsize)).from_address(ptr)
        return np.frombuffer(buf, dtype=dtype).reshape(shape)

    def _chunk(self, alpha, pos0, pi, a, lb, chunk, n, semiring, route, piece, is_double, out,
               bt, stream):
        route = ttr.STAGE_ROUTES[route]
        self.calls.append(dict(entry="chunk", pos0=pos0, chunk=chunk, n=n, semiring=semiring,
                               route=route, piece=piece, is_double=is_double, bt=bt))
        dt = np.float64 if is_double else np.float32
        v, rows = stage_model(self._view(alpha, dt, (n,)).copy(), pos0,
                              self._view(pi, dt, (n,)).copy(), self._view(a, dt, (n, n)).copy(),
                              self._view(lb, dt, (chunk, n)).copy(), semiring, bt is not None,
                              route, piece)
        self._view(out, dt, (n,))[...] = v
        if bt is not None:
            self._view(bt, np.int32, (chunk, n))[...] = rows
        return 0

    def _walk(self, alpha, n, bt, t, route, n_chunks, piece, staged, is_double, path, stream):
        route = ttr.WALK_ROUTES[route]
        self.calls.append(dict(entry="walk", n=n, t=t, route=route, n_chunks=n_chunks,
                               piece=piece, staged=staged, is_double=is_double))
        dt = np.float64 if is_double else np.float32
        self._view(path, np.int32, (t,))[...] = walk_model(
            self._view(alpha, dt, (n,)).copy(), self._view(bt, np.int32, (t, n)).copy(), route)
        return 0


@pytest.fixture
def model_library(monkeypatch):
    """The wrappers take their kernel paths on CPU tensors, against the
    models."""
    lib = _ModelLibrary()
    monkeypatch.setattr(_build, "load", lambda name, argtypes: lib)
    monkeypatch.setattr(ttr, "_on_cuda", lambda x: True)

    class _NoDevice:
        def __init__(self, dev):
            pass

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch.cuda, "device", _NoDevice)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(cuda_stream=0))
    return lib


@pytest.mark.parametrize("semiring", ["max", "log"])
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,kind", [(1, "random"), (5, "ties"), (5, "ltr"), (33, "ties"),
                                    (40, "random")])
def test_wrappers_against_the_model(model_library, n, kind, dtype, semiring):
    """The chunk launches carry ``alpha`` as the plain chain does (max-plus
    bitwise, the log semiring within 1e-12 at float64 and 1e-5 at float32),
    writing their pointer rows into the caller's slices; the walk gives the
    plain walk's path."""
    t, chunk = 45, 9
    log_pi, log_a, log_b = (torch.as_tensor(x) for x in _model(n, t, kind, dtype, 3 * n))
    bts = torch.full((t // chunk + 1, chunk, n), -1, dtype=torch.int32)
    alpha = torch.full((n,), -torch.inf, dtype=log_b.dtype)
    route = ttr.trellis_chunk_route(n, semiring)
    assert route == ("chunked" if semiring == "log" and n <= 8 else "warp" if n <= 32 else "block")
    by_route = dict(ttr.trellis_chunk.route_launches)
    before = (ttr.trellis_chunk.launches, ttr.pointer_walk.launches)
    ends, rows = _chain(log_pi.numpy(), log_a.numpy(), log_b.numpy(), chunk, semiring)
    for k, (s, e) in enumerate(_chunks(t, chunk)):
        alpha, bt = ttr.trellis_chunk(alpha, s, log_pi, log_a, log_b[s:e], semiring, True,
                                      bts[k + 1])
        assert bt.data_ptr() == bts[k + 1].data_ptr()
        if semiring == "max":
            np.testing.assert_array_equal(_bits(alpha.numpy()), _bits(ends[k][1]))
        else:
            np.testing.assert_allclose(alpha.numpy(), ends[k][1],
                                       rtol=1e-12 if dtype == np.float64 else 1e-5)
    assert model_library.calls[0]["pos0"] == 0 and model_library.calls[1]["pos0"] == chunk
    assert ttr.trellis_chunk.launches == before[0] + t // chunk
    assert ttr.trellis_chunk.route_launches[route] == by_route[route] + t // chunk
    assert {c["route"] for c in model_library.calls} == {route}
    if route == "chunked":  # pieces of the stepped rows: 8 after frame 0, then 9
        assert [c["piece"] for c in model_library.calls[:2]] == [ttr.stage_pieces(8)[1],
                                                                 ttr.stage_pieces(9)[1]]
        # the replay's pointers, every row of the caller's slices written;
        # frame 0 points to itself
        assert ((bts[1:] >= 0) & (bts[1:] < n)).all() and (bts[1, 0] == torch.arange(n)).all()
    flat = bts[1:].reshape(t, n)
    if semiring == "max":
        np.testing.assert_array_equal(flat.numpy(), rows)
        walks = dict(ttr.pointer_walk.route_launches)
        path = ttr.pointer_walk(alpha, flat)
        assert ttr.pointer_walk.launches == before[1] + 1
        assert ttr.pointer_walk.route_launches["maps"] == walks["maps"] + 1
        call = model_library.calls[-1]
        assert (call["route"], call["n_chunks"], call["piece"], call["staged"]) == (
            "maps", *ttr.walk_chunks(t, n), 1)
        np.testing.assert_array_equal(path.numpy(), ttr.pointer_walk_plain(alpha, flat).numpy())
    assert (bts[0] == -1).all()


def test_chunk_launch_promotes_and_skips_pointers(model_library):
    """float32 inputs with a float64 ``log_a`` run at float64, as the plain
    loop's adds promote; ``want_path=False`` passes no pointer buffer and
    leaves ``bt`` as it was."""
    log_pi, log_a, log_b = (torch.as_tensor(x) for x in _model(5, 12, "random", np.float32, 4))
    alpha, bt = ttr.trellis_chunk(torch.zeros(5), 3, log_pi, log_a.double(), log_b)
    ref, _ = ttr.trellis_chunk_plain(torch.zeros(5), 3, log_pi, log_a.double(), log_b)
    assert alpha.dtype == torch.float64 and model_library.calls[-1]["is_double"] == 1
    assert model_library.calls[-1]["bt"] is None and not bt.any()
    np.testing.assert_array_equal(_bits(alpha.numpy()), _bits(ref.numpy()))


@pytest.mark.parametrize("t", [1, 2, 31, 32, 33, 64, 65, 999])
@pytest.mark.parametrize("n", [1, 5, 32, 33, 70])
def test_walk_model_bitwise_vs_plain(t, n):
    """The walk's chunk maps (chunks of ``walk_chunks``, their edges at
    T = 31-33 and 64-65) and its chase through memory; ties in ``alpha``
    keep the first state."""
    rng = np.random.default_rng(t * 100 + n)
    bt = rng.integers(0, n, size=(t, n)).astype(np.int32)
    alpha = np.round(rng.normal(size=n))
    alpha[rng.random(n) < 0.3] = -np.inf
    ref = ttr.pointer_walk_plain(torch.as_tensor(alpha), torch.as_tensor(bt)).numpy()
    np.testing.assert_array_equal(walk_model(alpha, bt), ref)
    np.testing.assert_array_equal(walk_model(alpha, bt, "chase"), ref)
    np.testing.assert_array_equal(walk_model(np.full(n, -np.inf), bt)[-1], 0)


def test_cpu_never_builds(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda *a: pytest.fail("CPU tensors reached _build"))
    log_pi, log_a, log_b = (torch.as_tensor(x) for x in _model(4, 10, "random", np.float64, 1))
    before = (ttr.trellis_chunk.launches, ttr.pointer_walk.launches)
    alpha, bt = ttr.trellis_chunk(torch.zeros(4), 0, log_pi, log_a, log_b, "max", True)
    ttr.pointer_walk(alpha, bt)
    assert (ttr.trellis_chunk.launches, ttr.pointer_walk.launches) == before


class _CudaStandIn:
    """A CUDA tensor's device, dtype and shape: all the wrappers read before
    they refuse."""

    def __init__(self, shape, dtype=torch.float32):
        self.device, self.dtype, self.shape = torch.device("cuda"), dtype, tuple(shape)

    def dim(self):
        return len(self.shape)


def test_cuda_refuses_instead_of_the_loop(monkeypatch):
    """On CUDA tensors the wrappers launch or raise: past N = 1024, off
    float32/float64, a bad semiring or shape, no frame; nothing is built
    and nothing falls back to the plain versions."""
    monkeypatch.setattr(_build, "load", lambda *a: pytest.fail("built for a refused call"))
    monkeypatch.setattr(ttr, "trellis_chunk_plain", lambda *a: pytest.fail("fell back"))
    monkeypatch.setattr(ttr, "pointer_walk_plain", lambda *a: pytest.fail("fell back"))
    s = _CudaStandIn
    before = (ttr.trellis_chunk.launches, ttr.pointer_walk.launches)
    with pytest.raises(ValueError, match="N <= 1024"):
        ttr.trellis_chunk(s((1025,)), 0, s((1025,)), s((1025, 1025)), s((8, 1025)))
    f16 = torch.float16
    with pytest.raises(ValueError, match="float32 or float64"):
        ttr.trellis_chunk(s((5,), f16), 0, s((5,), f16), s((5, 5), f16), s((8, 5), f16))
    with pytest.raises(ValueError, match="semiring"):
        ttr.trellis_chunk(s((5,)), 0, s((5,)), s((5, 5)), s((8, 5)), "sum")
    with pytest.raises(ValueError, match="alpha"):
        ttr.trellis_chunk(s((4,)), 0, s((5,)), s((5, 5)), s((8, 5)))
    with pytest.raises(ValueError, match="chunk >= 1"):
        ttr.trellis_chunk(s((5,)), 0, s((5,)), s((5, 5)), s((0, 5)))
    with pytest.raises(ValueError, match="float32 or float64"):
        ttr.pointer_walk(s((5,), f16), s((8, 5), torch.int32))
    with pytest.raises(ValueError, match="int32"):
        ttr.pointer_walk(s((5,)), s((8, 5), torch.int64))
    with pytest.raises(ValueError, match="T >= 1"):
        ttr.pointer_walk(s((5,)), s((0, 5), torch.int32))
    with pytest.raises(ValueError, match="no route 'chunked'"):
        ttr._chunk_launch(s((5,)), 0, s((5,)), s((5, 5)), s((8, 5)), "max", False, None,
                          route="chunked")
    with pytest.raises(ValueError, match="no route 'chunked'"):
        ttr._chunk_launch(s((9,)), 0, s((9,)), s((9, 9)), s((8, 9)), "log", False, None,
                          route="chunked")
    with pytest.raises(ValueError, match="no route 'warp'"):
        ttr._chunk_launch(s((33,)), 0, s((33,)), s((33, 33)), s((8, 33)), "max", False, None,
                          route="warp")
    with pytest.raises(ValueError, match="no route 'maps'"):
        ttr._walk_launch(s((1025,)), s((8, 1025), torch.int32), route="maps")
    assert (ttr.trellis_chunk.launches, ttr.pointer_walk.launches) == before
    assert ttr.trellis_chunk_route(32) == "warp" and ttr.trellis_chunk_route(33) == "block"
    assert ttr.trellis_chunk_route(1024) == "block"
    assert [ttr.trellis_chunk_route(n, "log") for n in (1, 8, 9, 32, 33)] == [
        "chunked", "chunked", "warp", "warp", "block"]
    assert ttr.walk_route(1024) == "maps" and ttr.walk_route(1025) == "chase"


def _signature(src, name):
    sig = re.search(rf'extern "C" int {name}\(([^)]*)\)', src)
    assert sig is not None, name
    return [p.strip() for p in sig.group(1).split(",")]


def test_source_exports_what_the_wrappers_bind():
    """Both C entries take as many arguments as their ``argtypes`` name
    (ctypes cuts a pointer to 32 bits where one is missing), pointers where
    they have pointers; the adds are IEEE intrinsics and the maxima keep
    the first index (strict >)."""
    src = SOURCE.read_text()
    for name, argtypes in (("trellis_chunk_launch", ttr._CHUNK_ARGTYPES),
                           ("pointer_walk_launch", ttr._WALK_ARGTYPES)):
        params = _signature(src, name)
        assert len(params) == len(argtypes)
        assert ["*" in p for p in params] == [t is ctypes.c_void_p for t in argtypes], name
    names = [p.split()[-1].lstrip("*") for p in _signature(src, "trellis_chunk_launch")]
    assert names == ["alpha", "pos0", "log_pi", "log_a", "log_b", "chunk", "N", "semiring",
                     "route", "piece", "is_double", "alpha_out", "bt", "stream"]
    names = [p.split()[-1].lstrip("*") for p in _signature(src, "pointer_walk_launch")]
    assert names == ["alpha", "N", "bt", "T", "route", "n_chunks", "piece", "staged",
                     "is_double", "path", "stream"]
    assert 'extern "C" const char* trellis_chunk_error_string(int err)' in src
    code = re.sub(r"//[^\n]*", "", src)
    assert "__fadd_rn" in code and "__dadd_rn" in code
    assert "const bool right = rv > lv;" in code and "if (c > best)" in code
    assert "atomic" not in code
    # the routes' codes and limits as the host names them
    for name, value in (("ROUTE_WARP", 0), ("ROUTE_BLOCK", 1), ("ROUTE_CHUNKED", 2),
                        ("CHUNKED_MAX_N", ttr.CHUNK_MAX_N), ("MAX_PIECES", ttr.STAGE_MAX_PIECES),
                        ("WALK_MAPS", 0), ("WALK_CHASE", 1), ("WALK_MAX_N", ttr.WALK_MAX_N)):
        assert re.search(rf"\b{name} = {value}\b", code), name
    assert ttr.STAGE_ROUTES == ("warp", "block", "chunked")
    assert ttr.WALK_ROUTES == ("maps", "chase")


@pytest.mark.parametrize("steps", [0, 1, 2, 10, 110, 111, 1000, 1024, 1025, 100_000])
def test_stage_pieces(steps):
    """The chunked route's pieces cover the stepped rows, at most 32 of
    them, none empty, and cut the chain to about 2 sqrt(rows)."""
    c, piece = ttr.stage_pieces(steps)
    assert 1 <= c <= ttr.STAGE_MAX_PIECES and piece >= 1
    if steps:
        assert (c - 1) * piece < steps <= c * piece
        assert c + piece <= max(2 * math.isqrt(steps) + 3, -(-steps // 32) + 32)
    assert ttr.stage_pieces(110) == (10, 11) and ttr.stage_pieces(111) == (11, 11)


@pytest.mark.parametrize("t", [1, 2, 31, 32, 33, 999, 100_000])
@pytest.mark.parametrize("n", [1, 5, 32, 257, 1024])
def test_walk_chunks(t, n):
    """The walk's chunks cover the T - 1 pointer rows, none empty, the
    maps within their bytes; the rows staged where they fit."""
    c, piece = ttr.walk_chunks(t, n)
    if t == 1:
        assert (c, piece) == (0, 1)
    else:
        assert (c - 1) * piece < t - 1 <= c * piece
        assert 2 * c * (n + 1) <= ttr.WALK_MAP_BYTES
    assert ttr.walk_staged(t, n) == (2 * t * n <= ttr.WALK_ROWS_BYTES)
    assert ttr.walk_chunks(999, 5) == (44, 23)
