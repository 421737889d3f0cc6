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
- ``pointer_walk_plain`` gives the JAX ``viterbi_scan`` path, and the JAX
  ``streaming_pipeline_decode`` path on a 2-device CPU mesh, for T = 1, 2
  and 64.
- ``parallel.pipeline._pipeline`` on a stand-in stage mesh (the decoder
  rank of two stages, and an emission rank, no world): one
  ``trellis_chunk`` call an arrived chunk, at frames 0, chunk, 2 chunk...,
  equal to the plain chain; ``streaming_pipeline_decode`` one
  ``pointer_walk`` call; no kernel launch counted on the CPU.
- The wrappers' host side on CPU tensors, with ``_build.load`` replaced
  by a NumPy model of both C entries that reads the calls' pointers (the
  warp route's groups of rows, the walk's groups of 32 pointer rows held
  by lanes and walked by shuffles): promotion, the caller's ``bt`` slice
  written in place, ``want_path=False`` writing none; CUDA stand-ins
  refused past N = 1024 and off float32/float64 before anything is built;
  the C signatures against the wrappers' ``argtypes``.
"""

import ctypes
import functools
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


def stage_model(alpha, pos0, pi, a, lb, log_semiring, want_path):
    """What ``trellis_chunk_launch`` computes, row by row in the working
    type: row r is frame pos0 + r; frame 0 is ``pi + lb[0]`` with the
    pointers ``arange(N)``; every other row forms the candidates with one
    rounding, keeps the first maximal index, and in the log semiring adds
    ``log(sum exp(c - shift))`` to the shift (0 where the maximum is
    ``-inf``), the sum in float64."""
    chunk, n = lb.shape
    bt = np.zeros((chunk, n), np.int32)
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


def walk_model(alpha, bt):
    """What ``pointer_walk_launch`` does: the first argmax of ``alpha`` by
    32 lanes (lane l scans l, l + 32, ... with a strict >, then a (value,
    index) butterfly keeping the lower index); for N <= 32 the pointer rows
    in groups of 32 from the last (lane k holds column k of rows hi, hi - 1,
    ..., hi - 31), each step a shuffle from lane ``s``, lane q keeping the
    state of step q and writing ``path[hi - q - 1]``; past 32 states one
    thread's chase through memory."""
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
    s = best[0][1]
    path = np.full(t, -1, np.int32)
    path[t - 1] = s
    if n > 32:
        for q in range(t - 2, -1, -1):
            s = bt[q + 1, s]
            path[q] = s
        return path
    for hi in range(t - 1, 0, -32):
        regs = [[bt[hi - q, k] if k < n and hi - q >= 1 else 0 for q in range(32)]
                for k in range(32)]
        mine = [0] * 32
        for q in range(32):
            if hi - q < 1:
                break
            s = regs[s][q]
            mine[q] = s
        for lane in range(32):
            if hi - lane >= 1:
                path[hi - lane - 1] = mine[lane]
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

    def _chunk(self, alpha, pos0, pi, a, lb, chunk, n, semiring, is_double, out, bt, stream):
        self.calls.append(dict(entry="chunk", pos0=pos0, chunk=chunk, n=n, semiring=semiring,
                               is_double=is_double, bt=bt))
        dt = np.float64 if is_double else np.float32
        v, rows = stage_model(self._view(alpha, dt, (n,)).copy(), pos0,
                              self._view(pi, dt, (n,)).copy(), self._view(a, dt, (n, n)).copy(),
                              self._view(lb, dt, (chunk, n)).copy(), semiring, bt is not None)
        self._view(out, dt, (n,))[...] = v
        if bt is not None:
            self._view(bt, np.int32, (chunk, n))[...] = rows
        return 0

    def _walk(self, alpha, n, bt, t, is_double, path, stream):
        self.calls.append(dict(entry="walk", n=n, t=t, is_double=is_double))
        dt = np.float64 if is_double else np.float32
        self._view(path, np.int32, (t,))[...] = walk_model(
            self._view(alpha, dt, (n,)).copy(), self._view(bt, np.int32, (t, n)).copy())
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
    bts = torch.zeros((t // chunk + 1, chunk, n), dtype=torch.int32)
    alpha = torch.full((n,), -torch.inf, dtype=log_b.dtype)
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
    flat = bts[1:].reshape(t, n)
    if semiring == "max":
        np.testing.assert_array_equal(flat.numpy(), rows)
        path = ttr.pointer_walk(alpha, flat)
        assert ttr.pointer_walk.launches == before[1] + 1
        np.testing.assert_array_equal(path.numpy(), ttr.pointer_walk_plain(alpha, flat).numpy())
    assert not bts[0].any()


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
    """The walk's groups of 32 pointer rows, and its chase past 32 states,
    at the edges of a group; ties in ``alpha`` keep the first state."""
    rng = np.random.default_rng(t * 100 + n)
    bt = rng.integers(0, n, size=(t, n)).astype(np.int32)
    alpha = np.round(rng.normal(size=n))
    alpha[rng.random(n) < 0.3] = -np.inf
    ref = ttr.pointer_walk_plain(torch.as_tensor(alpha), torch.as_tensor(bt)).numpy()
    np.testing.assert_array_equal(walk_model(alpha, bt), ref)
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
    assert (ttr.trellis_chunk.launches, ttr.pointer_walk.launches) == before
    assert ttr.trellis_chunk_route(32) == "warp" and ttr.trellis_chunk_route(33) == "block"
    assert ttr.trellis_chunk_route(1024) == "block"


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
                     "is_double", "alpha_out", "bt", "stream"]
    assert 'extern "C" const char* trellis_chunk_error_string(int err)' in src
    code = re.sub(r"//[^\n]*", "", src)
    assert "__fadd_rn" in code and "__dadd_rn" in code
    assert "const bool right = rv > lv;" in code and "if (c > best)" in code
    assert "atomic" not in code
