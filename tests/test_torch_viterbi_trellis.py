"""Kernel K (``csrc/viterbi_trellis.cu``, the masked Viterbi trellis behind
every HMM decode) on the CPU, where it cannot run: its plain version, its
route and chunk rules, and its wrapper's host side.

- ``ops.trellis.viterbi_scan_plain`` bitwise against the JAX package's
  jitted ``viterbi_scan`` (vmapped over the batch) at float32 and float64
  in all four outputs (trellis, backpointers, path, score): ragged masks
  with a 1-frame utterance and holes, ``log_final`` with ``-inf``
  entries and all ``-inf`` (the final argmax gives state 0), ``-inf``
  rows and columns of ``log_a``, planted ties, T = 1, N = 1, 5 and 33.
- ``viterbi_trellis_route`` and ``viterbi_chunks``: every N up to 1024
  has a route, N = 1025 none; the chunks cover the steps within the
  route's shared-memory budget.
- A NumPy model of the warp route's forward (``warp_forward_model``):
  groups of G frames (32 at float32, 16 at float64) aligned to frame 0,
  the group's mask as one ballot word (bit k: frame t0 + k, bit 0 of the
  first group cleared, so frame 0 keeps ``v`` and points to state 0), a
  branch-free step whose select keeps ``v`` on masked frames, the rows
  staged and copied a group at a time; bitwise the plain loop's at T = 1,
  2, 31, 32, 33 and 999, with every frame after the first masked, the
  first frames masked, and ragged masks.
- The wrapper's host side on CPU tensors, with ``_build.load`` replaced by
  a NumPy model of the kernel (the warp route's group forward, or the
  block route's adds and first-index argmax, then the chunk-map backtrace
  at the wrapper's chunking, reading the int8 copy or the int32 output as
  the on-chip rule says) that reads the C call's pointers: flattening,
  promotion, mask broadcast, forced routes; all four outputs bitwise the
  plain loop's. Through it,
  ``HMM.decode_batch``, ``GMMHMM.decode_batch`` and the segmenter make one
  launch a call (a sentence) and decode as the JAX package does.
- ``viterbi_plain`` and ``viterbi_dense_plain`` (kernels B's and C's plain
  versions) call the plain loop, never the dispatch; CPU tensors never
  reach ``_build``; CUDA stand-ins are refused before anything is built;
  the C signature matches the wrapper's ``argtypes``.
"""

import ctypes
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lnasr_tpu.config import GMMHMMConfig as JGMMHMMConfig
from lnasr_tpu.models import hmm as jhmm
from lnasr_tpu.models.gmmhmm import GMMHMM as JGMMHMM
from lnasr_tpu.models.seg import Seg as JSeg
from lnasr_tpu.models.seg import SegDataSet as JSegDataSet
from lnasr_tpu.ops.trellis import viterbi_scan as j_viterbi_scan
from lnasr_tpu_torch import _build
from lnasr_tpu_torch.config import GMMHMMConfig
from lnasr_tpu_torch.convert import hmm_params_from_numpy, params_from_numpy
from lnasr_tpu_torch.models import hmm as thmm
from lnasr_tpu_torch.models.gmmhmm import GMMHMM
from lnasr_tpu_torch.models.seg import Seg, SegDataSet
from lnasr_tpu_torch.ops import trellis as ttr
from lnasr_tpu_torch.ops import viterbi as tvt
from lnasr_tpu_torch.ops import viterbi_dense as tvd
from tests.test_seg import CORPUS

F32, F64 = torch.float32, torch.float64
SOURCE = pathlib.Path(ttr.__file__).parent.parent / "csrc" / "viterbi_trellis.cu"

# one jitted batch scan, shared by every case (a compile a shape and dtype)
_J_SCAN = jax.jit(jax.vmap(j_viterbi_scan, in_axes=(None, None, 0, 0, None)))


def _case(rng, n, b, t, kind, dtype):
    """``(log_pi, log_a, log_b, mask, log_final)`` as NumPy arrays in
    ``dtype``: ``chip_smoke.trellis_inputs``, the cases the card runs
    (ragged masks with a 1-frame utterance and holes; planted ties,
    ``-inf`` rows, columns, emissions and endings, every ending ``-inf``,
    random ending weights)."""
    tdt = {np.float32: torch.float32, np.float64: torch.float64}[dtype]
    return tuple(None if x is None else x.numpy()
                 for x in chip_smoke.trellis_inputs(torch, rng, n, b, t, kind, tdt, "cpu"))


def _jax(log_pi, log_a, log_b, mask, log_final):
    return _J_SCAN(*(jnp.asarray(x) for x in (log_pi, log_a, log_b, mask)),
                   None if log_final is None else jnp.asarray(log_final))


def _tt(*xs):
    return [None if x is None else torch.as_tensor(x) for x in xs]


def _same(got, ref):
    """All four outputs bit for bit (``-inf`` and dtypes included)."""
    for name in ("scores", "backptr", "path", "score"):
        g, r = getattr(got, name), getattr(ref, name)
        g = g.numpy() if torch.is_tensor(g) else np.asarray(g)
        r = r.numpy() if torch.is_tensor(r) else np.asarray(r)
        assert g.dtype == r.dtype and g.shape == r.shape, (name, g.dtype, r.dtype)
        np.testing.assert_array_equal(g.view(np.uint8), r.view(np.uint8), err_msg=name)


CASES = [(5, 3, 40, "random"), (5, 3, 40, "ties"), (5, 3, 40, "inf"), (5, 3, 40, "dead"),
         (1, 3, 17, "random"), (33, 3, 20, "final"), (33, 3, 20, "inf"), (4, 2, 1, "final"),
         (5, 4, 70, "ties")]


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,b,t,kind", CASES)
def test_plain_bitwise_vs_jax(n, b, t, kind, dtype):
    rng = np.random.default_rng(1000 * n + t + len(kind))
    args = _case(rng, n, b, t, kind, dtype)
    ref = _jax(*args)
    got = ttr.viterbi_scan_plain(*_tt(*args))
    _same(got, ref)
    if kind == "dead":
        assert (got.path[:, -1] == 0).all() and torch.isinf(got.score).all()
    if kind == "ties":
        assert (got.backptr[:, 1:] == 0).float().mean() > 0.2  # first index taken on ties


def test_plain_without_batch_and_no_frame():
    rng = np.random.default_rng(5)
    pi, a, lb, mask, _ = _case(rng, 5, 3, 30, "random", np.float32)
    one = ttr.viterbi_scan_plain(*_tt(pi, a, lb[2], mask[2]))
    full = ttr.viterbi_scan_plain(*_tt(pi, a, lb, mask))
    np.testing.assert_array_equal(one.path.numpy(), full.path[2].numpy())
    with pytest.raises(IndexError):
        ttr.viterbi_scan_plain(*_tt(pi, a, lb[:, :0]))


# -- the route and chunk rules ------------------------------------------------------


def test_route_rule():
    assert [ttr.viterbi_trellis_route(n) for n in (1, 5, 32)] == ["warp"] * 3
    assert [ttr.viterbi_trellis_route(n) for n in (33, 179, 1024)] == ["block"] * 3
    for n in (0, 1025, 4096):
        with pytest.raises(ValueError):
            ttr.viterbi_trellis_route(n)


@pytest.mark.parametrize("t", [1, 2, 33, 34, 999, 5000, 100_000])
@pytest.mark.parametrize("n,route", [(1, "warp"), (5, "warp"), (32, "warp"), (33, "block"),
                                     (1024, "block")])
def test_chunks_cover_the_steps(t, n, route):
    c, k = ttr.viterbi_chunks(t, n, route)
    steps = t - 1
    if steps == 0:
        assert c == 0
        return
    assert c * k >= steps and (c - 1) * k < steps  # every chunk holds a step
    assert 2 * c * (n + 1) <= ttr.VITERBI_MAP_BYTES[route]
    if -(-steps // ttr.VITERBI_CHUNK) * 2 * (n + 1) <= ttr.VITERBI_MAP_BYTES[route]:
        assert k <= ttr.VITERBI_CHUNK  # chunks of at most 32 steps while the maps fit


def test_on_chip_rule():
    assert ttr.viterbi_on_chip(999, 5, "warp") and ttr.viterbi_on_chip(1536, 32, "warp")
    assert not ttr.viterbi_on_chip(1537, 32, "warp")
    assert not ttr.viterbi_on_chip(20, 33, "block")


# -- the wrapper's host side against a model of the kernel --------------------------


def warp_group(dtype):
    """Frames a group of the warp route: 32 at float32, 16 at float64."""
    return 32 if np.dtype(dtype) == np.float32 else 16


def warp_forward_model(pi, a, lb, mask):
    """The warp route's forward in NumPy, as the kernel schedules it:
    groups of G frames from frame 0; a group's mask is one ballot word
    (lane k's bit: frame t0 + k), bit 0 of the first group cleared; every
    step computes the max-plus candidate, then selects it or keeps ``v``
    (a masked frame points every state to itself, frame 0 to state 0);
    the step's row and int8 pointers go to the group's stage, copied out
    when the group ends. Returns ``(scores, int32 backptr, v, ballots)``."""
    b, t, n = lb.shape
    g = warp_group(lb.dtype)
    scores = np.empty_like(lb)
    bp = np.zeros((b, t, n), np.int32)
    lanes = np.arange(n, dtype=np.int32)
    v = pi + lb[:, 0]
    ballots = []
    for t0 in range(0, t, g):
        frames = np.arange(t0, t0 + 32)
        byte = np.ones((b, 32), bool)  # lanes past G or T, and no mask: valid
        inside = (np.arange(32) < g) & (frames < t)
        if mask is not None:
            byte[:, inside] = mask[:, frames[inside]]
        word = (byte.astype(np.uint64) << np.arange(32, dtype=np.uint64)).sum(1)
        bits = word & (~np.uint64(1) if t0 == 0 else np.uint64(0xFFFFFFFF))
        ballots.append(bits)
        stage = np.empty((b, g, n), lb.dtype)
        stage8 = np.empty((b, g, n), np.int8)
        for k in range(min(g, t - t0)):
            cand = v[:, :, None] + a
            new = cand.max(axis=1) + lb[:, t0 + k]
            arg = cand.argmax(axis=1).astype(np.int32)
            valid = ((bits >> np.uint64(k)) & np.uint64(1)).astype(bool)[:, None]
            v = np.where(valid, new, v)
            self_ = np.zeros(n, np.int32) if t0 + k == 0 else lanes
            stage[:, k] = v
            stage8[:, k] = np.where(valid, arg, self_)
        rows = min(g, t - t0)
        scores[:, t0:t0 + rows] = stage[:, :rows]
        bp[:, t0:t0 + rows] = stage8[:, :rows]
    return scores, bp, v, ballots


def kernel_model(pi, a, lb, mask, lf, on_chip, n_chunks, chunk, route="warp"):
    """Kernel K in NumPy: the forward (the warp route's groups,
    :func:`warp_forward_model`, or the block route's frame loop: the adds
    in the working type, the first index of the max, masked frames kept);
    the final argmax; then the backtrace by chunk maps: (1) every chunk
    walked from each end state, (2) the chunk ends composed from the last
    frame, (3) the chunks walked again from their ends, writing the
    path."""
    b, t, n = lb.shape
    if route == "warp":
        scores, bp, v, _ = warp_forward_model(pi, a, lb, mask)
    else:
        scores = np.empty_like(lb)
        bp = np.zeros((b, t, n), np.int32)
        v = pi + lb[:, 0]
        scores[:, 0] = v
        for s in range(1, t):
            cand = v[:, :, None] + a
            new = cand.max(axis=1) + lb[:, s]
            arg = cand.argmax(axis=1).astype(np.int32)
            valid = np.ones(b, bool) if mask is None else mask[:, s]
            v = np.where(valid[:, None], new, v)
            bp[:, s] = np.where(valid[:, None], arg, np.arange(n, dtype=np.int32))
            scores[:, s] = v
    vf = v if lf is None else v + lf
    last, score = vf.argmax(axis=1), vf.max(axis=1)
    read = bp.astype(np.int8) if on_chip else bp
    path = np.zeros((b, t), np.int32)
    path[:, t - 1] = last
    top = lambda c: min((c + 1) * chunk, t - 1)  # noqa: E731
    assert n_chunks * chunk >= t - 1
    for i in range(b):
        maps = np.zeros((n_chunks, n), np.int64)
        for c in range(n_chunks):
            for e in range(n):
                s_ = e
                for step in range(top(c), c * chunk, -1):
                    s_ = read[i, step, s_]
                maps[c, e] = s_
        ends = np.zeros(n_chunks, np.int64)
        if n_chunks:
            ends[-1] = last[i]
            for c in range(n_chunks - 1, 0, -1):
                ends[c - 1] = maps[c, ends[c]]
        for c in range(n_chunks):
            s_ = ends[c]
            for step in range(top(c), c * chunk, -1):
                s_ = read[i, step, s_]
                path[i, step - 1] = s_
    return scores, bp, path, score


class _ModelLibrary:
    """Stands in for the built ``viterbi_trellis`` library: reads the C
    call's pointers (CPU tensors' addresses) and writes the model's
    results where the kernel would."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _view(ptr, dtype, shape):
        count = int(np.prod(shape))
        buf = (ctypes.c_char * (count * np.dtype(dtype).itemsize)).from_address(ptr)
        return np.frombuffer(buf, dtype=dtype).reshape(shape)

    def viterbi_trellis_launch(self, pi, a, lb, mask, lf, b, t, n, route, on_chip, n_chunks,
                               chunk, is_double, scores, backptr, path, score, stream):
        self.calls.append(dict(b=b, t=t, n=n, route=ttr.VITERBI_ROUTES[route], on_chip=on_chip,
                               n_chunks=n_chunks, chunk=chunk, is_double=is_double,
                               mask=mask, lf=lf))
        dt = np.float64 if is_double else np.float32
        out = kernel_model(self._view(pi, dt, (n,)).copy(), self._view(a, dt, (n, n)).copy(),
                           self._view(lb, dt, (b, t, n)).copy(),
                           None if mask is None else self._view(mask, np.bool_, (b, t)).copy(),
                           None if lf is None else self._view(lf, dt, (n,)).copy(),
                           on_chip, n_chunks, chunk, ttr.VITERBI_ROUTES[route])
        for ptr, x, kind in zip((scores, backptr, path, score), out, (dt, np.int32, np.int32, dt)):
            self._view(ptr, kind, x.shape)[...] = x
        return 0


@pytest.fixture
def model_library(monkeypatch):
    """``viterbi_scan`` takes its kernel path on CPU tensors, against the
    model."""
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
                        lambda dev=None: type("S", (), {"cuda_stream": 0})())
    return lib


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("n,b,t,kind", [(5, 3, 40, "inf"), (5, 3, 40, "ties"), (1, 3, 17, "random"),
                                        (33, 3, 20, "final"), (4, 2, 1, "final"),
                                        (5, 2, 2000, "random")])
def test_launch_against_model(model_library, n, b, t, kind, dtype):
    rng = np.random.default_rng(7 * n + t)
    args = _case(rng, n, b, t, kind, dtype)
    before = ttr.viterbi_scan.launches
    got = ttr.viterbi_scan(*_tt(*args))
    assert ttr.viterbi_scan.launches == before + 1
    _same(got, ttr.viterbi_scan_plain(*_tt(*args)))
    call = model_library.calls[-1]
    route = ttr.viterbi_trellis_route(n)
    assert (call["b"], call["t"], call["n"], call["route"], call["is_double"]) == (
        b, t, n, route, int(dtype == np.float64))
    assert (call["n_chunks"], call["chunk"]) == ttr.viterbi_chunks(t, n, route)
    assert call["on_chip"] == int(ttr.viterbi_on_chip(t, n, route))


def test_launch_flattens_promotes_broadcasts_and_forces(model_library):
    """Leading dimensions flatten into B; float32 inputs promote with a
    float64 one as the plain loop's adds do, and a float32 ``log_final``
    widens exactly; a (T,) mask broadcasts; the block route is forced at
    N = 5 and runs the same function."""
    rng = np.random.default_rng(11)
    pi, a, lb, mask, lf = _case(rng, 5, 4, 30, "inf", np.float64)
    lb4 = torch.as_tensor(lb.reshape(2, 2, 30, 5))
    pi32, lf32 = torch.as_tensor(pi, dtype=F32), torch.as_tensor(lf, dtype=F32)
    m = torch.as_tensor(np.arange(30) < 21)
    got = ttr.viterbi_scan(pi32, torch.as_tensor(a), lb4, m, lf32)
    assert got.scores.shape == (2, 2, 30, 5) and got.path.shape == (2, 2, 30)
    assert got.score.dtype == F64 and model_library.calls[-1]["b"] == 4
    _same(got, ttr.viterbi_scan_plain(pi32, torch.as_tensor(a), lb4, m, lf32))
    by_route = dict(ttr.viterbi_scan.route_launches)
    forced = ttr._viterbi_launch(*_tt(pi, a, lb, mask, lf), route="block")
    assert model_library.calls[-1]["route"] == "block" and not model_library.calls[-1]["on_chip"]
    assert ttr.viterbi_scan.route_launches == by_route | {"block": by_route["block"] + 1}
    _same(forced, ttr.viterbi_scan_plain(*_tt(pi, a, lb, mask, lf)))
    off_chip = ttr._viterbi_launch(*_tt(pi, a, lb, mask, lf), on_chip=False)
    assert model_library.calls[-1]["route"] == "warp" and not model_library.calls[-1]["on_chip"]
    _same(off_chip, forced)
    with pytest.raises(ValueError, match="on chip"):
        ttr._viterbi_launch(*_tt(pi, a, lb, mask, lf), route="block", on_chip=True)
    no_mask = ttr.viterbi_scan(*_tt(pi, a, lb))
    assert model_library.calls[-1]["mask"] is None and model_library.calls[-1]["lf"] is None
    _same(no_mask, ttr.viterbi_scan_plain(*_tt(pi, a, lb)))


def test_decodes_launch_once(model_library):
    """``HMM.decode``/``decode_batch`` and ``GMMHMM.decode_batch`` reach
    kernel K once a call, with the JAX package's paths."""
    jm = jhmm.HMM(4, 6, dtype=jnp.float64).reset("random", key=jax.random.PRNGKey(3))
    tm = thmm.HMM(device="cpu", dtype=F64).set_params(
        hmm_params_from_numpy(*jm.params, device="cpu", dtype=F64))
    rng = np.random.default_rng(4)
    obs = rng.integers(0, 6, size=(3, 25))
    mask = np.arange(25)[None, :] < np.array([25, 1, 14])[:, None]
    before = ttr.viterbi_scan.launches
    got = tm.decode_batch(obs, mask)
    assert ttr.viterbi_scan.launches == before + 1 and got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jm.decode_batch(obs, mask)))
    np.testing.assert_array_equal(tm.decode(obs[0]).numpy(), np.asarray(jm.decode(obs[0])))
    assert ttr.viterbi_scan.launches == before + 2

    n, m, d = 5, 4, 6
    jg = JGMMHMM(JGMMHMMConfig(n, m, d), dtype=jnp.float32)
    feats = rng.normal(scale=3.0, size=(4, 30, d)).astype(np.float32)
    jg.init_from_data(jnp.asarray(feats.reshape(-1, d)), jax.random.PRNGKey(1))
    tg = GMMHMM(GMMHMMConfig(n, m, d), device="cpu").set_params(
        params_from_numpy(*jg.params, device="cpu"))
    gmask = np.arange(30)[None, :] < np.array([30, 9, 1, 22])[:, None]
    got = tg.decode_batch(feats, gmask)
    assert ttr.viterbi_scan.launches == before + 3
    np.testing.assert_array_equal(got.numpy(), np.asarray(jg.decode_batch(feats, gmask)))


SEG_SENTENCES = ["我们喜欢学习中文", "语言模型帮助分词", "学", "żółw隐马尔可夫"]


def test_segmenter_one_launch_a_sentence(model_library):
    port = Seg(device="cpu").train(SegDataSet.mark(line) for line in CORPUS)
    ref = JSeg().train(JSegDataSet.mark(line) for line in CORPUS)
    for text in SEG_SENTENCES:
        before = ttr.viterbi_scan.launches
        got = port.segment(text)
        assert ttr.viterbi_scan.launches == before + 1
        assert model_library.calls[-1]["is_double"] == 1 and model_library.calls[-1]["n"] == 4
        assert got == ref.segment(text)
    assert port.segment("我们喜欢学习中文") == ["我们", "喜欢", "学习", "中文"]


def _warp_case(rng, n, b, t, pattern, dtype):
    """Random model and emissions with a mask ``pattern``: ``after first``
    (every frame after frame 0 masked), ``first frames`` (frames 1-3
    masked, or as many as there are), ``ragged`` (lengths T, 1, T - 3 and
    holes, as the card's cases)."""
    pi, a, lb, mask, _ = _case(rng, n, b, t, "random", dtype)
    if pattern == "after first":
        mask = np.zeros((b, t), bool)
        mask[:, 0] = True
    elif pattern == "first frames":
        mask = np.ones((b, t), bool)
        mask[:, 1:4] = False
    return pi, a, lb, mask


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("t", [1, 2, 31, 32, 33, 999])
@pytest.mark.parametrize("pattern", ["after first", "first frames", "ragged"])
def test_warp_groups_bitwise_vs_plain(dtype, t, pattern):
    """The warp route's group schedule and ballot bits against the plain
    loop: scores and backpointers bit for bit, masked frames' rows equal to
    the last valid frame's."""
    n, b = 5, 3
    rng = np.random.default_rng([t, len(pattern)])
    pi, a, lb, mask = _warp_case(rng, n, b, t, pattern, dtype)
    scores, bp, _, ballots = warp_forward_model(pi, a, lb, mask)
    ref = ttr.viterbi_scan_plain(*_tt(pi, a, lb, mask))
    np.testing.assert_array_equal(scores.view(np.uint8), ref.scores.numpy().view(np.uint8))
    np.testing.assert_array_equal(bp, ref.backptr.numpy())
    g = warp_group(dtype)
    assert len(ballots) == -(-t // g)
    low = [(np.asarray(word) & np.uint64((1 << g) - 1)) for word in ballots]
    want = np.ones((b, len(ballots) * g), bool)  # a group's G bits: its frames' masks, 1 past T
    want[:, :t] = mask
    want[:, 0] = False  # frame 0 is no step
    got = np.stack([(w[:, None] >> np.arange(g, dtype=np.uint64)) & np.uint64(1) for w in low], 1)
    np.testing.assert_array_equal(got.reshape(b, -1).astype(bool), want)
    if pattern == "after first" and t > 1:
        assert (bp[:, 1:] == np.arange(n)).all()
        assert (scores[:, 1:] == scores[:, :1]).all()


# -- the CPU path, the plain call sites, the refusals --------------------------------


def test_cpu_never_builds(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda *a: pytest.fail("CPU tensors reached _build"))
    rng = np.random.default_rng(2)
    args = _case(rng, 5, 3, 20, "inf", np.float32)
    before = ttr.viterbi_scan.launches
    _same(ttr.viterbi_scan(*_tt(*args)), ttr.viterbi_scan_plain(*_tt(*args)))
    port = Seg(device="cpu").train(SegDataSet.mark(line) for line in CORPUS[:20])
    port.segment("我们喜欢学习中文")
    assert ttr.viterbi_scan.launches == before


def test_plain_call_sites_use_the_plain_loop(monkeypatch):
    """Kernels B's and C's plain versions are held to the plain loop on
    the card, so they call it, never the dispatch that would launch K."""
    calls = []

    def spy(*args, **kw):
        calls.append(args[2].shape)
        return ttr.viterbi_scan_plain(*args, **kw)

    for mod in (tvt, tvd):
        monkeypatch.setattr(mod, "viterbi_scan_plain", spy)
        assert not hasattr(mod, "viterbi_scan")
    monkeypatch.setattr(ttr, "viterbi_scan", lambda *a, **k: pytest.fail("the dispatch"))
    monkeypatch.setattr(ttr, "_viterbi_launch", lambda *a, **k: pytest.fail("kernel K"))
    rng = np.random.default_rng(8)
    pi, a, lb, mask, lf = _case(rng, 5, 3, 20, "inf", np.float32)
    tvt.viterbi_plain(*_tt(pi, a, lb))
    tvd.viterbi_dense_plain(*_tt(pi, a, lb, mask, lf))
    assert calls == [(3, 20, 5), (3, 20, 5)]


class _CudaStandIn:
    """A CUDA tensor's device, dtype and shape: all the wrapper reads before
    it refuses."""

    def __init__(self, shape, dtype=torch.float32):
        self.device, self.dtype, self.shape = torch.device("cuda"), dtype, tuple(shape)

    def dim(self):
        return len(self.shape)


def test_cuda_refuses_instead_of_the_loop(monkeypatch):
    """On CUDA tensors ``viterbi_scan`` launches kernel K or raises: past
    N = 1024, per-utterance matrices, a dtype other than float32/float64,
    a ``log_final`` wider than the trellis, no frame and a forced warp
    route past 32 states are refused before anything is built."""
    monkeypatch.setattr(_build, "load", lambda *a: pytest.fail("built for a refused call"))
    monkeypatch.setattr(ttr, "viterbi_scan_plain", lambda *a: pytest.fail("fell back"))
    s = _CudaStandIn
    before = ttr.viterbi_scan.launches
    with pytest.raises(ValueError, match="N <= 1024"):
        ttr.viterbi_scan(s((1025,)), s((1025, 1025)), s((2, 10, 1025)))
    with pytest.raises(ValueError, match="shared by the batch"):
        ttr.viterbi_scan(s((5,)), s((2, 5, 5)), s((2, 10, 5)))
    with pytest.raises(ValueError, match="shared by the batch"):
        ttr.viterbi_scan(s((5,)), s((5, 5)), s((2, 10, 5)), None, s((2, 5)))
    with pytest.raises(ValueError, match="float32 or float64"):
        ttr.viterbi_scan(s((5,), torch.float16), s((5, 5), torch.float16),
                         s((2, 10, 5), torch.float16))
    with pytest.raises(ValueError, match="wider"):
        ttr.viterbi_scan(s((5,)), s((5, 5)), s((2, 10, 5)), None, s((5,), torch.float64))
    with pytest.raises(ValueError, match="at least one frame"):
        ttr.viterbi_scan(s((5,)), s((5, 5)), s((2, 0, 5)))
    with pytest.raises(ValueError, match="no route"):
        ttr._viterbi_launch(s((40,)), s((40, 40)), s((2, 10, 40)), route="warp")
    with pytest.raises(ValueError, match="cpu or cuda"):
        ttr.viterbi_scan(torch.zeros(5, device="meta"), torch.zeros((5, 5), device="meta"),
                         torch.zeros((2, 10, 5), device="meta"))
    assert ttr.viterbi_scan.launches == before


def test_source_exports_what_the_wrapper_binds():
    """``viterbi_trellis_launch`` takes as many arguments as ``argtypes``
    names (ctypes passes a pointer cut to 32 bits where one is missing),
    pointers where it has pointers; the adds are IEEE intrinsics and the
    argmax keeps the first index (strict >)."""
    src = SOURCE.read_text()
    sig = re.search(r'extern "C" int viterbi_trellis_launch\(([^)]*)\)', src)
    assert sig is not None
    params = [p.strip() for p in sig.group(1).split(",")]
    assert len(params) == len(ttr._VITERBI_ARGTYPES) == 18
    assert ["*" in p for p in params] == [t is ctypes.c_void_p for t in ttr._VITERBI_ARGTYPES]
    names = [p.split()[-1].lstrip("*") for p in params]
    assert names[:5] == ["log_pi", "log_a", "log_b", "mask", "log_final"]
    assert names[8:12] == ["route", "on_chip", "n_chunks", "chunk"]
    assert 'extern "C" const char* viterbi_trellis_error_string(int err)' in src
    code = re.sub(r"//[^\n]*", "", src)
    assert "__fadd_rn" in code and "__dadd_rn" in code
    assert "const bool right = rv > lv;" in code and "if (c > best)" in code
    assert "atomic" not in code
