"""Kernel J (``csrc/ltsd_noise.cu``, the adaptive LTSD's noise recursion)
on the CPU, where it cannot run: its plain version and its wrapper's host
side.

- ``vad.ltsd.ltsd_noise_plain`` through ``ltsd_scores_adaptive`` against
  the JAX package's jitted ``ltsd_scores_adaptive`` at float64, at the JAX
  package's own LTSD bar (``rtol=1e-8, atol=1e-10``): small windows, a
  batch of 3 (``detect_batch``), leading zeros (noise 0: NaN and inf
  scores in the same frames as JAX), no valid frame (``n <= 2 order``) and
  the empty signal. The fixed order of sums (``_lane_sum``: lane l adds
  bins l, l + 32, ... ascending, then an XOR butterfly) is held bit for bit
  to a NumPy model of it.
- A NumPy model of the kernel's two passes (``rows_model``: every frame's
  squares at the lanes' slots, its level and range flag;
  ``recursion_model``: frame t + 1 divided by both candidate spectra
  while frame t is scored, the flag's candidate of the warps' partials
  selected, the fast float division's range checks) held bit for bit to
  ``ltsd_noise_plain`` at float32 and float64: every frame adapting, none,
  an alternating flag, the silent start (NaN and inf, run again with the
  IEEE division), F = 129, 257 and 1025 with the last lanes partly padded,
  one valid frame.
- The wrapper's host side on CPU tensors, with ``_build.load`` replaced by
  that model, reading and writing through the C calls' pointers (the rows
  scratch too): batch flattening, argument order, the config's scalars;
  bitwise equal to the plain loop. ``detect`` and ``detect_batch`` make one
  launch a call.
- CUDA stand-ins are refused before anything is built; CPU tensors never
  reach ``_build``; the C signature matches the wrapper's ``argtypes``.
"""

import ctypes
import pathlib
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lnasr_tpu.config import LTSDConfig as JLTSDConfig
from lnasr_tpu.vad import ltsd as jltsd
from lnasr_tpu_torch import _build
from lnasr_tpu_torch.config import LTSDConfig
from lnasr_tpu_torch.vad import VadLtsd
from lnasr_tpu_torch.vad import ltsd as tltsd

F64 = torch.float64
SOURCE = pathlib.Path(tltsd.__file__).parent.parent / "csrc" / "ltsd_noise.cu"
# small windows (F = 129 and 65 bins: 5 and 3 lanes' chunks, the last partial)
CONFIGS = {"w256": dict(win_size=256, step_size=128, order=3, threshold=-6.0, alpha=0.4),
           "w128": dict(win_size=128, step_size=64, order=2, threshold=5.0, alpha=0.9)}


@pytest.fixture(autouse=True)
def _one_thread():
    """The frame loops are thousands of tiny tensor ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_JIT = {}


def _jax_scores(signal, kw):
    """The JAX package's jitted adaptive LTSD (one compile a config and
    shape, shared by the tests)."""
    key = tuple(sorted(kw.items()))
    if key not in _JIT:
        cfg = JLTSDConfig(**kw)
        _JIT[key] = jax.jit(jax.vmap(lambda s: jltsd.ltsd_scores_adaptive(s, cfg, jnp.float64)))
    return np.asarray(_JIT[key](jnp.asarray(np.atleast_2d(signal))))


def _signal(rng, n, lead_zeros=0):
    """Bursts of tone and noise over a quiet floor, ``lead_zeros`` exact
    zeros in front."""
    t = np.arange(n)
    env = (np.sin(2 * np.pi * t / 3000.0) > 0.3).astype(np.float64)
    x = 0.002 * rng.normal(size=n) + env * (0.3 * np.sin(2 * np.pi * 440 * t / 16000)
                                            + 0.05 * rng.normal(size=n))
    x[:lead_zeros] = 0.0
    return x


def _warp_partials(x):
    """The kernel's W warp partials of a sum over the last axis, in NumPy:
    the lanes each adding their bins (+0 past F), every lane of a warp
    running the XOR butterfly; lane 0's value of each warp."""
    f = x.shape[-1]
    w = tltsd.ltsd_warps(f, x.dtype.itemsize)
    c = -(-f // (32 * w))
    pad = np.zeros(x.shape[:-1] + (c * 32 * w - f,), x.dtype)
    lanes = np.concatenate([x, pad], axis=-1).reshape(x.shape[:-1] + (c, w, 32))
    acc = lanes[..., 0, :, :].copy()
    for k in range(1, c):
        acc = acc + lanes[..., k, :, :]
    for h in (16, 8, 4, 2, 1):  # every lane adds its partner's value
        acc = np.stack([acc[..., i] + acc[..., i ^ h] for i in range(32)], axis=-1)
    return acc[..., 0]


def _in_order(partials):
    """The warps' partials added in ascending order of warp."""
    total = partials[..., 0]
    for i in range(1, partials.shape[-1]):
        total = total + partials[..., i]
    return total


def _lane_sum_model(x):
    """The kernel's order of a sum over the last axis: the warp partials,
    then the warps in ascending order."""
    return _in_order(_warp_partials(x))


@pytest.mark.parametrize("name", sorted(CONFIGS))
@pytest.mark.parametrize("lead_zeros", [0, 900])
def test_plain_matches_jax(name, lead_zeros):
    kw = CONFIGS[name]
    rng = np.random.default_rng(len(name) + lead_zeros)
    x = _signal(rng, 9000, lead_zeros)
    ref = _jax_scores(x, kw)[0]
    got = VadLtsd(LTSDConfig(**kw), dtype=F64, device="cpu").detect(x).ltsd.numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-10)  # NaN and inf where JAX has them
    if lead_zeros:
        assert np.isnan(got).any() and np.isinf(got).any()
    else:
        band = got[kw["order"]:len(got) - kw["order"]]
        assert np.isfinite(band).all() and (band < kw["threshold"]).any() \
            and (band > kw["threshold"]).any()


def test_batch_of_three_matches_jax():
    kw = CONFIGS["w256"]
    rng = np.random.default_rng(3)
    xs = np.stack([_signal(rng, 7000), _signal(rng, 7000), _signal(rng, 7000, 400)])
    ref = _jax_scores(xs, kw)
    vad = VadLtsd(LTSDConfig(**kw), dtype=F64, device="cpu")
    got = vad.detect_batch(xs).ltsd.numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-8, atol=1e-10)
    np.testing.assert_array_equal(got[1], vad.detect(xs[1]).ltsd.numpy())


@pytest.mark.parametrize("n", [0, 300, 600, 760])
def test_no_valid_frame(n):
    """``n`` samples give at most ``2 order = 6`` frames (760 exactly 6;
    0 none at all): every score 0, as in JAX."""
    kw = CONFIGS["w256"]
    x = _signal(np.random.default_rng(n), n)
    got = VadLtsd(LTSDConfig(**kw), dtype=F64, device="cpu").detect(x).ltsd.numpy()
    assert len(got) <= 2 * kw["order"] and not got.any()
    if n:
        np.testing.assert_array_equal(got, _jax_scores(x, kw)[0])


def test_warps_rule():
    """The fewest division warps with at most 5 bins a lane at float32 (3
    at float64), up to 31 (a combiner warp makes 32); past 8192 bins the
    kernel refuses, and 31 warps of 9 bins cover them."""
    fs = (1, 160, 161, 320, 513, 1025, 2049, 2976, 4960, 5121, 9000)
    got = {f: tltsd.ltsd_warps(f) for f in fs}
    assert got == {1: 1, 160: 1, 161: 2, 320: 2, 513: 4, 1025: 7, 2049: 13, 2976: 19, 4960: 31,
                   5121: 31, 9000: 31}
    got64 = {f: tltsd.ltsd_warps(f, 8) for f in fs}
    assert got64 == {1: 1, 160: 2, 161: 2, 320: 4, 513: 6, 1025: 11, 2049: 22, 2976: 31,
                     4960: 31, 5121: 31, 9000: 31}
    for itemsize, rule in ((4, got), (8, got64)):
        for f, w in rule.items():
            if f <= 31 * 32 * tltsd.BINS_A_LANE[itemsize]:
                assert -(-f // (32 * w)) <= tltsd.BINS_A_LANE[itemsize]
        assert 32 * tltsd.ltsd_warps(8192, itemsize) * tltsd.MAX_BINS_A_LANE >= tltsd.MAX_F == 8192


@pytest.mark.parametrize("f", [1, 31, 32, 33, 65, 129, 161, 513, 1025, 5121, 9000])
def test_lane_sum_order(f):
    rng = np.random.default_rng(f)
    for dtype in (np.float32, np.float64):
        x = (rng.random((3, f)) * 10.0 ** rng.integers(-3, 4, size=(3, f))).astype(dtype)
        got = tltsd._lane_sum(torch.as_tensor(x)).numpy()
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, _lane_sum_model(x))
        np.testing.assert_allclose(got, x.sum(-1, dtype=np.float64), rtol=1e-5)


# -- the kernel's two passes, modelled ------------------------------------------------


def _in_range(v):
    """Where the fast float division is exact: |v| in [2^-50, 2^50)."""
    a = np.abs(v)
    return (a >= 2.0 ** -50) & (a < 2.0 ** 50)


def _log10(x):
    """torch's log10 of a NumPy scalar (the plain loop's own, bit for bit;
    the kernel's is CUDA's, which torch uses on the card)."""
    return torch.log10(torch.as_tensor(np.asarray(x))).numpy()[()]


def rows_model(ltse, win, beta):
    """Kernel J's rows kernel in NumPy: ``(B, T, row)``, each frame's
    squares at the lanes' ``32 W bins`` slots (+0 past F), then its level
    ``beta (sum x / win)`` in the lanes' order of sums, its range flag (every
    square 0 or in the fast division's range; 1 at float64) and zeros."""
    dt = ltse.dtype.type
    b, t, f = ltse.shape
    fp = tltsd.ltsd_row(f, ltse.dtype.itemsize) - 16 // ltse.dtype.itemsize
    rows = np.zeros((b, t, tltsd.ltsd_row(f, ltse.dtype.itemsize)), ltse.dtype)
    rows[..., :f] = ltse * ltse
    rows[..., fp] = dt(beta) * (_lane_sum_model(ltse) / dt(win))
    sq = rows[..., :fp]
    ok = ((sq == 0) | _in_range(sq)).all(-1) if dt is np.float32 else np.ones((b, t), bool)
    rows[..., fp + 1] = ok
    return rows


def recursion_model(rows, noise0, f, order, win, thr, alpha):
    """Kernel J's recursion over ``rows_model``'s rows, in NumPy, one
    rounding an operation: frame t + 1's squares divided by both candidate
    spectra (frame t keeps ``n``, or adapts to ``alpha n + level_t``; 1 in
    the padded bins) while frame t is scored from the partials of the
    candidate its predecessor's flag chose; the division by ``win`` a
    multiply where ``win`` is a power of two. Returns ``(scores, fast)``:
    ``fast`` per utterance, whether every operand stayed in the fast float
    division's range (else the kernel runs it again with ``__fdiv_rn``:
    the same values, as the model's divisions are IEEE's)."""
    dt = rows.dtype.type
    b, t, row = rows.shape
    fp = row - 16 // rows.dtype.itemsize
    win_, thr, alpha, lo, ten = dt(win), dt(thr), dt(alpha), dt(1e-30), dt(10.0)
    pow2 = win > 0 and (int(win) & (int(win) - 1)) == 0 and int(win) == win
    real = np.arange(fp) < f
    scores = np.zeros((b, t), rows.dtype)
    fast = np.zeros(b, bool)
    first, stop = order, t - order
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        for i in range(b):
            if first >= stop:
                fast[i] = True
                continue
            n = np.where(real, np.pad(noise0[i], (0, fp - f)), dt(1)).astype(rows.dtype)
            ok = bool(_in_range(n).all()) and bool(rows[i, first, fp + 1])
            sq = rows[i, first, :fp]
            parts = (_warp_partials(sq / n),) * 2  # frame first: keep and adapt alike
            lvl, prev = rows[i, first, fp], False
            for s in range(first, stop):
                q = _in_order(parts[int(prev)])
                da = np.where(real, alpha * n + lvl, dt(1)).astype(rows.dtype)
                ok = ok and bool(_in_range(da).all())
                if s + 1 < stop:
                    sq = rows[i, s + 1, :fp]
                    ok = ok and bool(rows[i, s + 1, fp + 1])
                    parts = (_warp_partials(sq / n), _warp_partials(sq / da))
                r = q * (dt(1) / win_) if pow2 else q / win_
                ok = ok and (pow2 or q == 0 or bool(_in_range(q)))
                score = ten * _log10(lo if r < lo else r)  # a NaN stays NaN
                scores[i, s] = score
                flag = score < thr
                n = da if flag else n
                if s + 1 < stop:
                    lvl = rows[i, s + 1, fp]
                prev = flag
            fast[i] = ok and dt is np.float32
    return scores, fast


def kernel_model(ltse, noise0, order, win, thr, alpha, beta):
    """Kernel J's call in NumPy: the rows, then the recursion."""
    return recursion_model(rows_model(ltse, win, beta), noise0, ltse.shape[-1], order, win, thr,
                           alpha)


def _cfg(win, threshold=-6.0, alpha=0.4, order=3):
    return LTSDConfig(win_size=win, step_size=win // 2, order=order, threshold=threshold,
                      alpha=alpha)


def _model_vs_plain(ltse, noise, cfg):
    """The model's scores bit for bit the plain loop's (NaN where it has
    NaN); returns the plain scores and the model's ``fast``."""
    got, fast = kernel_model(ltse.numpy(), noise.numpy(), cfg.order, cfg.win_size,
                             cfg.threshold, cfg.alpha, 1.0 - cfg.alpha)
    ref = tltsd.ltsd_noise_plain(ltse, noise, cfg).numpy()
    nan = np.isnan(ref)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(np.where(nan, 0, got).view(np.uint8),
                                  np.where(nan, 0, ref).view(np.uint8))
    return ref, fast


def _synthetic(rng, b, t, f, dtype, loud=None):
    """Seeded LTSE ``(b, t, f)`` and noise ``(b, f)``: amplitudes spread over
    four decades; ``loud`` (a bool per frame) scales those frames by 100."""
    x = rng.random((b, t, f)) * 10.0 ** rng.uniform(-2, 1, size=(b, t, f))
    if loud is not None:
        x = x * np.where(loud, 100.0, 1.0)[None, :, None]
    noise = (rng.random((b, f)) + 0.1) ** 2
    return torch.as_tensor(x, dtype=dtype), torch.as_tensor(noise, dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("win", [256, 512, 2048])  # F = 129, 257, 1025: the last lanes padded
@pytest.mark.parametrize("regime", ["all adapt", "none adapts", "alternating"])
def test_model_bitwise_vs_plain(dtype, win, regime):
    f = win // 2 + 1
    t = 40
    rng = np.random.default_rng([win, len(regime)])
    alternate = np.arange(t) % 2 == 1
    ltse, noise = _synthetic(rng, 2, t, f, dtype, alternate if regime == "alternating" else None)
    thr = {"all adapt": 200.0, "none adapts": -200.0, "alternating": 27.0}[regime]
    cfg = _cfg(win, threshold=thr)
    assert f % (32 * tltsd.ltsd_warps(f, ltse.dtype.itemsize)) != 0  # a partly padded last lane
    ref, fast = _model_vs_plain(ltse, noise, cfg)
    band = ref[:, cfg.order:t - cfg.order]
    flags = band < thr
    if regime == "all adapt":
        assert flags.all()
    elif regime == "none adapts":
        assert not flags.any()
    else:  # the loud frames score above the threshold, the quiet ones below
        np.testing.assert_array_equal(
            flags, np.broadcast_to(~alternate[cfg.order:t - cfg.order], flags.shape))
    assert fast.all() == (dtype == torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("win", [256, 2048])
def test_model_silent_start(dtype, win):
    """Digital silence in front: noise 0, so NaN and inf scores; the float
    utterance leaves the fast division's range and runs with the IEEE one."""
    cfg = _cfg(win)
    rng = np.random.default_rng(win)
    x = _signal(rng, 16 * win, lead_zeros=4 * win)
    amps = tltsd._amplitudes(torch.as_tensor(np.stack([x, _signal(rng, 16 * win)])), cfg, dtype)
    ltse, noise = tltsd._ltse(amps, cfg.order), amps[..., :2, :].mean(dim=-2) ** 2
    ref, fast = _model_vs_plain(ltse, noise, cfg)
    assert np.isnan(ref[0]).any() and np.isinf(ref[0]).any() and np.isfinite(ref[1]).all()
    assert not fast[0] and fast[1] == (dtype == torch.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("t", [7, 8, 9])  # no valid frame, one, two (order 3)
def test_model_short(dtype, t):
    ltse, noise = _synthetic(np.random.default_rng(t), 3, t, 129, dtype)
    ref, _ = _model_vs_plain(ltse, noise, _cfg(256))
    assert (ref[:, :3] == 0).all() and (ref[:, t - 3:] == 0).all()


def test_model_other_window():
    """A window that is not a power of two divides by ``win`` (the fast
    division, its quotient's range checked)."""
    cfg = LTSDConfig(win_size=400, step_size=160, order=3, threshold=-6.0, alpha=0.4)
    x = _signal(np.random.default_rng(40), 8000)
    for dtype in (torch.float32, torch.float64):
        amps = tltsd._amplitudes(torch.as_tensor(x), cfg, dtype)
        ltse, noise = tltsd._ltse(amps, cfg.order), amps[:2].mean(dim=0) ** 2
        _model_vs_plain(ltse[None], noise[None], cfg)


def test_row_layout():
    """A row holds the lanes' slots and 16 bytes; 1025 bins take 5 bins a
    lane on 7 warps at float32, 3 on 11 at float64."""
    assert tltsd.ltsd_row(1025, 4) == 7 * 32 * 5 + 4 and tltsd.ltsd_row(1025, 8) == 11 * 32 * 3 + 2
    assert tltsd.ltsd_row(129, 4) == 32 * 5 + 4 and tltsd.ltsd_row(1, 8) == 32 + 2


# -- the wrapper's host side against the model -------------------------------------


class _ModelLibrary:
    """Stands in for the built ``ltsd_noise`` library: reads the C calls'
    pointers (CPU tensors' addresses) and writes the model's rows and
    scores. ``calls`` lists the two entries' calls in order."""

    def __init__(self):
        self.calls = []

        def ltsd_noise_rows(ltse, b, t, f, warps, is_double, win, beta, rows, stream):
            self.calls.append(dict(entry="rows", b=b, t=t, f=f, warps=warps,
                                   is_double=is_double, win=win, beta=beta))
            dt = np.float64 if is_double else np.float32
            shape = (b, t, tltsd.ltsd_row(f, np.dtype(dt).itemsize))
            self._view(rows, dt, shape)[...] = rows_model(self._view(ltse, dt, (b, t, f)).copy(),
                                                          win, beta)
            return 0

        self.ltsd_noise_rows = ltsd_noise_rows  # a function: the wrapper sets its argtypes

    @staticmethod
    def _view(ptr, dtype, shape):
        count = int(np.prod(shape))
        buf = (ctypes.c_char * (count * np.dtype(dtype).itemsize)).from_address(ptr)
        return np.frombuffer(buf, dtype=dtype).reshape(shape)

    def ltsd_noise_launch(self, rows, noise, b, t, f, order, warps, is_double, win, thr, alpha,
                          scores, stream):
        self.calls.append(dict(entry="recursion", b=b, t=t, f=f, order=order, warps=warps,
                               is_double=is_double, win=win, thr=thr, alpha=alpha))
        dt = np.float64 if is_double else np.float32
        shape = (b, t, tltsd.ltsd_row(f, np.dtype(dt).itemsize))
        self._view(scores, dt, (b, t))[...] = recursion_model(
            self._view(rows, dt, shape).copy(), self._view(noise, dt, (b, f)).copy(), f, order,
            win, thr, alpha)[0]
        return 0


@pytest.fixture
def model_library(monkeypatch):
    """``ltsd_noise`` takes its kernel path on CPU tensors, against the
    model."""
    lib = _ModelLibrary()
    monkeypatch.setattr(_build, "load", lambda name, argtypes: lib)
    monkeypatch.setattr(tltsd, "_on_cuda", lambda x: True)

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("win,warps", [(256, (1, 2)), (512, (2, 3))])
def test_launch_against_model(model_library, dtype, win, warps):
    """One launch a ``detect`` and a ``detect_batch`` call, the plain loop's
    scores (to the two ``log10``s' last bits), the batch flattened and the
    scalars in order; 129 bins on one warp (two at float64), 257 on two
    (three)."""
    warps = warps[dtype == F64]
    cfg = LTSDConfig(**(CONFIGS["w256"] | dict(win_size=win, step_size=win // 2)))
    rng = np.random.default_rng(9)
    xs = np.stack([_signal(rng, 6000), _signal(rng, 6000, 900), _signal(rng, 6000)])
    vad = VadLtsd(cfg, dtype=dtype, device="cpu")
    before = tltsd.ltsd_noise.launches
    got = vad.detect_batch(xs).ltsd
    one = vad.detect(xs[0]).ltsd
    assert tltsd.ltsd_noise.launches == before + 2 and len(model_library.calls) == 4
    assert [c["entry"] for c in model_library.calls] == ["rows", "recursion"] * 2
    rows, call = model_library.calls[:2]
    assert (call["b"], call["f"], call["order"], call["warps"], call["is_double"]) == (
        3, win // 2 + 1, 3, warps, int(dtype == F64))
    assert (call["win"], call["thr"], call["alpha"]) == (win, -6.0, 0.4)
    assert {k: rows[k] for k in ("b", "t", "f", "warps", "is_double", "win")} == {
        k: call[k] for k in ("b", "t", "f", "warps", "is_double", "win")}
    assert rows["beta"] == 1.0 - 0.4
    assert model_library.calls[2]["b"] == model_library.calls[3]["b"] == 1
    amps = tltsd._amplitudes(torch.as_tensor(xs), cfg, dtype)
    ref = tltsd.ltsd_noise_plain(tltsd._ltse(amps, cfg.order),
                                 amps[..., :2, :].mean(dim=-2) ** 2, cfg)
    # the model's log10 is NumPy's, the plain loop's torch's: they may differ
    # in the last bit, so the bar is a few ulps (NaN and inf where they lie)
    rtol = 1e-12 if dtype == F64 else 1e-6
    assert got.dtype == dtype
    np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=rtol, atol=0)
    np.testing.assert_allclose(one.numpy(), ref[0].numpy(), rtol=rtol, atol=0)
    assert not np.isfinite(got.numpy()[1]).all()  # the silent start: NaN or inf


def test_launch_without_valid_frames(model_library):
    """Too few frames for the band, or none: still one launch, all scores
    0."""
    cfg = LTSDConfig(**CONFIGS["w256"])
    vad = VadLtsd(cfg, dtype=F64, device="cpu")
    before = tltsd.ltsd_noise.launches
    assert not vad.detect(np.ones(500)).ltsd.numpy().any()
    assert vad.detect(np.zeros(0)).ltsd.shape == (0,)
    assert tltsd.ltsd_noise.launches == before + 2


class _CudaStandIn:
    """A CUDA tensor's device, dtype and shape: all the wrapper reads before
    it refuses."""

    def __init__(self, shape, dtype=torch.float32):
        self.device, self.dtype, self.shape = torch.device("cuda"), dtype, tuple(shape)

    def dim(self):
        return len(self.shape)


def test_cuda_refuses_instead_of_the_loop(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda *a: pytest.fail("built for a refused call"))
    monkeypatch.setattr(tltsd, "ltsd_noise_plain", lambda *a: pytest.fail("fell back"))
    cfg = LTSDConfig(**CONFIGS["w256"])
    before = tltsd.ltsd_noise.launches
    with pytest.raises(ValueError, match="float32 or float64"):
        tltsd.ltsd_noise(_CudaStandIn((40, 129), torch.float16),
                         _CudaStandIn((129,), torch.float16), cfg)
    with pytest.raises(ValueError, match="one dtype"):
        tltsd.ltsd_noise(_CudaStandIn((40, 129)), _CudaStandIn((129,), F64), cfg)
    with pytest.raises(ValueError, match="noise"):
        tltsd.ltsd_noise(_CudaStandIn((2, 40, 129)), _CudaStandIn((129,)), cfg)
    with pytest.raises(ValueError, match="at most 8192 frequency bins"):
        tltsd.ltsd_noise(_CudaStandIn((40, 8193)), _CudaStandIn((8193,)), cfg)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tltsd.ltsd_noise(torch.zeros((4, 5), device="meta"), torch.zeros(5, device="meta"), cfg)
    assert tltsd.ltsd_noise.launches == before


def test_cpu_never_builds(monkeypatch):
    monkeypatch.setattr(_build, "load", lambda *a: pytest.fail("CPU tensors reached _build"))
    cfg = LTSDConfig(**CONFIGS["w128"])
    before = tltsd.ltsd_noise.launches
    vad = VadLtsd(cfg, dtype=F64, device="cpu")
    x = _signal(np.random.default_rng(2), 3000)
    vad.detect(x)
    vad.detect_batch(np.stack([x, x]))
    assert tltsd.ltsd_noise.launches == before


def test_source_exports_what_the_wrapper_binds():
    """``ltsd_noise_launch`` (the recursion) and ``ltsd_noise_rows`` (the
    rows pass) take as many arguments as their ``argtypes`` name (ctypes
    passes a pointer cut to 32 bits where one is missing), pointers where
    they have pointers and doubles where they have doubles; the kernels use
    the IEEE intrinsics and the library's log10, no fast math, no fmax."""
    src = SOURCE.read_text()
    for entry, argtypes, count, named in (
            ("ltsd_noise_launch", tltsd._ARGTYPES, 13, {0: "rows", 5: "order", 6: "warps"}),
            ("ltsd_noise_rows", tltsd._ROWS_ARGTYPES, 10, {4: "warps", 8: "rows"})):
        sig = re.search(rf'extern "C" int {entry}\(([^)]*)\)', src)
        assert sig is not None
        params = [p.strip() for p in sig.group(1).split(",")]
        assert len(params) == len(argtypes) == count
        assert {i: params[i].split()[-1] for i in named} == named
        kinds = ["*" in p and "void" in p for p in params]
        assert kinds == [t is ctypes.c_void_p for t in argtypes]
        assert [p.startswith("double") for p in params] == [t is ctypes.c_double
                                                            for t in argtypes]
    assert 'extern "C" const char* ltsd_noise_error_string(int err)' in src
    code = re.sub(r"//[^\n]*", "", src)
    assert "__fdiv_rn" in code and "__ddiv_rn" in code and "log10f" in code
    assert "fmax" not in code and "__log10f" not in code and "__fdividef" not in code
    assert "use_fast_math" not in " ".join(_build.NVCC_FLAGS)
