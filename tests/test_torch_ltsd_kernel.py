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
- The wrapper's host side on CPU tensors, with ``_build.load`` replaced by
  a NumPy model of the kernel (the same order of sums, one rounding an
  operation) that reads the C call's pointers: batch flattening, argument
  order, the config's scalars; bitwise equal to the plain loop. ``detect``
  and ``detect_batch`` make one launch a call.
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


def _lane_sum_model(x):
    """The kernel's order of a sum over the last axis, in NumPy: W warps'
    lanes each adding their bins, every lane of a warp running the XOR
    butterfly, then the warps' partials in ascending order."""
    f = x.shape[-1]
    w = tltsd.ltsd_warps(f)
    c = -(-f // (32 * w))
    pad = np.zeros(x.shape[:-1] + (c * 32 * w - f,), x.dtype)
    lanes = np.concatenate([x, pad], axis=-1).reshape(x.shape[:-1] + (c, w, 32))
    acc = lanes[..., 0, :, :].copy()
    for k in range(1, c):
        acc = acc + lanes[..., k, :, :]
    for h in (16, 8, 4, 2, 1):  # every lane adds its partner's value
        acc = np.stack([acc[..., i] + acc[..., i ^ h] for i in range(32)], axis=-1)
    total = acc[..., 0, 0]
    for i in range(1, w):
        total = total + acc[..., i, 0]
    return total


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
    """The fewest warps with at most 5 bins a lane, up to 32; past 32 x 32
    x 8 = 8192 bins the kernel refuses."""
    got = {f: tltsd.ltsd_warps(f) for f in (1, 160, 161, 320, 513, 1025, 2049, 5120, 5121, 9000)}
    assert got == {1: 1, 160: 1, 161: 2, 320: 2, 513: 4, 1025: 7, 2049: 13, 5120: 32,
                   5121: 32, 9000: 32}
    for f, w in got.items():
        if f <= 5120:
            assert -(-f // (32 * w)) <= tltsd.BINS_A_LANE


@pytest.mark.parametrize("f", [1, 31, 32, 33, 65, 129, 161, 513, 1025, 5121, 9000])
def test_lane_sum_order(f):
    rng = np.random.default_rng(f)
    for dtype in (np.float32, np.float64):
        x = (rng.random((3, f)) * 10.0 ** rng.integers(-3, 4, size=(3, f))).astype(dtype)
        got = tltsd._lane_sum(torch.as_tensor(x)).numpy()
        assert got.dtype == dtype
        np.testing.assert_array_equal(got, _lane_sum_model(x))
        np.testing.assert_allclose(got, x.sum(-1, dtype=np.float64), rtol=1e-5)


# -- the wrapper's host side against a model of the kernel ----------------------


def kernel_model(ltse, noise0, order, win, thr, alpha, beta):
    """Kernel J in NumPy: a warp's arithmetic, in the working type, one
    rounding an operation and the sums in the lanes' order."""
    dt = ltse.dtype.type
    b, t, f = ltse.shape
    win, thr, alpha, beta, lo = dt(win), dt(thr), dt(alpha), dt(beta), dt(1e-30)
    scores = np.zeros((b, t), ltse.dtype)
    with np.errstate(divide="ignore", invalid="ignore"):
        for i in range(b):
            noise = noise0[i].copy()
            for s in range(order, t - order):
                x = ltse[i, s]
                r = _lane_sum_model(x * x / noise) / win
                score = dt(10.0) * np.log10(lo if r < lo else r)
                level = beta * (_lane_sum_model(x) / win)
                if score < thr:
                    noise = alpha * noise + level
                scores[i, s] = score
    return scores


class _ModelLibrary:
    """Stands in for the built ``ltsd_noise`` library: reads the C call's
    pointers (CPU tensors' addresses) and writes the model's scores."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _view(ptr, dtype, shape):
        count = int(np.prod(shape))
        buf = (ctypes.c_char * (count * np.dtype(dtype).itemsize)).from_address(ptr)
        return np.frombuffer(buf, dtype=dtype).reshape(shape)

    def ltsd_noise_launch(self, ltse, noise, b, t, f, order, warps, is_double, win, thr, alpha,
                          beta, scores, stream):
        self.calls.append(dict(b=b, t=t, f=f, order=order, warps=warps, is_double=is_double,
                               win=win, thr=thr, alpha=alpha, beta=beta))
        dt = np.float64 if is_double else np.float32
        self._view(scores, dt, (b, t))[...] = kernel_model(
            self._view(ltse, dt, (b, t, f)).copy(), self._view(noise, dt, (b, f)).copy(),
            order, win, thr, alpha, beta)
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
@pytest.mark.parametrize("win,warps", [(256, 1), (512, 2)])
def test_launch_against_model(model_library, dtype, win, warps):
    """One launch a ``detect`` and a ``detect_batch`` call, the plain loop's
    scores (to the two ``log10``s' last bits), the batch flattened and the
    scalars in order; 129 bins on one warp, 257 on two."""
    cfg = LTSDConfig(**(CONFIGS["w256"] | dict(win_size=win, step_size=win // 2)))
    rng = np.random.default_rng(9)
    xs = np.stack([_signal(rng, 6000), _signal(rng, 6000, 900), _signal(rng, 6000)])
    vad = VadLtsd(cfg, dtype=dtype, device="cpu")
    before = tltsd.ltsd_noise.launches
    got = vad.detect_batch(xs).ltsd
    one = vad.detect(xs[0]).ltsd
    assert tltsd.ltsd_noise.launches == before + 2 and len(model_library.calls) == 2
    call = model_library.calls[0]
    assert (call["b"], call["f"], call["order"], call["warps"], call["is_double"]) == (
        3, win // 2 + 1, 3, warps, int(dtype == F64))
    assert (call["win"], call["thr"], call["alpha"], call["beta"]) == (win, -6.0, 0.4, 1.0 - 0.4)
    assert model_library.calls[1]["b"] == 1
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
    """``ltsd_noise_launch`` takes as many arguments as ``argtypes`` names
    (ctypes passes a pointer cut to 32 bits where one is missing), pointers
    where it has pointers and doubles where it has doubles; the kernel uses
    the IEEE intrinsics and the library's log10, no fast math, no fmax."""
    src = SOURCE.read_text()
    sig = re.search(r'extern "C" int ltsd_noise_launch\(([^)]*)\)', src)
    assert sig is not None
    params = [p.strip() for p in sig.group(1).split(",")]
    assert len(params) == len(tltsd._ARGTYPES) == 14
    assert [p.split()[-1] for p in params][5:7] == ["order", "warps"]
    kinds = ["*" in p and "void" in p for p in params]
    assert kinds == [t is ctypes.c_void_p for t in tltsd._ARGTYPES]
    assert [p.startswith("double") for p in params] == [t is ctypes.c_double
                                                        for t in tltsd._ARGTYPES]
    assert 'extern "C" const char* ltsd_noise_error_string(int err)' in src
    code = re.sub(r"//[^\n]*", "", src)
    assert "__fdiv_rn" in code and "__ddiv_rn" in code and "log10f" in code
    assert "fmax" not in code and "__log10f" not in code and "__fdividef" not in code
    assert "use_fast_math" not in " ".join(_build.NVCC_FLAGS)
