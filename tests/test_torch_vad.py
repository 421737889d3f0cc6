"""The port's VAD (native detectors, LTSD, the WebRTC-style torch VAD)
and IIR scans against the JAX package on the same seeded inputs.

- The native detectors are built from the port's own copies of the C++
  sources, which must stay byte-identical to the JAX package's; flags and
  AMR-WB power sums must be equal (the JAX package's ``AmrWbVad`` is the
  oracle of the port's). A sanitized build lands in a file of its own,
  and the port's copy of the self-test runs clean under ASan/UBSan.
- LTSD at float64 is held to the bar of the JAX package's own LTSD test
  (``rtol=1e-8, atol=1e-10``).
- The IIR scans at float64 within ``rtol=1e-10`` of the JAX scans and of
  ``scipy.signal.lfilter``, chunk by chunk with the state carried.
- ``WebRtcVadTorch`` flags equal to ``WebRtcVadJax``'s and the native
  detector's, frame for frame, in every mode.
"""

import functools
import os
import re
import subprocess

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.signal
import torch

from lnasr_tpu.config import LTSDConfig as JLTSDConfig
from lnasr_tpu.ops import lfilter as jlf
from lnasr_tpu.vad import webrtc as jweb
from lnasr_tpu.vad.ltsd import VadLtsd as JVadLtsd
from lnasr_tpu.vad.native import AmrWbVad as JAmrWbVad
from lnasr_tpu.vad.native import WebRtcVad as JWebRtcVad
from lnasr_tpu_torch import _build
from lnasr_tpu_torch.config import LTSDConfig
from lnasr_tpu_torch.ops import lfilter as tlf
from lnasr_tpu_torch.utils.audio import resample
from lnasr_tpu_torch.vad import AmrWbVad, VadLtsd, WebRtcVad, WebRtcVadTorch
from lnasr_tpu_torch.vad import webrtc as tweb

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64


@pytest.fixture(autouse=True)
def _one_thread():
    """The frame loops are thousands of tiny tensor ops: one CPU thread
    runs them faster than a pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_native_sources_are_copies():
    """The port builds its detectors from copies of the JAX package's C++
    sources, into its own build directory. The copies are byte for byte
    the same but for two comments, which name files of the original
    toolkit by their path inside its checkout instead of an absolute
    one."""
    ref = os.path.join(ROOT, "lnasr_tpu", "native", "vad")
    for name in _build.NATIVE_VAD_SOURCES + _build.NATIVE_VAD_HEADERS + ("vad_selftest.cpp",):
        with open(os.path.join(ref, name), "rb") as f:
            want = re.sub(rb"/[\w/]+?/(?=third/)", b"", f.read())
        with open(os.path.join(_build.NATIVE_VAD, name), "rb") as f:
            assert f.read() == want, name
    path = _build.build_native_vad()
    assert os.path.dirname(path) == _build.BUILD_DIR and os.path.exists(path)
    assert sorted(os.listdir(_build.NATIVE_VAD)) == sorted(os.listdir(ref))


def test_sanitized_build_has_a_file_of_its_own():
    """``build_native_vad(sanitize=True)`` compiles the detectors under
    AddressSanitizer and UBSan into ``_build/`` beside the normal library,
    which stays as it was."""
    normal = _build.build_native_vad()
    with open(normal, "rb") as f:
        before = f.read()
    sanitized = _build.build_native_vad(sanitize=True)
    assert sanitized == _build.native_vad_path(sanitize=True) != normal
    assert os.path.dirname(sanitized) == _build.BUILD_DIR and os.path.exists(sanitized)
    assert os.path.basename(sanitized).startswith("native_vad_sanitized-")
    with open(sanitized, "rb") as f:
        assert b"__asan_" in f.read() and b"__asan_" not in before
    with open(_build.build_native_vad(), "rb") as f:
        assert f.read() == before


@pytest.mark.slow
def test_native_vad_selftest_under_sanitizers():
    """The port's copy of the detectors under ASan/UBSan, no recovery from a
    finding: the self-test ends clean (the JAX package's
    ``tests/test_native_sanitize.py`` on the port's sources)."""
    exe = _build.build_vad_selftest()
    assert os.path.dirname(exe) == _build.BUILD_DIR
    run = subprocess.run([exe], capture_output=True, text=True, timeout=120)
    assert run.returncode == 0, f"sanitized self-test failed (rc={run.returncode}):\n{run.stderr}"
    assert "OK" in run.stderr


@pytest.mark.parametrize("rate", [8000, 16000, 32000, 48000])
def test_webrtc_native_matches_jax(vad_audio, rate):
    """Flags equal to the JAX package's native detector at each rate, in
    every mode, one-shot and fed in whole-frame chunks (the whole fixture
    at 16 kHz, 1.5 s of it resampled at the other rates)."""
    data = np.asarray(vad_audio)
    if rate != 16000:
        data = np.clip(resample(data[:24000].astype(np.float64), 16000, rate), -32768,
                       32767).astype(np.int16)
    for mode in range(4):
        ours, ref = WebRtcVad(mode=mode, sample_rate=rate), JWebRtcVad(mode=mode, sample_rate=rate)
        assert ours.FRAME_LEN == ref.FRAME_LEN == rate // 100
        flags = ours.process(data)
        np.testing.assert_array_equal(flags, ref.process(data))
        ours.reset()
        step = 37 * ours.FRAME_LEN
        chunked = np.concatenate([ours.process(data[i: i + step])
                                  for i in range(0, len(data), step)])
        np.testing.assert_array_equal(chunked, flags)
    with pytest.raises(ValueError):
        WebRtcVad(sample_rate=44100)


@pytest.mark.parametrize("pow_low", [None, 1e8])
def test_amrwb_native_matches_jax(vad_audio, pow_low):
    data = np.asarray(vad_audio)
    ours, ref = AmrWbVad(), JAmrWbVad()
    if pow_low is not None:
        ours.set_pow_low(pow_low)
        ref.set_pow_low(pow_low)
    flags, power = ours.process(data)
    ref_flags, ref_power = ref.process(data)
    assert flags.shape == (len(data) // 256,) and ours.FRAME_LEN == 256
    np.testing.assert_array_equal(flags, ref_flags)
    np.testing.assert_array_equal(power, ref_power)
    ours.reset()
    if pow_low is not None:
        ours.set_pow_low(pow_low)
    again, power2 = ours.process(data)
    np.testing.assert_array_equal(again, flags)
    np.testing.assert_array_equal(power2, power)


@pytest.mark.parametrize("alpha", [None, 0.4])
def test_ltsd_matches_jax(vad_audio, alpha):
    data = np.asarray(vad_audio[:60000], np.float64) / 32768.0
    kw = dict(win_size=1024, step_size=512, order=4, threshold=-6.0, alpha=alpha)
    ref = np.asarray(JVadLtsd(JLTSDConfig(**kw), dtype=jnp.float64).detect(data).ltsd)
    vad = VadLtsd(LTSDConfig(**kw), dtype=F64, device="cpu")
    res = vad.detect(data)
    np.testing.assert_allclose(res.ltsd.numpy(), ref, rtol=1e-8, atol=1e-10)
    np.testing.assert_array_equal(res.is_speech.numpy(), res.ltsd.numpy() > -6.0)
    batch = vad.detect_batch(np.stack([data, data[::-1].copy()])).ltsd.numpy()
    np.testing.assert_array_equal(batch[0], res.ltsd.numpy())
    np.testing.assert_allclose(batch[1], vad.detect(data[::-1].copy()).ltsd.numpy(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("alpha", [None, 0.4])
def test_ltsd_empty_signal(alpha):
    """An empty signal (one stride of zeros in front, a window of two
    strides: no frame) scores no frame, as in the JAX package."""
    ref = JVadLtsd(JLTSDConfig(alpha=alpha)).detect(np.zeros(0))
    got = VadLtsd(LTSDConfig(alpha=alpha), device="cpu").detect(np.zeros(0))
    for a, b in zip(got, ref):
        assert tuple(a.shape) == np.asarray(b).shape == (0,)
        assert a.numpy().dtype == np.asarray(b).dtype


def _jit(fn, static=()):
    import jax

    return jax.jit(fn, static_argnums=static)


def _seeded(n, seed=0):
    return np.random.default_rng(seed).normal(size=n)


def test_first_order_recurrence(seed=0):
    x = _seeded(1001, seed)
    a_var = np.random.default_rng(1).uniform(-0.95, 0.95, size=1001)
    for a in (0.9, -0.6, a_var):
        got = tlf.first_order_recurrence(torch.as_tensor(np.asarray(a)), torch.as_tensor(x),
                                         0.3).numpy()
        ref = np.asarray(_jit(jlf.first_order_recurrence)(jnp.asarray(a), jnp.asarray(x), 0.3))
        np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)
    # scipy, chunk by chunk with the state carried
    h1 = tlf.first_order_recurrence(0.9, torch.as_tensor(x[:400]), 0.3)
    h2 = tlf.first_order_recurrence(0.9, torch.as_tensor(x[400:]), h1[-1])
    ref, _ = scipy.signal.lfilter([1.0], [1.0, -0.9], x, zi=[0.9 * 0.3])
    np.testing.assert_allclose(torch.cat([h1, h2]).numpy(), ref, rtol=1e-10, atol=1e-12)


def test_affine_recurrence():
    rng = np.random.default_rng(2)
    t, d = 300, 3
    mats = rng.uniform(-0.5, 0.5, size=(t, d, d))
    vecs, h0 = rng.normal(size=(t, d)), rng.normal(size=d)
    got = tlf.affine_recurrence(*(torch.as_tensor(v) for v in (mats, vecs, h0))).numpy()
    ref = np.asarray(_jit(jlf.affine_recurrence)(jnp.asarray(mats), jnp.asarray(vecs),
                                                 jnp.asarray(h0)))
    np.testing.assert_allclose(got, ref, rtol=1e-10, atol=1e-12)
    h, loop = h0, []
    for k in range(t):
        h = mats[k] @ h + vecs[k]
        loop.append(h)
    np.testing.assert_allclose(got, np.asarray(loop), rtol=1e-10, atol=1e-12)


@pytest.mark.parametrize("c", [20972.0 / 32768.0, 5571.0 / 32768.0])
def test_allpass2(c):
    x = _seeded(2000, 3) * 1000.0
    state = (torch.tensor(0.0, dtype=F64), torch.tensor(0.0, dtype=F64))
    y, st = tlf.allpass2(torch.as_tensor(x), c, state)
    yj, stj = _jit(jlf.allpass2, 1)(jnp.asarray(x), c, (jnp.asarray(0.0), jnp.asarray(0.0)))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-10, atol=1e-9)
    np.testing.assert_allclose([float(v) for v in st], [float(v) for v in stj], rtol=1e-10)
    # y(n) = c x(n) + x(n-2) - c y(n-2), chunk by chunk with the state carried
    ref = scipy.signal.lfilter([c, 0.0, 1.0], [1.0, 0.0, c], x)
    outs = []
    for a in range(0, len(x), 600):
        y_k, state = tlf.allpass2(torch.as_tensor(x[a: a + 600]), c, state)
        outs.append(y_k)
    np.testing.assert_allclose(torch.cat(outs).numpy(), ref, rtol=1e-10, atol=1e-9)
    with pytest.raises(AssertionError):
        tlf.allpass2(torch.as_tensor(x[:7]), c, state)


def test_biquad():
    x = _seeded(1500, 4) * 1000.0
    b, a = jweb._HP_ZERO, jweb._HP_POLE
    st0 = np.array([0.5, -0.25, 2.0, -1.0])
    y, st = tlf.biquad(torch.as_tensor(x), b, a, torch.as_tensor(st0))
    yj, stj = _jit(jlf.biquad, (1, 2))(jnp.asarray(x), b, a, jnp.asarray(st0))
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), rtol=1e-10, atol=1e-9)
    np.testing.assert_allclose(st.numpy(), np.asarray(stj), rtol=1e-10, atol=1e-9)
    ref = scipy.signal.lfilter(b, a, x)
    state, outs = torch.zeros(4, dtype=F64), []
    for k in range(0, len(x), 499):
        y_k, state = tlf.biquad(torch.as_tensor(x[k: k + 499]), b, a, state)
        outs.append(y_k)
    np.testing.assert_allclose(torch.cat(outs).numpy(), ref, rtol=1e-10, atol=1e-9)


def test_webrtc_features_match_jax(vad_audio):
    """The filterbank features at float32 (float64 band sums) against the
    JAX package's. The two scans round in different orders, and the
    downsampler truncates to integers, so a last-bit difference can move a
    sample by one: log band energies agree within 0.005 dB, not bitwise."""
    x = np.asarray(vad_audio[: 160 * 300], np.float32)
    feats, total, st = tweb.extract_features(torch.as_tensor(x), tweb.initial_filter_state())
    jf, jt, jst = _jit(jweb.extract_features)(jnp.asarray(x), jweb.initial_filter_state())
    np.testing.assert_allclose(feats.numpy(), np.asarray(jf), rtol=0, atol=5e-3)
    np.testing.assert_allclose(total.numpy(), np.asarray(jt), rtol=1e-4, atol=1e-4)
    for a, b in zip(st, jst):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-3, atol=1.0)
    assert np.isfinite(feats.numpy()).all() and total.numpy().min() >= 0


def test_minimum_tracker_matches_jax():
    """The vectorized aging of the 16-slot minimum tracker (evictions as one
    stable compaction) against the JAX package's sequential walk, on states
    with runs of slots aged 100 at the start, the middle and the end: the
    same values and ages, the empty slots' ages past 100 included."""
    rng = np.random.default_rng(5)
    find_minimum = _jit(jweb._find_minimum)
    consts = tweb._constants(torch.float32, "cpu")
    for trial in range(40):
        ages = rng.integers(0, 99, size=(6, 16)).astype(np.int32)
        for ch in range(6):
            start = rng.integers(0, 16)
            ages[ch, start: start + rng.integers(1, 5)] = 100
            ages[ch, rng.integers(0, 16)] = 100
        ages[0, :] = 100
        ages[1, 12:] = 100
        ages[2, :] = rng.integers(101, 110, size=16)
        lows = np.sort(rng.uniform(0, 100, size=(6, 16)), axis=1).astype(np.float32)
        feats = rng.uniform(-10, 110, size=6).astype(np.float32)
        fc = int(rng.integers(0, 5))
        jstate = jweb.initial_gmm_state()._replace(
            low_values=jnp.asarray(lows), value_ages=jnp.asarray(ages),
            frame_count=jnp.asarray(fc, jnp.int32))
        tstate = tweb.initial_gmm_state()._replace(
            low_values=torch.as_tensor(lows), value_ages=torch.as_tensor(ages),
            frame_count=torch.tensor(fc, dtype=torch.int32))
        jl, ja, jm = (np.asarray(v) for v in find_minimum(jstate, jnp.asarray(feats)))
        tl, ta, tm = (v.numpy() for v in tweb._find_minimum(tstate, torch.as_tensor(feats), consts))
        np.testing.assert_array_equal(tl, jl, err_msg=f"trial {trial}")
        np.testing.assert_array_equal(tm, jm, err_msg=f"trial {trial}")
        np.testing.assert_array_equal(ta, ja, err_msg=f"trial {trial}")


@pytest.fixture(scope="module")
def jax_webrtc_flags(vad_audio):
    """The JAX package's WebRTC VAD flags in every mode from one compiled
    program: its own ``extract_features``, ``gmm_step`` and scan, as in
    ``webrtc_vad_flags``, with the mode's thresholds as arguments (one
    compilation instead of four); mode 0 also through ``WebRtcVadJax``
    itself, which must agree."""
    import jax

    data = np.asarray(vad_audio)
    x = jnp.asarray(data[: len(data) // 160 * 160], jnp.float32)

    @jax.jit
    def flags(x, thresholds):
        feats, total, _ = jweb.extract_features(x, jweb.initial_filter_state(jnp.float32))
        step = functools.partial(jweb.gmm_step, thresholds=thresholds)
        return jax.lax.scan(step, jweb.initial_gmm_state(jnp.float32), (feats, total))[1]

    out = {}
    for mode, (oh1, oh2, local, glob) in enumerate(jweb.MODE_TABLE):
        thresholds = (jnp.asarray(oh1, jnp.int32), jnp.asarray(oh2, jnp.int32),
                      jnp.asarray(local, jnp.float32), jnp.asarray(glob, jnp.float32))
        out[mode] = np.asarray(flags(x, thresholds))
    np.testing.assert_array_equal(out[0], jweb.WebRtcVadJax(mode=0).process(data))
    return out


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_webrtc_torch_matches_jax_and_native(vad_audio, jax_webrtc_flags, mode):
    data = np.asarray(vad_audio)
    native = WebRtcVad(mode=mode).process(data)
    ours = WebRtcVadTorch(mode=mode, device="cpu").process(data)
    assert ours.dtype == np.int32 and ours.shape == native.shape
    np.testing.assert_array_equal(ours, native)
    np.testing.assert_array_equal(ours, jax_webrtc_flags[mode])
