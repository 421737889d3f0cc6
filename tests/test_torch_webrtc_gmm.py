"""Kernel I (the WebRTC-style VAD's GMM recursion) on the CPU: its plain
version against the JAX package, a NumPy model of the kernel, the aging
walk the kernel runs, and the wrapper's dispatch.

- ``vad.webrtc.gmm_flags_plain`` (the frame loop the kernel is held to on
  the card) against ``jax.lax.scan(lnasr_tpu.vad.webrtc.gmm_step, ...)``
  on the same features (the port's filterbank of the ``vad_audio``
  fixture), modes 0-3: flags equal frame for frame; the final state's
  counters, tracker values and ages equal, its means, deviations and
  smoothed minima within ``rtol=1e-4``: the two packages' float32
  ``exp``/``log2`` differ in the last bits and the adaptation carries
  that through 1,250 frames (7.4e-6 relative at most, measured).
- ``vad.webrtc._age_walk`` (the torch mirror of the sequential aging walk
  that kernel I runs) and the plain version's compaction ``_age``, both
  bitwise against the JAX package's walk, ages past 100 included, on
  random states with runs of expiring slots (slot 15 evicted or passed
  over among them).
- A NumPy model of ``csrc/webrtc_gmm.cu``: its operations in its order
  (per channel, the 6-channel sum in order 0..5, the walk, the sorted
  insertion), at float32 and float64, held against the plain version:
  flags equal, state as above.
- The wrapper: CPU tensors take the plain version and count no launch; a
  CUDA tensor goes to the kernel or raises (a stand-in: this machine has
  no card), never to the frame loop.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lnasr_tpu.vad import webrtc as jweb
from lnasr_tpu_torch.vad import webrtc as tweb


@pytest.fixture(autouse=True)
def _one_thread():
    """The frame loop is thousands of tiny tensor ops: one CPU thread runs
    them faster than a pool."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def features(vad_audio):
    """The port's filterbank features of the fixture, float32 and float64."""
    data = np.asarray(vad_audio)
    out = {}
    for dtype in (torch.float32, torch.float64):
        x = torch.as_tensor(data[: len(data) // 160 * 160]).to(dtype)
        feats, total, _ = tweb.extract_features(x, tweb.initial_filter_state(dtype))
        out[dtype] = (feats, total)
    return out


@pytest.fixture(scope="module")
def jax_gmm():
    """The JAX package's GMM scan, one compiled program for every mode
    (the thresholds are arguments): ``(final state, flags)``."""

    @jax.jit
    def run(feats, total, thresholds):
        step = functools.partial(jweb.gmm_step, thresholds=thresholds)
        return jax.lax.scan(step, jweb.initial_gmm_state(jnp.float32), (feats, total))

    def call(feats, total, mode):
        oh1, oh2, local, glob = jweb.MODE_TABLE[mode]
        thr = (jnp.asarray(oh1, jnp.int32), jnp.asarray(oh2, jnp.int32),
               jnp.asarray(local, jnp.float32), jnp.asarray(glob, jnp.float32))
        state, flags = run(jnp.asarray(feats.numpy()), jnp.asarray(total.numpy()), thr)
        return state, np.asarray(flags)
    return call


def _same_state(got, ref, what):
    """The final GMM state ``got`` (torch) against ``ref`` (arrays): see
    the module's docstring for the bars."""
    for name in tweb.GmmState._fields:
        a, b = np.asarray(getattr(got, name)), np.asarray(getattr(ref, name))
        if name in ("low_values", "value_ages", "frame_count", "over_hang", "speech_run"):
            np.testing.assert_array_equal(a, b, err_msg=f"{what}: {name}")
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=0, err_msg=f"{what}: {name}")


@pytest.mark.parametrize("mode", [0, 1, 2, 3])
def test_plain_matches_jax_scan(features, jax_gmm, mode):
    feats, total = features[torch.float32]
    jstate, jflags = jax_gmm(feats, total, mode)
    flags, state = tweb.gmm_flags_plain(feats, total, tweb.MODE_TABLE[mode], final_state=True)
    assert flags.dtype == torch.int32 and flags.shape == (feats.shape[0],)
    np.testing.assert_array_equal(flags.numpy(), jflags)
    _same_state(state, jstate, f"mode {mode}")
    if mode < 2:  # the fixture has speech and hangover frames at these modes
        assert (jflags == 1).any() and (jflags >= 2).any()


def _random_tracker(rng):
    """Random tracker slots: sorted values, ages with runs of 100 at the
    start, the middle and the end (slot 15 passed over in channel 1,
    evicted in channels 3 and 4), and slots past 100."""
    ages = rng.integers(0, 99, size=(6, 16)).astype(np.int32)
    for ch in range(6):
        start = rng.integers(0, 16)
        ages[ch, start: start + rng.integers(1, 6)] = 100
        ages[ch, rng.integers(0, 16)] = 100
    ages[0, :] = 100
    ages[1, 12:] = 100
    ages[2, :] = rng.integers(99, 103, size=16)
    ages[3, 14:] = (50, 100)
    ages[4, 13:] = 100
    lows = np.sort(rng.uniform(0, 100, size=(6, 16)), axis=1).astype(np.float32)
    return lows, ages


def test_age_walk_matches_jax_walk_and_compaction():
    """The mirror of kernel I's walk and the plain version's compaction,
    both bitwise against the JAX package's fori_loop walk (its
    ``_find_minimum`` with a value above every slot inserts nothing), the
    empty slots' ages (101, or 102 where the walk reaches them) too."""
    rng = np.random.default_rng(14)
    find_minimum = jax.jit(jweb._find_minimum)
    consts = tweb._constants(torch.float32, "cpu")
    above = jnp.full((6,), 1e9, jnp.float32)
    for trial in range(60):
        lows, ages = _random_tracker(rng)
        wl, wa = (x.numpy() for x in tweb._age_walk(torch.as_tensor(lows), torch.as_tensor(ages)))
        state = jweb.initial_gmm_state()._replace(low_values=jnp.asarray(lows),
                                                  value_ages=jnp.asarray(ages))
        jl, ja, _ = (np.asarray(x) for x in find_minimum(state, above))
        np.testing.assert_array_equal(wl, jl, err_msg=f"trial {trial}")
        np.testing.assert_array_equal(wa, ja, err_msg=f"trial {trial}")
        cl, ca = (x.numpy() for x in tweb._age(torch.as_tensor(lows), torch.as_tensor(ages),
                                               consts))
        np.testing.assert_array_equal(cl, jl, err_msg=f"trial {trial}")
        np.testing.assert_array_equal(ca, ja, err_msg=f"trial {trial}")


# -- a NumPy model of kernel I ---------------------------------------------------


def _kernel_model(feats, total, thresholds):
    """What ``csrc/webrtc_gmm.cu`` computes, vectorized over the 6 channels
    (lanes) in the working dtype, each operation rounded as there:
    ``(flags, GmmState)``."""
    dt = feats.dtype.type
    c = lambda x: np.asarray(x, feats.dtype)  # noqa: E731
    nw, sw = c(tweb._NOISE_W), c(tweb._SPEECH_W)
    weight, min_diff = c(tweb._SPECTRUM_WEIGHT), c(tweb._MIN_DIFF)
    max_noise, max_speech = c(tweb._MAX_NOISE), c(tweb._MAX_SPEECH)
    nm, sm = c(tweb._NOISE_MEANS), c(tweb._SPEECH_MEANS)
    ns, ss = c(tweb._NOISE_STDS), c(tweb._SPEECH_STDS)
    lows, ages = np.full((6, 16), dt(625.0)), np.zeros((6, 16), np.int32)
    mv = np.full(6, dt(100.0))
    fc = oh = sr = 0
    oh1, oh2, local_thr, global_thr = thresholds
    tiny, g_idx, ch = dt(1e-38), c([[0.0], [1.0]]), c(np.arange(6))
    flags = np.zeros(len(feats), np.int32)

    def gauss(x, mean, std):
        d = x - mean
        q = (d * d) / ((dt(2) * std) * std)
        return np.where(q < dt(22005.0 / 1024.0), np.exp(-np.minimum(q, dt(80))) / std, dt(0))

    for i, (x, tp) in enumerate(zip(feats, total)):
        active = tp > dt(10)
        pn, ps = nw * gauss(x, nm, ns), sw * gauss(x, sm, ss)
        h0, h1 = pn[0] + pn[1], ps[0] + ps[1]
        shift0 = np.where(h0 <= 0, dt(31), dt(4) - np.log2(np.maximum(h0, tiny)))
        shift1 = np.where(h1 <= 0, dt(31), dt(4) - np.log2(np.maximum(h1, tiny)))
        llr = shift0 - shift1
        term = llr * weight
        sum_llr = term[0]
        for j in range(1, 6):
            sum_llr = sum_llr + term[j]
        vad = bool(active) and (bool((llr * dt(4) > dt(local_thr)).any())
                                or bool(sum_llr >= dt(global_thr)))
        ngpr0 = np.where(h0 > 0, pn[0] / np.maximum(h0, tiny), dt(1))
        ngpr = np.stack([ngpr0, dt(1) - ngpr0])
        sgpr0 = np.where(h1 > 0, ps[0] / np.maximum(h1, tiny), dt(0))
        sgpr = np.stack([sgpr0, np.where(h1 > 0, dt(1) - sgpr0, dt(0))])
        nl, na = (y.numpy() for y in tweb._age_walk(torch.as_tensor(lows), torch.as_tensor(ages)))
        for k in range(6):  # the sorted insertion, a lane each
            below = np.nonzero(x[k] < nl[k])[0]
            if len(below):
                p = below[0]
                nl[k, p + 1:], na[k, p + 1:] = nl[k, p:-1].copy(), na[k, p:-1].copy()
                nl[k, p], na[k, p] = x[k], 1
        median = nl[:, 2] if fc > 2 else (nl[:, 0] if fc > 0 else np.full(6, dt(100)))
        alpha = (np.where(median < mv, dt(6553 / 32768), dt(32439 / 32768)) if fc > 0
                 else np.full(6, dt(0)))
        mv_new = ((alpha + dt(1 / 32768)) * mv + (dt(1) - alpha) * median) + dt(1 / 32)
        ngm = nm[0] * nw[0] + nm[1] * nw[1]
        dn, ds = x - nm, x - sm
        delta_n, delta_s = dn / (ns * ns), ds / (ss * ss)
        upd = np.zeros_like(nm) if vad else (dt(655 / 32768) * ngpr) * delta_n
        nm1 = (nm + upd) + dt(154 / 256) * (mv_new - ngm)
        nm1 = np.minimum(np.maximum(nm1, g_idx + dt(5)), dt(72) + g_idx - ch)
        sm1 = sm + (dt(6554 / 32768) * sgpr) * delta_s
        sm1 = np.minimum(np.maximum(sm1, g_idx + dt(5)), dt(105))
        sm1 = sm1 if vad else sm
        ss1 = ss + ((sgpr * (delta_s * ds - dt(1))) * dt(0.1)) / ss
        ss1 = np.maximum(ss1, dt(3)) if vad else ss
        ns1 = ns + (ngpr * (delta_n * dn - dt(1))) / ns
        ns1 = ns if vad else np.maximum(ns1, dt(3))
        ngm2, sgm = nm1[0] * nw[0] + nm1[1] * nw[1], sm1[0] * sw[0] + sm1[1] * sw[1]
        t_sep = np.maximum(min_diff - (sgm - ngm2), dt(0))
        sm1, nm1 = sm1 + dt(0.8) * t_sep, nm1 - dt(0.2) * t_sep
        sgm2, ngm3 = sm1[0] * sw[0] + sm1[1] * sw[1], nm1[0] * nw[0] + nm1[1] * nw[1]
        sm1 = sm1 - np.maximum(sgm2 - max_speech, dt(0))
        nm1 = nm1 - np.maximum(ngm3 - max_noise, dt(0))
        hang = not vad and oh > 0
        flags[i] = oh + 2 if hang else int(vad)
        oh = (oh2 if sr >= 6 else oh1) if vad else oh - int(hang)
        sr = min(sr + 1, 6) if vad else 0
        if active:
            nm, sm, ns, ss, lows, ages, mv = nm1, sm1, ns1, ss1, nl, na, mv_new
            fc += 1
    t = torch.as_tensor
    return flags, tweb.GmmState(t(nm), t(sm), t(ns), t(ss), t(fc), t(oh), t(sr), t(lows),
                                t(ages), t(mv))


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("mode", [0, 2])
def test_kernel_model_matches_plain(features, mode, dtype):
    feats, total = features[dtype]
    flags, state = tweb.gmm_flags_plain(feats, total, tweb.MODE_TABLE[mode], final_state=True)
    mflags, mstate = _kernel_model(feats.numpy(), total.numpy(), tweb.MODE_TABLE[mode])
    np.testing.assert_array_equal(mflags, flags.numpy())
    _same_state(mstate, state, f"mode {mode} {dtype}")


# -- the wrapper ------------------------------------------------------------------


class _CudaStandIn:
    """A CUDA tensor's device, dtype and shape: all the wrapper reads before
    it reaches the card."""

    def __init__(self, shape, dtype=torch.float32):
        self.device, self.dtype, self.shape = torch.device("cuda"), dtype, torch.Size(shape)

    def dim(self):
        return len(self.shape)


def test_wrapper_dispatch(features, monkeypatch):
    """CPU tensors take the plain version (``webrtc_vad_flags`` too) and
    count no launch; a CUDA tensor reaches the kernel (here: fails for want
    of a card) or raises on what the kernel does not take, never looping."""
    feats, total = features[torch.float32]
    feats, total = feats[:200], total[:200]
    tweb.gmm_flags.launches = 0
    thr = tweb.MODE_TABLE[1]
    assert torch.equal(tweb.gmm_flags(feats, total, thr), tweb.gmm_flags_plain(feats, total, thr))
    assert tweb.gmm_flags(feats[:0], total[:0], thr).shape == (0,)
    tweb.webrtc_vad_flags(torch.zeros(1600, dtype=torch.int16), mode=1)
    assert tweb.gmm_flags.launches == 0

    def no_loop(*a, **k):
        raise AssertionError("the frame loop ran for a CUDA tensor")
    monkeypatch.setattr(tweb, "gmm_flags_plain", no_loop)
    monkeypatch.setattr(tweb, "gmm_step", no_loop)
    with pytest.raises(ValueError, match="features \\(F, 6\\)"):
        tweb.gmm_flags(_CudaStandIn((50, 5)), _CudaStandIn((50,)), thr)
    with pytest.raises(ValueError, match="float32 or float64"):
        tweb.gmm_flags(_CudaStandIn((50, 6), torch.float16), _CudaStandIn((50,), torch.float16),
                       thr)
    with pytest.raises(ValueError, match="one dtype"):
        tweb.gmm_flags(_CudaStandIn((50, 6)), _CudaStandIn((50,), torch.float64), thr)
    with pytest.raises((RuntimeError, AssertionError)):  # the launch needs a card
        tweb.gmm_flags(_CudaStandIn((50, 6)), _CudaStandIn((50,)), thr)
    with pytest.raises(ValueError, match="cpu or cuda"):
        tweb.gmm_flags(torch.zeros((5, 6), device="meta"), torch.zeros(5, device="meta"), thr)
    assert tweb.gmm_flags.launches == 0
