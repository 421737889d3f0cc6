"""The port's MFCC frontend against the JAX package on the same inputs.

Bars, from the JAX package's own kernel tests: mel energies within
``atol=2e-6 * max_energy, rtol=1e-4`` (fp32 sums in another order), and
features within 0.01 max-abs (the dB of near-silent mel bins amplifies
the last-ulp differences of the power spectrum). JAX runs in float32,
given explicitly: the test harness turns on x64.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lnasr_tpu import config as jconfig
from lnasr_tpu.models import mfcc as jmfcc
from lnasr_tpu.ops import framing as jframing
from lnasr_tpu.ops import spectral as jspectral
from lnasr_tpu.ops.mfcc_pallas import mel_frontend_pallas
from lnasr_tpu_torch import config as tconfig
from lnasr_tpu_torch.models import mfcc as tmfcc
from lnasr_tpu_torch.ops import framing as tframing
from lnasr_tpu_torch.ops import spectral as tspectral
from lnasr_tpu_torch.ops.mel_frontend import mel_frontend, mel_frontend_plain, preemphasize

J_CFG = jconfig.MFCCConfig(energy_floor=1e-10)
T_CFG = tconfig.MFCCConfig(energy_floor=1e-10)
N_SAMPLES = 16000  # 1 s: keeps the interpret-mode Pallas runs short
LENGTHS = np.array([16000, 14321, 9000])


@pytest.fixture(scope="module")
def signals(speech_audio):
    rng = np.random.default_rng(3)
    base = np.asarray(speech_audio, np.float32)
    sig = np.stack([np.resize(base[i * 37:], N_SAMPLES) for i in range(3)])
    return sig + rng.normal(scale=30.0, size=sig.shape).astype(np.float32)


def _jax_features(sig, cfg, lengths=None):
    if lengths is None:
        fn = lambda s: jmfcc.mfcc_features(s, cfg, dtype=jnp.float32)  # noqa: E731
        return jax.vmap(fn)(jnp.asarray(sig))
    fn = lambda s, n: jmfcc.mfcc_features(s, cfg, length=n, dtype=jnp.float32)  # noqa: E731
    return jax.vmap(fn)(jnp.asarray(sig), jnp.asarray(lengths))


@pytest.mark.parametrize("cls", ["MFCCConfig", "GMMHMMConfig"])
def test_config_fields_match(cls):
    j, t = getattr(jconfig, cls)(), getattr(tconfig, cls)()
    assert [f.name for f in dataclasses.fields(j)] == [f.name for f in dataclasses.fields(t)]
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    if cls == "MFCCConfig":
        for prop in ("frame_len", "frame_step", "fft_size", "feature_dim"):
            assert getattr(j, prop) == getattr(t, prop)


@pytest.mark.parametrize("length", [1, 239, 240, 241, 400, 16000, 16001])
def test_framing_matches(length):
    rng = np.random.default_rng(length)
    x = rng.normal(size=(2, length)).astype(np.float32)
    L, S = 400, 160
    assert tframing.num_frames(length, L, S) == jframing.num_frames(length, L, S)
    assert tframing.pad_length(length, L, S) == jframing.pad_length(length, L, S)
    np.testing.assert_array_equal(
        tframing.split_frames(torch.as_tensor(x), L, S).numpy(),
        np.asarray(jframing.split_frames(jnp.asarray(x), L, S)))
    np.testing.assert_array_equal(
        tframing.preemphasis(torch.as_tensor(x), 0.97).numpy(),
        np.asarray(jframing.preemphasis(jnp.asarray(x), 0.97)))
    lengths = np.array([length, max(1, length // 3)])
    n = tframing.num_frames(length, L, S)
    np.testing.assert_array_equal(
        tframing.frame_mask(torch.as_tensor(lengths), n, L, S).numpy(),
        np.asarray(jframing.frame_mask(jnp.asarray(lengths), n, L, S)))


@pytest.mark.parametrize("shape, L, S", [((3, 240), 400, 160), ((1024,), 2048, 1024),
                                          ((128,), 256, 128), ((2, 0), 400, 400)])
def test_framing_zero_frames(shape, L, S):
    """A signal of exactly L - S samples has no frame: the JAX package's
    ``(..., 0, L)`` in the signal's dtype, whatever the leading axes."""
    x = np.random.default_rng(L).normal(size=shape).astype(np.float32)
    assert tframing.num_frames(shape[-1], L, S) == 0
    got = tframing.split_frames(torch.as_tensor(x), L, S)
    ref = np.asarray(jframing.split_frames(jnp.asarray(x), L, S))
    assert tuple(got.shape) == ref.shape == (*shape[:-1], 0, L)
    assert got.dtype == torch.float32 and ref.dtype == np.float32
    np.testing.assert_array_equal(got.numpy(), ref)


def test_mfcc_zero_frames():
    """``MFCC`` of 240 int16 samples (no frame at L = 400, S = 160): every
    output's shape and dtype the JAX package's, the serving path's and the
    kernel's plain version empty too."""
    x = np.random.default_rng(240).integers(-3000, 3000, size=240).astype(np.int16)
    ref = jmfcc.MFCC(jconfig.MFCCConfig())(x)
    m = tmfcc.MFCC(tconfig.MFCCConfig(), device="cpu")
    got = m(x)
    for name in ref._fields:
        a, b = getattr(got, name), np.asarray(getattr(ref, name))
        assert tuple(a.shape) == b.shape and a.numpy().dtype == b.dtype, name
    assert [tuple(r.shape) for r in (ref.power, ref.cepstrum, ref.features, ref.mask)] == [
        (0, 257), (0, 40), (0, 39), (0,)]
    feats, mask = m.features_fast(x)
    assert tuple(feats.shape) == (0, 39) and feats.dtype == torch.float32 and mask is None
    feats, mask = m.features_fast(np.stack([x, x]), np.array([240, 100]))
    assert tuple(feats.shape) == (2, 0, 39) and tuple(mask.shape) == (2, 0)
    mel, energy = mel_frontend(torch.as_tensor(np.stack([x, x, x])), T_CFG)
    assert tuple(mel.shape) == (3, 0, 40) and tuple(energy.shape) == (3, 0)


def test_spectral_constants_match():
    np.testing.assert_array_equal(tframing.hamming_window(400), jframing.hamming_window(400))
    np.testing.assert_array_equal(tspectral.mel_filterbank(40, 512, 16000),
                                  jspectral.mel_filterbank(40, 512, 16000))
    np.testing.assert_array_equal(tspectral.dct2_ortho_matrix(40), jspectral.dct2_ortho_matrix(40))
    for a, b in zip(tspectral.windowed_dft_basis(400, 512), jspectral.windowed_dft_basis(400, 512)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("method", ["matmul", "fft"])
def test_power_spectrum_matches(signals, method):
    frames = signals[:, :4000].reshape(2, -1, 400)[:, :, :400] / 1000.0
    got = tspectral.power_spectrum(torch.as_tensor(frames), 512, method).numpy()
    ref = np.asarray(jspectral.power_spectrum(jnp.asarray(frames), 512, method))
    np.testing.assert_allclose(got, ref, atol=2e-6 * ref.max(), rtol=1e-4)


def test_mel_frontend_matches_pallas_and_xla(signals):
    """The kernel's plain version against the TPU kernel (interpret mode,
    f32-faithful passes=6) and against the XLA power @ fbank chain."""
    mel, energy = mel_frontend(torch.as_tensor(signals), T_CFG, passes=6)
    p_mel, p_energy = mel_frontend_pallas(jnp.asarray(signals), J_CFG, passes=6, interpret=True)
    power = np.asarray(_jax_features(signals, J_CFG).power)
    fbank = jspectral.mel_filterbank(40, 512, 16000).astype(np.float32)
    x_mel, x_energy = power @ fbank.T, power.sum(-1)
    scale = float(x_energy.max())
    for ref_mel, ref_energy in ((p_mel, p_energy), (x_mel, x_energy)):
        np.testing.assert_allclose(mel.numpy(), np.asarray(ref_mel), atol=2e-6 * scale, rtol=1e-4)
        np.testing.assert_allclose(energy.numpy(), np.asarray(ref_energy),
                                   atol=2e-6 * scale, rtol=1e-4)


def test_mel_frontend_lengths_zero_after_preemphasis(signals):
    lengths = torch.as_tensor(LENGTHS)
    mel, energy = mel_frontend(torch.as_tensor(signals), T_CFG, lengths=lengths)
    p_mel, p_energy = mel_frontend_pallas(jnp.asarray(signals), J_CFG, lengths=jnp.asarray(LENGTHS),
                                          passes=6, interpret=True)
    scale = float(np.asarray(p_energy).max())
    np.testing.assert_allclose(mel.numpy(), np.asarray(p_mel), atol=2e-6 * scale, rtol=1e-4)
    np.testing.assert_allclose(energy.numpy(), np.asarray(p_energy), atol=2e-6 * scale, rtol=1e-4)
    y = preemphasize(torch.as_tensor(signals), T_CFG, lengths)
    assert float(y[2, 9000:].abs().max()) == 0.0 and float(y[2, 8999]) != 0.0
    np.testing.assert_array_equal(mel_frontend_plain(y, T_CFG)[0].numpy(), mel.numpy())


@pytest.mark.parametrize("bad", [dict(passes=4), dict(fft_n=384), dict(fft_n=256)])
def test_mel_frontend_rejects(signals, bad):
    passes = bad.pop("passes", 6)
    cfg = dataclasses.replace(T_CFG, **bad)
    with pytest.raises(ValueError):
        mel_frontend(torch.as_tensor(signals[:1]), cfg, passes=passes)


@pytest.mark.parametrize("variable", [False, True])
def test_mfcc_features_match(signals, variable):
    lengths = LENGTHS if variable else None
    ref = _jax_features(signals, J_CFG, lengths)
    got = tmfcc.mfcc_features(torch.as_tensor(signals), T_CFG,
                              None if lengths is None else torch.as_tensor(lengths))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    m = got.mask.numpy()[..., None]
    assert np.max(np.abs(got.features.numpy() - np.asarray(ref.features)) * m) < 0.01
    assert np.max(np.abs(got.cepstrum.numpy() - np.asarray(ref.cepstrum)) * m) < 0.01
    scale = float(np.asarray(ref.power).max())
    np.testing.assert_allclose(got.power.numpy(), np.asarray(ref.power), atol=2e-6 * scale, rtol=1e-4)


@pytest.mark.parametrize("variable", [False, True])
def test_features_fast_matches_fused(signals, variable):
    """The port's serving path (CPU: plain mel + epilogue) against the JAX
    fused frontend in interpret mode, and the single-utterance form."""
    lengths = LENGTHS if variable else None
    ref, ref_mask = jmfcc.mfcc_features_fused(jnp.asarray(signals), J_CFG, lengths=lengths,
                                              passes=6, interpret=True, dtype=jnp.float32)
    m = tmfcc.MFCC(T_CFG, device="cpu")
    got, mask = m.features_fast(signals, lengths)
    assert got.shape == ref.shape and got.dtype == torch.float32
    if variable:
        np.testing.assert_array_equal(mask.numpy(), np.asarray(ref_mask))
        w = mask.numpy()[..., None]
    else:
        assert mask is None
        w = 1.0
    assert np.max(np.abs(got.numpy() - np.asarray(ref)) * w) < 0.01
    fused, _ = tmfcc.mfcc_features_fused(torch.as_tensor(signals), T_CFG,
                                         None if lengths is None else torch.as_tensor(lengths))
    np.testing.assert_array_equal(fused.numpy(), got.numpy())
    one, one_mask = m.features_fast(signals[1], None if lengths is None else lengths[1])
    assert np.max(np.abs(one.numpy() - got[1].numpy())) < 1e-3
    if variable:
        np.testing.assert_array_equal(one_mask.numpy(), mask[1].numpy())


@pytest.mark.parametrize("delta_mode", ["compat", "standard"])
@pytest.mark.parametrize("mean_norm", [True, False])
def test_delta_modes_and_mean_norm(signals, delta_mode, mean_norm):
    jc = dataclasses.replace(J_CFG, delta_mode=delta_mode, mean_norm=mean_norm)
    tc = dataclasses.replace(T_CFG, delta_mode=delta_mode, mean_norm=mean_norm)
    ref = np.asarray(jmfcc.MFCC(jc, dtype=jnp.float32)(jnp.asarray(signals[0])).features)
    got = tmfcc.MFCC(tc, device="cpu")(signals[0]).features.numpy()
    assert np.max(np.abs(got - ref)) < 0.01
    if delta_mode == "compat":  # row 0 of the delta repeats feature row 1
        np.testing.assert_array_equal(got[0, 13:26], got[1, :13])


def test_int16_input_and_fft_method(speech_audio):
    audio = np.asarray(speech_audio[:12000], np.int16)
    for method in ("matmul", "fft"):
        jc = dataclasses.replace(J_CFG, spectrum_method=method)
        tc = dataclasses.replace(T_CFG, spectrum_method=method)
        ref = np.asarray(jmfcc.MFCC(jc, dtype=jnp.float32)(audio).features)
        got = tmfcc.MFCC(tc, device="cpu")(audio).features.numpy()
        assert np.max(np.abs(got - ref)) < 0.01


def test_frontend_dispatch():
    cpu = torch.device("cpu")
    assert not tmfcc.use_fused_frontend(T_CFG, cpu)
    assert not tmfcc.use_fused_frontend(dataclasses.replace(T_CFG, frontend="xla"), cpu)
    with pytest.raises(ValueError, match="CUDA"):
        tmfcc.use_fused_frontend(dataclasses.replace(T_CFG, frontend="fused"), cpu)
    with pytest.raises(ValueError, match="CUDA"):
        tmfcc.MFCC(dataclasses.replace(T_CFG, frontend="fused"), device="cpu").features_fast(
            np.zeros(4000, np.float32))
    with pytest.raises(ValueError, match="unknown frontend"):
        tmfcc.use_fused_frontend(dataclasses.replace(T_CFG, frontend="gpu"), cpu)
