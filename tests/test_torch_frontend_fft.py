"""A NumPy model of the mel frontend kernel's warp-per-frame route
(``csrc/mel_frontend.cu``), held against its plain version and the JAX
package's kernel.

The CUDA kernel cannot run here, so its arithmetic runs here instead, in
float64 as the kernel computes (from the windowing of the float32 samples
to the mel sums, each output rounded once to float32) and in the kernel's order:
each lane's points z[l + 32m], the
Stockham radix passes of ``ops.mel_frontend.fft_plan`` with their
radix-8/4/2 DFTs and the host's pass twiddles, every exchange through a
warp plane at the kernel's padded elements (``padded``), the split step
and power of bins l, l + 32, ..., the frame energy as lane partials plus
an xor shuffle tree, and each mel filter summed over its packed support.
Bars: mel energies within ``atol=2e-6 * max_energy, rtol=1e-4`` of
``mel_frontend_plain`` and of ``mel_frontend_pallas(passes=6,
interpret=True)``, features within 0.01 of a float64 oracle.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lnasr_tpu import config as jconfig
from lnasr_tpu.ops.mfcc_pallas import mel_frontend_pallas
from lnasr_tpu_torch import config as tconfig
from lnasr_tpu_torch.models.mfcc import cepstral_epilogue
from lnasr_tpu_torch.ops.framing import frame_mask, hamming_window, num_frames
from lnasr_tpu_torch.ops.mel_frontend import (
    fft_plan,
    frames_per_block,
    mel_frontend,
    mel_frontend_plain,
    mel_support,
    pass_twiddles,
    preemphasize,
)
from lnasr_tpu_torch.ops.spectral import mel_filterbank

N_SAMPLES = 16000  # 1 s, 3 utterances: keeps the interpret-mode Pallas runs short
LENGTHS = np.array([16000, 14321, 9000])
# (frame_len, fft_n, n_mels) at 16 kHz
GEOMETRIES = [(400, 512, 40), (320, 512, 26), (400, 1024, 80), (240, 256, 40)]
F32, F64 = np.float32, np.float64
SQRT1_2 = np.sqrt(0.5)


def _cfg(frame_len, fft_n, n_mels, mod=tconfig):
    return mod.MFCCConfig(frame_t=frame_len / 16000, fft_n=fft_n, n_mels=n_mels,
                          energy_floor=1e-10)


@pytest.fixture(scope="module")
def signals(speech_audio):
    rng = np.random.default_rng(3)
    base = np.asarray(speech_audio, np.float32)
    sig = np.stack([np.resize(base[i * 37:], N_SAMPLES) for i in range(3)])
    return sig + rng.normal(scale=30.0, size=sig.shape).astype(np.float32)


# -- the model ---------------------------------------------------------------


def padded(i):
    """Element of point ``i`` in a warp's plane of float64: one pad element
    after every 16 (the kernel's ``pad``)."""
    return i + (i >> 4)


def _dft4(y):
    """The kernel's dft4 on four complex (re, im) pairs: outputs Y0..Y3."""
    (y0r, y0i), (y1r, y1i), (y2r, y2i), (y3r, y3i) = y
    c0r, c0i = y0r + y2r, y0i + y2i
    c1r, c1i = y0r - y2r, y0i - y2i
    c2r, c2i = y1r + y3r, y1i + y3i
    c3r, c3i = y1i - y3i, y3r - y1r  # (y1 - y3)(-i)
    return [(c0r + c2r, c0i + c2i), (c1r + c3r, c1i + c3i), (c0r - c2r, c0i - c2i),
            (c1r - c3r, c1i - c3i)]


def _dft(x, sqrt1_2=SQRT1_2):
    """The kernel's radix-R DFT (R = 2, 4, 8) on a list of (re, im)."""
    if len(x) == 2:
        (ar, ai), (br, bi) = x
        return [(ar + br, ai + bi), (ar - br, ai - bi)]
    if len(x) == 4:
        return _dft4(x)
    a = [(x[n][0] + x[n + 4][0], x[n][1] + x[n + 4][1]) for n in range(4)]
    d = [(x[n][0] - x[n + 4][0], x[n][1] - x[n + 4][1]) for n in range(4)]
    b = [d[0],
         ((d[1][0] + d[1][1]) * sqrt1_2, (d[1][1] - d[1][0]) * sqrt1_2),
         (d[2][1], -d[2][0]),
         ((d[3][1] - d[3][0]) * sqrt1_2, -(d[3][0] + d[3][1]) * sqrt1_2)]
    ea, eb = _dft4(a), _dft4(b)
    return [ea[0], eb[0], ea[1], eb[1], ea[2], eb[2], ea[3], eb[3]]


def fft_model(zr, zi, plan, dtype=F64):
    """The warp's FFT of ``z (F, H)`` frames: lane l holds z[l + 32m]; each
    Stockham pass twiddles, runs its DFT and stores to the plane at
    ``padded(d + r Ns)``; the next pass loads ``padded(l + 32m)``.
    Returns the planes ``(re, im)`` (Z[k] at ``padded(k)``) and every
    pass's store words, ``[(pass, c, r, words of lanes 0..31)]``."""
    f, h = zr.shape
    p_pts = h // 32
    lane = np.arange(32)
    m = np.arange(p_pts)
    idx = lane[:, None] + 32 * m[None, :]  # (32, P): lane l holds z[l + 32m]
    vr, vi = zr[:, idx].astype(dtype), zi[:, idx].astype(dtype)
    tw = pass_twiddles(plan).astype(dtype)
    plane_r, plane_i = np.zeros((f, h + h // 16), dtype), np.zeros((f, h + h // 16), dtype)
    stores, ns, tw_off = [], 1, 0
    for p, r_ in enumerate(plan):
        c_n = p_pts // r_
        for c in range(c_n):
            j = lane + 32 * c
            s = j & (ns - 1)
            pts = [(vr[:, :, c + r * c_n], vi[:, :, c + r * c_n]) for r in range(r_)]
            if p > 0:
                for r in range(1, r_):
                    w = tw[tw_off + r * ns + s]  # (32, 2)
                    ar, ai = pts[r]
                    pts[r] = (ar * w[:, 0] - ai * w[:, 1], ar * w[:, 1] + ai * w[:, 0])
            out = _dft(pts, dtype(np.sqrt(0.5)))
            d = (j // ns) * ns * r_ + s
            for r in range(r_):
                words = padded(d + r * ns)
                stores.append((p, c, r, words))
                plane_r[:, words], plane_i[:, words] = out[r]
        if p > 0:
            tw_off += r_ * ns
        ns *= r_
        if p + 1 < len(plan):
            words = padded(idx)
            vr, vi = plane_r[:, words], plane_i[:, words]
    return (plane_r, plane_i), stores


def split_power(plane_r, plane_i, k, h, dtype=F64):
    """Power of bins ``k`` from the plane, as the kernel's split_power."""
    ka, kb = padded(k & (h - 1)), padded((h - k) & (h - 1))
    ar, ai, br, bi = plane_r[:, ka], plane_i[:, ka], plane_r[:, kb], plane_i[:, kb]
    half = dtype(0.5)
    er, ei = half * (ar + br), half * (ai - bi)
    orr, oi = half * (ai + bi), -half * (ar - br)
    ang = 2.0 * np.pi * k / (2 * h)
    c, sn = np.cos(ang).astype(dtype), np.sin(ang).astype(dtype)
    xr = er + (c * orr + sn * oi)
    xi = ei + (c * oi - sn * orr)
    return (xr * xr + xi * xi) * dtype(1.0 / (2 * h))


def kernel_model(y, cfg, dtype=F64):
    """The warp route on pre-emphasized ``y (B, S)``: ``(mel (B, T,
    n_mels), energy (B, T))`` rounded to float32, and the FFT's store
    words."""
    b, s_len = y.shape
    h = cfg.fft_n // 2
    plan = fft_plan(cfg.fft_n)
    t = num_frames(s_len, cfg.frame_len, cfg.frame_step)
    # each frame's fft_n samples from the zero-padded span, times the window
    # zero-padded past frame_len
    pad = np.zeros((b, (t - 1) * cfg.frame_step + cfg.fft_n), F32)
    pad[:, :min(s_len, pad.shape[1])] = y[:, :pad.shape[1]]
    n = np.arange(cfg.fft_n)
    x = pad[:, np.arange(t)[:, None] * cfg.frame_step + n[None, :]].reshape(b * t, -1)
    win = np.zeros(cfg.fft_n, dtype)
    win[:cfg.frame_len] = hamming_window(cfg.frame_len)
    x = x.astype(dtype) * win
    (pr, pi), stores = fft_model(x[:, 0::2], x[:, 1::2], plan, dtype)
    lane = np.arange(32)
    pw = np.stack([split_power(pr, pi, lane + 32 * m, h, dtype) for m in range(h // 32)], -1)
    p_h = split_power(pr, pi, np.array([h]), h, dtype)[:, 0]
    # energy: each lane's partial over its bins in order (lane 0 adds bin H),
    # then the xor butterfly
    part = np.zeros((b * t, 32), dtype)
    for m in range(h // 32):
        part = part + pw[:, :, m]
    part[:, 0] = part[:, 0] + p_h
    for off in (16, 8, 4, 2, 1):
        part = part + part[:, lane ^ off]
    power = np.concatenate([pw.transpose(0, 2, 1).reshape(b * t, h), p_h[:, None]], -1)
    weights, lo, hi, off = mel_support(mel_filterbank(cfg.n_mels, cfg.fft_n, cfg.sample_rate))
    weights = weights.astype(dtype)
    mel = np.zeros((b * t, cfg.n_mels), dtype)
    for mm in range(cfg.n_mels):  # filter m on lane m % 32, bins in order
        acc = np.zeros(b * t, dtype)
        for k in range(lo[mm], hi[mm]):
            acc = acc + weights[off[mm] + k - lo[mm]] * power[:, k]
        mel[:, mm] = acc
    return (mel.reshape(b, t, -1).astype(F32), part[:, 0].reshape(b, t).astype(F32), stores)


# -- tests -----------------------------------------------------------------


def _bars(got, ref, scale):
    np.testing.assert_allclose(got, ref, atol=2e-6 * scale, rtol=1e-4)


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=lambda g: "-".join(map(str, g)))
@pytest.mark.parametrize("variable", [False, True], ids=["full", "lengths"])
def test_model_within_mel_bars(signals, geometry, variable):
    """The model against ``mel_frontend_plain`` and the JAX package's kernel
    (interpret mode, f32-faithful passes=6), with and without lengths."""
    cfg, jcfg = _cfg(*geometry), _cfg(*geometry, mod=jconfig)
    lengths = LENGTHS if variable else None
    y = preemphasize(torch.as_tensor(signals), cfg,
                     None if lengths is None else torch.as_tensor(lengths))
    mel, energy, _ = kernel_model(y.numpy(), cfg)
    p_mel, p_energy = mel_frontend_plain(y, cfg)
    j_mel, j_energy = mel_frontend_pallas(jnp.asarray(signals), jcfg, passes=6, interpret=True,
                                          lengths=None if lengths is None else
                                          jnp.asarray(lengths))
    scale = float(p_energy.max())
    for ref_mel, ref_energy in ((p_mel.numpy(), p_energy.numpy()),
                                (np.asarray(j_mel), np.asarray(j_energy))):
        assert mel.shape == ref_mel.shape and energy.shape == ref_energy.shape
        _bars(mel, ref_mel, scale)
        _bars(energy, ref_energy, scale)


@pytest.mark.parametrize("geometry", GEOMETRIES, ids=lambda g: "-".join(map(str, g)))
def test_model_features_vs_float64_oracle(signals, geometry):
    """Features of the model's mel energies within 0.01 of the plain chain
    run in float64, with and without lengths, and nearer it than the
    plain float32 chain's."""
    cfg = _cfg(*geometry)
    for lengths in (None, torch.as_tensor(LENGTHS)):
        y = preemphasize(torch.as_tensor(signals), cfg, lengths)
        mel, energy, _ = kernel_model(y.numpy(), cfg)
        t = mel.shape[1]
        mask = (torch.ones((3, t), dtype=torch.bool) if lengths is None
                else frame_mask(lengths, t, cfg.frame_len, cfg.frame_step))
        masked = lengths is not None
        feats = cepstral_epilogue(torch.as_tensor(mel), torch.as_tensor(energy), mask, cfg,
                                  torch.float32, masked)[1]
        mel64, en64 = mel_frontend_plain(y.double(), cfg)
        f64 = cepstral_epilogue(mel64, en64, mask, cfg, torch.float64, masked)[1]
        err = float(((feats.double() - f64).abs() * mask[..., None]).max())
        mel32, en32 = mel_frontend_plain(y, cfg)
        plain = cepstral_epilogue(mel32, en32, mask, cfg, torch.float32, masked)[1]
        plain_err = float(((plain.double() - f64).abs() * mask[..., None]).max())
        assert err < 0.01 and err < plain_err, (err, plain_err)


@pytest.mark.parametrize("fft_n", [256, 512, 1024, 2048])
def test_plan_is_the_fft(fft_n):
    """The model's passes, twiddles and exchanges give numpy's FFT; the
    radices multiply to H, each divides a lane's points."""
    plan = fft_plan(fft_n)
    h = fft_n // 2
    assert int(np.prod(plan)) == h and all((h // 32) % r == 0 and r in (2, 4, 8) for r in plan)
    rng = np.random.default_rng(fft_n)
    z = rng.normal(size=(2, h)) + 1j * rng.normal(size=(2, h))
    (pr, pi), _ = fft_model(z.real, z.imag, plan, np.float64)
    got = (pr + 1j * pi)[:, padded(np.arange(h))]
    ref = np.fft.fft(z, axis=-1)
    np.testing.assert_allclose(got, ref, atol=1e-13 * np.abs(ref).max())
    assert fft_plan(128) is None and fft_plan(4096) is None and fft_plan(8) is None


@pytest.mark.parametrize("fft_n", [256, 512, 1024, 2048])
def test_exchanges_are_bank_conflict_free(fft_n):
    """A warp's 8-byte accesses go to the banks a half-warp at a time: every
    load of z[l + 32m] hits 16 distinct 8-byte bank pairs in each
    half-warp, as do the stores of every pass but the second, whose are
    2-way conflicted (4-way at fft_n 256, radix 4 after 4 points), as are
    at most the split step's reads of Z[H - k]."""
    h = fft_n // 2
    _, stores = fft_model(np.zeros((1, h)), np.zeros((1, h)), fft_plan(fft_n))
    lane = np.arange(32)

    def ways(elems):
        return max(max(np.bincount(half % 16)) for half in (elems[:16], elems[16:]))

    for p, _, _, words in stores:
        assert ways(words) <= ((4 if fft_n == 256 else 2) if p == 1 else 1)
    for m in range(h // 32):
        assert ways(padded(lane + 32 * m)) == 1
        assert ways(padded((h - lane - 32 * m) % h)) <= 2
    assert len(set(padded(np.arange(h)))) == h and padded(h - 1) < h + h // 16


def test_pass_twiddles_table():
    assert pass_twiddles(fft_plan(512)).shape == (8 * 8 + 4 * 64, 2)  # H = 256: 8, 8, 4
    tw = pass_twiddles(fft_plan(1024))  # H = 512: 8, 8, 8
    assert tw.dtype == np.float64 and tw.shape == (8 * 8 + 8 * 64, 2)
    ns, r, s = 64, 8, 37  # pass 2: W_512^(5 s) at 64 + 5 * 64 + s
    ang = -2.0 * np.pi * 5 * s / (ns * r)
    np.testing.assert_array_equal(tw[64 + 5 * ns + s], np.array([np.cos(ang), np.sin(ang)]))


def test_frames_per_block_spreads_short_batches():
    """The serving step (B = 64 x 999 frames) takes 24 frames a block; a
    segment (B = 1, T = 511) takes 4, so its 128 blocks reach as many SMs."""
    assert frames_per_block(64, 999, 132) == 24
    assert frames_per_block(1, 511, 132) == 4
    assert frames_per_block(4, 511, 132) == 4 and frames_per_block(8, 999, 132) == 8
    assert frames_per_block(12, 999, 132) == 16
    for b, t in ((64, 999), (1, 511), (3, 99)):
        fpb = frames_per_block(b, t, 132)
        assert fpb in (4, 8, 16, 24) and b * -(-t // fpb) >= min(4 * 132, b * -(-t // 4))


def test_mel_support_packs_each_filter(signals):
    fbank = mel_filterbank(40, 512, 16000)
    weights, lo, hi, off = mel_support(fbank)
    assert len(weights) == int((hi - lo).sum()) and off[0] == 0
    for m in range(40):
        np.testing.assert_array_equal(weights[off[m]:off[m] + hi[m] - lo[m]], fbank[m, lo[m]:hi[m]])
        assert not fbank[m, :lo[m]].any() and not fbank[m, hi[m]:].any()
    # the plain wrapper path is unchanged by the packing
    cfg = _cfg(400, 512, 40)
    mel, _ = mel_frontend(torch.as_tensor(signals[:1]), cfg)
    ref, _ = mel_frontend_plain(preemphasize(torch.as_tensor(signals[:1]), cfg), cfg)
    np.testing.assert_array_equal(mel.numpy(), ref.numpy())


def test_other_geometries_stay_checked(signals):
    """fft_n outside 256..2048 takes the generic route; the geometry rules
    are unchanged (powers of two, frame_len <= fft_n)."""
    for fft_n in (128, 4096):
        assert fft_plan(fft_n) is None
    cfg = dataclasses.replace(_cfg(240, 256, 40), fft_n=384)
    with pytest.raises(ValueError):
        mel_frontend(torch.as_tensor(signals[:1]), cfg)


def oracle_errors(n_utts=6):
    """Features of the model and of the plain float32 chain against the
    plain chain in float64, on the first ``n_utts`` of ``chip_smoke.py``'s
    serving-step signals (10 s each): ``(model, plain)`` max errors."""
    import chip_smoke

    chip_smoke.B = n_utts
    cfg = tconfig.MFCCConfig(energy_floor=1e-10)
    y = preemphasize(chip_smoke.make_signals(torch, "cpu"), cfg)
    mel, energy, _ = kernel_model(y.numpy(), cfg)
    mask = torch.ones(mel.shape[:2], dtype=torch.bool)
    feats = [cepstral_epilogue(torch.as_tensor(m), torch.as_tensor(e), mask, cfg, dt, False)[1]
             for m, e, dt in ((mel, energy, torch.float32),
                              (*mel_frontend_plain(y, cfg), torch.float32),
                              (*mel_frontend_plain(y.double(), cfg), torch.float64))]
    return tuple(float((f.double() - feats[2]).abs().max()) for f in feats[:2])


if __name__ == "__main__":  # JAX_PLATFORMS=cpu PYTHONPATH=. python tests/test_torch_frontend_fft.py
    print("features vs a float64 oracle on 6 x 10 s of chip_smoke's signals (CPU): "
          "model of the kernel %.3g, plain float32 chain %.3g" % oracle_errors())
