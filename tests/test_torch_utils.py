"""The port's host utilities (``utils/audio.py``, ``utils/metrics.py``)
against the JAX package's: the same files read to the same samples, the
same resampling bitwise, and the same WER/CER counts."""

import struct
import sys
import types

import numpy as np
import pytest

from lnasr_tpu.utils import audio as jaudio
from lnasr_tpu.utils import metrics as jmetrics
from lnasr_tpu_torch import utils
from lnasr_tpu_torch.utils import audio, metrics


def _tone(sr, n=None, hz=440.0):
    n = sr if n is None else n
    return 0.4 * np.sin(2 * np.pi * hz * np.arange(n) / sr)


def _riff(path, fmt_code, n_ch, sr, bits, body):
    hdr = struct.pack("<HHIIHH", fmt_code, n_ch, sr, sr * n_ch * bits // 8, n_ch * bits // 8, bits)
    with open(path, "wb") as fp:
        fp.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(hdr) + 8 + len(body)))
        fp.write(b"WAVE" + b"fmt " + struct.pack("<I", len(hdr)) + hdr)
        fp.write(b"data" + struct.pack("<I", len(body)) + body)


def _both(fn_name, *args):
    ours, ref = getattr(audio, fn_name)(*args), getattr(jaudio, fn_name)(*args)
    return ours, ref


def test_exports():
    for name in ("Recorder", "record", "resample", "read_audio", "read_pcm", "write_pcm",
                 "read_wave", "write_wave", "wer", "cer", "wer_details", "edit_distance"):
        assert callable(getattr(utils, name)), name


def test_pcm_and_wave_round_trips(tmp_path, speech_audio):
    x = np.asarray(speech_audio)[:8000]
    audio.write_pcm(str(tmp_path / "a.pcm"), x)
    np.testing.assert_array_equal(audio.read_pcm(str(tmp_path / "a.pcm")), x)
    np.testing.assert_array_equal(jaudio.read_pcm(str(tmp_path / "a.pcm")), x)
    audio.write_wave(str(tmp_path / "a.wav"), x)
    jaudio.write_wave(str(tmp_path / "b.wav"), x)
    assert (tmp_path / "a.wav").read_bytes() == (tmp_path / "b.wav").read_bytes()
    got, rate = audio.read_wave(str(tmp_path / "a.wav"))
    assert rate == 16000
    np.testing.assert_array_equal(got, x)
    # read at another rate: resampled, as the JAX package does
    for sr in (8000, 22050):
        ours, ref = _both("read_wave", str(tmp_path / "a.wav"), sr)
        assert ours[1] == ref[1] == sr
        np.testing.assert_array_equal(ours[0], ref[0])


@pytest.mark.parametrize("rates", [(16000, 8000), (8000, 16000), (22050, 16000),
                                   (16000, 48000), (44100, 16000)])
def test_resample_matches_jax(rates):
    x = np.random.default_rng(0).normal(size=3000)
    ours, ref = audio.resample(x, *rates), jaudio.resample(x, *rates)
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(audio.resample(x, 16000, 16000), x)


def test_read_audio_formats_match_jax(tmp_path):
    """Float32 stereo and 24-bit WAV, AIFF, AU (16-bit and mu-law), raw
    PCM: the same int16 samples and rate as the JAX package's reader."""
    sr = 22050
    left, right = _tone(sr, 4000), _tone(sr, 4000, hz=880.0)
    inter = np.empty(2 * len(left), np.float32)
    inter[0::2], inter[1::2] = left, right
    _riff(tmp_path / "f32.wav", 3, 2, sr, 32, inter.astype("<f4").tobytes())
    vals = (_tone(16000, 3000) * (2 ** 23 - 1)).astype(np.int32)
    _riff(tmp_path / "p24.wav", 1, 1, 16000, 24,
          vals.astype("<i4").view(np.uint8).reshape(-1, 4)[:, :3].tobytes())
    pcm = (_tone(16000, 3000) * 32767).astype(">i2")
    comm = struct.pack(">HIH", 1, len(pcm), 16) + struct.pack(">HQ", 16383 + 13, 16000 << 50)
    ssnd = struct.pack(">II", 0, 0) + pcm.tobytes()
    chunks = (b"COMM" + struct.pack(">I", len(comm)) + comm
              + b"SSND" + struct.pack(">I", len(ssnd)) + ssnd)
    (tmp_path / "a.aiff").write_bytes(b"FORM" + struct.pack(">I", 4 + len(chunks)) + b"AIFF"
                                      + chunks)
    (tmp_path / "a.au").write_bytes(b".snd" + struct.pack(">IIIII", 24, len(pcm) * 2, 3, 16000, 1)
                                    + pcm.tobytes())
    mulaw = np.random.default_rng(1).integers(0, 256, size=2000).astype(np.uint8)
    (tmp_path / "m.au").write_bytes(b".snd" + struct.pack(">IIIII", 24, len(mulaw), 1, 16000, 1)
                                    + mulaw.tobytes())
    audio.write_pcm(str(tmp_path / "x.raw"), pcm.astype(np.int16))
    for name in ("f32.wav", "p24.wav", "a.aiff", "a.au", "m.au", "x.raw"):
        ours, ref = _both("read_audio", str(tmp_path / name))
        assert ours[1] == ref[1] == 16000, name
        assert ours[0].dtype == np.int16, name
        np.testing.assert_array_equal(ours[0], ref[0], err_msg=name)
    bad = tmp_path / "x.mp3"
    bad.write_bytes(b"\xff\xfb\x90notarealmp3" * 4)
    with pytest.raises(ValueError, match="soundfile"):
        audio.read_audio(str(bad))


def test_recorder_with_a_fake_pyaudio(monkeypatch):
    """``pyaudio`` is imported only when capture starts: a stand-in module
    feeds three 10 ms callbacks."""
    captured = {}

    class FakeStream:
        def __init__(self, cb):
            self._cb = cb

        def start_stream(self):
            for k in range(3):
                self._cb(np.full(160, k + 1, np.int16).tobytes(), 160, None, None)

        def stop_stream(self):
            captured["stopped"] = True

        def close(self):
            pass

    class FakePyAudio:
        def open(self, **kw):
            return FakeStream(kw["stream_callback"])

        def terminate(self):
            captured["terminated"] = True

    fake = types.ModuleType("pyaudio")
    fake.PyAudio, fake.paInt16, fake.paContinue = FakePyAudio, 8, 0
    monkeypatch.setitem(sys.modules, "pyaudio", fake)
    with audio.Recorder() as rec:
        with pytest.raises(RuntimeError, match="already recording"):
            rec.start()
    np.testing.assert_array_equal(np.unique(rec.samples()), [1, 2, 3])
    assert len(rec.samples()) == 480 and captured == {"stopped": True, "terminated": True}


@pytest.mark.parametrize("ref,hyp", [
    ("a b c", "a b c"), ("a b c", "a x c"), ("a b c d", "a c d e f"), ("", ""), ("", "a"),
    ("the cat sat on the mat", "cat sat on a mat mat"), ("a", ""),
])
def test_metrics_match_jax(ref, hyp):
    r, h = ref.split(), hyp.split()
    assert metrics.edit_distance(r, h) == jmetrics.edit_distance(r, h)
    assert metrics.wer(r, h) == jmetrics.wer(r, h)
    assert metrics.wer_details(r, h) == jmetrics.wer_details(r, h)
    assert metrics.cer(ref, hyp) == jmetrics.cer(ref, hyp)
