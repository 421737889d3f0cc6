"""Audio I/O (host side).

The port's own copy of the JAX package's ``utils/audio.py`` (NumPy only).
PCM convention matches the reference (``lnasr/utils.py:100-104``): mono,
16 kHz, 16-bit little-endian. WAV reading resamples with a polyphase
windowed-sinc filter (the quality class of the reference's librosa
resampler, ``lnasr/utils.py:90-98``) without the librosa dependency;
microphone capture is optional and gated on ``pyaudio`` being importable
(``lnasr/utils.py:51-88``).
"""

from __future__ import annotations

import math
import wave
from typing import Optional, Tuple

import numpy as np

SAMPLE_RATE = 16000


def read_pcm(filename: str) -> np.ndarray:
    """Raw PCM (mono / 16-bit / little-endian) as int16 samples."""
    with open(filename, "rb") as fp:
        return np.frombuffer(fp.read(), dtype="<i2")


def write_pcm(filename: str, data: np.ndarray) -> None:
    np.asarray(data, dtype="<i2").tofile(filename)


def resample(x: np.ndarray, sr_in: int, sr_out: int,
             half_taps: int = 32, beta: float = 8.6) -> np.ndarray:
    """Windowed-sinc (Kaiser) resampling to any rate.

    Anti-aliased: the kernel cutoff is ``min(sr_in, sr_out)/2``, so
    downsampling real 44.1 kHz material does not fold HF content into the
    band the MFCC frontend reads (the previous linear interpolation
    aliased; the reference delegates this to ``librosa.load``,
    ``lnasr/utils.py:90-98``). Evaluated directly at the exact rational
    output times — one gather + weighted sum per output sample,
    O(n_out * taps), float64.
    """
    x = np.asarray(x, np.float64)
    if sr_in == sr_out or len(x) == 0:
        return x.copy()
    g = math.gcd(int(sr_in), int(sr_out))
    up, down = sr_out // g, sr_in // g
    n_out = int(math.ceil(len(x) * up / down))
    # cutoff (in input-sample units) and kernel half-width; widen the
    # kernel when downsampling so the transition band stays proportional
    ratio = min(1.0, up / down)
    half_width = int(math.ceil(half_taps / ratio))
    # exact rational positions of output samples on the input grid
    pos_num = np.arange(n_out, dtype=np.int64) * down
    centers = pos_num // up                      # floor input index
    frac = (pos_num - centers * up) / up         # in [0, 1)
    offsets = np.arange(-half_width + 1, half_width + 1, dtype=np.int64)
    # t: signed distance (input samples) from each tap to the output time
    t = offsets[None, :] - frac[:, None]         # (n_out, taps)
    kernel = ratio * np.sinc(ratio * t)
    # Kaiser window evaluated at |t|/half_width
    w_arg = np.clip(t / half_width, -1.0, 1.0)
    kernel *= np.i0(beta * np.sqrt(1.0 - w_arg**2)) / np.i0(beta)
    idx = np.clip(centers[:, None] + offsets[None, :], 0, len(x) - 1)
    # zero taps that fall outside the signal instead of clamping them
    valid = ((centers[:, None] + offsets[None, :]) >= 0) & (
        (centers[:, None] + offsets[None, :]) < len(x)
    )
    return np.sum(np.where(valid, x[idx] * kernel, 0.0), axis=1)


def _pcm_bytes_to_float(raw: bytes, width: int, fmt_code: int) -> np.ndarray:
    """Interleaved PCM/float bytes -> float64 in [-1, 1)."""
    if fmt_code == 3:  # IEEE float
        if width == 4:
            return np.frombuffer(raw, dtype="<f4").astype(np.float64)
        if width == 8:
            return np.frombuffer(raw, dtype="<f8").astype(np.float64)
        raise ValueError(f"unsupported float sample width: {width}")
    if width == 2:
        return np.frombuffer(raw, dtype="<i2").astype(np.float64) / 32768.0
    if width == 1:  # WAV 8-bit is unsigned
        return (np.frombuffer(raw, dtype=np.uint8).astype(np.float64) - 128.0) / 128.0
    if width == 3:  # 24-bit packed: widen to i4 via zero-padded low byte
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        quads = np.zeros((b.shape[0], 4), np.uint8)
        quads[:, 1:] = b
        return quads.view("<i4")[:, 0].astype(np.float64) / 2147483648.0
    if width == 4:
        return np.frombuffer(raw, dtype="<i4").astype(np.float64) / 2147483648.0
    raise ValueError(f"unsupported sample width: {width}")


def _parse_riff_wave(filename: str) -> Tuple[np.ndarray, int, int]:
    """Minimal RIFF/WAVE parser -> (float64 interleaved, n_channels, rate).

    Handles what the stdlib ``wave`` module rejects: 24-bit PCM, IEEE
    float (format 3), and WAVE_FORMAT_EXTENSIBLE (format 0xFFFE, resolved
    through the subformat GUID). The reference gets all of this for free
    from librosa (``lnasr/utils.py:90-98``); here it is native.
    """
    import struct

    with open(filename, "rb") as fp:
        head = fp.read(12)
        if len(head) < 12 or head[:4] != b"RIFF" or head[8:12] != b"WAVE":
            raise ValueError(f"{filename}: not a RIFF/WAVE file")
        fmt = None
        data = None
        while True:
            hdr = fp.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack("<I", hdr[4:])[0]
            body = fp.read(size)
            if size % 2:
                fp.read(1)  # chunks are word-aligned
            if cid == b"fmt ":
                fmt = body
            elif cid == b"data":
                data = body
            if fmt is not None and data is not None:
                break
    if fmt is None or data is None:
        raise ValueError(f"{filename}: missing fmt/data chunk")
    (fmt_code, n_ch, sr, _, _, bits) = struct.unpack("<HHIIHH", fmt[:16])
    if fmt_code == 0xFFFE:  # EXTENSIBLE: first two GUID bytes = real code
        if len(fmt) < 26:
            raise ValueError(f"{filename}: truncated extensible fmt chunk")
        fmt_code = struct.unpack("<H", fmt[24:26])[0]
    if fmt_code not in (1, 3):
        raise ValueError(
            f"{filename}: compressed WAV (format {fmt_code:#x}) — only "
            "PCM/float supported natively; install soundfile for codecs"
        )
    width = bits // 8
    frames = len(data) // (width * n_ch) * width * n_ch
    return _pcm_bytes_to_float(data[:frames], width, fmt_code), n_ch, sr


def _finish(data: np.ndarray, n_ch: int, sr: int, sample_rate: int):
    if n_ch > 1:
        data = data.reshape(-1, n_ch).mean(axis=1)
    data = resample(data, sr, sample_rate)
    return (np.clip(data * 32768.0, -32768, 32767).astype(np.int16), sample_rate)


def read_wave(filename: str, sample_rate: int = SAMPLE_RATE) -> Tuple[np.ndarray, int]:
    """Read a WAV file (8/16/24/32-bit PCM, float32/64, extensible),
    downmix to mono, resample to ``sample_rate``, return
    (int16 samples, sample_rate)."""
    try:
        with wave.open(filename, "rb") as fp:
            n_ch = fp.getnchannels()
            width = fp.getsampwidth()
            sr = fp.getframerate()
            raw = fp.readframes(fp.getnframes())
        data = _pcm_bytes_to_float(raw, width, fmt_code=1)
    except (wave.Error, ValueError):
        # float / 24-bit / extensible WAVs: the stdlib module refuses them
        data, n_ch, sr = _parse_riff_wave(filename)
    return _finish(data, n_ch, sr, sample_rate)


def _read_aiff(filename: str, sample_rate: int) -> Tuple[np.ndarray, int]:
    """AIFF/AIFC: big-endian PCM parsed from FORM/COMM/SSND chunks."""
    import struct

    with open(filename, "rb") as fp:
        head = fp.read(12)
        if head[:4] != b"FORM" or head[8:12] not in (b"AIFF", b"AIFC"):
            raise ValueError(f"{filename}: not an AIFF file")
        comm = ssnd = None
        while True:
            hdr = fp.read(8)
            if len(hdr) < 8:
                break
            cid, size = hdr[:4], struct.unpack(">I", hdr[4:])[0]
            body = fp.read(size)
            if size % 2:
                fp.read(1)
            if cid == b"COMM":
                comm = body
            elif cid == b"SSND":
                ssnd = body[8:]  # skip offset/blocksize
    if comm is None or ssnd is None:
        raise ValueError(f"{filename}: missing COMM/SSND chunk")
    n_ch, _, bits = struct.unpack(">HIH", comm[:8])
    # sample rate is an 80-bit IEEE extended float
    exp = struct.unpack(">H", comm[8:10])[0]
    mant = struct.unpack(">Q", comm[10:18])[0]
    sr = int(mant / (1 << (16383 + 63 - (exp & 0x7FFF))))
    if len(comm) >= 22 and comm[18:22] not in (b"NONE", b"sowt"):
        raise ValueError(f"{filename}: compressed AIFC not supported natively")
    little = len(comm) >= 22 and comm[18:22] == b"sowt"
    width = bits // 8
    dt = {1: "b", 2: "i2", 3: None, 4: "i4"}[width]
    if width == 3:
        b = np.frombuffer(ssnd[: len(ssnd) // 3 * 3], np.uint8).reshape(-1, 3)
        quads = np.zeros((b.shape[0], 4), np.uint8)
        # place the 3 bytes little-endian in the TOP of the i4 so the
        # sign bit extends correctly (value << 8, like the WAV path)
        quads[:, 1:] = b[:, ::-1] if not little else b
        data = quads.view("<i4")[:, 0].astype(np.float64) / 2147483648.0
    else:
        order = "<" if little else ">"
        data = np.frombuffer(ssnd, dtype=order + dt).astype(np.float64)
        data /= float(1 << (bits - 1))
    return _finish(data, n_ch, sr, sample_rate)


def _read_au(filename: str, sample_rate: int) -> Tuple[np.ndarray, int]:
    """Sun/NeXT .au/.snd: header-described big-endian linear PCM."""
    import struct

    with open(filename, "rb") as fp:
        hdr = fp.read(24)
        if hdr[:4] != b".snd":
            raise ValueError(f"{filename}: not an AU file")
        offset, _, enc, sr, n_ch = struct.unpack(">IIIII", hdr[4:24])
        fp.seek(offset)
        raw = fp.read()
    if enc == 2:
        data = np.frombuffer(raw, np.int8).astype(np.float64) / 128.0
    elif enc == 3:
        data = np.frombuffer(raw, ">i2").astype(np.float64) / 32768.0
    elif enc == 5:
        data = np.frombuffer(raw, ">i4").astype(np.float64) / 2147483648.0
    elif enc == 6:
        data = np.frombuffer(raw, ">f4").astype(np.float64)
    elif enc == 1:  # 8-bit mu-law
        u = ~np.frombuffer(raw, np.uint8)
        sign = np.where(u & 0x80, -1.0, 1.0)
        exp = (u >> 4) & 0x07
        mant = (u & 0x0F).astype(np.int32)
        mag = ((mant << 3) + 0x84).astype(np.int32) << exp
        data = sign * (mag - 0x84) / 32768.0
    else:
        raise ValueError(f"{filename}: AU encoding {enc} not supported natively")
    return _finish(data, n_ch, sr, sample_rate)


def read_audio(filename: str, sample_rate: int = SAMPLE_RATE) -> Tuple[np.ndarray, int]:
    """Read ANY supported audio file -> (mono int16 at ``sample_rate``,
    rate) — the reference's ``read_wave`` surface (it delegates to
    librosa/audioread and so reads whatever those decode,
    ``lnasr/utils.py:90-98``), realized natively:

    - WAV (8/16/24/32-bit PCM, float32/64, extensible), AIFF/AIFC
      (uncompressed), Sun AU (linear PCM + mu-law): parsed here with no
      dependencies, multi-channel downmixed, Kaiser-sinc resampled;
    - raw ``.pcm``/``.raw``: the reference's 16 kHz/16-bit convention;
    - anything else (mp3/flac/ogg/...): decoded through ``soundfile`` or
      ``librosa`` WHEN importable; otherwise a clear error names the
      natively-supported formats.

    Dispatch is by content magic, not extension.
    """
    with open(filename, "rb") as fp:
        magic = fp.read(12)
    if magic[:4] == b"RIFF" and magic[8:12] == b"WAVE":
        return read_wave(filename, sample_rate)
    if magic[:4] == b"FORM" and magic[8:12] in (b"AIFF", b"AIFC"):
        return _read_aiff(filename, sample_rate)
    if magic[:4] == b".snd":
        return _read_au(filename, sample_rate)
    if filename.endswith((".pcm", ".raw")):
        return read_pcm(filename), sample_rate
    try:  # optional decoder backends for compressed formats
        import soundfile  # type: ignore

        data, sr = soundfile.read(filename, dtype="float64", always_2d=True)
        return _finish(data.reshape(-1), data.shape[1], sr, sample_rate)
    except ImportError:
        pass
    try:
        import librosa  # type: ignore

        data, sr = librosa.load(filename, sr=None, mono=True)
        return _finish(np.asarray(data, np.float64), 1, sr, sample_rate)
    except ImportError:
        pass
    if len(magic) >= 2 and _looks_compressed(magic):
        raise ValueError(
            f"{filename}: unrecognized audio container. Natively "
            "supported: WAV (PCM/float), AIFF/AIFC, Sun AU, raw "
            ".pcm/.raw; install soundfile or librosa for compressed "
            "formats (mp3/flac/ogg)."
        )
    # headerless file with no compressed-container signature: treat as
    # the reference's raw-PCM convention (16-bit LE at sample_rate) —
    # the behavior every non-.wav input had before magic dispatch
    import warnings

    warnings.warn(
        f"{filename}: no recognized container; assuming headerless "
        "16-bit little-endian PCM (the reference's raw convention)",
        stacklevel=2,
    )
    return read_pcm(filename), sample_rate


def _looks_compressed(magic: bytes) -> bool:
    """Signatures of common compressed audio containers we cannot decode
    natively — these must error loudly rather than be misread as PCM."""
    if magic[:3] == b"ID3" or magic[:2] in (b"\xff\xfb", b"\xff\xf3",
                                            b"\xff\xf2", b"\xff\xf1"):
        return True  # mp3 / aac
    return magic[:4] in (b"fLaC", b"OggS") or magic[4:8] == b"ftyp"  # m4a


def write_wave(filename: str, data: np.ndarray, sample_rate: int = SAMPLE_RATE) -> None:
    with wave.open(filename, "wb") as fp:
        fp.setnchannels(1)
        fp.setsampwidth(2)
        fp.setframerate(sample_rate)
        fp.writeframes(np.asarray(data, dtype="<i2").tobytes())


def record(seconds: float, sample_rate: int = SAMPLE_RATE) -> np.ndarray:
    """Fixed-duration microphone capture (requires ``pyaudio``)."""
    with Recorder(sample_rate) as rec:
        import time

        time.sleep(seconds)
    return rec.samples()


class Recorder:
    """Interactive start/stop-controlled microphone capture, like the
    reference's key-controlled ``recording`` loop (``lnasr/utils.py:51-88``)
    but callback-driven: audio accumulates in the background between
    :meth:`start` and :meth:`stop`, so the caller decides when to stop
    (key press, VAD endpoint, UI event) without blocking on reads.

    Requires ``pyaudio``; also usable as a context manager::

        with Recorder() as rec:
            input("recording... press Enter to stop")
        audio = rec.samples()
    """

    def __init__(self, sample_rate: int = SAMPLE_RATE, chunk: int = 160):
        self.sample_rate = sample_rate
        self.chunk = chunk
        self._frames: list = []
        self._pa = None
        self._stream = None

    def start(self) -> "Recorder":
        import pyaudio  # noqa: deferred optional dependency

        if self._stream is not None:
            raise RuntimeError("already recording")
        self._frames = []
        self._pa = pyaudio.PyAudio()

        def _on_audio(in_data, frame_count, time_info, status):
            self._frames.append(in_data)
            return (None, pyaudio.paContinue)

        self._stream = self._pa.open(
            rate=self.sample_rate, channels=1, format=pyaudio.paInt16,
            input=True, frames_per_buffer=self.chunk,
            stream_callback=_on_audio,
        )
        self._stream.start_stream()
        return self

    def stop(self) -> np.ndarray:
        if self._stream is not None:
            self._stream.stop_stream()
            self._stream.close()
            self._stream = None
        if self._pa is not None:
            self._pa.terminate()
            self._pa = None
        return self.samples()

    def samples(self) -> np.ndarray:
        return np.frombuffer(b"".join(self._frames), dtype=np.int16)

    def __enter__(self) -> "Recorder":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()
