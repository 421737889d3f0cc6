"""Build and bind the hand-written CUDA kernels of ``csrc/``.

Each ``csrc/<name>.cu`` exposes a plain C interface. At first use it is
compiled by ``nvcc`` for ``sm_90a`` into a shared library under
``lnasr_tpu_torch/_build/`` (keyed by the hash of the source and of the
local headers, so an edited source or header rebuilds) and loaded with ``ctypes``. Nothing is built when the
package is imported. :func:`build_all` starts one ``nvcc`` per source,
all at once, and waits for them.

The native VAD detectors (``native/vad/``, host C++) are built the same
way by ``g++`` (:func:`build_native_vad`, optionally under the
sanitizers), and so is their self-test (:func:`build_vad_selftest`).
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NATIVE_VAD = os.path.join(_HERE, "native", "vad")
NATIVE_VAD_SOURCES = ("vad_amrwb.cpp", "vad_webrtc.cpp", "vad_api.cpp")
NATIVE_VAD_HEADERS = ("vad_amrwb.h", "vad_webrtc.h")
GXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-shared")
SANITIZE_FLAGS = ("-fsanitize=address,undefined", "-g")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_loaded: dict = {}


class KernelBuildError(RuntimeError):
    pass


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise KernelBuildError("nvcc not found: the CUDA kernels cannot be built")


def library_path(name: str) -> str:
    """The library of ``csrc/<name>.cu``, keyed by the hash of the source
    and of every local header in ``csrc/`` (``*.cuh``), which it may include."""
    h = hashlib.sha256()
    for path in [os.path.join(CSRC, f"{name}.cu"), *sorted(glob.glob(os.path.join(CSRC, "*.cuh")))]:
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"{name}-{h.hexdigest()[:16]}.so")


def _start(name: str):
    """Start ``nvcc`` for one source; returns ``(process, tmp, out)`` or
    ``None`` when the library is already built."""
    out = library_path(name)
    if os.path.exists(out):
        return None
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> str:
    if started is None:
        return ""
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        raise KernelBuildError(f"nvcc failed for {name}.cu (rc {proc.returncode}):\n{log}")
    os.replace(tmp, out)
    return log


def build_all() -> dict:
    """Compile every kernel source in parallel. Returns ``{name: (seconds,
    nvcc log)}``; the log is empty for a library that was already built."""
    t0 = time.perf_counter()
    names = sorted(os.path.basename(p)[:-3] for p in glob.glob(os.path.join(CSRC, "*.cu")))
    started = {name: _start(name) for name in names}
    result = {}
    try:
        for name in names:
            log = _finish(name, started[name])
            result[name] = (time.perf_counter() - t0, log)
    finally:
        for s in started.values():
            if s is not None and s[0].poll() is None:
                s[0].kill()
                s[0].wait()
    return result


def load(name: str, argtypes: list) -> ctypes.CDLL:
    """The kernel library ``name`` (built on first use). Its launch entry
    ``<name>_launch`` gets ``argtypes`` and returns the launch's
    ``cudaError_t`` as an int; ``<name>_error_string`` names an error."""
    lib = _loaded.get(name)
    if lib is None:
        _finish(name, _start(name))
        lib = ctypes.CDLL(library_path(name))
        launch = getattr(lib, f"{name}_launch")
        launch.argtypes = argtypes
        launch.restype = ctypes.c_int
        err = getattr(lib, f"{name}_error_string")
        err.argtypes = [ctypes.c_int]
        err.restype = ctypes.c_char_p
        _loaded[name] = lib
    return lib


def check(lib: ctypes.CDLL, name: str, rc: int) -> None:
    """Raise if ``<name>_launch`` returned a non-zero ``cudaError_t``."""
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name} kernel launch failed: {msg} (cudaError {rc})")


def _native_digest(names) -> str:
    digest = hashlib.sha256()
    for name in sorted(names):
        with open(os.path.join(NATIVE_VAD, name), "rb") as f:
            digest.update(name.encode() + f.read())
    return digest.hexdigest()[:16]


def native_vad_path(sanitize: bool = False) -> str:
    """Path of the native VAD library, keyed by its sources' hash; the
    sanitized build has a name of its own."""
    stem = "native_vad_sanitized" if sanitize else "native_vad"
    return os.path.join(BUILD_DIR, f"{stem}-{_native_digest(NATIVE_VAD_SOURCES + NATIVE_VAD_HEADERS)}.so")


def _gxx(cmd, out: str, what: str) -> str:
    """Run the ``g++`` command ``cmd`` writing a temporary file, then move
    it to ``out`` (concurrent builds race to an atomic rename)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run([*cmd, "-o", tmp], capture_output=True, text=True)
    if proc.returncode != 0:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise KernelBuildError(f"g++ failed for {what} (rc {proc.returncode}):\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_native_vad(sanitize: bool = False) -> str:
    """Compile the native VAD detectors with ``g++`` (once) and return the
    library's path. ``sanitize`` builds them under AddressSanitizer and
    UBSan, into a file of its own (:func:`native_vad_path`), so the normal
    library is never replaced; a process loads that one only with the
    sanitizer runtime preloaded."""
    out = native_vad_path(sanitize)
    if os.path.exists(out):
        return out
    flags = GXX_FLAGS + (SANITIZE_FLAGS if sanitize else ())
    return _gxx(["g++", *flags, "-I", NATIVE_VAD,
                 *(os.path.join(NATIVE_VAD, s) for s in NATIVE_VAD_SOURCES)], out,
                "the native VAD")


def build_vad_selftest() -> str:
    """Compile the native detectors' self-test (``vad_selftest.cpp``: both
    detectors over resets, mode changes and full-scale audio, exit code 0
    and "OK" on stderr when clean) under AddressSanitizer and UBSan, with
    no recovery from a finding, and return the executable's path."""
    sources = ("vad_selftest.cpp", "vad_webrtc.cpp", "vad_amrwb.cpp")
    out = os.path.join(BUILD_DIR, f"vad_selftest-{_native_digest(sources + NATIVE_VAD_HEADERS)}")
    if os.path.exists(out):
        return out
    return _gxx(["g++", "-std=c++17", "-g", "-O1", "-fsanitize=address,undefined",
                 "-fno-sanitize-recover=all", *(os.path.join(NATIVE_VAD, s) for s in sources),
                 "-I", NATIVE_VAD, "-lm"], out, "the native VAD self-test")
