"""The host DSP library of the waveform augmentations (``native/dsp.cpp``),
the port's counterpart of ``w2v2_speaker_tpu/utils/native.py``, and the
build of the repository's C++ sources that ``utils/flac.py`` shares.

A source is compiled with the host's C++ compiler (``$CXX``, else ``c++``)
at first use, into ``build/torch_native/`` beside the package (a
git-ignored tree), under a file name that carries a hash of the source, so
an edited source is never served from a stale build; the prebuilt
libraries under ``native/`` are not used. The library file is written
whole and then renamed into place, so a concurrent loader never opens half
a file.

``upfirdn``, ``fir_same`` and ``fft_convolve`` take and return float32
numpy arrays. Unlike the JAX package's loader, which returns None and lets
its callers degrade, every entry point raises when the library cannot be
built or loaded (with the compiler's output), and ``data/augment.py`` never
swaps this branch for scipy's or back.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import threading

import numpy as np

__all__ = ["BUILD_DIR", "SOURCE", "build_library", "fft_convolve", "fir_same", "hashed_path", "library_path",
           "load", "upfirdn"]

_ROOT = pathlib.Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "dsp.cpp"
BUILD_DIR = _ROOT / "build" / "torch_native"
CXXFLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-Wall")
ABI_VERSION = 1

_lock = threading.Lock()
_lib = None

_f32p = ctypes.POINTER(ctypes.c_float)


def hashed_path(source: pathlib.Path, build_dir: pathlib.Path, stem: str) -> pathlib.Path:
    """``build_dir / <stem>-<16 hex digits of the source's sha256>.so``."""
    digest = hashlib.sha256(source.read_bytes()).hexdigest()[:16]
    return build_dir / f"{stem}-{digest}.so"


def build_library(source: pathlib.Path, out: pathlib.Path, what: str) -> None:
    """Compile ``source`` into the shared library ``out``; raises
    ``RuntimeError`` naming ``what``, with the compiler's output, when the
    build fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(
        [os.environ.get("CXX", "c++"), *CXXFLAGS, "-o", str(tmp), str(source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"building {what} from {source} failed:\n{proc.stdout}")
    os.replace(tmp, out)  # atomic: a concurrent loader never sees half a file


def library_path() -> pathlib.Path:
    return hashed_path(SOURCE, BUILD_DIR, "libdsp")


def load() -> ctypes.CDLL:
    """The DSP library, built first if needed; raises if it cannot be built
    or loaded, or speaks another ABI."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                build_library(SOURCE, path, "the DSP library")
            lib = ctypes.CDLL(str(path))
            i64 = ctypes.c_int64
            lib.w2vtpu_upfirdn.argtypes = [_f32p, i64, _f32p, i64, i64, i64, _f32p, i64]
            lib.w2vtpu_fir_same.argtypes = [_f32p, i64, _f32p, i64, _f32p]
            lib.w2vtpu_fft_convolve.argtypes = [_f32p, i64, _f32p, i64, _f32p]
            lib.w2vtpu_abi_version.restype = ctypes.c_int
            if lib.w2vtpu_abi_version() != ABI_VERSION:
                raise RuntimeError(f"{path}: DSP library ABI {lib.w2vtpu_abi_version()}, expected {ABI_VERSION}")
            _lib = lib
        return _lib


def _f32(a: np.ndarray) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(_f32p)


def upfirdn(x: np.ndarray, taps: np.ndarray, up: int, down: int) -> np.ndarray:
    """Upsample by ``up``, FIR-filter with ``taps``, downsample by ``down``:
    ``scipy.signal.upfirdn(taps, x, up, down)``, untrimmed."""
    lib = load()
    x, taps = _f32(x), _f32(taps)
    ny = ((x.shape[0] - 1) * up + taps.shape[0] + down - 1) // down  # scipy's output length
    y = np.empty(ny, np.float32)
    lib.w2vtpu_upfirdn(_ptr(x), x.shape[0], _ptr(taps), taps.shape[0], up, down, _ptr(y), ny)
    return y


def fir_same(x: np.ndarray, taps: np.ndarray) -> np.ndarray:
    """``x`` filtered by ``taps``, the output centred to ``x``'s length
    (``scipy.signal.fftconvolve(x, taps, mode="same")``)."""
    lib = load()
    x, taps = _f32(x), _f32(taps)
    y = np.empty_like(x)
    lib.w2vtpu_fir_same(_ptr(x), x.shape[0], _ptr(taps), taps.shape[0], _ptr(y))
    return y


def fft_convolve(x: np.ndarray, h: np.ndarray) -> np.ndarray:
    """The full linear convolution of ``x`` and ``h``
    (``scipy.signal.fftconvolve(x, h)``)."""
    lib = load()
    x, h = _f32(x), _f32(h)
    y = np.empty(x.shape[0] + h.shape[0] - 1, np.float32)
    lib.w2vtpu_fft_convolve(_ptr(x), x.shape[0], _ptr(h), h.shape[0], _ptr(y))
    return y
