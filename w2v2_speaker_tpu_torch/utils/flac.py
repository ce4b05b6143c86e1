"""FLAC decoding through the repository's own C++ decoder
(``native/flac.cpp``), the port's counterpart of
``w2v2_speaker_tpu/utils/flac.py``.

The decoder is compiled with the host's C++ compiler (``$CXX``, else
``c++``) at first use, into ``build/torch_native/`` beside the package (a
git-ignored tree), under a file name that carries a hash of the source, so
an edited decoder is never served from a stale build; the prebuilt
libraries under ``native/`` are not used. If the build fails, reading a
FLAC file raises with the compiler's output: there is no Python decoder to
fall back on. Decoding returns float32 scaled by 2^(bits - 1) (torchaudio's
``load`` semantics) or the raw int32 PCM.
"""

from __future__ import annotations

import ctypes
import pathlib
import threading
from typing import Tuple

import numpy as np

from .native import build_library, hashed_path

__all__ = ["BUILD_DIR", "SOURCE", "library_path", "load", "probe", "read_flac"]

SOURCE = pathlib.Path(__file__).resolve().parents[2] / "native" / "flac.cpp"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "torch_native"

_lock = threading.Lock()
_lib = None

_u8p = ctypes.POINTER(ctypes.c_uint8)
_i32p = ctypes.POINTER(ctypes.c_int32)
_i64p = ctypes.POINTER(ctypes.c_int64)

_ERRORS = {
    -1: "not a FLAC stream (bad magic)",
    -2: "truncated metadata",
    -3: "missing STREAMINFO",
    -4: "unsupported stream parameters",
    -5: "malformed frame header",
    -6: "frame CRC mismatch (corrupt header or frame body)",
    -7: "channel count changed mid-stream",
    -8: "malformed subframe",
    -9: "more samples than STREAMINFO declared",
}


def library_path() -> pathlib.Path:
    return hashed_path(SOURCE, BUILD_DIR, "libflac")


def load() -> ctypes.CDLL:
    """The decoder library, built first if needed; raises if it cannot be
    built."""
    global _lib
    with _lock:
        if _lib is None:
            path = library_path()
            if not path.exists():
                build_library(SOURCE, path, "the FLAC decoder")
            lib = ctypes.CDLL(str(path))
            i64, i32 = ctypes.c_int64, ctypes.c_int32
            lib.w2vtpu_flac_probe.argtypes = [
                _u8p, i64, _i64p,
                ctypes.POINTER(i32), ctypes.POINTER(i32), ctypes.POINTER(i32),
            ]
            lib.w2vtpu_flac_probe.restype = ctypes.c_int
            lib.w2vtpu_flac_decode.argtypes = [_u8p, i64, _i32p, i64, _i64p]
            lib.w2vtpu_flac_decode.restype = ctypes.c_int
            _lib = lib
        return _lib


def _as_u8(data: bytes) -> Tuple[np.ndarray, _u8p]:
    buf = np.frombuffer(data, dtype=np.uint8)
    return buf, buf.ctypes.data_as(_u8p)


def probe(data: bytes) -> Tuple[int, int, int, int]:
    """-> (total_samples_per_channel, channels, sample_rate, bits)."""
    lib = load()
    buf, ptr = _as_u8(data)
    total = ctypes.c_int64()
    ch, sr, bps = ctypes.c_int32(), ctypes.c_int32(), ctypes.c_int32()
    rc = lib.w2vtpu_flac_probe(
        ptr, len(buf), ctypes.byref(total), ctypes.byref(ch),
        ctypes.byref(sr), ctypes.byref(bps),
    )
    if rc != 0:
        raise ValueError(f"FLAC probe failed: {_ERRORS.get(rc, rc)}")
    return total.value, ch.value, sr.value, bps.value


def read_flac(path, dtype=np.float32) -> Tuple[np.ndarray, int]:
    """Decode a FLAC file -> (samples [T] mono or [T, C], sample_rate).

    A stream that declares no sample count is decoded into a buffer grown
    4x on each overflow, up to 2^28 samples per channel (as the JAX
    package's reader, :117-148)."""
    data = pathlib.Path(path).read_bytes()
    total, ch, sr, bps = probe(data)
    lib = load()
    buf, ptr = _as_u8(data)
    max_cap = 1 << 28
    cap = total if total > 0 else (len(data) * 8 // max(bps, 1) + 65536)
    cap = min(cap, max_cap)
    while True:
        out = np.empty(cap * ch, dtype=np.int32)
        written = ctypes.c_int64()
        rc = lib.w2vtpu_flac_decode(
            ptr, len(buf), out.ctypes.data_as(_i32p), cap, ctypes.byref(written)
        )
        if rc == -9 and total == 0 and cap < max_cap:
            cap = min(cap * 4, max_cap)
            continue
        if rc != 0:
            raise ValueError(f"FLAC decode failed: {_ERRORS.get(rc, rc)}")
        break
    n = written.value
    pcm = out[: n * ch].reshape(n, ch)
    if ch == 1:
        pcm = pcm[:, 0]
    if np.dtype(dtype) == np.int32:
        return pcm, sr
    return (pcm.astype(np.float32) / float(1 << (bps - 1))), sr
