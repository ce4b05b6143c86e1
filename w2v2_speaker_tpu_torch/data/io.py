"""Host-side audio I/O (copy of ``w2v2_speaker_tpu/data/io.py``): stdlib
``wave`` and numpy for WAV (PCM8/16/32, multi-channel downmixed), the
repository's own C++ decoder for FLAC (``utils/flac.py``); float32 mono
waveforms in [-1, 1], the 16 kHz check and the NaN / inf guard of
``load_raw_audio`` (:85).
"""

from __future__ import annotations

import pathlib
import wave
from typing import Tuple

import numpy as np

__all__ = [
    "read_wav", "read_audio", "write_wav", "load_raw_audio", "guard_finite",
]


def read_wav(path: pathlib.Path | str) -> Tuple[np.ndarray, int]:
    """Read a WAV file -> (float32 mono waveform in [-1, 1], sample_rate)."""
    with wave.open(str(path), "rb") as f:
        sr = f.getframerate()
        n = f.getnframes()
        channels = f.getnchannels()
        width = f.getsampwidth()
        raw = f.readframes(n)
    if width == 2:
        data = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        data = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        data = (
            np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0
        ) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width}")
    if channels > 1:
        data = data.reshape(-1, channels).mean(axis=1)
    return data, sr


def read_audio(path: pathlib.Path | str) -> Tuple[np.ndarray, int]:
    """Read WAV or FLAC -> (float32 mono waveform in [-1, 1], sample_rate).

    FLAC decode uses the native decoder (utils/flac.py), replacing the
    reference's torchaudio.load of LibriSpeech .flac
    (librispeech.py:662-804); multi-channel audio is downmixed like
    `read_wav`.
    """
    p = pathlib.Path(path)
    if p.suffix.lower() == ".flac":
        from ..utils.flac import read_flac

        data, sr = read_flac(p, dtype=np.float32)
        if data.ndim > 1:
            data = data.mean(axis=1)
        return data.astype(np.float32), sr
    return read_wav(p)


def write_wav(
    path: pathlib.Path | str, wav: np.ndarray, sample_rate: int = 16000
) -> None:
    """Write a float32 [-1, 1] mono waveform as PCM16 WAV."""
    pcm = np.clip(wav, -1.0, 1.0)
    pcm = np.round(pcm * 32767.0).astype("<i2")
    with wave.open(str(path), "wb") as f:
        f.setnchannels(1)
        f.setsampwidth(2)
        f.setframerate(sample_rate)
        f.writeframes(pcm.tobytes())


def guard_finite(wav: np.ndarray, name: str = "waveform") -> np.ndarray:
    if not np.isfinite(wav).all():
        raise ValueError(f"{name} contains NaN or inf values")
    return wav


def load_raw_audio(
    path: pathlib.Path | str, expected_sample_rate: int = 16000
) -> np.ndarray:
    """Load audio with the reference's 16 kHz + finiteness guards
    (`data/util.py:19-34`, 60-76)."""
    wav, sr = read_audio(path)
    if sr != expected_sample_rate:
        raise ValueError(
            f"{path}: sample rate {sr} != expected {expected_sample_rate}"
        )
    return guard_finite(wav, str(path))
