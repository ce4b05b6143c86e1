"""Per-utterance input normalisation (copy of
``w2v2_speaker_tpu/data/normalize.py``): ``normalize_2d`` (:22) per feature
channel or globally, ``normalize_waveform`` (:40) for a 1-D waveform;
unbiased std (ddof 1), eps 1e-5 added to it.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["normalize_2d", "normalize_waveform"]

_EPS = 1e-5


def normalize_2d(
    spectrogram: np.ndarray, channel_wise: bool = True
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Normalize [frames, features]; returns (normalized, mean, std)."""
    if spectrogram.ndim != 2:
        raise ValueError(
            f"expected 2-D [frames, features] input, got {spectrogram.shape}"
        )
    if channel_wise:
        mean = spectrogram.mean(axis=0)
        std = spectrogram.std(axis=0, ddof=1)
    else:
        mean = spectrogram.mean()
        std = spectrogram.std(ddof=1)
    normalized = (spectrogram - mean) / (std + _EPS)
    return normalized, mean, std


def normalize_waveform(wav: np.ndarray) -> np.ndarray:
    """Mean/variance-normalize a 1-D waveform (global statistics)."""
    if wav.ndim != 1:
        raise ValueError(f"expected 1-D waveform, got {wav.shape}")
    mean = wav.mean()
    std = wav.std(ddof=1)
    return (wav - mean) / (std + _EPS)
