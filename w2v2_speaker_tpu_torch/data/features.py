"""Log-mel filterbank features of a padded waveform batch.

Counterpart of ``w2v2_speaker_tpu/data/features.py``: ``FbankConfig``
(:27), ``mel_filterbank_matrix`` (:47), ``_dft_and_mel`` (:72),
``num_frames`` (:89) and ``log_mel_filterbank`` (:96). The transform is
framing (``unfold``), the DFT as two float32 products (float64 for a
float64 waveform) with fixed
``[n_fft, n_fft // 2 + 1]`` cos and sin matrices (the symmetric Hamming
window of ``np.hamming`` folded in), the power spectrum, the mel
projection as a third product, then the log. The matrices are built in
numpy, as the JAX package builds them, and kept per device. The JAX
package asks for ``Precision.HIGHEST``: on the card the products are full
float32 only under ``device.set_float32_precision`` (no TF32), which the
run and predict twins set.

With ``lengths``, the centre padding reflects each row at its true end
(a per-row gather), not at the zero-padded batch edge, so the first
``num_frames(length)`` frames of a padded row equal the unpadded row's.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

__all__ = ["FbankConfig", "log_mel_filterbank", "mel_filterbank_matrix", "num_frames"]


@dataclass(frozen=True)
class FbankConfig:
    sample_rate: int = 16000
    n_fft: int = 400
    win_length: int = 400  # 25 ms
    hop_length: int = 160  # 10 ms
    n_mels: int = 40
    f_min: float = 0.0
    f_max: Optional[float] = None  # defaults to sample_rate / 2
    log_eps: float = 1e-10
    center: bool = True  # torch.stft-style reflect padding


def _hz_to_mel(hz: np.ndarray) -> np.ndarray:
    return 2595.0 * np.log10(1.0 + hz / 700.0)


def _mel_to_hz(mel: np.ndarray) -> np.ndarray:
    return 700.0 * (10.0 ** (mel / 2595.0) - 1.0)


def mel_filterbank_matrix(cfg: FbankConfig) -> np.ndarray:
    """Triangular mel filterbank, shape [n_fft // 2 + 1, n_mels]."""
    f_max = cfg.f_max if cfg.f_max is not None else cfg.sample_rate / 2.0
    fft_freqs = np.linspace(0.0, cfg.sample_rate / 2.0, cfg.n_fft // 2 + 1)
    mel_pts = np.linspace(_hz_to_mel(np.array(cfg.f_min)), _hz_to_mel(np.array(f_max)), cfg.n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    lower, center, upper = hz_pts[:-2][None, :], hz_pts[1:-1][None, :], hz_pts[2:][None, :]
    f = fft_freqs[:, None]
    up_slope = (f - lower) / np.maximum(center - lower, 1e-10)
    down_slope = (upper - f) / np.maximum(upper - center, 1e-10)
    return np.maximum(0.0, np.minimum(up_slope, down_slope)).astype(np.float32)


@functools.lru_cache(maxsize=8)
def _dft_and_mel(cfg: FbankConfig) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(cos, sin, mel) projection matrices, the window folded into the
    first two. ``np.hamming`` is the symmetric window;
    ``torch.hamming_window`` defaults to the periodic one."""
    n = cfg.n_fft
    k = np.arange(n)[:, None]
    f = np.arange(n // 2 + 1)[None, :]
    angle = -2.0 * np.pi * k * f / n
    window = np.hamming(cfg.win_length).astype(np.float32)
    if cfg.win_length < n:
        pad = (n - cfg.win_length) // 2
        window = np.pad(window, (pad, n - cfg.win_length - pad))
    cos_m = (np.cos(angle) * window[:, None]).astype(np.float32)
    sin_m = (np.sin(angle) * window[:, None]).astype(np.float32)
    return cos_m, sin_m, mel_filterbank_matrix(cfg)


@functools.lru_cache(maxsize=16)
def _matrices(cfg: FbankConfig, device: torch.device, dtype: torch.dtype) -> Tuple[torch.Tensor, ...]:
    return tuple(torch.from_numpy(m).to(device, dtype) for m in _dft_and_mel(cfg))


def num_frames(num_samples: int, cfg: FbankConfig = FbankConfig()) -> int:
    """Frame count for a waveform of ``num_samples`` samples."""
    if cfg.center:
        return num_samples // cfg.hop_length + 1
    return 1 + (num_samples - cfg.n_fft) // cfg.hop_length


def log_mel_filterbank(
    wav: torch.Tensor, cfg: FbankConfig = FbankConfig(), lengths: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """[batch, samples] waveform -> [batch, frames, n_mels] log-mel features,
    float32 (float64 for a float64 waveform). ``lengths`` [batch] gives each
    row's true sample count; the frames past ``num_frames(length)`` are
    garbage, for the caller to mask."""
    if wav.ndim != 2:
        raise ValueError(f"expected [batch, samples], got {tuple(wav.shape)}")
    x = wav.to(torch.promote_types(wav.dtype, torch.float32))
    cos_m, sin_m, mel = _matrices(cfg, x.device, x.dtype)
    if cfg.center:
        p = cfg.n_fft // 2
        if lengths is None:
            x = F.pad(x[:, None], (p, p), mode="reflect")[:, 0]
        else:
            n = x.shape[1]
            last = (lengths.long() - 1).clamp_min(0)[:, None]
            i = torch.arange(-p, n + p, device=x.device)[None, :].abs()  # left edge, as jnp.pad reflects
            i = torch.where(i > last, 2 * last - i, i)  # right edge at the true end
            x = x.gather(1, i.clamp(0, n - 1))  # an all-padding row degrades gracefully
    frames = x.unfold(1, cfg.n_fft, cfg.hop_length)  # [batch, frames, n_fft]
    real, imag = frames @ cos_m, frames @ sin_m
    return torch.log((real * real + imag * imag) @ mel + cfg.log_eps)
