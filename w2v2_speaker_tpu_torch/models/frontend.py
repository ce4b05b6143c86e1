"""The fbank frontend: waveform -> normalised log-mel frames -> inner model.

Counterpart of ``w2v2_speaker_tpu/models/frontend.py::FbankFrontend``
(:23-67): ``log_mel_filterbank`` of the batch (reflected at each row's
true end under a mask), ``lengths // hop + 1`` valid frames a row, then
per utterance and channel ``(x - mean) / (std + 1e-5)`` over the valid
frames (std with ddof 1, the count clamped at 2), the padding frames zeroed
after it, and the inner network (``inner``, the flax submodule's name) on
the frames and their mask. It computes in float32 (float64 for a float64
waveform).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from ..data.features import FbankConfig, log_mel_filterbank

__all__ = ["FbankFrontend"]


class FbankFrontend(nn.Module):
    def __init__(self, inner: nn.Module, fbank: FbankConfig = FbankConfig()):
        super().__init__()
        self.inner, self.fbank = inner, fbank

    def features(self, wav: torch.Tensor, wav_mask: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """([B, T, n_mels] normalised features, [B, T] frame mask or None)."""
        frame_mask = None
        if wav_mask is None:
            feats = log_mel_filterbank(wav, self.fbank)
        else:
            lengths = wav_mask.sum(dim=-1)
            feats = log_mel_filterbank(wav, self.fbank, lengths=lengths)
            n_frames = lengths // self.fbank.hop_length + 1
            frame_mask = torch.arange(feats.shape[1], device=feats.device)[None, :] < n_frames[:, None]
        if frame_mask is None:
            mean = feats.mean(dim=1, keepdim=True)
            std = feats.std(dim=1, keepdim=True)
        else:
            m = frame_mask.float()[:, :, None]
            n = m.sum(dim=1, keepdim=True).clamp_min(2.0)
            mean = (feats * m).sum(dim=1, keepdim=True) / n
            std = (((feats - mean) ** 2 * m).sum(dim=1, keepdim=True) / (n - 1.0)).sqrt()
        feats = (feats - mean) / (std + 1e-5)
        if frame_mask is not None:
            feats = feats * frame_mask.float()[:, :, None]
        return feats, frame_mask

    def forward(self, wav, wav_mask=None, train: bool = False, generator=None, labels=None):
        feats, frame_mask = self.features(wav, wav_mask)
        return self.inner(feats, frame_mask, train=train, generator=generator, labels=labels)

    def compute_embedding(self, wav: torch.Tensor, wav_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        feats, frame_mask = self.features(wav, wav_mask)
        return self.inner.compute_embedding(feats, frame_mask)
