"""The dummy model of schedule and pipeline smoke runs.

Counterpart of ``w2v2_speaker_tpu/models/dummy.py::DummyModel`` (:19): the
"embedding" is the (mean, std) of each waveform over its valid samples
(std with ddof 1, the divisor clamped at 1 and 1e-10 under the sqrt with a
mask; ``torch.std`` without one), and the ``classifier`` is one dense
layer from 2 to the speaker count.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
from torch import nn

__all__ = ["DummyModel"]


class DummyModel(nn.Module):
    """The model contract of ``SpeakerTask``; ``train``, ``generator`` and
    ``labels`` are accepted and not read."""

    def __init__(self, num_speakers: int = 100):
        super().__init__()
        self.classifier = nn.Linear(2, num_speakers)

    def forward(self, wav, wav_mask=None, train: bool = False, generator=None, labels=None) -> Dict[str, torch.Tensor]:
        wav = wav.to(self.classifier.weight.dtype)
        if wav_mask is None:
            mean, std = wav.mean(dim=-1), wav.std(dim=-1)
        else:
            m = wav_mask.float()
            n = m.sum(dim=-1).clamp_min(1.0)
            mean = (wav * m).sum(dim=-1) / n
            var = ((wav - mean[:, None]) ** 2 * m).sum(dim=-1) / (n - 1.0).clamp_min(1.0)
            std = (var + 1e-10).sqrt()
        embedding = torch.stack([mean, std], dim=-1)
        return {"embedding": embedding, "logits": self.classifier(embedding)}

    def compute_embedding(self, wav: torch.Tensor, wav_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        return self.forward(wav, wav_mask)["embedding"]
