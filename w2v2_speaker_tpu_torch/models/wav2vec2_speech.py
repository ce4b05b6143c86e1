"""wav2vec2 + CTC letter head, the speech-recognition model.

Counterpart of ``w2v2_speaker_tpu/models/wav2vec2_speech.py``:
``Wav2Vec2SpeechConfig`` (:31) and ``Wav2Vec2SpeechModel`` (:42). The
backbone's float32 frames go, in training, through the embedding masker
(whole time steps and channels zeroed, ``embedding_mask``) and the head
dropout, then the ``lm_head`` Linear to the vocabulary; the logits are
float32, with the backbone's ``frame_mask``. The submodules carry the flax
names (``wav2vec2``, ``lm_head``), so ``params_from_jax`` of the JAX
model's params loads with ``strict=True``.

The head dropout draws its mask as the backbone's dropout sites do
(``HashDropout``: the counter hash of a seed from the step's generator, or
``torch.bernoulli`` with ``hash_dropout`` false); the JAX package's is
flax's ``nn.Dropout``. No mask is bit-equal across the packages.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import torch
from torch import nn

from .masking import embedding_mask
from .wav2vec2 import BASE_CONFIG, HashDropout, Wav2Vec2Config, Wav2Vec2Model

__all__ = ["Wav2Vec2SpeechConfig", "Wav2Vec2SpeechModel"]


@dataclass(frozen=True)
class Wav2Vec2SpeechConfig:
    w2v2: Wav2Vec2Config = BASE_CONFIG
    vocab_size: int = 32
    head_dropout: float = 0.1
    timestep_mask_prob: float = 0.0  # the embedding masker, training only
    timestep_mask_width: int = 1
    channel_mask_prob: float = 0.0
    channel_mask_width: int = 1


class Wav2Vec2SpeechModel(nn.Module):
    def __init__(self, cfg: Wav2Vec2SpeechConfig = Wav2Vec2SpeechConfig()):
        super().__init__()
        self.cfg = cfg
        self.wav2vec2 = Wav2Vec2Model(cfg.w2v2)
        self.head_dropout = HashDropout(cfg.head_dropout, cfg.w2v2.hash_dropout)
        self.lm_head = nn.Linear(cfg.w2v2.hidden_size, cfg.vocab_size)

    def forward(
        self,
        wav: torch.Tensor,  # [B, N]
        wav_mask: Optional[torch.Tensor] = None,  # [B, N] validity
        train: bool = False,
        generator: Optional[torch.Generator] = None,
    ) -> Dict[str, Optional[torch.Tensor]]:
        """``{"logits"`` [B, T, V] float32, ``"frame_mask"`` [B, T] or None,
        ``"embedding"`` [B, T, hidden]``}``; ``train=True`` draws every
        mask from ``generator``."""
        cfg = self.cfg
        features, frame_mask = self.wav2vec2(wav, wav_mask, train, generator)
        if train and (cfg.timestep_mask_prob > 0 or cfg.channel_mask_prob > 0):
            features = embedding_mask(features, cfg.timestep_mask_prob, cfg.timestep_mask_width,
                                      cfg.channel_mask_prob, cfg.channel_mask_width, generator)
        h = self.head_dropout(features, generator if train else None)
        return {"logits": self.lm_head(h).float(), "frame_mask": frame_mask, "embedding": features}
